"""The port's CUDA libraries: each hand-written kernel source in `csrc/` is
compiled with nvcc into a shared library of its own with a plain C
interface, loaded with ctypes by its wrapper.

A library is built at first use from the sources in the checkout into
`_build/` beside the package (listed in .gitignore), named by its source's
content hash and flags, so an edit rebuilds.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(stem: str, source: Path, flags: tuple[str, ...] = FLAGS) -> Path:
    """Build output of library `stem`, named by its source's content hash."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}_{digest}.so"


def build(stem: str, source: Path, flags: tuple[str, ...] = FLAGS,
          verbose: bool = False) -> Path:
    """Library `stem`'s path, compiled from `source` with `flags` first unless
    it has an up-to-date build.  With `verbose` nvcc's `-Xptxas -v` report is
    printed."""
    out = library_path(stem, source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, *(("-Xptxas", "-v") if verbose else ()), "-o", tmp, str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out
