"""ctypes loader for the native host helper library, `csrc/host_kernels.cpp`
(port of `srsran_projectvtlmo_tpu.native`).

The library is built at first use with the host C++ compiler
(`c++ -O3 -std=c++17 -fPIC -shared`) into `_build/` beside the package
(listed in .gitignore), named by the source's content hash so an edit
rebuilds.  Without a compiler, or when the build fails, `load()` returns None
and the helpers fall back to their pure-Python versions; `available()` says
which path is in use.  Nothing on a slot path calls these helpers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host_kernels.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libsrsran_host_{digest}.so"


def build() -> Path | None:
    """Compile the library unless an up-to-date build exists; None when no
    C++ compiler is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("c++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                             timeout=120)
    except subprocess.TimeoutExpired:
        os.unlink(tmp)
        return None
    if res.returncode != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.pack_bits_u32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.unpack_bits_u32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.crc_bits.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int]
    lib.crc_bits.restype = ctypes.c_uint32
    lib.spsc_create.argtypes = [ctypes.c_int64]
    lib.spsc_create.restype = ctypes.c_void_p
    lib.spsc_destroy.argtypes = [ctypes.c_void_p]
    lib.spsc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.spsc_write.restype = ctypes.c_int64
    lib.spsc_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.spsc_read.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """True when the native library is in use, False on the Python fallback."""
    return load() is not None


def pack_bits(bits: np.ndarray) -> np.ndarray:
    lib = load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if lib is None:
        from .utils.bits import pack_bits as py_pack

        return py_pack(bits)
    words = np.empty((len(bits) + 31) // 32, dtype=np.uint32)
    lib.pack_bits_u32(bits.ctypes.data, words.ctypes.data, len(bits))
    return words


def unpack_bits(words: np.ndarray, nof_bits: int) -> np.ndarray:
    lib = load()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    if lib is None:
        from .utils.bits import unpack_bits as py_unpack

        return py_unpack(words, nof_bits)
    bits = np.empty(nof_bits, dtype=np.uint8)
    lib.unpack_bits_u32(words.ctypes.data, bits.ctypes.data, nof_bits)
    return bits


def crc_bits(bits: np.ndarray, name: str) -> int:
    from .ops.crc import POLYS

    order, poly = POLYS[name]
    lib = load()
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if lib is None:
        from .ops.crc import crc_host

        rem = crc_host(bits, name)
        return int("".join(map(str, rem.tolist())), 2) if len(rem) else 0
    return int(lib.crc_bits(bits.ctypes.data, len(bits), poly & ((1 << order) - 1), order))


class SpscRing:
    """Native single-producer single-consumer IQ ring buffer."""

    def __init__(self, capacity_samples: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ring = lib.spsc_create(capacity_samples)

    def write(self, iq_pair: np.ndarray) -> int:
        iq = np.ascontiguousarray(iq_pair, dtype=np.float32)
        return self._lib.spsc_write(self._ring, iq.ctypes.data, iq.shape[0])

    def read(self, nof_samples: int) -> np.ndarray:
        out = np.empty((nof_samples, 2), dtype=np.float32)
        self._lib.spsc_read(self._ring, out.ctypes.data, nof_samples)
        return out

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.spsc_destroy(self._ring)
            self._ring = None
