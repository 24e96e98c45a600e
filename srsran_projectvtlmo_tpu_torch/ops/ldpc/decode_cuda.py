"""Early-stop LDPC decoding on the card: the hand-written CUDA kernel
`csrc/ldpc_decode_es.cu` and the wrapper that builds, checks and launches it.

The kernel replaces the Pallas TPU kernels `ldpc_decode_pallas_es_bm` and its
packed-lane form `_ldpc_decode_pallas_es_packed`
(srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py); see the source note for
its design.  `ldpc_decode_es` is the entry point the PUSCH receiver calls:
a CPU tensor takes the plain torch decoder (`decode.ldpc_decode_es`), a CUDA
tensor launches the kernel or raises.

The library is built with nvcc at first use, from the sources in the
checkout, into `_build/` beside the package (listed in .gitignore), and
loaded with ctypes; the kernel runs on torch's current stream.
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
import torch

from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph

from ...utils.tables import on_device
from ..crc import POLYS
from . import decode as plain
from .graphs import get_graph

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "ldpc_decode_es.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"ldpc_decode_es": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> Path:
    """Build output, named by the source's content hash so an edit rebuilds."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libldpc_decode_es_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel library unless an up-to-date build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ldpc_decode_es_launch.argtypes = [vp] * 8 + [ci] * 6 + [ctypes.c_float, vp]
    lib.ldpc_decode_es_launch.restype = ci
    return lib


def row_ptr_table(bg: BaseGraph, z: int) -> np.ndarray:
    """(m+1,) int32: row r's edges are edge_table[row_ptr[r]:row_ptr[r+1]]."""
    deg = (get_graph(bg, z).row_cols >= 0).sum(axis=1)
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


def edge_table(bg: BaseGraph, z: int) -> np.ndarray:
    """(nnz,) int32 row-major edges, ascending columns: column | shift << 16."""
    g = get_graph(bg, z)
    sel = g.row_cols >= 0
    return (g.row_cols[sel] | (g.row_shifts[sel] << 16)).astype(np.int32)


def ldpc_decode_es_cuda(llrs: torch.Tensor, bg: BaseGraph, z: int, crc_name: str,
                        nof_crc_covered_bits: int, *,
                        nof_iterations: int = plain.DEFAULT_ITERATIONS,
                        scaling_factor: float = plain.DEFAULT_SCALING):
    """The CUDA kernel; same contract as `decode.ldpc_decode_es`."""
    g = get_graph(bg, z)
    if not llrs.is_cuda:
        raise ValueError("ldpc_decode_es_cuda needs a CUDA tensor")
    if llrs.dtype != torch.int8 or llrs.dim() != 2 or llrs.shape[1] != g.n:
        raise ValueError(f"llrs must be int8 (B, {g.n}), got {llrs.dtype} {tuple(llrs.shape)}")
    if not llrs.is_contiguous():
        raise ValueError("llrs must be contiguous")
    if crc_name not in POLYS or not 0 < nof_crc_covered_bits <= g.k:
        raise ValueError(f"bad CRC {crc_name} over {nof_crc_covered_bits} bits")
    if nof_iterations < 1:
        raise ValueError("nof_iterations must be >= 1")
    b = llrs.shape[0]
    dev = llrs.device
    row_ptr = on_device(row_ptr_table, bg, z, device=dev)
    edges = on_device(edge_table, bg, z, device=dev)
    mask = on_device(plain.packed_crc_mask, bg, z, crc_name, int(nof_crc_covered_bits),
                     device=dev)
    hard = torch.empty((b, g.k), dtype=torch.uint8, device=dev)
    soft = torch.empty((b, g.k), dtype=torch.int8, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    iters = torch.empty((b,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ldpc_decode_es_launch(
            llrs.data_ptr(), row_ptr.data_ptr(), edges.data_ptr(), mask.data_ptr(),
            hard.data_ptr(), soft.data_ptr(), ok.data_ptr(), iters.data_ptr(),
            b, z, g.n_full, g.m, g.kb, int(nof_iterations), float(scaling_factor), stream)
    if rc != 0:
        raise RuntimeError(f"ldpc_decode_es kernel launch failed: CUDA error {rc}")
    LAUNCHES["ldpc_decode_es"] += 1
    return hard, soft, ok, iters


def ldpc_decode_es(llrs: torch.Tensor, bg: BaseGraph, z: int, crc_name: str,
                   nof_crc_covered_bits: int, *,
                   nof_iterations: int = plain.DEFAULT_ITERATIONS,
                   scaling_factor: float = plain.DEFAULT_SCALING):
    """Early-stop decode: (hard (B,K) u8, soft (B,K) i8, crc_ok (B,) bool,
    iterations (B,) i32).  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    if llrs.device.type == "cpu":
        return plain.ldpc_decode_es(llrs, bg, z, crc_name, nof_crc_covered_bits,
                                    nof_iterations=nof_iterations,
                                    scaling_factor=scaling_factor)
    if llrs.device.type == "cuda":
        return ldpc_decode_es_cuda(llrs, bg, z, crc_name, nof_crc_covered_bits,
                                   nof_iterations=nof_iterations,
                                   scaling_factor=scaling_factor)
    raise ValueError(f"no LDPC decoder for device {llrs.device}")
