"""LDPC decoding on the card: the hand-written CUDA kernel `csrc/ldpc_decode.cu`
and the wrappers that build, check and launch it, one per mode.

Early-stop mode replaces the Pallas TPU kernels `ldpc_decode_pallas_es_bm`,
its packed-lane form `_ldpc_decode_pallas_es_packed` and the transposed
`ldpc_decode_pallas_es`; fixed-iteration mode replaces `ldpc_decode_pallas`
(v1), `ldpc_decode_pallas_v3` and `ldpc_decode_pallas_v2`
(srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py, decode_pallas_v2.py); see
the source note for the design.  `ldpc_decode_es` and `ldpc_decode` are the
entry points the PUSCH receiver calls: a CPU tensor takes the plain torch
decoder (`decode.ldpc_decode_es`, `decode.ldpc_decode`), a CUDA tensor
launches the kernel or raises.

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

from ...ran.ldpc_params import BaseGraph
from ...utils.tables import on_device
from ..crc import POLYS
from . import decode as plain
from .graphs import get_graph

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "ldpc_decode.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"ldpc_decode_es": 0, "ldpc_decode": 0}


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
    return BUILD_DIR / f"libldpc_decode_{digest}.so"


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
    lib.ldpc_decode_es_launch.argtypes = [vp] * 6 + [ci] * 2 + [vp, vp]
    lib.ldpc_decode_es_launch.restype = ci
    lib.ldpc_decode_launch.argtypes = [vp] * 3 + [ci] * 2 + [vp, vp]
    lib.ldpc_decode_launch.restype = ci
    return lib


def row_ptr_table(bg: BaseGraph, z: int) -> np.ndarray:
    """(m+1,) int32: row r's edges are edge_table[row_ptr[r]:row_ptr[r+1]]."""
    deg = (get_graph(bg, z).row_cols >= 0).sum(axis=1)
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


def edge_table(bg: BaseGraph, z: int) -> np.ndarray:
    """(nnz, 2) int32 row-major edges, ascending columns: (shift, col * z).
    Check lane i of the edge reads soft index col * z + (i + shift) mod z,
    which the kernel forms as col * z + umin(i + shift, i + shift - z)."""
    g = get_graph(bg, z)
    sel = g.row_cols >= 0
    return np.stack([g.row_shifts[sel], g.row_cols[sel] * z], axis=1).astype(np.int32)


def row_groups(bg: BaseGraph, z: int) -> np.ndarray:
    """(ngroups,) int32 exclusive end rows of the barrier groups: runs of
    consecutive rows that share no column, so one group's rows update
    disjoint soft bits and need no barrier between them."""
    g = get_graph(bg, z)
    ends, seen = [], set()
    for r in range(g.m):
        cols = set(g.row_cols[r][g.row_cols[r] >= 0].tolist())
        if seen & cols:
            ends.append(r)
            seen = set()
        seen |= cols
    ends.append(g.m)
    return np.asarray(ends, dtype=np.int32)


#: The kernel's `Plan` parameter (csrc/ldpc_decode.cu), field by field.  The
#: .cu file asserts each field's offset and the size; the CPU tests hold
#: those assertions against this dtype.
PLAN_MAX_ROWS, PLAN_MAX_EDGES = 46, 316
PLAN_DTYPE = np.dtype([
    ("z", "<i4"), ("nv", "<i4"), ("m", "<i4"), ("kb", "<i4"), ("ngroups", "<i4"),
    ("group_end", "<i4", (PLAN_MAX_ROWS,)),    # exclusive last row of group g
    ("row_ptr", "<i4", (PLAN_MAX_ROWS + 1,)),  # row r: edge[row_ptr[r]:row_ptr[r+1]]
    ("edge", "<i4", (PLAN_MAX_EDGES, 2)),      # (shift, col * z), edge_table
    ("lut", "i1", (128,)),                     # decode.scale_table
])


@functools.lru_cache(maxsize=None)
def kernel_plan(bg: BaseGraph, z: int, scaling_factor: float) -> np.ndarray:
    """() PLAN_DTYPE: the kernel's graph, barrier groups and scale table for
    one (base graph, z, scaling factor), passed by value."""
    g = get_graph(bg, z)
    groups, row_ptr, edges = row_groups(bg, z), row_ptr_table(bg, z), edge_table(bg, z)
    plan = np.zeros((), dtype=PLAN_DTYPE)
    plan["z"], plan["nv"], plan["m"], plan["kb"] = z, g.n_full, g.m, g.kb
    plan["ngroups"] = len(groups)
    plan["group_end"][:len(groups)] = groups
    plan["row_ptr"][:len(row_ptr)] = row_ptr
    plan["edge"][:len(edges)] = edges
    plan["lut"] = plain.scale_table(scaling_factor).astype(np.int8)
    plan.flags.writeable = False
    return plan


def _check_llrs(llrs: torch.Tensor, bg: BaseGraph, z: int, nof_iterations: int):
    """The kernel's input contract; returns the graph."""
    g = get_graph(bg, z)
    if not llrs.is_cuda:
        raise ValueError("the LDPC kernel needs a CUDA tensor")
    if llrs.dtype != torch.int8 or llrs.dim() != 2 or llrs.shape[1] != g.n:
        raise ValueError(f"llrs must be int8 (B, {g.n}), got {llrs.dtype} {tuple(llrs.shape)}")
    if not llrs.is_contiguous():
        raise ValueError("llrs must be contiguous")
    if nof_iterations < 1:
        raise ValueError("nof_iterations must be >= 1")
    return g


def _plan(bg: BaseGraph, z: int, scaling_factor: float) -> np.ndarray:
    """The kernel's plan; the kernel's arithmetic assumes |c2v| <= 120, which
    holds for the min-sum scaling domain (0, 1] of the JAX decoder."""
    if not 0.0 < scaling_factor <= 1.0:
        raise ValueError(f"scaling_factor must be in (0, 1], got {scaling_factor}")
    return kernel_plan(bg, z, float(scaling_factor))


def ldpc_decode_es_cuda(llrs: torch.Tensor, bg: BaseGraph, z: int, crc_name: str,
                        nof_crc_covered_bits: int, *,
                        nof_iterations: int = plain.DEFAULT_ITERATIONS,
                        scaling_factor: float = plain.DEFAULT_SCALING):
    """The kernel's early-stop mode; same contract as `decode.ldpc_decode_es`."""
    g = _check_llrs(llrs, bg, z, nof_iterations)
    if crc_name not in POLYS or not 0 < nof_crc_covered_bits <= g.k:
        raise ValueError(f"bad CRC {crc_name} over {nof_crc_covered_bits} bits")
    plan = _plan(bg, z, scaling_factor)
    b = llrs.shape[0]
    dev = llrs.device
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
            llrs.data_ptr(), mask.data_ptr(), hard.data_ptr(), soft.data_ptr(), ok.data_ptr(),
            iters.data_ptr(), b, int(nof_iterations), plan.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"ldpc_decode_es kernel launch failed: CUDA error {rc}")
    LAUNCHES["ldpc_decode_es"] += 1
    return hard, soft, ok, iters


def ldpc_decode_cuda(llrs: torch.Tensor, bg: BaseGraph, z: int, *,
                     nof_iterations: int = plain.DEFAULT_ITERATIONS,
                     scaling_factor: float = plain.DEFAULT_SCALING):
    """The kernel's fixed-iteration mode; same contract as `decode.ldpc_decode`."""
    g = _check_llrs(llrs, bg, z, nof_iterations)
    plan = _plan(bg, z, scaling_factor)
    b = llrs.shape[0]
    dev = llrs.device
    hard = torch.empty((b, g.k), dtype=torch.uint8, device=dev)
    soft = torch.empty((b, g.k), dtype=torch.int8, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ldpc_decode_launch(llrs.data_ptr(), hard.data_ptr(), soft.data_ptr(), b,
                                    int(nof_iterations), plan.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"ldpc_decode kernel launch failed: CUDA error {rc}")
    LAUNCHES["ldpc_decode"] += 1
    return hard, soft


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


def ldpc_decode(llrs: torch.Tensor, bg: BaseGraph, z: int, *,
                nof_iterations: int = plain.DEFAULT_ITERATIONS,
                scaling_factor: float = plain.DEFAULT_SCALING):
    """Fixed-iteration decode: (hard (B,K) u8, soft (B,K) i8).  CPU tensors
    take the plain version; CUDA tensors the kernel."""
    if llrs.device.type == "cpu":
        return plain.ldpc_decode(llrs, bg, z, nof_iterations=nof_iterations,
                                 scaling_factor=scaling_factor)
    if llrs.device.type == "cuda":
        return ldpc_decode_cuda(llrs, bg, z, nof_iterations=nof_iterations,
                                scaling_factor=scaling_factor)
    raise ValueError(f"no LDPC decoder for device {llrs.device}")
