"""The PUSCH receiver's demap stage: max-log soft demapping, LLR quantisation
and descrambling of the equalised symbols, from (eq, noise, signs) to int8
LLRs, in the rate dematcher's bit-major layout or the UCI placement's
symbol-major one.

`demap_descramble` is the entry point, and `demap_route` the function it
takes for a device, which the receiver binds when it is built: a CPU tensor
takes the plain torch version (`demap_descramble_plain`: `ops.demodulation.soft_demap`
and the descrambling product, as the receiver has always run them), a CUDA
tensor launches the hand-written kernel `csrc/pusch_demap.cu` or raises.  The
kernel is bit-exact with the plain version run on the card; see the source
note for the arithmetic.  It replaces no TPU kernel: on the card the plain
version is about 270 elementwise kernels for 256QAM in each replay of the
receiver's CUDA graph.

The library is its own (`utils.nvcc`, stem `pusch_demap`), built with
`-fmad=false` at first use and loaded with ctypes; the kernel runs on
torch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from ..ran.modulation import Modulation, bits_per_symbol
from ..utils import nvcc
from .demodulation import demap_axis_tables, demap_tables, range_limit, soft_demap

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pusch_demap.cu"
NVCC_FLAGS = nvcc.FLAGS + ("-fmad=false",)

#: Kernel launches since the last reset, counted where the kernel is
#: launched (a replayed CUDA graph's launches are not counted).
LAUNCHES = {"pusch_demap": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: The kernel's `Tables` parameter (csrc/pusch_demap.cu), field by field.  The
#: .cu file asserts each field's offset and the size; the CPU tests hold
#: those assertions against this dtype.
MAX_LEVELS = 16
TABLES_DTYPE = np.dtype([
    ("level", "<f4", (MAX_LEVELS,)),     # square QAM: one axis's PAM levels, ascending
    ("level_sq", "<f4", (MAX_LEVELS,)),  # level * level in float32
    ("point", "<f4", (2, 2)),            # BPSK: the point of bit value b, (re, im)
    ("point_norm", "<f4", (2,)),         # |point|^2 in float32
    ("limit", "<f4"),                    # the range limit L
    ("inv_limit", "<f4"),                # 1 / L in float32
])


def build(verbose: bool = False) -> Path:
    """Compile the kernel library unless an up-to-date build exists."""
    return nvcc.build("pusch_demap", SOURCE, NVCC_FLAGS, verbose)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.pusch_demap_launch.argtypes = [vp] * 4 + [ci] * 5 + [ctypes.c_longlong, vp, vp]
    lib.pusch_demap_launch.restype = ci
    return lib


def pam_bit(k: int, j: int, i: int) -> int:
    """Axis bit j (0: the sign bit) of the ascending PAM level i, k bits per
    axis, as the kernel derives it (`pam_bit` in the source)."""
    v = 2 * i - ((1 << k) - 1)
    for t in range(j):
        v = (1 << (k - 1 - t)) - abs(v)
    return int(v < 0)


@functools.lru_cache(maxsize=None)
def kernel_tables(mod: Modulation) -> np.ndarray:
    """() TABLES_DTYPE: `mod`'s constants for the kernel, passed by value.
    Raises unless the constellation's bits lie as the kernel derives them
    (symbol bit b on axis b % 2, its axis bit b // 2 by `pam_bit`)."""
    qm = bits_per_symbol(mod)
    t = np.zeros((), dtype=TABLES_DTYPE)
    axis = demap_axis_tables(mod)
    if axis is not None:
        pam, bit_axis, bits_pam = axis
        k = qm // 2
        want = np.asarray([[pam_bit(k, b // 2, i) for b in range(qm)] for i in range(len(pam))])
        if (len(pam) != 1 << k or list(bit_axis) != [b % 2 for b in range(qm)]
                or not np.array_equal(bits_pam, want.astype(bool))):
            raise ValueError(f"{mod}: the constellation is not the kernel's Gray PAM layout")
        t["level"][:len(pam)] = pam
        t["level_sq"][:len(pam)] = pam * pam
    elif qm == 1:
        c_pair, c_norm, bits = demap_tables(mod)
        t["point"] = c_pair[np.argsort(bits[:, 0])]
        t["point_norm"] = c_norm[np.argsort(bits[:, 0])]
    else:
        raise ValueError(f"{mod}: no demap kernel")
    limit = np.float32(range_limit(mod))
    t["limit"], t["inv_limit"] = limit, np.float32(1.0) / limit
    t.flags.writeable = False
    return t


def demap_descramble_plain(eq: torch.Tensor, noise_var: torch.Tensor, signs: torch.Tensor,
                           mod: Modulation, bit_major: bool) -> torch.Tensor:
    """The plain torch version: `soft_demap` of eq (B, N, 2) with noise
    (B, N), times the descrambling signs (B, N*Qm) (or (N*Qm,) for every row)
    int8 with position n's bit b at n*Qm + b, saturated at +/-127.  Returns
    bit-major (B, Qm, N) or symbol-major (B, N*Qm) int8."""
    if bit_major:
        llr = soft_demap(eq, noise_var, mod, bit_major=True)
        qm = bits_per_symbol(mod)
        sg = signs.reshape(-1, eq.shape[-2], qm).transpose(1, 2).to(torch.int32)
    else:
        llr = soft_demap(eq, noise_var, mod)
        sg = signs.to(torch.int32)
    return torch.clamp(llr.to(torch.int32) * sg, -127, 127).to(torch.int8)


def _check(eq: torch.Tensor, noise_var: torch.Tensor, signs: torch.Tensor, qm: int):
    """The kernel's input contract."""
    if not (eq.is_cuda and noise_var.device == eq.device and signs.device == eq.device):
        raise ValueError("the demap kernel needs its inputs on one card")
    if eq.dtype != torch.float32 or eq.dim() != 3 or eq.shape[-1] != 2:
        raise ValueError(f"eq must be float32 (B, N, 2), got {eq.dtype} {tuple(eq.shape)}")
    b, n = eq.shape[:2]
    if noise_var.dtype != torch.float32 or tuple(noise_var.shape) != (b, n):
        raise ValueError(f"noise_var must be float32 {(b, n)}, got {noise_var.dtype} "
                         f"{tuple(noise_var.shape)}")
    if signs.dtype != torch.int8 or tuple(signs.shape) not in ((b, n * qm), (n * qm,)):
        raise ValueError(f"signs must be int8 {(b, n * qm)} or {(n * qm,)}, got "
                         f"{signs.dtype} {tuple(signs.shape)}")
    if not (eq.is_contiguous() and noise_var.is_contiguous() and signs.is_contiguous()):
        raise ValueError("eq, noise_var and signs must be contiguous")
    if b > 65535:
        raise ValueError(f"at most 65535 rows, got {b}")


def demap_descramble_cuda(eq: torch.Tensor, noise_var: torch.Tensor, signs: torch.Tensor,
                          mod: Modulation, bit_major: bool) -> torch.Tensor:
    """The kernel; same contract as `demap_descramble_plain`."""
    qm = bits_per_symbol(mod)
    _check(eq, noise_var, signs, qm)
    tables = kernel_tables(mod)
    b, n = eq.shape[:2]
    out = torch.empty((b, qm, n) if bit_major else (b, n * qm), dtype=torch.int8,
                      device=eq.device)
    lib = _library()
    with torch.cuda.device(eq.device):
        stream = torch.cuda.current_stream(eq.device).cuda_stream
        rc = lib.pusch_demap_launch(
            eq.data_ptr(), noise_var.data_ptr(), signs.data_ptr(), out.data_ptr(), b, n, qm,
            int(mod == Modulation.PI_2_BPSK), int(bit_major),
            n * qm if signs.dim() == 2 else 0, tables.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError(f"pusch_demap kernel launch failed: CUDA error {rc}")
    LAUNCHES["pusch_demap"] += 1
    return out


def demap_route(device):
    """The demap stage's function for tensors on `device`, with the contract
    of `demap_descramble_plain`: the kernel on a card, the plain version on
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return demap_descramble_cuda
    if dev.type == "cpu":
        return demap_descramble_plain
    raise ValueError(f"no demap kernel for device {dev}")


def demap_descramble(eq: torch.Tensor, noise_var: torch.Tensor, signs: torch.Tensor,
                     mod: Modulation, bit_major: bool) -> torch.Tensor:
    """Demap, quantise and descramble: bit-major (B, Qm, N) or symbol-major
    (B, N*Qm) int8 LLRs.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    return demap_route(eq.device)(eq, noise_var, signs, mod, bit_major)
