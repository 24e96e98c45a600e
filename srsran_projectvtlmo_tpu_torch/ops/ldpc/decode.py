"""Layered scaled min-sum LDPC decoder in plain torch ops, int8-exact.

Port of `srsran_projectvtlmo_tpu.ops.ldpc.decode` (`ldpc_decode`,
`ldpc_decode_es`), bit-exact with it and with the reference arithmetic
(reference: lib/phy/upper/channel_coding/ldpc/ldpc_decoder_generic.cpp:30-125,
ldpc_decoder_impl.cpp:116-135):

  per iteration, per layer (= lifted check row):
    v2c   = soft - c2v            (saturated difference: clip +/-120,
                                   +/-127 dominates, a - a = 0)
    min1/min2/argmin of |v2c| (running minima start at 120, first edge wins
    ties) and the sign product over the row's edges
    c2v'  = copysign(floor(min * 0.8 + 0.5), sign_prod ^ sign(v2c))
    soft  = promotion_sum(c2v', v2c)  (overflow promotes to +/-127)

This is the CPU path and the reference the CUDA kernel
(`decode_cuda.py`, `csrc/ldpc_decode.cu`) is held against.  Each layer
is one gather, a few batched elementwise ops and one scatter over the
row's real edges; the row loop runs in Python.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ran.ldpc_params import BaseGraph
from ...utils.llr import LLR_INFTY, LLR_MAX
from ...utils.tables import on_device
from ..crc import POLYS, packed_zero_mask, xor_reduce
from .graphs import get_graph

#: Default min-sum scaling factor and iteration count (reference defaults).
DEFAULT_SCALING = 0.8
DEFAULT_ITERATIONS = 6


def _row_index(bg: BaseGraph, z: int, r: int) -> np.ndarray:
    """Row r's flat soft-bit index (deg * z,) of each (edge, check lane):
    column c at lane i reads variable index c*z + (i + s) mod z.  The same
    index scatters the updated values back, since a row touches each of its
    columns once."""
    g = get_graph(bg, z)
    deg = int((g.row_cols[r] >= 0).sum())
    cols, shifts = g.row_cols[r, :deg], g.row_shifts[r, :deg]
    idx = cols[:, None] * z + (np.arange(z)[None, :] + shifts[:, None]) % z
    return idx.reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def scale_table(scaling_factor: float) -> np.ndarray:
    """(128,) int32: floor(mag * sf + 0.5) in float32, for mag = 0..127."""
    mags = np.arange(128, dtype=np.float32)
    return np.floor(mags * np.float32(scaling_factor) + np.float32(0.5)).astype(np.int32)


def packed_crc_mask(bg: BaseGraph, z: int, crc_name: str, kp: int) -> np.ndarray:
    """(kb*z,) int32 zero-basis CRC rows of the first kp systematic bits, zero after."""
    return packed_zero_mask(crc_name, get_graph(bg, z).k, kp)


def _sat_sub(a, b):
    plain = torch.clamp(a - b, -LLR_MAX, LLR_MAX)
    out = torch.where(a.abs() == LLR_INFTY, a, torch.where(b.abs() == LLR_INFTY, -b, plain))
    return torch.where(a == b, 0, out)


def _promotion_sum(a, b):
    s = a + b
    plain = torch.where(s.abs() > LLR_MAX, torch.sign(s) * LLR_INFTY, s)
    out = torch.where(a.abs() == LLR_INFTY, a, torch.where(b.abs() == LLR_INFTY, b, plain))
    return torch.where(a == -b, 0, out)


class _Sweeper:
    """Decoder state for one batch: soft bits (B, nv*z) int32 and the per-row
    check-to-variable messages (B, deg_r, z) int32."""

    def __init__(self, llrs: torch.Tensor, bg: BaseGraph, z: int, scaling_factor: float):
        g = get_graph(bg, z)
        if llrs.dim() != 2 or llrs.shape[1] != g.n:
            raise ValueError(f"llrs must be (B, {g.n}), got {tuple(llrs.shape)}")
        dev = llrs.device
        self.g, self.z, self.b = g, z, llrs.shape[0]
        self.soft = torch.cat([torch.zeros((self.b, 2 * z), dtype=torch.int32, device=dev),
                               llrs.to(torch.int32)], dim=1)
        self.idx = [on_device(_row_index, bg, z, r, device=dev) for r in range(g.m)]
        self.c2v = [torch.zeros((self.b, i.numel() // z, z), dtype=torch.int32, device=dev)
                    for i in self.idx]
        self.scale = on_device(scale_table, float(scaling_factor), device=dev)

    def sweep(self):
        b, z = self.b, self.z
        for r, idx in enumerate(self.idx):
            deg = idx.numel() // z
            v2c = _sat_sub(self.soft[:, idx].view(b, deg, z), self.c2v[r])
            absv = v2c.abs()
            eidx = torch.arange(deg, device=v2c.device).view(1, deg, 1)
            low = absv.min(dim=1, keepdim=True).values
            argmin = torch.where(absv == low, eidx, deg).min(dim=1, keepdim=True).values
            min1 = torch.clamp(low, max=LLR_MAX)
            min2 = torch.clamp(torch.where(eidx == argmin, LLR_INFTY + 1, absv)
                               .min(dim=1, keepdim=True).values, max=LLR_MAX)
            neg = v2c < 0
            sign_prod = neg.sum(dim=1, keepdim=True) % 2
            mag = self.scale[torch.where(eidx == argmin, min2, min1).long()]
            c2v = torch.where((sign_prod ^ neg.to(torch.int64)) == 1, -mag, mag)
            self.soft[:, idx] = _promotion_sum(c2v, v2c).view(b, deg * z)
            self.c2v[r] = c2v

    def systematic(self) -> torch.Tensor:
        return self.soft[:, :self.g.kb * self.z]


def _outputs(info: torch.Tensor):
    soft = torch.clamp(info, -LLR_INFTY, LLR_INFTY).to(torch.int8)
    return (info <= 0).to(torch.uint8), soft


def ldpc_decode(llrs: torch.Tensor, bg: BaseGraph, z: int, *,
                nof_iterations: int = DEFAULT_ITERATIONS,
                scaling_factor: float = DEFAULT_SCALING):
    """Fixed-iteration decode.

    llrs: (B, N) int8 with N = (n_full - 2) * z; filler positions +127.
    Returns (hard (B, K) uint8, soft (B, K) int8 systematic LLRs).
    """
    st = _Sweeper(llrs, bg, z, scaling_factor)
    for _ in range(nof_iterations):
        st.sweep()
    return _outputs(st.systematic())


def ldpc_decode_es(llrs: torch.Tensor, bg: BaseGraph, z: int, crc_name: str,
                   nof_crc_covered_bits: int, *,
                   nof_iterations: int = DEFAULT_ITERATIONS,
                   scaling_factor: float = DEFAULT_SCALING):
    """Early-stop decode: after each sweep the CB CRC (zero-basis dot over the
    first `nof_crc_covered_bits` hard systematic bits, filler excluded) is
    checked; a passing codeblock's output is frozen at that iteration.

    Returns (hard (B, K) uint8, soft (B, K) int8, crc_ok (B,) bool,
    iterations (B,) int32; `nof_iterations` where the CRC never passed).
    """
    if crc_name not in POLYS:
        raise ValueError(f"unknown CRC {crc_name}")
    st = _Sweeper(llrs, bg, z, scaling_factor)
    mask = on_device(packed_crc_mask, bg, z, crc_name, int(nof_crc_covered_bits),
                     device=llrs.device)
    b = st.b
    done = torch.zeros(b, dtype=torch.bool, device=llrs.device)
    frozen = torch.zeros_like(st.systematic())
    iters = torch.full((b,), nof_iterations, dtype=torch.int32, device=llrs.device)
    for it in range(nof_iterations):
        st.sweep()
        info = st.systematic()
        ok = xor_reduce((info <= 0).to(torch.int32) * mask) == 0
        newly = ok & ~done
        frozen = torch.where(newly[:, None], info, frozen)
        iters = torch.where(newly, it + 1, iters)
        done = done | ok
        if bool(done.all()):
            break
    hard, soft = _outputs(torch.where(done[:, None], frozen, st.systematic()))
    return hard, soft, done, iters
