"""Polar rate matching / dematching, TS 38.212 Sections 5.4.1.1-5.4.1.3
(port of `srsran_projectvtlmo_tpu.ops.polar.rate_match`).

Sub-block interleaver, bit selection (puncture / shorten / repeat) and the
triangular channel interleaver (uplink, ibil) are index maps precomputed per
PolarCode; Tx is one gather, Rx a scatter-add with repetition combining.
reference: lib/phy/upper/channel_coding/polar/polar_rate_matcher_impl.cpp:27-106,
polar_rate_dematcher_impl.cpp:40-118.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.llr import LLR_INFTY, LLR_MAX
from ...utils.tables import on_device
from .code import PolarCode, blk_interleaver


def _triangular_perm(e: int) -> np.ndarray:
    """perm[i_out] = i_in for the uplink triangular channel interleaver."""
    t = 1
    s = 1
    while s < e:
        t += 1
        s += t
    out = []
    for r in range(t):
        i_in = r
        for c in range(t - r):
            if i_in < e:
                out.append(i_in)
                i_in += t - c
            else:
                break
    return np.asarray(out, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def tx_plan(code: PolarCode) -> np.ndarray:
    """(E,) gather indices from the N-bit codeword to the rate-matched bits."""
    nn, e, k = code.N, code.E, code.K
    blk = blk_interleaver(code.n)  # y[j] = x[blk[j]]
    if e >= nn:
        sel = np.concatenate([blk, blk[np.arange(nn, e) % nn]])
    elif 16 * k <= 7 * e:  # puncture the first N-E interleaved bits
        sel = blk[nn - e:]
    else:  # shorten the last N-E interleaved bits
        sel = blk[:e]
    if code.ibil:
        sel = sel[_triangular_perm(e)]
    return sel.astype(np.int64)


def rate_match(codeword: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, N) bits -> (B, E)."""
    return codeword[..., on_device(tx_plan, code, device=codeword.device)]


@functools.lru_cache(maxsize=None)
def rx_plan(code: PolarCode) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(target (E,) int64, init (N,) int32, blk (N,) int64).

    Received bit i lands at position target[i] of the interleaved domain y,
    which starts at `init` (0, or +LLR_INFTY on shortened positions); the
    output is y deinterleaved, out[blk[j]] = y[j].  The channel
    deinterleaver is folded into `target`.
    """
    nn, e, k = code.N, code.E, code.K
    if e >= nn:
        y_target = np.arange(e) % nn
    elif 16 * k <= 7 * e:
        y_target = (nn - e) + np.arange(e)
    else:
        y_target = np.arange(e)
    if code.ibil:
        # e_buf[perm[i]] = f[i], and e_buf[j] lands at y_target[j].
        y_target = y_target[_triangular_perm(e)]
    init = np.zeros(nn, dtype=np.int32)
    if e < nn and not (16 * k <= 7 * e):
        init[e:] = LLR_INFTY
    return y_target.astype(np.int64), init, blk_interleaver(code.n)


def _rx_target(code: PolarCode) -> np.ndarray:
    return rx_plan(code)[0]


def _rx_init(code: PolarCode) -> np.ndarray:
    return rx_plan(code)[1]


def _rx_blk(code: PolarCode) -> np.ndarray:
    return rx_plan(code)[2]


def rate_dematch(llrs: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, E) int8 LLRs -> (B, N) int8: punctured 0, shortened +127, repeats
    combined by the promotion-sum rule (beyond +/-120 -> +/-127)."""
    dev = llrs.device
    lead = tuple(llrs.shape[:-1])
    y = on_device(_rx_init, code, device=dev).expand(lead + (code.N,)).clone()
    y.index_add_(-1, on_device(_rx_target, code, device=dev), llrs.to(torch.int32))
    y = torch.where(y.abs() > LLR_MAX, torch.sign(y) * LLR_INFTY, y)
    out = torch.empty_like(y)
    out[..., on_device(_rx_blk, code, device=dev)] = y
    return out.to(torch.int8)
