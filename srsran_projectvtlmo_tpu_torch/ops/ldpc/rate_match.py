"""LDPC rate matching / recovery, TS 38.212 Sections 5.4.2.1-5.4.2.2.

Port of `srsran_projectvtlmo_tpu.ops.ldpc.rate_match`.  The circular-buffer
bit selection and the bit interleaver are index permutations planned on the
host per (bg, z, filler, rv, E, Qm), with the same plans as the JAX package;
the device side is slicing, gathers and clips.  Bit-exact with JAX, including
its clamp-after-sum on repeated positions.
reference: lib/phy/upper/channel_coding/ldpc/ldpc_rate_matcher_impl.cpp:60-115,
ldpc_rate_dematcher_impl.cpp:46-184.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ran.ldpc_params import BaseGraph
from ...utils.llr import LLR_INFTY, LLR_MAX, llr_promotion_sum
from ...utils.tables import on_device


def _bg_dims(bg: BaseGraph) -> tuple[int, int]:
    """(codeword columns after puncturing, systematic columns)."""
    return (66, 22) if bg == BaseGraph.BG1 else (50, 10)


def k0_index(bg: BaseGraph, rv: int, n_cb: int, z: int) -> int:
    """Circular-buffer start per redundancy version (Table 5.4.2.1-2)."""
    if bg == BaseGraph.BG1:
        num, den = {0: 0, 1: 17, 2: 33, 3: 56}[rv], 66
    else:
        num, den = {0: 0, 1: 13, 2: 25, 3: 43}[rv], 50
    return (num * n_cb // (den * z)) * z


def _filler_mask(bg: BaseGraph, z: int, nof_filler: int) -> np.ndarray:
    n_nodes, kb = _bg_dims(bg)
    filler = np.zeros(n_nodes * z, dtype=bool)
    filler[kb * z - 2 * z - nof_filler:kb * z - 2 * z] = True
    return filler


def _gap_values(bg: BaseGraph, z: int, nof_filler: int) -> np.ndarray:
    """(N,) int8 value of a buffer position no LLR lands on: +127 on filler, else 0."""
    return np.where(_filler_mask(bg, z, nof_filler), LLR_INFTY, 0).astype(np.int8)


@functools.lru_cache(maxsize=None)
def rate_match_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int,
                    qm: int) -> np.ndarray:
    """(E,) int32 gather indices from the N-bit circular buffer to the output bits."""
    filler = _filler_mask(bg, z, nof_filler)
    n = len(filler)
    order = (k0_index(bg, rv, n, z) + np.arange(n)) % n
    valid = order[~filler[order]]
    sel = np.tile(valid, -(-e // len(valid)))[:e].astype(np.int32)
    # Bit interleaver: output j*Qm + i takes selected bit i*(E/Qm) + j.
    j, i = np.arange(e // qm), np.arange(qm)
    return sel[(i[None, :] * (e // qm) + j[:, None]).reshape(-1)]


def rate_match(codeword: torch.Tensor, bg: BaseGraph, z: int, nof_filler: int,
               rv: int, e: int, qm: int) -> torch.Tensor:
    """Tx bit selection + interleave: codeword (B, N) bits -> (B, E) bits."""
    idx = torch.as_tensor(rate_match_plan(bg, z, nof_filler, rv, e, qm).astype(np.int64),
                          device=codeword.device)
    return codeword[..., idx]


@functools.lru_cache(maxsize=None)
def rate_dematch_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int, qm: int):
    """(scatter_idx (E,), filler_mask (N,)) for soft-bit recovery."""
    return rate_match_plan(bg, z, nof_filler, rv, e, qm), _filler_mask(bg, z, nof_filler)


@functools.lru_cache(maxsize=None)
def rate_dematch_gather_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int,
                             e: int, qm: int):
    """Inverse tables: (src (k_max, N) int32, -1 = no contribution; filler (N,))."""
    sel, filler = rate_dematch_plan(bg, z, nof_filler, rv, e, qm)
    n = len(filler)
    k_max = max(1, int(np.bincount(sel, minlength=n).max()))
    src = np.full((k_max, n), -1, np.int32)
    fill = np.zeros(n, np.int64)
    for i, s in enumerate(sel):
        src[fill[s], s] = i
        fill[s] += 1
    return src, filler


@functools.lru_cache(maxsize=None)
def rate_dematch_slice_plan(bg: BaseGraph, z: int, nof_filler: int, rv: int,
                            e: int, qm: int):
    """Without repetition or wrap (code rate above 1/3) the dematch is a
    deinterleave plus a few contiguous copies.  Returns (runs [(dst, src,
    len)], n), or None when the gather path is needed."""
    filler = _filler_mask(bg, z, nof_filler)
    n = len(filler)
    order = (k0_index(bg, rv, n, z) + np.arange(n)) % n
    valid = order[~filler[order]]
    if e > len(valid):
        return None
    sel = valid[:e]
    if not np.all(np.diff(sel) >= 1):
        return None
    breaks = np.flatnonzero(np.diff(sel) != 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks + 1, [len(sel)]])
    runs = [(int(sel[a]), int(a), int(b - a)) for a, b in zip(starts, ends)]
    return runs, n


def _assemble(pieces, gaps: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Concatenate (dst, tensor) pieces in buffer order, filling the gaps
    from `gaps` (N,)."""
    n = gaps.shape[0]
    parts, pos = [], 0
    for dst, x in pieces:
        if dst > pos:
            parts.append(gaps[pos:dst].expand(lead + (dst - pos,)))
        parts.append(x)
        pos = dst + x.shape[-1]
    if pos < n:
        parts.append(gaps[pos:n].expand(lead + (n - pos,)))
    return torch.cat(parts, dim=-1)


def rate_dematch(llrs: torch.Tensor, bg: BaseGraph, z: int, nof_filler: int,
                 rv: int, e: int, qm: int) -> torch.Tensor:
    """(..., E) int8 LLRs -> (..., N) int8 circular-buffer LLRs.

    Repeated positions accumulate, then saturate at +/-120; filler positions
    are +127; unseen positions 0.
    """
    lead = tuple(llrs.shape[:-1])
    plan = rate_dematch_slice_plan(bg, z, nof_filler, rv, e, qm)
    if plan is not None:
        runs, _ = plan
        x = llrs.reshape(lead + (e // qm, qm)).transpose(-1, -2).reshape(lead + (e,))
        x = torch.clamp(x, -LLR_MAX, LLR_MAX)
        return _assemble([(dst, x[..., src:src + ln]) for dst, src, ln in runs],
                         on_device(_gap_values, bg, z, nof_filler, device=llrs.device), lead)
    src, filler = rate_dematch_gather_plan(bg, z, nof_filler, rv, e, qm)
    x = llrs.to(torch.int32)
    acc = torch.zeros(lead + (len(filler),), dtype=torch.int32, device=llrs.device)
    for k in range(src.shape[0]):
        idx = torch.as_tensor(np.maximum(src[k], 0).astype(np.int64), device=llrs.device)
        seen = torch.as_tensor(src[k] >= 0, device=llrs.device)
        acc = acc + torch.where(seen, x[..., idx], 0)
    acc = torch.clamp(acc, -LLR_MAX, LLR_MAX)
    acc = torch.where(torch.as_tensor(filler, device=llrs.device), LLR_INFTY, acc)
    return acc.to(torch.int8)


@functools.lru_cache(maxsize=None)
def _bit_major_pieces(bg: BaseGraph, z: int, nof_filler: int, rv: int, e: int, qm: int):
    """The slice plan split into per-row column slices of the bit-major
    (qm, e//qm) layout: [(dst, row, col0, col1)], or None."""
    plan = rate_dematch_slice_plan(bg, z, nof_filler, rv, e, qm)
    if plan is None:
        return None
    runs, _ = plan
    width = e // qm
    pieces = []
    for dst, src, ln in runs:
        pos = src
        while pos < src + ln:
            row, col = divmod(pos, width)
            take = min(src + ln - pos, width - col)
            pieces.append((dst + (pos - src), row, col, col + take))
            pos += take
    return pieces


def rate_dematch_bit_major(x4: torch.Tensor, bg: BaseGraph, z: int, nof_filler: int,
                           rv: int, e: int, qm: int) -> torch.Tensor:
    """Rate recovery from bit-major demapped LLRs.

    x4: (B, qm, C, e//qm) int8, the `soft_demap(..., bit_major=True)` planes of
    one equal-E codeblock group; the deinterleave is implicit in this layout.
    Returns (B, C, N) int8, identical to `rate_dematch` on the interleaved input.
    """
    b, _, c, _ = x4.shape
    pieces = _bit_major_pieces(bg, z, nof_filler, rv, e, qm)
    if pieces is None:
        x = x4.permute(0, 2, 3, 1).reshape(b, c, e)
        return rate_dematch(x, bg, z, nof_filler, rv, e, qm)
    xc = torch.clamp(x4, -LLR_MAX, LLR_MAX)
    return _assemble([(dst, xc[:, row, :, c0:c1]) for dst, row, c0, c1 in pieces],
                     on_device(_gap_values, bg, z, nof_filler, device=x4.device), (b, c))


def harq_combine(buffer: torch.Tensor, new_llrs: torch.Tensor) -> torch.Tensor:
    """Soft-combine a dematched transmission into the HARQ buffer (promotion sum).

    reference: ldpc_rate_dematcher_impl.cpp:116; fixed bits stay fixed.
    """
    return llr_promotion_sum(buffer, new_llrs)
