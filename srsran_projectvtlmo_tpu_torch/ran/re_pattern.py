"""Reserved resource-element patterns (reference:
include/srsran/phy/support/re_pattern.h, lib/phy/support/re_pattern.cpp).

A pattern marks the REs of a strided PRB range, a per-RB 12-bit RE mask and a
set of slot symbols.  The PDSCH processor rate-matches around the union of
such patterns (CSI-RS, CORESET) merged with its DM-RS pattern (reference:
lib/phy/upper/channel_processors/pdsch_processor_impl.cpp:77-96
compute_nof_data_re / get_inclusion_count).

Everything here is host-side index math: the DL slot program folds the
resulting free-RE layout into its static mapping plan (phy.dl_slot), and the
SCH chain configs fold the free-RE count into the rate-match E computation.

The port's own copy of `srsran_projectvtlmo_tpu.ran.re_pattern`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RePattern:
    """REs of PRBs rb_begin..rb_end-1 (step rb_stride), per-RB `re_mask`
    (12 bools, True = reserved) on absolute slot `symbols`."""

    rb_begin: int
    rb_end: int
    re_mask: tuple[bool, ...]
    symbols: tuple[int, ...]
    rb_stride: int = 1

    def __post_init__(self):
        assert len(self.re_mask) == 12, "re_mask covers one RB (12 REs)"
        assert 0 <= self.rb_begin < self.rb_end, "empty PRB range"
        assert self.rb_stride >= 1


def coreset_pattern(rb_begin: int, rb_end: int, start_symbol: int,
                    duration: int) -> RePattern:
    """Whole-RB reservation for a CORESET region (PDCCH REs + their DM-RS
    occupy all 12 subcarriers of every REG)."""
    return RePattern(rb_begin=rb_begin, rb_end=rb_end,
                     re_mask=(True,) * 12,
                     symbols=tuple(range(start_symbol, start_symbol + duration)))


def csi_rs_patterns(csi_cfg) -> tuple[RePattern, ...]:
    """Reserved patterns covering EVERY port's REs of one CSI-RS resource
    (reference: the fapi adaptor passes the CSI-RS pattern as PDSCH reserved
    RE, fapi_to_phy_translator.cpp)."""
    from ..ops.csi_rs import csi_rs_pattern

    per_symbol: dict[int, set[int]] = {}
    rb0 = rb1 = stride = None
    for symbols, subc, _ in csi_rs_pattern(csi_cfg):
        rbs = np.unique(np.asarray(subc) // 12)
        s = 1 if len(rbs) == 1 else int(rbs[1] - rbs[0])
        if rb0 is None:
            rb0, rb1, stride = int(rbs[0]), int(rbs[-1]) + 1, s
        else:
            rb0, rb1 = min(rb0, int(rbs[0])), max(rb1, int(rbs[-1]) + 1)
            assert s == stride, "mixed CSI-RS RB strides"
        k_offs = {int(k) % 12 for k in subc}
        for sym in symbols:
            per_symbol.setdefault(int(sym), set()).update(k_offs)
    # Group symbols sharing the same k-offset set into one pattern.
    by_mask: dict[tuple[bool, ...], list[int]] = {}
    for sym, offs in per_symbol.items():
        mask = tuple(k in offs for k in range(12))
        by_mask.setdefault(mask, []).append(sym)
    return tuple(
        RePattern(rb_begin=rb0, rb_end=rb1, re_mask=mask,
                  symbols=tuple(sorted(syms)), rb_stride=stride)
        for mask, syms in sorted(by_mask.items(), key=lambda kv: kv[1])
    )


def reserved_mask_window(patterns, rb_start: int, nof_rb: int,
                         symbols) -> np.ndarray:
    """(len(symbols), nof_rb*12) bool: True where a pattern reserves the RE,
    windowed to the allocation [rb_start, rb_start+nof_rb) on the given
    ABSOLUTE slot symbols."""
    symbols = list(symbols)
    out = np.zeros((len(symbols), nof_rb * 12), bool)
    for pat in patterns:
        re_mask = np.asarray(pat.re_mask, bool)
        prbs = np.arange(pat.rb_begin, pat.rb_end, pat.rb_stride)
        prbs = prbs[(prbs >= rb_start) & (prbs < rb_start + nof_rb)]
        if not len(prbs):
            continue
        cols = ((prbs[:, None] - rb_start) * 12
                + np.arange(12)[None, :])[:, re_mask].reshape(-1)
        for si, sym in enumerate(symbols):
            if sym in pat.symbols:
                out[si, cols] = True
    return out


def inclusion_count(patterns, rb_start: int, nof_rb: int, symbols) -> int:
    """Number of reserved REs inside the window (the reference's
    re_pattern_list::get_inclusion_count over the allocation PRB mask)."""
    return int(reserved_mask_window(patterns, rb_start, nof_rb, symbols).sum())
