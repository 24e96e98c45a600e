"""CCE-to-REG/PRB mapping for PDCCH (TS 38.211 Section 7.3.2.2).

Exact-integer port of the reference's mapping rules
(reference: lib/ran/pdcch/cce_to_prb_mapping.cpp:30-199):

 * non-interleaved: CCE i occupies REGs [6i, 6(i+al)).
 * interleaved: REG bundles of size L are permuted by
   f(x) = (r*C + c + n_shift) mod (N_REG/L) with x = c*R + r,
   C = N_REG/(L*R); CCE i occupies bundles [i*6/L, (i+al)*6/L).
 * CORESET0: interleaved with L=6, R=2, n_shift = N_cell_id.

REGs are numbered time-first within the CORESET: REG n sits in CORESET PRB
n // N_symb at CORESET symbol n % N_symb.  These helpers are host-side index
math; the resulting RE index plans feed device scatter programs.

The port's own copy of `srsran_projectvtlmo_tpu.ran.pdcch_mapping`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import numpy as np

NOF_REG_PER_CCE = 6


def cce_to_reg_non_interleaved(aggregation_level: int, cce_index: int) -> list[int]:
    first = NOF_REG_PER_CCE * cce_index
    return list(range(first, first + NOF_REG_PER_CCE * aggregation_level))


def cce_to_reg_interleaved(
    n_rb_coreset: int,
    n_symb_coreset: int,
    reg_bundle_size: int,
    interleaver_size: int,
    shift_index: int,
    aggregation_level: int,
    cce_index: int,
) -> list[int]:
    l, r_sz = reg_bundle_size, interleaver_size
    n_reg = n_rb_coreset * n_symb_coreset
    if n_reg == 0 or n_reg % (l * r_sz) != 0 or l % n_symb_coreset != 0:
        raise ValueError(
            f"invalid CORESET: N_reg={n_reg}, L={l}, R={r_sz}, nsymb={n_symb_coreset}")
    c_sz = n_reg // (l * r_sz)
    bundles_per_cce = NOF_REG_PER_CCE // l
    regs: list[int] = []
    for x in range(cce_index * bundles_per_cce,
                   (cce_index + aggregation_level) * bundles_per_cce):
        r = x % r_sz
        c = x // r_sz
        fx = (r * c_sz + c + shift_index) % (n_reg // l)
        regs.extend(range(fx * l, (fx + 1) * l))
    return sorted(regs)


def pdcch_coreset_prbs(
    regs: list[int],
    n_symb_coreset: int,
    coreset_prb_offsets: list[int] | np.ndarray,
) -> list[int]:
    """REG indices -> carrier PRB indices of the candidate.

    `coreset_prb_offsets` lists the carrier PRBs of the CORESET in increasing
    order (the expansion of the CORESET's frequency-resource bitmap; for a
    contiguous CORESET simply rb_start + arange(n_rb)).  Every REG of a PRB is
    occupied together (L % nsymb == 0), so PRBs are regs[::nsymb] / nsymb.
    """
    offsets = np.asarray(coreset_prb_offsets)
    prbs = [int(offsets[reg // n_symb_coreset]) for reg in regs[::n_symb_coreset]]
    return prbs


def pdcch_re_indices(
    prbs: list[int],
    n_symb_coreset: int,
    start_symbol: int,
    nof_subc_carrier: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Flat (symbol*nsubc + k) RE indices for one candidate.

    Returns (data_idx, dmrs_idx): data REs skip subcarriers {1,5,9} of each RB
    (PDCCH DM-RS positions, TS 38.211 Section 7.4.1.3.2); both are ordered
    symbol-major then PRB then subcarrier, matching the modulator's output
    order (reference: lib/phy/upper/channel_processors/pdcch_modulator_impl.cpp).
    """
    data, dmrs = [], []
    for sym in range(start_symbol, start_symbol + n_symb_coreset):
        for prb in prbs:
            base = sym * nof_subc_carrier + prb * 12
            for k in range(12):
                (dmrs if k % 4 == 1 else data).append(base + k)
    return np.asarray(data, np.int32), np.asarray(dmrs, np.int32)
