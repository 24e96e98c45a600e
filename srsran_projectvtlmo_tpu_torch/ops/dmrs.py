"""DM-RS sequence generation and mapping (TS 38.211 Sections 7.4.1.1 / 6.4.1.1).

PDSCH/PUSCH DM-RS configuration type 1: QPSK pilots from the Gold sequence on
every other subcarrier (delta = CDM group) of the configured symbols.
reference: lib/phy/upper/signal_processors/dmrs_pdsch_processor_impl.cpp,
dmrs_pusch_estimator_impl.cpp.

The port's own copy of `srsran_projectvtlmo_tpu.ops.dmrs`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import functools

import numpy as np

from . import prg as prg_mod


def dmrs_cinit(slot: int, symbol: int, n_id: int, n_scid: int = 0) -> int:
    """TS 38.211 Section 7.4.1.1.1 pseudo-random initialization for one symbol."""
    return ((1 << 17) * (14 * slot + symbol + 1) * (2 * n_id + 1) + 2 * n_id + n_scid) % (1 << 31)


@functools.lru_cache(maxsize=None)
def dmrs_type1_sequence(slot: int, symbol: int, n_id: int, nof_rb: int, *, prb_start: int = 0,
                        n_scid: int = 0) -> np.ndarray:
    """Complex64 pilots for one DM-RS symbol: 6 pilots per RB (type 1).

    Pilot m covers subcarrier 2m + delta; the sequence index starts at the
    pilot offset of prb_start (reference points r(m) with m counted from CRB0).
    """
    npil = 6 * nof_rb
    m0 = 6 * prb_start
    cinit = dmrs_cinit(slot, symbol, n_id, n_scid)
    bits = prg_mod.gold_sequence_bits(cinit, 2 * (m0 + npil)).astype(np.float32)
    bits = bits[2 * m0:]
    vals = (1.0 - 2.0 * bits) / np.sqrt(2.0)
    return (vals[0::2] + 1j * vals[1::2]).astype(np.complex64)


def dmrs_type1_subcarriers(nof_rb: int, delta: int = 0) -> np.ndarray:
    """Subcarrier indices of type-1 pilots within the allocation."""
    return (2 * np.arange(6 * nof_rb) + delta).astype(np.int32)


def dmrs_type2_sequence(slot: int, symbol: int, n_id: int, nof_rb: int, *,
                        prb_start: int = 0, n_scid: int = 0) -> np.ndarray:
    """Complex64 pilots for one DM-RS symbol: 4 pilots per RB (type 2).

    Type 2 places pilot pairs at k = 6n + k' + delta (TS 38.211 Table
    6.4.1.1.3-1; reference carries the full type-2 parameter set,
    dmrs_pusch_estimator_impl.cpp:55-66); the sequence index starts at the
    pilot offset of prb_start."""
    npil = 4 * nof_rb
    m0 = 4 * prb_start
    cinit = dmrs_cinit(slot, symbol, n_id, n_scid)
    bits = prg_mod.gold_sequence_bits(cinit, 2 * (m0 + npil)).astype(np.float32)
    bits = bits[2 * m0:]
    vals = (1.0 - 2.0 * bits) / np.sqrt(2.0)
    return (vals[0::2] + 1j * vals[1::2]).astype(np.complex64)


def dmrs_type2_subcarriers(nof_rb: int, delta: int = 0) -> np.ndarray:
    """Subcarrier indices of type-2 pilots within the allocation: pairs
    {6n, 6n+1} + delta, delta = 2 * (CDM group)."""
    n = np.repeat(6 * np.arange(2 * nof_rb), 2)
    kp = np.tile(np.arange(2), 2 * nof_rb)
    return (n + kp + delta).astype(np.int32)
