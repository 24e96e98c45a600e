"""Low-PAPR sequences r^(alpha)_{u,v}(n), TS 38.211 Section 5.2.2.

Lengths 6/12/18/24 use the standard phi tables; lengths >= 36 are cyclically
extended Zadoff-Chu of the largest prime N_zc < M.  Used by PUCCH formats 0/1,
DM-RS for PUCCH, and SRS.
reference: lib/phy/upper/sequence_generators/low_papr_sequence_generator_impl.cpp:134-210.

The port's own copy of `srsran_projectvtlmo_tpu.ops.low_papr`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data" / "low_papr_tables.npz"


@functools.lru_cache(maxsize=1)
def _phi_tables():
    with np.load(_DATA) as z:
        return {m: z[f"phi_{m}"].astype(np.float64) for m in (6, 12, 18, 24)}


def _largest_prime_below(n: int) -> int:
    def is_prime(x):
        if x < 2:
            return False
        for d in range(2, int(x ** 0.5) + 1):
            if x % d == 0:
                return False
        return True

    p = n - 1
    while not is_prime(p):
        p -= 1
    return p


@functools.lru_cache(maxsize=None)
def base_sequence(u: int, v: int, m: int) -> np.ndarray:
    """r_{u,v}(n) of length m, complex64."""
    if m in (6, 12, 18, 24):
        phi = _phi_tables()[m][u]
        return np.exp(1j * phi * np.pi / 4).astype(np.complex64)
    n_zc = _largest_prime_below(m)
    qbar = n_zc * (u + 1) / 31.0
    # TS 38.211: q = floor(qbar + 1/2) + v * (-1)^{floor(2 qbar)}
    q = int(np.floor(qbar + 0.5)) + v * ((-1) ** int(np.floor(2 * qbar)))
    n = np.arange(m)
    mzc = n % n_zc
    phase = -np.pi * q * mzc * (mzc + 1) / n_zc
    return np.exp(1j * phase).astype(np.complex64)


def low_papr_sequence(u: int, v: int, alpha: float, m: int) -> np.ndarray:
    """r^(alpha)_{u,v}(n) = e^{j alpha n} r_{u,v}(n), complex64 (host)."""
    n = np.arange(m)
    return (np.exp(1j * alpha * n) * base_sequence(u, v, m)).astype(np.complex64)


def pucch_group_sequence(n_id: int, *, group_hopping: bool = False,
                         slot: int = 0, hop: int = 0) -> tuple[int, int]:
    """(u, v) for PUCCH sequence selection (TS 38.211 Section 6.3.2.2.1).

    Without hopping: u = n_id mod 30, v = 0.  With group hopping enabled,
    f_gh(n_s, hop) comes from the Gold sequence with c_init = n_id // 30.
    """
    f_ss = n_id % 30
    if not group_hopping:
        return f_ss, 0
    from . import prg as prg_mod

    cinit = n_id // 30
    off = 8 * (2 * slot + hop)
    bits = prg_mod.gold_sequence_bits(cinit, off + 8)[off:off + 8]
    f_gh = int((bits.astype(int) * (1 << np.arange(8))).sum()) % 30
    return (f_gh + f_ss) % 30, 0
