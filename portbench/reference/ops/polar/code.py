"""Polar code construction, TS 38.212 Section 5.3.1.

Derives N, the information set (K_set), frozen set, and parity-check bit
positions from (K, E, nMax, ibil), including rate-matching-induced pre-frozen
bits for puncturing/shortening.
reference: lib/phy/upper/channel_coding/polar/polar_code_impl.cpp:325-491.

The port's own copy of `srsran_projectvtlmo_tpu.ops.polar.code`, reading the
port's copy of `data/polar_tables.npz`; tests/test_torch_host_copies.py holds
both equal to the originals.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

NMAX = 1024
EMAX = 8192

_DATA = Path(__file__).resolve().parent.parent.parent / "data" / "polar_tables.npz"

#: TS 38.212 Table 5.4.1.1-1 sub-block interleaver pattern.
SUBBLOCK_PATTERN = np.asarray(
    [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
     12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31], dtype=np.int64)


@functools.lru_cache(maxsize=1)
def _mother_codes() -> dict[int, np.ndarray]:
    with np.load(_DATA) as z:
        return {n: z[f"mother_code_{n}"].astype(np.int64) for n in range(5, 11)}


def blk_interleaver(n: int) -> np.ndarray:
    nn = 1 << n
    j = np.arange(nn)
    p = SUBBLOCK_PATTERN
    return (p[32 * j // nn] * (nn // 32) + j % (nn // 32)).astype(np.int64)


@dataclass(frozen=True)
class PolarCode:
    """Static polar code description (hashable; keys compiled programs)."""

    K: int
    E: int
    n_max: int  # 9 for downlink, 10 for uplink
    ibil: bool  # channel (triangular) interleaver present (uplink)

    # Derived (filled in __post_init__ via object.__setattr__).
    n: int = field(init=False)
    N: int = field(init=False)
    n_pc: int = field(init=False)
    n_wm_pc: int = field(init=False)

    def __post_init__(self):
        k, e = self.K, self.E
        assert e <= EMAX
        if self.n_max == 9:
            assert 36 <= k <= 164, f"downlink K={k} out of range"
        elif self.n_max == 10:
            assert k >= 18 and not (25 < k < 31) and k <= 1023, f"uplink K={k} invalid"
        else:
            raise ValueError("n_max must be 9 (DL) or 10 (UL)")

        n_pc = 0
        n_wm_pc = 0
        if k <= 25:
            n_pc = 3
            if e > k + 189:
                n_wm_pc = 1
        assert k + n_pc < e

        ce = 1
        while (1 << ce) < e:
            ce += 1
        if (8 * e <= 9 * (1 << (ce - 1))) and (16 * k < 9 * e):
            n1 = ce - 1
        else:
            n1 = ce
        ck = 0
        while (1 << ck) < k:
            ck += 1
        n2 = ck + 3
        n = min(n1, n2, self.n_max)
        n = max(n, 5)

        object.__setattr__(self, "n", n)
        object.__setattr__(self, "N", 1 << n)
        object.__setattr__(self, "n_pc", n_pc)
        object.__setattr__(self, "n_wm_pc", n_wm_pc)
        assert k < self.N

    @functools.cached_property
    def _sets(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(K_set sorted, F_set mask (N,), PC_set sorted)."""
        k, e, n, nn = self.K, self.E, self.n, self.N
        mother = _mother_codes()[n]
        blk = blk_interleaver(n)

        k_set = mother[-(k + self.n_pc):]
        if nn > e:
            f_size = nn - e
            n_th = 3 * nn // 4
            if 16 * k <= 7 * e:  # puncturing
                t = (n_th - (e >> 1) - 1) if e >= n_th else (9 * nn // 16 - (e >> 2))
                f_set = blk[:f_size]
            else:  # shortening
                t = 0
                f_set = blk[e:e + f_size]
            f_lookup = set(f_set.tolist())
            # setdiff_stable: drop entries <= T or in F_set, preserving order
            # (note x <= T always excludes sub-channel 0, even when T == 0,
            # matching the reference's unsigned comparison).
            keep = [x for x in mother.tolist() if x > t and x not in f_lookup]
            k_set = np.asarray(keep[-(k + self.n_pc):], dtype=np.int64)

        pc = list(k_set[: max(self.n_pc - self.n_wm_pc, 0)])
        if self.n_wm_pc == 1:
            pc.append(252 if k <= 21 else 248)
        pc_set = np.sort(np.asarray(pc, dtype=np.int64)) if pc else np.empty(0, np.int64)

        mask = np.zeros(nn, dtype=bool)
        mask[k_set] = True
        return np.sort(k_set), ~mask, pc_set

    @property
    def k_set(self) -> np.ndarray:
        """Sorted information (+PC) bit positions."""
        return self._sets[0]

    @property
    def frozen_mask(self) -> np.ndarray:
        """(N,) bool: true where the sub-channel is frozen."""
        return self._sets[1]

    @property
    def pc_set(self) -> np.ndarray:
        """Sorted parity-check bit positions (subset of k_set)."""
        return self._sets[2]
