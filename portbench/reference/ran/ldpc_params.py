"""LDPC constants from TS 38.212 Section 5.2.2 / 5.3.2.

Mirrors the constant surface of the reference
(reference: include/srsran/phy/upper/channel_coding/ldpc/ldpc.h:95-214).

The port's own copy of `srsran_projectvtlmo_tpu.ran.ldpc_params`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import enum

# A lifting size Z is valid iff Z = a * 2^j with a in {2,3,5,7,9,11,13,15} and Z <= 384.
# The "lifting index" i_LS (0..7) identifies the set, i.e. the position of `a` above.
_SET_BASES = (2, 3, 5, 7, 9, 11, 13, 15)

MAX_LIFTING_SIZE = 384

ALL_LIFTING_SIZES: tuple[int, ...] = tuple(
    sorted({a * (1 << j) for a in _SET_BASES for j in range(8) if a * (1 << j) <= MAX_LIFTING_SIZE})
)
assert len(ALL_LIFTING_SIZES) == 51

#: Maximum number of information bits in a codeblock (BG1: 22 * 384).
MAX_MESSAGE_SIZE = 22 * MAX_LIFTING_SIZE  # 8448
#: Maximum codeblock size (BG1 full: 66 * 384).
MAX_CODEBLOCK_SIZE = 66 * MAX_LIFTING_SIZE  # 25344
#: Sentinel marking filler bits in codeblocks (reference: ldpc.h FILLER_BIT=254).
FILLER_BIT = 254


class BaseGraph(enum.IntEnum):
    BG1 = 1
    BG2 = 2


def lifting_index(ls: int) -> int:
    """i_LS in 0..7 identifying the lifting-size set of Z."""
    z = ls
    while z % 2 == 0 and z > 15:
        z //= 2
    # After removing factors of two down to <= 15 we must land on a set base.
    while z not in _SET_BASES:
        if z % 2 != 0:
            raise ValueError(f"invalid lifting size {ls}")
        z //= 2
    return _SET_BASES.index(z)


def lifting_size_position(ls: int) -> int:
    """Position of Z in the sorted list of all 51 lifting sizes."""
    return ALL_LIFTING_SIZES.index(ls)


def min_lifting_size(kb: int, k_prime: int) -> int:
    """Smallest valid Z with kb * Z >= k_prime (TS 38.212 Section 5.2.2)."""
    for z in ALL_LIFTING_SIZES:
        if kb * z >= k_prime:
            return z
    raise ValueError(f"no lifting size for kb={kb}, k'={k_prime}")


def bg_params(bg: BaseGraph) -> tuple[int, int, int]:
    """(info nodes K_b-full, check nodes M, total var nodes N_full) of the base graph."""
    if bg == BaseGraph.BG1:
        return 22, 46, 68
    return 10, 42, 52
