"""Polar input-bit interleaver (downlink: PBCH and DCI), TS 38.212 Section
5.3.1.1 (port of `srsran_projectvtlmo_tpu.ops.polar.interleave`).

The K_IL_max = 164 pattern (Table 5.3.1.1-1); for K < 164 only entries
>= 164 - K participate, shifted down.  Both directions are one gather on the
device of the bits they are given.
reference: lib/phy/upper/channel_coding/polar/polar_interleaver_impl.cpp:27-56.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.tables import on_device

K_MAX_IL = 164

#: TS 38.212 Table 5.3.1.1-1.
PATTERN = np.asarray([
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34, 42, 45, 49, 50, 51, 53, 54,
    56, 58, 59, 61, 62, 65, 66, 67, 69, 70, 71, 72, 76, 77, 81, 82, 83, 87, 88, 89, 91,
    93, 95, 98, 101, 104, 106, 108, 110, 111, 113, 115, 118, 119, 120, 122, 123, 126, 127, 129, 132, 134,
    138, 139, 140, 1, 3, 5, 8, 10, 15, 21, 27, 29, 32, 35, 43, 46, 52, 55, 57, 60, 63,
    68, 73, 78, 84, 90, 92, 94, 96, 99, 102, 105, 107, 109, 112, 114, 116, 121, 124, 128, 130, 133,
    135, 141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64, 74, 79, 85, 97, 100, 103, 117, 125, 131,
    136, 142, 12, 17, 23, 37, 48, 75, 80, 86, 137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41,
    147, 148, 149, 150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162, 163,
], dtype=np.int64)

assert len(PATTERN) == K_MAX_IL


@functools.lru_cache(maxsize=None)
def interleave_plan(k: int) -> np.ndarray:
    """(K,) indices: out[i] = in[plan[i]]."""
    sel = PATTERN[PATTERN >= K_MAX_IL - k] - (K_MAX_IL - k)
    assert len(sel) == k
    return sel.astype(np.int64)


@functools.lru_cache(maxsize=None)
def deinterleave_plan(k: int) -> np.ndarray:
    """(K,) indices of the inverse permutation."""
    inv = np.empty(k, dtype=np.int64)
    inv[interleave_plan(k)] = np.arange(k)
    return inv


def interleave(bits: torch.Tensor, k: int) -> torch.Tensor:
    """(..., K) -> (..., K) interleaved."""
    return bits[..., on_device(interleave_plan, k, device=bits.device)]


def deinterleave(bits: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse of `interleave`."""
    return bits[..., on_device(deinterleave_plan, k, device=bits.device)]
