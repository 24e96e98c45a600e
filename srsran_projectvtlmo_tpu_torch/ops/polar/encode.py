"""Polar encoder: log2(N) butterfly XOR stages, batched (port of
`srsran_projectvtlmo_tpu.ops.polar.encode`).

u -> x = u G_N with G_N = F^{xor n}, F = [[1,0],[1,1]]: at stage s, pairs at
distance 2^s combine as (a, b) -> (a xor b, b).
reference: lib/phy/upper/channel_coding/polar/polar_encoder_impl.cpp:31-55.
"""

from __future__ import annotations

import torch


def polar_encode(u: torch.Tensor, code_size_log: int) -> torch.Tensor:
    """(B, N) uint8 -> (B, N) uint8 codeword."""
    b = u.shape[0]
    x = u
    for s in range(code_size_log):
        half = 1 << s
        y = x.reshape(b, -1, 2, half)
        x = torch.stack([y[:, :, 0] ^ y[:, :, 1], y[:, :, 1]], dim=2).reshape(b, -1)
    return x
