"""Polar sub-channel allocation / deallocation, TS 38.212 Section 5.3.1.2
(port of `srsran_projectvtlmo_tpu.ops.polar.allocate`).

Message bits map to the information set positions; when parity-check bits are
present (K <= 25, nPC = 3), their values come from a length-5 cyclic shift
register driven by the preceding message bits
(reference: lib/phy/upper/channel_coding/polar/polar_allocator_impl.cpp:27-69).

The register is linear over GF(2), so its effect is precomputed per code as a
(K, nPC) bit matrix; on the device the PC bits are an integer product summed
and taken mod 2, and the allocation is one static scatter.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.tables import on_device
from .code import PolarCode


@functools.lru_cache(maxsize=None)
def pc_matrix(code: PolarCode) -> np.ndarray:
    """(K, nPC) uint8: pc_bits = message @ pc_matrix mod 2."""
    if code.n_pc == 0:
        return np.zeros((code.K, 0), dtype=np.uint8)
    k_set = set(code.k_set.tolist())
    pc_set = set(code.pc_set.tolist())
    # Symbolically run the shift register with message-bit indicator vectors.
    y = [np.zeros(code.K, dtype=np.uint8) for _ in range(5)]
    i_k = 0
    pc_rows = []
    for i in range(code.N):
        y = [y[1], y[2], y[3], y[4], y[0]]
        if i in k_set:
            if i in pc_set:
                pc_rows.append(y[0].copy())
            else:
                y[0] = y[0].copy()
                y[0][i_k] ^= 1
                i_k += 1
    assert i_k == code.K and len(pc_rows) == code.n_pc
    return np.stack(pc_rows, axis=1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def msg_positions(code: PolarCode) -> np.ndarray:
    """Information positions that carry message bits (PC positions dropped)."""
    pc_set = set(code.pc_set.tolist())
    return np.asarray([p for p in code.k_set if p not in pc_set], dtype=np.int64)


def _pc_positions(code: PolarCode) -> np.ndarray:
    return code.pc_set


def _pc_matrix_i32(code: PolarCode) -> np.ndarray:
    return pc_matrix(code).astype(np.int32)


def polar_allocate(message: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, K) uint8 message -> (B, N) uint8 encoder input u."""
    dev = message.device
    u = torch.zeros((message.shape[0], code.N), dtype=torch.uint8, device=dev)
    u[:, on_device(msg_positions, code, device=dev)] = message.to(torch.uint8)
    if code.n_pc:
        mat = on_device(_pc_matrix_i32, code, device=dev)  # (K, nPC)
        pc = (message.to(torch.int32)[:, :, None] * mat).sum(dim=1) & 1
        u[:, on_device(_pc_positions, code, device=dev)] = pc.to(torch.uint8)
    return u


def polar_deallocate(u: torch.Tensor, code: PolarCode) -> torch.Tensor:
    """(B, N) decoded u -> (B, K) message bits (PC positions dropped)."""
    return u[..., on_device(msg_positions, code, device=u.device)]
