"""LDPC systematic encoder (TS 38.212 Section 5.3.2) in plain torch ops.

Port of `srsran_projectvtlmo_tpu.ops.ldpc.encode.ldpc_encode`, bit-exact
with it.  The math is the JAX package's, with its structurally derived
core-parity solve (`graphs.EncodePlan`):

  1. lambda_r = XOR over the info edges of row r of the rotated info blocks;
  2. core parity p0 from the telescoped XOR of the four core lambdas;
  3. p1..p3 by the plan's back-substitution;
  4. extension parities, one per row 4..M-1, from lambda_r and the core
     parities.

A rotation by s reads index (i + s) mod Z (H[(r,i),(c,j)] = 1 iff
j = (i + s) mod Z).  Where the JAX program rolls one block per edge (and
bit-packs 32 codeblocks per int32 word from batch 8 up, a TPU speed trick),
steps 1 and 4 here are one gather each over host-planned flat indices,
followed by a sum over the row's edges taken mod 2: XOR of bits.
reference: lib/phy/upper/channel_coding/ldpc/ldpc_encoder_generic.cpp:33-121.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...ran.ldpc_params import BaseGraph
from ...utils.tables import on_device
from .graphs import get_graph


def _padded_row_index(shifts: np.ndarray, z: int) -> np.ndarray:
    """(rows, max_deg, z) int64 flat indices into blocks (cols, z) followed by
    one zero block: row r's edge to block c with shift s reads c*z + (i+s) mod z;
    missing edges read the zero block at cols*z."""
    rows, cols = shifts.shape
    deg = int((shifts >= 0).sum(axis=1).max())
    idx = np.full((rows, max(deg, 1), z), cols * z, np.int64)
    lanes = np.arange(z)
    for r in range(rows):
        for e, c in enumerate(np.flatnonzero(shifts[r] >= 0)):
            idx[r, e] = c * z + (lanes + shifts[r, c]) % z
    return idx


@functools.lru_cache(maxsize=None)
def _lambda_index(bg: BaseGraph, z: int) -> np.ndarray:
    g = get_graph(bg, z)
    return _padded_row_index(g.shifts[:, :g.kb], z)


@functools.lru_cache(maxsize=None)
def _extension_index(bg: BaseGraph, z: int) -> np.ndarray:
    g = get_graph(bg, z)
    return _padded_row_index(g.shifts[4:, g.kb:g.kb + 4], z)


def _xor_rows(blocks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """blocks (B, cols*z) bits, idx (rows, deg, z) -> (B, rows, z): the XOR of
    each row's rotated blocks."""
    padded = torch.cat([blocks, torch.zeros_like(blocks[:, :idx.shape[-1]])], dim=1)
    return (padded[:, idx].sum(dim=2) & 1).to(torch.uint8)


def _rot(v: torch.Tensor, s: int) -> torch.Tensor:
    """rot_s(v)[..., i] = v[..., (i + s) mod z]: roll left by s."""
    return torch.roll(v, -int(s), dims=-1) if s % v.shape[-1] else v


def ldpc_encode(info_bits: torch.Tensor, bg: BaseGraph, z: int) -> torch.Tensor:
    """Encode (B, K) uint8 info bits (filler bits must be 0) -> (B, N_full * Z).

    Output contains all variable nodes including the two punctured
    systematic blocks; slice [2Z:] for the rate-matching buffer.
    """
    g = get_graph(bg, z)
    if info_bits.dim() != 2 or info_bits.shape[1] != g.k:
        raise ValueError(f"info_bits must be (B, {g.k}), got {tuple(info_bits.shape)}")
    info = info_bits.to(torch.uint8)
    b, dev = info.shape[0], info.device
    lam = _xor_rows(info, on_device(_lambda_index, bg, z, device=dev))  # (B, M, Z)

    kb, plan = g.kb, g.encode_plan
    p = [None] * 4
    # rot_a(p0) = XOR of the core lambdas  =>  p0 = rot_{-a}(that).
    p[0] = _rot(lam[:, 0] ^ lam[:, 1] ^ lam[:, 2] ^ lam[:, 3], (z - plan.p0_shift % z) % z)
    for local, r in plan.solve_order:
        acc = lam[:, r]
        for q in range(4):
            s = int(g.shifts[r, kb + q])
            if q != local and s >= 0:
                acc = acc ^ _rot(p[q], s)
        p[local] = acc
    core = torch.stack(p, dim=1)  # (B, 4, Z)
    ext = lam[:, 4:] ^ _xor_rows(core.reshape(b, 4 * z),
                                 on_device(_extension_index, bg, z, device=dev))
    return torch.cat([info, core.reshape(b, -1), ext.reshape(b, -1)], dim=1)
