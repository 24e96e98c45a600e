"""Modulation mapping, TS 38.211 Section 5.1 (BPSK ... 256QAM, Gray-coded).

Port of `srsran_projectvtlmo_tpu.ops.modulation` (that module imports jax):
`constellation` (the table the demapper and EVM are built from), `modulate`,
`modulate_planes` and the host mapper `modulate_np`, bit-exact with it.
Square QAM evaluates the nested Gray formula from the bit planes in float32,
exactly as JAX does; BPSK and pi/2-BPSK look the point up in the table.
reference: lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.cpp.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.modulation import Modulation, bits_per_symbol
from ..utils.tables import on_device

#: Per-modulation amplitude normalization (TS 38.211 Section 5.1).
_NORM = {Modulation.QPSK: 2.0, Modulation.QAM16: 10.0,
         Modulation.QAM64: 42.0, Modulation.QAM256: 170.0}


@functools.lru_cache(maxsize=None)
def constellation(mod: Modulation) -> np.ndarray:
    """Complex64 table of 2^Qm points; index = bits MSB-first (b0 is MSB)."""
    qm = bits_per_symbol(mod)
    idx = np.arange(1 << qm)
    b = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(np.float64)
    s = 1.0 - 2.0 * b
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        pts = s[:, 0] * (1 + 1j) / np.sqrt(2)
    elif mod == Modulation.QPSK:
        pts = (s[:, 0] + 1j * s[:, 1]) / np.sqrt(2)
    elif mod == Modulation.QAM16:
        pts = (s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3])) / np.sqrt(10)
    elif mod == Modulation.QAM64:
        pts = (s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
               + 1j * s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))) / np.sqrt(42)
    elif mod == Modulation.QAM256:
        pts = (s[:, 0] * (8 - s[:, 2] * (4 - s[:, 4] * (2 - s[:, 6])))
               + 1j * s[:, 1] * (8 - s[:, 3] * (4 - s[:, 5] * (2 - s[:, 7])))) / np.sqrt(170)
    else:
        raise ValueError(mod)
    return pts.astype(np.complex64)


def modulate_np(bits: np.ndarray, mod: Modulation) -> np.ndarray:
    """Host-side numpy mapper: bits (G,) -> (G / Qm,) complex64."""
    qm = bits_per_symbol(mod)
    groups = np.asarray(bits, dtype=np.int64).reshape(-1, qm)
    weights = np.asarray([1 << (qm - 1 - i) for i in range(qm)])
    sym = constellation(mod)[(groups * weights).sum(-1)]
    if mod == Modulation.PI_2_BPSK:
        rot = np.where(np.arange(len(sym)) % 2 == 1, 1j, 1.0)
        sym = (sym * rot).astype(np.complex64)
    return sym


def _square_qam(s, mod: Modulation) -> torch.Tensor:
    """The nested Gray formula over sign planes s(i) = 1 - 2 b_i (float32)."""
    if mod == Modulation.QPSK:
        re, im = s(0), s(1)
    elif mod == Modulation.QAM16:
        re = s(0) * (2.0 - s(2))
        im = s(1) * (2.0 - s(3))
    elif mod == Modulation.QAM64:
        re = s(0) * (4.0 - s(2) * (2.0 - s(4)))
        im = s(1) * (4.0 - s(3) * (2.0 - s(5)))
    else:  # QAM256
        re = s(0) * (8.0 - s(2) * (4.0 - s(4) * (2.0 - s(6))))
        im = s(1) * (8.0 - s(3) * (4.0 - s(5) * (2.0 - s(7))))
    # The float32 value of 1/sqrt(norm), as JAX multiplies by it.
    inv = float(np.float32(1.0 / np.sqrt(_NORM[mod])))
    return torch.complex(re * inv, im * inv)


def modulate(bits: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """bits (..., nsym * Qm) uint8 -> complex64 symbols (..., nsym).

    For PI_2_BPSK, even symbol indices use the base point and odd indices the
    pi/2-rotated point (TS 38.211 Section 5.1.1).
    """
    qm = bits_per_symbol(mod)
    groups = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // qm, qm))
    if mod in _NORM:
        signs = 1.0 - 2.0 * groups.to(torch.float32)
        return _square_qam(lambda i: signs[..., i], mod)
    weights = torch.tensor([1 << (qm - 1 - i) for i in range(qm)], device=bits.device)
    idx = (groups.to(torch.int64) * weights).sum(dim=-1)
    sym = on_device(constellation, mod, device=bits.device)[idx]
    if mod == Modulation.PI_2_BPSK:
        odd = torch.arange(sym.shape[-1], device=bits.device) % 2 == 1
        sym = sym * torch.where(odd, 1j, 1.0).to(torch.complex64)
    return sym


def modulate_planes(planes: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """Square-QAM mapping from bit planes: planes (..., Qm, nsym) uint8 ->
    complex64 (..., nsym).  Bit plane i of the transmitted symbols is a
    contiguous slice of the rate matcher's e-order stream, so a transmitter
    that keeps e-order needs no interleave permutation."""
    if mod not in _NORM:
        raise ValueError("plane modulation covers square QAM")
    signs = 1.0 - 2.0 * planes.to(torch.float32)
    return _square_qam(lambda i: signs[..., i, :], mod)
