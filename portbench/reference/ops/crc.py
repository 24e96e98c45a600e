"""CRC calculators for TS 38.212 Section 5.1 (port of `srsran_projectvtlmo_tpu.ops.crc`).

crc(m) = XOR over set message bits of basis vectors; the bases are built once
per (polynomial, length) on the host, exactly as in the JAX package.  On the
device each basis row is packed into one int32 (bit j = coefficient of x^j),
so a CRC is an elementwise product with the packed mask followed by an XOR
reduction: integer arithmetic, bit-exact by construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tables import on_device

#: Generator polynomials including the leading term, as in TS 38.212 Section 5.1.
POLYS = {
    "CRC24A": (24, 0x1864CFB),
    "CRC24B": (24, 0x1800063),
    "CRC24C": (24, 0x1B2B117),
    "CRC16": (16, 0x11021),
    "CRC11": (11, 0xE21),
    "CRC6": (6, 0x61),
}


def _mul_x_matrix(order: int, poly: int) -> np.ndarray:
    """GF(2) matrix applying r -> r*x mod g.  Bit i = coefficient of x^i."""
    mat = np.zeros((order, order), dtype=np.uint8)
    g = poly & ((1 << order) - 1)
    for i in range(order):
        if i + 1 < order:
            mat[i + 1, i] = 1
        else:
            for j in range(order):
                mat[j, i] = (g >> j) & 1
    return mat


def _doubling_rows(r0: np.ndarray, a: np.ndarray, length: int) -> np.ndarray:
    """Rows r0 A^d for d = 0..length-1 by log-doubling, reversed so that row i
    belongs to distance length-1-i from the message end."""
    rows = r0[None, :].copy()
    a_pow = a.copy()
    while rows.shape[0] < length:
        ext = (rows.astype(np.int64) @ a_pow.T.astype(np.int64)) % 2
        rows = np.concatenate([rows, ext.astype(np.uint8)], axis=0)
        a_pow = (a_pow.astype(np.int64) @ a_pow.astype(np.int64) % 2).astype(np.uint8)
    return rows[:length][::-1].copy()


@functools.lru_cache(maxsize=None)
def crc_basis(name: str, length: int) -> np.ndarray:
    """(length, order) uint8: row d = x^(length-1-d + order) mod g."""
    order, poly = POLYS[name]
    g = poly & ((1 << order) - 1)
    r0 = np.array([(g >> j) & 1 for j in range(order)], dtype=np.uint8)
    return _doubling_rows(r0, _mul_x_matrix(order, poly), length)


@functools.lru_cache(maxsize=None)
def crc_zero_basis(name: str, length: int) -> np.ndarray:
    """(length, order) uint8: row i = x^(length-1-i) mod g.

    For s = payload||crc, xor_i s_i * row_i == 0 iff the CRC checks; the LDPC
    decoders use it for the per-iteration codeblock CRC.
    """
    order, poly = POLYS[name]
    r0 = np.zeros(order, dtype=np.uint8)
    r0[0] = 1
    return _doubling_rows(r0, _mul_x_matrix(order, poly), length)


def pack_rows(basis: np.ndarray) -> np.ndarray:
    """(n, order) uint8 GF(2) rows -> (n,) int32 with bit j = column j."""
    order = basis.shape[1]
    return (basis.astype(np.int64) << np.arange(order, dtype=np.int64)).sum(-1).astype(np.int32)


def crc_host(bits: np.ndarray, name: str) -> np.ndarray:
    """CRC of an MSB-first uint8 bit array -> uint8 CRC bits, MSB first."""
    basis = crc_basis(name, len(bits))
    rem = (bits.astype(np.int64) @ basis.astype(np.int64)) % 2
    return rem[::-1].astype(np.uint8)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce an integer tensor over its last axis (pairwise tree)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


@functools.lru_cache(maxsize=None)
def packed_basis(name: str, length: int) -> np.ndarray:
    """(length,) int32 packed `crc_basis` rows."""
    return pack_rows(crc_basis(name, length))


@functools.lru_cache(maxsize=None)
def packed_zero_mask(name: str, length: int, total_len: int) -> np.ndarray:
    """(length,) int32: packed `crc_zero_basis(name, total_len)` rows, then zeros."""
    mask = np.zeros(length, np.int32)
    mask[:total_len] = pack_rows(crc_zero_basis(name, total_len))
    return mask


def crc_device(bits: torch.Tensor, name: str) -> torch.Tensor:
    """Batched CRC: bits (..., N) -> (..., order) uint8, MSB first."""
    order, _ = POLYS[name]
    mask = on_device(packed_basis, name, bits.shape[-1], device=bits.device)
    rem = xor_reduce(bits.to(torch.int32) * mask)
    js = torch.arange(order - 1, -1, -1, device=bits.device)
    return ((rem[..., None] >> js) & 1).to(torch.uint8)


def crc_check_device_cbs(payload_bits_3d: torch.Tensor, name: str, total_len: int) -> torch.Tensor:
    """CRC check over the concatenation of per-CB payload bits.

    payload_bits_3d: (..., C, Kpay) bits; the TB stream is their row-major
    concatenation truncated to `total_len` (payload + appended CRC).
    Returns (...) bool.
    """
    c, kpay = payload_bits_3d.shape[-2:]
    if c * kpay < total_len:
        raise ValueError(f"{c} x {kpay} payload bits cover less than {total_len}")
    mask = on_device(packed_zero_mask, name, c * kpay, total_len, device=payload_bits_3d.device)
    flat = payload_bits_3d.reshape(payload_bits_3d.shape[:-2] + (c * kpay,))
    return xor_reduce(flat.to(torch.int32) * mask) == 0


def crc_check_device(bits_with_crc: torch.Tensor, name: str) -> torch.Tensor:
    """Check the CRC over (..., N + order) bits: (...) bool, True when it passes."""
    order, _ = POLYS[name]
    got = crc_device(bits_with_crc[..., :-order], name)
    return torch.all(got == bits_with_crc[..., -order:].to(torch.uint8), dim=-1)
