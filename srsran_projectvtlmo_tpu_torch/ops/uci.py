"""UCI encoding/decoding (HARQ-ACK / CSI payloads), TS 38.212 Sections 6.3.1/6.3.2
(port of `srsran_projectvtlmo_tpu.ops.uci`).

1-11 bits: short-block code with brute-force ML detection.
12-1706 bits: CRC6 (K<=19) or CRC11 (K>=20) + polar (n_max=10, ibil), with
two-codeblock segmentation when (K>=360 and E>=1088) or K>=1013; filler bits
are prepended to the first codeblock.
reference: lib/phy/upper/channel_processors/uci/uci_decoder_impl.cpp:30-123.
"""

from __future__ import annotations

import numpy as np
import torch

from . import short_block
from .crc import crc_check_device, crc_device
from .polar import PolarCode, polar_allocate, polar_deallocate, polar_decode, polar_encode
from .polar import rate_matching as polar_rm


def nof_uci_codeblocks(k: int, e: int) -> int:
    return 2 if (k >= 360 and e >= 1088) or k >= 1013 else 1


def uci_crc_size(k: int) -> int:
    return 11 if k >= 20 else 6


def _segments(k: int, e: int):
    """(codeblocks, CRC name, per-CB payload sizes, filler bits before CB 0)."""
    c = nof_uci_codeblocks(k, e)
    crc_name = "CRC11" if uci_crc_size(k) == 11 else "CRC6"
    sizes = [k // c, -(-k // c)] if c == 2 else [k]
    return c, crc_name, sizes, (k % c if c > 1 else 0)


def polar_uci_encode(bits: torch.Tensor, e: int) -> torch.Tensor:
    """Device CRC + polar encoder for K >= 12: bits (B, K) uint8 -> (B, E) uint8."""
    k = bits.shape[-1]
    c, crc_name, sizes, filler = _segments(k, e)
    outs, start = [], 0
    for j in range(c):
        cb = bits[:, start:start + sizes[j]]
        start += sizes[j]
        if j == 0 and filler:
            cb = torch.cat([torch.zeros((bits.shape[0], filler), dtype=bits.dtype,
                                        device=bits.device), cb], dim=-1)
        payload = torch.cat([cb, crc_device(cb, crc_name)], dim=-1)
        code = PolarCode(K=payload.shape[-1], E=e // c, n_max=10, ibil=True)
        x = polar_encode(polar_allocate(payload, code), code.n)
        outs.append(polar_rm.rate_match(x, code).to(torch.uint8))
    return torch.cat(outs, dim=-1)


def uci_encode(msg: np.ndarray, e: int, bits_per_symbol: int = 2) -> np.ndarray:
    """Host-side UCI encoder (test driver / UE emulator). msg (K,) -> (E,) bits."""
    if len(msg) <= 11:
        return short_block.encode_host(msg, e, bits_per_symbol)
    bits = torch.as_tensor(np.asarray(msg, np.uint8)[None])
    return polar_uci_encode(bits, e)[0].numpy()


def uci_decode(llrs: torch.Tensor, k: int, bits_per_symbol: int = 2):
    """Decode one UCI payload from (B, E) int8 LLRs.

    Returns (bits (B, K) uint8, valid (B,) bool): for short blocks the
    detection metric against 0.25, for polar the CRC check.
    """
    e = llrs.shape[-1]
    if k <= 11:
        bits, metric = short_block.detect(llrs, k, bits_per_symbol)
        return bits, metric > 0.25
    c, crc_name, sizes, filler = _segments(k, e)
    crc_bits = uci_crc_size(k)
    outs, valid = [], None
    for j in range(c):
        cb_k = sizes[j] + crc_bits + (filler if j == 0 else 0)
        code = PolarCode(K=cb_k, E=e // c, n_max=10, ibil=True)
        buf = polar_rm.rate_dematch(llrs[..., j * (e // c):(j + 1) * (e // c)], code)
        payload = polar_deallocate(polar_decode(buf, code), code)  # (B, cb_k)
        ok = crc_check_device(payload, crc_name)
        outs.append(payload[..., (filler if j == 0 else 0):cb_k - crc_bits])
        valid = ok if valid is None else (valid & ok)
    return torch.cat(outs, dim=-1), valid
