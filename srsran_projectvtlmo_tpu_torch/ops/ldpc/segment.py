"""Transport-block segmentation into LDPC codeblocks (TS 38.212 Section 5.2.2).

Port of `srsran_projectvtlmo_tpu.ops.ldpc.segment`, bit-exact with it.
Tx: TB bits + CRC24A/16 -> C codeblocks of K bits each, with a CRC24B per
codeblock when C > 1 and the filler bits zeroed for encoding.  Rx: the
inverse, with both CRC levels checked.
reference: lib/phy/upper/channel_coding/ldpc/ldpc_segmenter_impl.cpp:90-254.
"""

from __future__ import annotations

import torch

from srsran_projectvtlmo_tpu.ran.sch import SchSegmentation

from ..crc import crc_check_device, crc_device


def tb_crc_name(seg: SchSegmentation) -> str:
    """The TB CRC: CRC24A, or CRC16 for small transport blocks."""
    return "CRC24A" if seg.tb_crc_bits == 24 else "CRC16"


def segment_tx(tb_bits: torch.Tensor, seg: SchSegmentation) -> torch.Tensor:
    """(..., TBS) bits -> (..., C, K) uint8 codeblocks with CRCs attached and
    filler zeroed."""
    tb_bits = tb_bits.to(torch.uint8)
    lead = tuple(tb_bits.shape[:-1])
    full = torch.cat([tb_bits, crc_device(tb_bits, tb_crc_name(seg))], dim=-1)
    c, kp, k = seg.nof_cb, seg.nof_payload_bits_per_cb, seg.nof_bits_per_cb
    payload = kp - seg.cb_crc_bits
    # Only the last codeblock can be short of payload bits: zero-pad to C * payload.
    full = torch.cat([full, full.new_zeros(lead + (c * payload - full.shape[-1],))], dim=-1)
    cbs = full.reshape(lead + (c, payload))
    if seg.cb_crc_bits:
        cbs = torch.cat([cbs, crc_device(cbs, "CRC24B")], dim=-1)
    return torch.cat([cbs, cbs.new_zeros(lead + (c, k - kp))], dim=-1)


def desegment_rx(cb_bits: torch.Tensor, seg: SchSegmentation, tbs: int):
    """(C, K) decoded hard bits -> (tb_bits (TBS,), tb_crc_ok bool, cb_crc_ok (C,)).

    Strips filler and per-CB CRCs, reassembles the TB, checks both CRC levels.
    """
    c, kp = seg.nof_cb, seg.nof_payload_bits_per_cb
    payload_bits = cb_bits[:, :kp]
    if seg.cb_crc_bits:
        cb_ok = crc_check_device(payload_bits, "CRC24B")
        payload = payload_bits[:, :kp - seg.cb_crc_bits].reshape(-1)
    else:
        cb_ok = torch.ones((c,), dtype=torch.bool, device=cb_bits.device)
        payload = payload_bits.reshape(-1)
    tb_and_crc = payload[:tbs + seg.tb_crc_bits]
    tb_ok = crc_check_device(tb_and_crc[None], tb_crc_name(seg))[0]
    return tb_and_crc[:tbs], tb_ok, cb_ok
