"""Open Fronthaul U-plane (section type 1) message serdes.

Byte-level framing is host-side; the IQ payload itself (BFP compression and
the bit packing of mantissas) comes from the batched device programs in
ops/ofh_compression, so one device launch can produce the PRB payloads of a
whole symbol (or slot) across all eAxCs before framing.

reference: lib/ofh/serdes/ofh_uplane_message_builder_impl.cpp:33-165
(radio-app header, section-1 header, IQ serialization),
ofh_uplane_message_builder_{static,dynamic}_compression_impl.cpp (udCompHdr
present only for dynamic configuration), ofh_uplane_message_decoder_impl.cpp.

Wire layout (all big-endian):

  radio app header (4 B):
    [dir:1 | payloadVersion:3 | filterIndex:4]
    [frameId:8]  (SFN mod 256)
    [subframeId:4 | slotId msb:4]
    [slotId lsb:2 | symbolId:6]
  section 1 header (4 B):
    [sectionId:8(=0)]
    [sectionId:4(=0) | rb:1 | symInc:1 | startPrb msb:2]
    [startPrb lsb:8]
    [numPrb:8]  (0 means >255 PRBs: "all until end")
  udCompHdr (dynamic compression only, 2 B):
    [udIqWidth:4 | udCompMeth:4] [reserved:8]
  per PRB: [udCompParam (exponent) when method needs one] [24 IQ fields]
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ran.slot import SlotPoint

OFH_PAYLOAD_VERSION = 1
DIRECTION_UPLINK = 0
DIRECTION_DOWNLINK = 1

#: compression_type wire values (include/srsran/ofh/compression/compression_params.h:41-58).
COMP_NONE = 0
COMP_BFP = 1

_RADIO_APP_HDR_SIZE = 4
_SECTION1_HDR_SIZE = 4


@dataclass(frozen=True)
class UplaneMessageParams:
    slot: SlotPoint
    symbol_id: int
    start_prb: int
    nof_prb: int
    direction: int = DIRECTION_DOWNLINK
    data_width: int = 9
    comp_type: int = COMP_BFP
    #: Static configuration omits the udCompHdr (builder_static_compression_impl.cpp:28-33).
    static_compression: bool = True


@dataclass(frozen=True)
class UplaneDecodeResult:
    direction: int
    frame_id: int
    subframe_id: int
    slot_id: int
    symbol_id: int
    start_prb: int
    nof_prb: int
    data_width: int
    comp_type: int
    #: (nof_prb, bytes_per_prb) uint8 — feed to ops.ofh_compression.unpack_prbs
    #: + bfp_decompress on device.
    prb_payload: np.ndarray


def _prb_bytes(data_width: int, comp_type: int) -> int:
    n = (24 * data_width + 7) // 8
    if comp_type == COMP_BFP:
        n += 1  # udCompParam exponent byte
    return n


def build_uplane_message(params: UplaneMessageParams, prb_payload) -> bytes:
    """Frame one U-plane message around already-packed PRB payload bytes.

    prb_payload: (nof_prb, bytes_per_prb) uint8 from
    ops.ofh_compression.pack_prbs (exponent byte included for BFP).
    """
    payload = np.asarray(prb_payload, np.uint8)
    expected = (params.nof_prb, _prb_bytes(params.data_width, params.comp_type))
    if payload.shape != expected:
        raise ValueError(f"PRB payload shape {payload.shape} != {expected}")

    slot = params.slot
    hdr = bytearray()
    # Radio app header (builder_impl.cpp:33-92).
    hdr.append(((params.direction & 1) << 7) | (OFH_PAYLOAD_VERSION << 4))
    hdr.append(slot.sfn & 0xFF)
    hdr.append(((slot.subframe_index & 0xF) << 4) | ((slot.slot_in_subframe >> 2) & 0xF))
    hdr.append(((slot.slot_in_subframe & 0x3) << 6) | (params.symbol_id & 0x3F))
    # Section 1 header (builder_impl.cpp:94-109): sectionId=0, rb=every_rb_used(0),
    # symInc=current(0), startPrb over 10 bits, numPrb saturating to 0.
    hdr.append(0)
    hdr.append((params.start_prb >> 8) & 0x3)
    hdr.append(params.start_prb & 0xFF)
    hdr.append(0 if params.nof_prb > 255 else params.nof_prb)
    if not params.static_compression:
        # udCompHdr + reserved (builder_dynamic_compression_impl.cpp:29-41).
        hdr.append(((params.data_width & 0xF) << 4) | (params.comp_type & 0xF))
        hdr.append(0)
    return bytes(hdr) + payload.tobytes()


def decode_uplane_message(data: bytes,
                          static_width: int | None = 9,
                          static_comp_type: int = COMP_BFP) -> UplaneDecodeResult:
    """Decode one U-plane section-1 message.

    With static compression (the reference's default operating mode) the
    udCompHdr is absent, so the configured (width, type) must be supplied;
    pass static_width=None to parse a dynamic-compression message.
    reference: ofh_uplane_message_decoder_{impl,static,dynamic}_compression_impl.cpp.
    """
    need = _RADIO_APP_HDR_SIZE + _SECTION1_HDR_SIZE
    if len(data) < need:
        raise ValueError("U-plane message shorter than headers")
    b = data
    direction = b[0] >> 7
    if ((b[0] >> 4) & 0x7) != OFH_PAYLOAD_VERSION:
        raise ValueError("unsupported U-plane payload version")
    frame_id = b[1]
    subframe_id = b[2] >> 4
    slot_id = ((b[2] & 0xF) << 2) | (b[3] >> 6)
    symbol_id = b[3] & 0x3F
    start_prb = ((b[5] & 0x3) << 8) | b[6]
    nof_prb = b[7]
    off = need
    if static_width is None:
        if len(data) < need + 2:
            raise ValueError("U-plane message missing udCompHdr")
        width = b[off] >> 4
        comp_type = b[off] & 0xF
        off += 2
    else:
        width, comp_type = static_width, static_comp_type
    per_prb = _prb_bytes(width, comp_type)
    body = np.frombuffer(data, np.uint8, offset=off)
    if nof_prb == 0:
        nof_prb = body.size // per_prb
    if body.size < nof_prb * per_prb:
        raise ValueError("U-plane IQ payload truncated")
    payload = body[: nof_prb * per_prb].reshape(nof_prb, per_prb)
    return UplaneDecodeResult(direction, frame_id, subframe_id, slot_id,
                              symbol_id, start_prb, nof_prb, width, comp_type,
                              payload)
