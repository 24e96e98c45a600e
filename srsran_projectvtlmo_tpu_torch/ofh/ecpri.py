"""eCPRI packet framing (common header + IQ-data / real-time-control types).

reference: lib/ofh/ecpri/ecpri_packet_builder_impl.cpp:31-103 (builder) and
ecpri_packet_decoder_impl.cpp (decoder). Big-endian (network order) fields:

  common header (4 B): [revision:4 | reserved:3 | concat:1] [msg type:8]
                       [payload size:16]
  iq_data fields (4 B): [PC_ID:16] [SEQ_ID:16]
  rt_control fields (4 B): [RTC_ID:16] [SEQ_ID:16]
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

ECPRI_PROTOCOL_REVISION = 1
MSG_TYPE_IQ_DATA = 0x00
MSG_TYPE_RT_CONTROL = 0x02

_COMMON = struct.Struct("!BBH")
_FIELDS = struct.Struct("!HH")


@dataclass(frozen=True)
class EcpriIqPacket:
    pc_id: int
    seq_id: int
    payload: bytes


@dataclass(frozen=True)
class EcpriRtControlPacket:
    rtc_id: int
    seq_id: int
    payload: bytes


def _common_header(msg_type: int, payload_size: int) -> bytes:
    # Revision in the 4 MSBs, concatenation (unsupported, as in the
    # reference) in the LSB (ecpri_packet_builder_impl.cpp:44-57).
    return _COMMON.pack(ECPRI_PROTOCOL_REVISION << 4, msg_type, payload_size)


def build_iq_data_packet(pc_id: int, seq_id: int, payload: bytes) -> bytes:
    """eCPRI type-0 IQ data packet. The payload size excludes the common
    header but includes the PC_ID/SEQ_ID fields
    (reference: ecpri_packet_builder_impl.cpp:82-103)."""
    body = _FIELDS.pack(pc_id & 0xFFFF, seq_id & 0xFFFF) + payload
    return _common_header(MSG_TYPE_IQ_DATA, len(body)) + body


def build_rt_control_packet(rtc_id: int, seq_id: int, payload: bytes) -> bytes:
    """eCPRI type-2 real-time control packet
    (reference: ecpri_packet_builder_impl.cpp:59-80)."""
    body = _FIELDS.pack(rtc_id & 0xFFFF, seq_id & 0xFFFF) + payload
    return _common_header(MSG_TYPE_RT_CONTROL, len(body)) + body


def decode_packet(data: bytes):
    """Decode one eCPRI packet -> EcpriIqPacket | EcpriRtControlPacket.

    Raises ValueError on malformed input (wrong revision, short packet,
    unknown type), mirroring the decoder's drop conditions
    (reference: ecpri_packet_decoder_impl.cpp)."""
    if len(data) < _COMMON.size:
        raise ValueError("eCPRI packet shorter than common header")
    first, msg_type, payload_size = _COMMON.unpack_from(data)
    if (first >> 4) != ECPRI_PROTOCOL_REVISION:
        raise ValueError(f"unsupported eCPRI revision {first >> 4}")
    if first & 0x1:
        raise ValueError("eCPRI concatenation not supported")
    body = data[_COMMON.size:_COMMON.size + payload_size]
    if len(body) != payload_size:
        raise ValueError("eCPRI payload truncated")
    if len(body) < _FIELDS.size:
        raise ValueError("eCPRI payload shorter than type fields")
    id_field, seq_id = _FIELDS.unpack_from(body)
    payload = body[_FIELDS.size:]
    if msg_type == MSG_TYPE_IQ_DATA:
        return EcpriIqPacket(id_field, seq_id, payload)
    if msg_type == MSG_TYPE_RT_CONTROL:
        return EcpriRtControlPacket(id_field, seq_id, payload)
    raise ValueError(f"unknown eCPRI message type {msg_type:#x}")
