"""O-RAN fronthaul C-plane message serdes (O-RAN.WG4.CUS section 7.5.2).

Section type 1 (DL/UL radio channel), type 0 (idle/guard period) and type 3
(PRACH mixed-numerology) messages, byte-compatible with the reference's
builder (reference: lib/ofh/serdes/ofh_cplane_message_builder_impl.cpp:40-330).
Single-section messages, no extensions/beams — the reference's own envelope.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

OFH_PAYLOAD_VERSION = 1

#: dataDirection values.
DIRECTION_UL = 0
DIRECTION_DL = 1

#: filterIndex values (O-RAN.WG4.CUS Table 7.5.2.3-2).
FILTER_STANDARD = 0
FILTER_PRACH_LONG = 1
FILTER_PRACH_SHORT = 2

#: rb/symInc bits.
_RB_EVERY = 0
_SYMINC_CURRENT = 0

#: cplane_scs values (Table 7.5.2.13-3).
CPLANE_SCS = {15e3: 0, 30e3: 1, 60e3: 2, 120e3: 3, 1.25e3: 12, 5e3: 14}


@dataclass(frozen=True)
class CplaneRadioHeader:
    direction: int            # DIRECTION_UL / DIRECTION_DL
    sfn: int
    subframe: int             # 0-9
    slot: int                 # slot within the subframe
    start_symbol: int
    filter_index: int = FILTER_STANDARD


@dataclass(frozen=True)
class CplaneCommonSection:
    section_id: int
    prb_start: int
    nof_prb: int              # 0 encodes "all PRBs" for >255
    re_mask: int = 0xFFF
    nof_symbols: int = 14


@dataclass(frozen=True)
class CplaneSection3Params:
    """Extra fields of section type 3 (PRACH): O-RAN.WG4.CUS 7.5.2.12-14."""
    time_offset: int
    frame_structure_fft: int  # 4 MSB: FFT size exponent
    scs_hz: float
    cp_length: int = 0
    freq_offset: int = 0


def _radio_header_bytes(hdr: CplaneRadioHeader) -> bytes:
    b0 = ((hdr.direction & 1) << 7) | ((OFH_PAYLOAD_VERSION & 0x7) << 4) \
        | (hdr.filter_index & 0xF)
    b1 = hdr.sfn & 0xFF
    b2 = ((hdr.subframe & 0xF) << 4) | ((hdr.slot >> 2) & 0xF)
    b3 = ((hdr.slot & 0x3) << 6) | (hdr.start_symbol & 0x3F)
    return bytes([b0, b1, b2, b3])


def _common_section_bytes(s: CplaneCommonSection) -> bytes:
    nof_prb = 0 if s.nof_prb > 255 else s.nof_prb
    b0 = (s.section_id >> 4) & 0xFF
    b1 = ((s.section_id & 0xF) << 4) | (_RB_EVERY << 3) | (_SYMINC_CURRENT << 2) \
        | ((s.prb_start >> 8) & 0x3)
    b2 = s.prb_start & 0xFF
    b3 = nof_prb
    b4 = (s.re_mask >> 4) & 0xFF
    b5 = ((s.re_mask & 0xF) << 4) | (s.nof_symbols & 0xF)
    return bytes([b0, b1, b2, b3, b4, b5])


def build_type1_message(hdr: CplaneRadioHeader, section: CplaneCommonSection,
                        ud_comp_header: int = 0) -> bytes:
    """Section type 1: DL/UL radio channel scheduling
    (reference: build_dl_ul_radio_channel_message)."""
    out = bytearray(_radio_header_bytes(hdr))
    out.append(1)  # numberOfSections
    out.append(1)  # sectionType
    # udCompHdr only for UL direction; DL writes reserved 0 first
    # (reference serialize_compression_header ordering handled by caller).
    out.append(ud_comp_header & 0xFF)
    out.append(0)  # reserved
    out += _common_section_bytes(section)
    out += bytes([0, 0])  # ef + beamId: no extensions, no beams
    return bytes(out)


def build_type0_message(hdr: CplaneRadioHeader, section: CplaneCommonSection,
                        time_offset: int = 0, frame_structure: int = 0,
                        cp_length: int = 0) -> bytes:
    """Section type 0: idle/guard period (reference:
    build_idle_guard_period_message)."""
    out = bytearray(_radio_header_bytes(hdr))
    out.append(1)
    out.append(0)  # sectionType
    out += struct.pack(">H", time_offset & 0xFFFF)
    out.append(frame_structure & 0xFF)
    out += struct.pack(">H", cp_length & 0xFFFF)
    out.append(0)  # reserved
    out += _common_section_bytes(section)
    out += bytes([0, 0])  # ef/reserved extension bytes
    return bytes(out)


def build_type3_message(hdr: CplaneRadioHeader, section: CplaneCommonSection,
                        p3: CplaneSection3Params, ud_comp_header: int = 0) -> bytes:
    """Section type 3: PRACH / mixed numerology (reference:
    build_prach_mixed_numerology_message)."""
    scs = CPLANE_SCS.get(p3.scs_hz, 15)
    out = bytearray(_radio_header_bytes(hdr))
    out.append(1)
    out.append(3)  # sectionType
    out += struct.pack(">H", p3.time_offset & 0xFFFF)
    out.append(((p3.frame_structure_fft & 0xF) << 4) | (scs & 0xF))
    out += struct.pack(">H", p3.cp_length & 0xFFFF)
    out.append(ud_comp_header & 0xFF)
    out += _common_section_bytes(section)
    # frequency offset (3 bytes) + reserved (1 byte); then ef/beam (2 bytes).
    out += struct.pack(">i", p3.freq_offset << 8)[:3]
    out += bytes([0, 0, 0])
    return bytes(out)


@dataclass
class CplaneDecoded:
    section_type: int
    header: CplaneRadioHeader
    section: CplaneCommonSection


def decode_message(data: bytes) -> CplaneDecoded:
    """Decode the radio header + first section of a C-plane message."""
    direction = (data[0] >> 7) & 1
    filt = data[0] & 0xF
    sfn = data[1]
    subframe = (data[2] >> 4) & 0xF
    slot = ((data[2] & 0xF) << 2) | ((data[3] >> 6) & 0x3)
    start_symbol = data[3] & 0x3F
    section_type = data[5]
    if section_type == 1:
        off = 8
    elif section_type == 0:
        off = 12
    elif section_type == 3:
        off = 12
    else:
        raise ValueError(f"unsupported C-plane section type {section_type}")
    s = data[off:off + 6]
    section_id = (s[0] << 4) | ((s[1] >> 4) & 0xF)
    prb_start = ((s[1] & 0x3) << 8) | s[2]
    nof_prb = s[3]
    re_mask = (s[4] << 4) | ((s[5] >> 4) & 0xF)
    nof_symbols = s[5] & 0xF
    return CplaneDecoded(
        section_type=section_type,
        header=CplaneRadioHeader(direction, sfn, subframe, slot, start_symbol, filt),
        section=CplaneCommonSection(section_id, prb_start, nof_prb, re_mask,
                                    nof_symbols),
    )
