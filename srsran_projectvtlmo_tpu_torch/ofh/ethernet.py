"""Ethernet VLAN framing + eAxC addressing for the O-RAN fronthaul.

Byte-compatible with the reference's VLAN frame builder/decoder
(reference: lib/ofh/ethernet/vlan_ethernet_frame_builder_impl.cpp:33-55,
vlan_ethernet_frame_decoder_impl.cpp; ECPRI_ETH_TYPE = 0xAEFE,
include/srsran/ofh/ethernet/ethernet_properties.h:31).  The eAxC rides the
eCPRI pc_id/rtc_id (already in ofh.ecpri); this layer adds the L2 frame.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

VLAN_TPID = 0x8100
ECPRI_ETH_TYPE = 0xAEFE
#: Minimum Ethernet payload (frames are padded to 64B incl. FCS-less header).
MIN_FRAME_SIZE = 60


@dataclass(frozen=True)
class VlanFrameParams:
    mac_dst: bytes  # 6 bytes
    mac_src: bytes  # 6 bytes
    tci: int        # PCP (3b) | DEI (1b) | VLAN id (12b)
    eth_type: int = ECPRI_ETH_TYPE


def build_vlan_frame(params: VlanFrameParams, payload: bytes) -> bytes:
    """dst(6) + src(6) + 802.1Q tag (TPID + TCI) + ethType + payload."""
    assert len(params.mac_dst) == 6 and len(params.mac_src) == 6
    hdr = (params.mac_dst + params.mac_src
           + struct.pack(">HH", VLAN_TPID, params.tci & 0xFFFF)
           + struct.pack(">H", params.eth_type & 0xFFFF))
    frame = hdr + payload
    if len(frame) < MIN_FRAME_SIZE:
        frame += bytes(MIN_FRAME_SIZE - len(frame))
    return frame


@dataclass
class VlanFrameDecoded:
    mac_dst: bytes
    mac_src: bytes
    tci: int
    eth_type: int
    payload: bytes


def decode_vlan_frame(frame: bytes) -> VlanFrameDecoded:
    if len(frame) < 18:
        raise ValueError("frame too short for VLAN Ethernet header")
    mac_dst, mac_src = frame[0:6], frame[6:12]
    tpid, tci = struct.unpack(">HH", frame[12:16])
    if tpid != VLAN_TPID:
        raise ValueError(f"not an 802.1Q frame (TPID {tpid:#x})")
    (eth_type,) = struct.unpack(">H", frame[16:18])
    return VlanFrameDecoded(mac_dst, mac_src, tci, eth_type, frame[18:])


def eaxc_pc_id(du_port: int, band_sector: int, cc_id: int, ru_port: int,
               widths=(2, 6, 4, 4)) -> int:
    """Pack the eAxC identifier into the 16-bit eCPRI pc_id
    (O-RAN.WG4.CUS 3.1.3.1.6: DU port | band/sector | CC | RU port)."""
    wd, wb, wc, wr = widths
    assert wd + wb + wc + wr == 16
    assert du_port < (1 << wd) and band_sector < (1 << wb)
    assert cc_id < (1 << wc) and ru_port < (1 << wr)
    return (du_port << (wb + wc + wr)) | (band_sector << (wc + wr)) \
        | (cc_id << wr) | ru_port


def eaxc_unpack(pc_id: int, widths=(2, 6, 4, 4)) -> tuple[int, int, int, int]:
    wd, wb, wc, wr = widths
    ru = pc_id & ((1 << wr) - 1)
    cc = (pc_id >> wr) & ((1 << wc) - 1)
    bs = (pc_id >> (wc + wr)) & ((1 << wb) - 1)
    du = (pc_id >> (wb + wc + wr)) & ((1 << wd) - 1)
    return du, bs, cc, ru


class TxWindowChecker:
    """DL transmission window monitor (reference:
    lib/ofh/transmitter/ofh_tx_window_checker.h:33-86): tracks the current
    OTA symbol count and flags resource grids that arrive too late to meet
    the advance-time (T1a) budget."""

    def __init__(self, advance_time_in_symbols: int, nof_symbols: int = 14,
                 numerology: int = 1):
        self.advance = advance_time_in_symbols
        self.nof_symbols = nof_symbols
        self.numerology = numerology
        self._ota_count = 0
        self.nof_late = 0

    def on_new_symbol(self, slot: int, symbol: int) -> None:
        self._ota_count = slot * self.nof_symbols + symbol

    def is_late(self, slot: int) -> bool:
        """True when `slot`'s grid (worst case symbol 0) can no longer be
        sent `advance` symbols ahead of its OTA time."""
        rg_count = slot * self.nof_symbols - self.advance
        late = self._ota_count >= rg_count
        if late:
            self.nof_late += 1
        return late
