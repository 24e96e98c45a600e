"""FAPI-shaped PDU dataclasses: the public slot API of the framework.

These mirror the PDU set the reference's FAPI adaptor translates into PHY
processor configurations (reference: lib/fapi_adaptor/phy/fapi_to_phy_translator.cpp,
include/srsran/fapi/messages.h): dl_tti_request (SSB/PDCCH/PDSCH/CSI-RS),
tx_data_request, ul_tti_request (PRACH/PUSCH/PUCCH), and the uplink result
indications (CRC, RxData, UCI, RACH).

Static (shape-determining) fields are frozen dataclass members so PDUs are
hashable compile-cache keys; payloads travel separately.

The port's own copy of `srsran_projectvtlmo_tpu.fapi.pdus`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ran.modulation import Modulation


@dataclass(frozen=True)
class SsbPdu:
    phys_cell_id: int
    ssb_block_index: int
    sfn: int
    half_radio_frame: bool
    ssb_subcarrier_offset: int = 0
    ssb_offset_pointa: int = 0
    l_max: int = 8
    mib_payload: tuple[int, ...] = tuple([0] * 24)
    #: Single-layer precoding vector over the cell's TX ports; None = port 0.
    precoding: tuple[tuple[float, float], ...] | None = None


@dataclass(frozen=True)
class PdcchPdu:
    rnti: int
    nof_dci_bits: int
    aggregation_level: int
    cce_index: int
    start_symbol: int
    n_id: int = 0
    n_rnti: int = 0
    #: First RB of the CORESET region used by this candidate.
    coreset_rb_start: int = 0
    #: CORESET width in RBs (contiguous frequency resources).
    coreset_nof_rb: int = 96
    #: CORESET duration in OFDM symbols (1-3).
    duration: int = 1
    #: CCE-to-REG mapping (TS 38.211 Section 7.3.2.2; reference:
    #: lib/ran/pdcch/cce_to_prb_mapping.cpp): non-interleaved (6 consecutive
    #: REGs per CCE) or interleaved with REG bundles of `reg_bundle_size`
    #: permuted by f(x) = (r*C + c + shift_index) mod (N_REG/L).
    interleaved: bool = False
    reg_bundle_size: int = 6
    interleaver_size: int = 2
    shift_index: int = 0
    #: Single-layer precoding vector over the cell's TX ports ((re, im) per
    #: port); None = port 0 only (reference: resource_grid_mapper applies
    #: precoding to every channel, resource_grid_mapper_impl.cpp).
    precoding: tuple[tuple[float, float], ...] | None = None


@dataclass(frozen=True)
class PdschPdu:
    rnti: int
    rb_start: int
    rb_size: int
    modulation: Modulation
    target_code_rate: float
    rv: int = 0
    nof_layers: int = 1
    start_symbol: int = 2
    nof_symbols: int = 12
    dmrs_symbols: tuple[int, ...] = (2,)
    n_id: int = 0
    #: Precoding matrix, (nof_tx_ports rows) x (nof_layers cols) of (re, im)
    #: pairs; None = identity layer->port mapping (reference:
    #: include/srsran/phy/generic_functions/precoding/channel_precoder.h:49-61).
    precoding: tuple[tuple[tuple[float, float], ...], ...] | None = None
    #: Reserved RE patterns (ran.re_pattern.RePattern) the PDSCH
    #: rate-matches around: CSI-RS resources, CORESET regions (reference:
    #: pdsch_processor pdu_t::reserved, pdsch_processor_impl.cpp:77-96).
    reserved: tuple = ()


@dataclass(frozen=True)
class CsiRsPdu:
    """NZP-CSI-RS PDU, full mapping-table row set 1-18 (reference:
    lib/fapi_adaptor/phy/fapi_to_phy_translator.cpp:336-351 process_csi,
    lib/ran/csi_rs/csi_rs_pattern.cpp; rows 13-18 per TS 38.211
    Table 7.4.1.5.3-1 directly — the reference's own generator stops at 12)."""

    nof_rb: int
    prb_start: int = 0
    symbol: int = 4
    #: Second time reference l_1 (rows 13/14/16/17 only).
    symbol_l1: int = 8
    subcarrier_offset: int = 0
    scrambling_id: int = 0
    #: TS 38.211 Table 7.4.1.5.3-1 row (1..18); ports/CDM derive from it.
    row: int = 2
    #: Frequency allocation references k_0..k_n (count depends on the row);
    #: empty = repeat subcarrier_offset.
    k_ref: tuple[int, ...] = ()
    #: "one", "three", "dot5_even" or "dot5_odd".
    density: str = "one"


@dataclass(frozen=True)
class SrsPdu:
    """Sounding reference signal PDU (reference:
    lib/phy/upper/uplink_processor_impl.cpp process_srs,
    lib/phy/upper/signal_processors/srs/srs_estimator_generic_impl.cpp)."""

    rnti: int
    nof_rb: int
    comb_size: int = 2
    comb_offset: int = 0
    start_symbol: int = 13
    nof_symbols: int = 1
    sequence_id: int = 0
    cyclic_shift: int = 0
    nof_antenna_ports: int = 1
    prb_start: int = 0


@dataclass(frozen=True)
class PuschPdu:
    rnti: int
    rb_start: int
    rb_size: int
    modulation: Modulation
    target_code_rate: float
    harq_id: int = 0
    new_data: bool = True
    rv: int = 0
    nof_layers: int = 1
    start_symbol: int = 0
    nof_symbols: int = 14
    dmrs_symbols: tuple[int, ...] = (2,)
    n_id: int = 0
    #: UCI multiplexing (HARQ-ACK bits riding on PUSCH) -- 0 = none.
    nof_harq_ack_bits: int = 0
    #: CSI part-1 payload bits multiplexed on PUSCH -- 0 = none (reference:
    #: ul_pusch_pdu uci fields, fapi_to_phy_translator.cpp:290-351).
    nof_csi_part1_bits: int = 0
    #: uci-part2 correspondence: part2_size_map[value(csi1 bits)] = CSI
    #: part-2 payload size in bits (0 entries = part 2 absent for that part-1
    #: value).  Empty = no CSI part 2.  Length must be 2**nof_csi_part1_bits;
    #: a CONSTANT map runs single-pass in the fused program, a varying map
    #: runs the two-phase part1->part2 protocol (phy.pusch_uci)
    #: (reference: uci_part2_correspondence in the FAPI PUSCH PDU,
    #: pusch_processor_impl.cpp:40-92).
    part2_size_map: tuple[int, ...] = ()
    #: DM-RS configuration type (TS 38.211 Section 6.4.1.1.3): 1 or 2
    #: (reference: pusch_processor dmrs field, dmrs_pusch_estimator_impl.cpp).
    dmrs_config_type: int = 1
    #: Intra-slot frequency hopping: absolute slot symbol where the second
    #: hop starts, and its PRB start (None = no hopping; reference:
    #: port_channel_estimator_average_impl.cpp:238-330 hop loop).
    hop_symbol: int | None = None
    second_hop_prb: int | None = None


@dataclass(frozen=True)
class PucchPdu:
    format: int  # 0, 1 or 2
    rnti: int
    prb_start: int
    nof_prb: int
    start_symbol: int
    nof_symbols: int
    initial_cyclic_shift: int = 0
    time_domain_occ: int = 0
    nof_harq_bits: int = 0
    nof_uci_bits: int = 0
    sr_opportunity: bool = False
    n_id: int = 0
    n_id0: int = 0
    #: Format 1 intra-slot frequency hopping: second-hop PRB (None = off).
    second_hop_prb: int | None = None


@dataclass(frozen=True)
class PrachPdu:
    format_is_long: bool = True
    root_sequence_index: int = 0
    zero_correlation_zone: int = 0
    restricted_set: int = 0
    nof_preamble_indices: int = 64


@dataclass(frozen=True)
class DlTtiRequest:
    slot: int
    ssb: tuple[SsbPdu, ...] = ()
    pdcch: tuple[PdcchPdu, ...] = ()
    pdsch: tuple[PdschPdu, ...] = ()
    csi_rs: tuple[CsiRsPdu, ...] = ()


@dataclass(frozen=True)
class UlTtiRequest:
    slot: int
    pusch: tuple[PuschPdu, ...] = ()
    pucch: tuple[PucchPdu, ...] = ()
    prach: tuple[PrachPdu, ...] = ()
    srs: tuple[SrsPdu, ...] = ()


@dataclass
class TxDataRequest:
    """Transport blocks for the slot's PDSCH PDUs, in PDU order (bit arrays)."""

    slot: int
    tb_bits: list[np.ndarray] = field(default_factory=list)


@dataclass
class CrcIndication:
    slot: int
    rnti: int
    harq_id: int
    tb_crc_ok: bool


@dataclass
class RxDataIndication:
    slot: int
    rnti: int
    harq_id: int
    tb_bits: np.ndarray | None


@dataclass
class UciIndication:
    slot: int
    rnti: int
    harq_bits: np.ndarray
    uci_bits: np.ndarray | None
    valid: bool
    sr_detected: bool = False
    #: CSI-on-PUSCH sections (reference: uci_pusch_pdu carries HARQ + CSI
    #: part 1 + CSI part 2 parts, include/srsran/fapi/messages.h).
    csi1_bits: np.ndarray | None = None
    csi1_valid: bool = False
    csi2_bits: np.ndarray | None = None
    csi2_valid: bool = False


@dataclass
class RachIndication:
    slot: int
    preambles: list[tuple[int, float, float]]  # (index, ta_samples, metric)


@dataclass
class SrsIndication:
    """SRS channel-estimate report (reference: srs_indication in
    include/srsran/fapi/messages.h; wideband metrics per antenna pair)."""

    slot: int
    rnti: int
    #: (rx_ports, sequence_length) complex channel estimate on the comb.
    channel: np.ndarray
    noise_var: float
    time_alignment_s: float
