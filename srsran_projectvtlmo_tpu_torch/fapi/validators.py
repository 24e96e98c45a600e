"""FAPI message/PDU validators: the rebuild's equivalent of the reference's
slot-message validation layer.

The reference validates every PDU of dl_tti/ul_tti/tx_data requests field by
field before they reach the PHY, collecting (message, pdu, field) error
reports (reference: lib/fapi/validators/dl_pdsch_pdu.cpp:38-228,
lib/fapi/validators/ul_pusch_pdu.cpp, lib/fapi/message_validators.cpp), and
each channel processor exposes a `pdu_validator` checking its own processing
envelope (reference: include/srsran/phy/upper/upper_phy.h:49-106,
lib/phy/upper/channel_processors/pusch/pusch_processor_impl.cpp:300-340).

Here both tiers live in one module: range checks mirroring the FAPI field
tables, plus envelope checks mirroring the processors' own constraints
(DM-RS type 1, 2 CDM groups, supported formats). Validation runs on host at
PDU submission, before any program dispatch, and returns a report rather than
raising so the caller can produce FAPI error indications.

The port's own copy of `srsran_projectvtlmo_tpu.fapi.validators`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ran.modulation import Modulation
from . import pdus

MAX_RNTI = 65535
MAX_NOF_PRBS = 275
MAX_NOF_LAYERS_PDSCH = 8
MAX_NOF_LAYERS_PUSCH = 4
NOF_OFDM_SYM_PER_SLOT = 14
MAX_NID = 1023
MAX_CCE_INDEX = 135
VALID_AGGREGATION_LEVELS = (1, 2, 4, 8, 16)
MAX_DCI_BITS = 128  # reference pdcch constants: DCI payload fits one candidate
MAX_PRACH_ROOT_LONG = 837
MAX_PRACH_ROOT_SHORT = 137
MAX_ZCZ = 15


@dataclass
class ValidationError:
    message_type: str
    pdu_type: str
    field_name: str
    value: object
    expected: str

    def __str__(self) -> str:  # matches the reference's report formatting intent
        return (f"{self.message_type}.{self.pdu_type}: field '{self.field_name}'"
                f" = {self.value!r} out of range ({self.expected})")


@dataclass
class ValidatorReport:
    """Collected validation failures (reference: fapi::validator_report)."""

    errors: list[ValidationError] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    def add(self, msg: str, pdu: str, fieldname: str, value, expected: str):
        self.errors.append(ValidationError(msg, pdu, fieldname, value, expected))


def _in_range(rep: ValidatorReport, msg: str, pdu: str, name: str, value, lo, hi):
    if not (lo <= value <= hi):
        rep.add(msg, pdu, name, value, f"[{lo}, {hi}]")
        return False
    return True


def _validate_alloc(rep: ValidatorReport, msg: str, pdu: str,
                    rb_start: int, rb_size: int,
                    start_symbol: int, nof_symbols: int,
                    dmrs_symbols=None):
    _in_range(rep, msg, pdu, "RB Start", rb_start, 0, MAX_NOF_PRBS - 1)
    _in_range(rep, msg, pdu, "RB Size", rb_size, 1, MAX_NOF_PRBS)
    if rb_start + rb_size > MAX_NOF_PRBS:
        rep.add(msg, pdu, "RB Start + RB Size", rb_start + rb_size,
                f"<= {MAX_NOF_PRBS}")
    _in_range(rep, msg, pdu, "Start symbol index", start_symbol, 0,
              NOF_OFDM_SYM_PER_SLOT - 1)
    _in_range(rep, msg, pdu, "Nr of symbols", nof_symbols, 1,
              NOF_OFDM_SYM_PER_SLOT)
    if start_symbol + nof_symbols > NOF_OFDM_SYM_PER_SLOT:
        rep.add(msg, pdu, "Start symbol + Nr of symbols",
                start_symbol + nof_symbols, f"<= {NOF_OFDM_SYM_PER_SLOT}")
    if dmrs_symbols is not None:
        if not dmrs_symbols:
            rep.add(msg, pdu, "DMRS symbol positions", dmrs_symbols, "non-empty")
        # PDU DM-RS positions are absolute slot symbol indices.
        for s in dmrs_symbols:
            if not (start_symbol <= s < start_symbol + nof_symbols):
                rep.add(msg, pdu, "DMRS symbol position", s,
                        f"[{start_symbol}, {start_symbol + nof_symbols - 1}]"
                        " (within the allocation)")


def validate_ssb(pdu: pdus.SsbPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/dl_ssb_pdu.cpp."""
    m, p = "dl_tti_request", "SSB"
    _in_range(rep, m, p, "Physical cell ID", pdu.phys_cell_id, 0, 1007)
    _in_range(rep, m, p, "SSB block index", pdu.ssb_block_index, 0, 63)
    _in_range(rep, m, p, "SSB subcarrier offset", pdu.ssb_subcarrier_offset, 0, 31)
    _in_range(rep, m, p, "SSB offset PointA", pdu.ssb_offset_pointa, 0, 2199)
    if pdu.l_max not in (4, 8, 64):
        rep.add(m, p, "L_max", pdu.l_max, "{4, 8, 64}")
    if len(pdu.mib_payload) != 24:
        rep.add(m, p, "MIB payload", len(pdu.mib_payload), "24 bits")


def validate_pdcch(pdu: pdus.PdcchPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/dl_pdcch_pdu.cpp."""
    m, p = "dl_tti_request", "PDCCH"
    _in_range(rep, m, p, "RNTI", pdu.rnti, 1, MAX_RNTI)
    if pdu.aggregation_level not in VALID_AGGREGATION_LEVELS:
        rep.add(m, p, "Aggregation level", pdu.aggregation_level,
                str(VALID_AGGREGATION_LEVELS))
    _in_range(rep, m, p, "CCE index", pdu.cce_index, 0, MAX_CCE_INDEX)
    _in_range(rep, m, p, "Start symbol index", pdu.start_symbol, 0,
              NOF_OFDM_SYM_PER_SLOT - 1)
    # reference dci payload sizes: [12, 128] bits (dl_dci_pdu checks)
    _in_range(rep, m, p, "DCI payload size", pdu.nof_dci_bits, 12, MAX_DCI_BITS)
    _in_range(rep, m, p, "nID PDCCH data", pdu.n_id, 0, 65535)
    _in_range(rep, m, p, "nRNTI PDCCH data", pdu.n_rnti, 0, 65535)
    _in_range(rep, m, p, "CORESET RB start", pdu.coreset_rb_start, 0,
              MAX_NOF_PRBS - 1)


def validate_pdsch(pdu: pdus.PdschPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/dl_pdsch_pdu.cpp:38-228 +
    pdsch_processor envelope."""
    m, p = "dl_tti_request", "PDSCH"
    _in_range(rep, m, p, "RNTI", pdu.rnti, 1, MAX_RNTI)
    _in_range(rep, m, p, "RV Index", pdu.rv, 0, 3)
    _in_range(rep, m, p, "nID PDSCH", pdu.n_id, 0, MAX_NID)
    _in_range(rep, m, p, "Number of layers", pdu.nof_layers, 1,
              MAX_NOF_LAYERS_PDSCH)
    if not isinstance(pdu.modulation, Modulation):
        rep.add(m, p, "QAM modulation order", pdu.modulation, "Modulation enum")
    if not (0.0 < pdu.target_code_rate < 1.0):
        rep.add(m, p, "Target code rate", pdu.target_code_rate, "(0, 1)")
    _validate_alloc(rep, m, p, pdu.rb_start, pdu.rb_size, pdu.start_symbol,
                    pdu.nof_symbols, pdu.dmrs_symbols)
    for pat in getattr(pdu, "reserved", ()):
        if len(pat.re_mask) != 12:
            rep.add(m, p, "Reserved RE mask length", len(pat.re_mask), "12")
        if not (0 <= pat.rb_begin < pat.rb_end <= MAX_NOF_PRBS):
            rep.add(m, p, "Reserved PRB range", (pat.rb_begin, pat.rb_end),
                    f"0 <= begin < end <= {MAX_NOF_PRBS}")
        for s in pat.symbols:
            if not (0 <= s < NOF_OFDM_SYM_PER_SLOT):
                rep.add(m, p, "Reserved symbol", s, "0..13")
        # The scheduler must not collide reserved REs (CSI-RS/CORESET) with
        # the PDSCH DM-RS symbols inside the allocation.
        overlap_rb = (pat.rb_begin < pdu.rb_start + pdu.rb_size
                      and pat.rb_end > pdu.rb_start)
        if overlap_rb and any(s in pat.symbols for s in pdu.dmrs_symbols) \
                and any(pat.re_mask):
            rep.add(m, p, "Reserved symbols", tuple(pat.symbols),
                    "no overlap with PDSCH DM-RS symbols")


def validate_pusch(pdu: pdus.PuschPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/ul_pusch_pdu.cpp + the PUSCH
    processor's own envelope (pusch_processor_impl.cpp:300-340: DM-RS type 1,
    2 CDM groups without data, <= 4 layers)."""
    m, p = "ul_tti_request", "PUSCH"
    _in_range(rep, m, p, "RNTI", pdu.rnti, 1, MAX_RNTI)
    _in_range(rep, m, p, "RV Index", pdu.rv, 0, 3)
    _in_range(rep, m, p, "HARQ process id", pdu.harq_id, 0, 15)
    _in_range(rep, m, p, "nID PUSCH", pdu.n_id, 0, MAX_NID)
    _in_range(rep, m, p, "Number of layers", pdu.nof_layers, 1,
              MAX_NOF_LAYERS_PUSCH)
    if not (0.0 < pdu.target_code_rate < 1.0):
        rep.add(m, p, "Target code rate", pdu.target_code_rate, "(0, 1)")
    _in_range(rep, m, p, "HARQ-ACK bit length", pdu.nof_harq_ack_bits, 0, 1706)
    _in_range(rep, m, p, "CSI part1 bit length", pdu.nof_csi_part1_bits, 0, 1706)
    if pdu.part2_size_map:
        if pdu.nof_csi_part1_bits < 1 or pdu.nof_csi_part1_bits > 11:
            rep.add(m, p, "CSI part1 bit length", pdu.nof_csi_part1_bits,
                    "1..11 when a part2 map indexes the part-1 value")
        elif len(pdu.part2_size_map) != (1 << pdu.nof_csi_part1_bits):
            rep.add(m, p, "CSI part2 map length", len(pdu.part2_size_map),
                    f"2**nof_csi_part1_bits = {1 << pdu.nof_csi_part1_bits}")
        for sz in pdu.part2_size_map:
            if not (0 <= sz <= 1706):
                rep.add(m, p, "CSI part2 size", sz, "0..1706")
    if pdu.dmrs_config_type not in (1, 2):
        rep.add(m, p, "DMRS config type", pdu.dmrs_config_type, "1 or 2")
    if pdu.hop_symbol is not None:
        if pdu.second_hop_prb is None:
            rep.add(m, p, "Second hop PRB", None, "set when hopping")
        else:
            _in_range(rep, m, p, "Second hop PRB", pdu.second_hop_prb, 0,
                      MAX_NOF_PRBS - pdu.rb_size)
        if not (pdu.start_symbol < pdu.hop_symbol
                < pdu.start_symbol + pdu.nof_symbols):
            rep.add(m, p, "Hop symbol", pdu.hop_symbol,
                    "inside the allocation's symbol span")
        if pdu.nof_layers != 1:
            rep.add(m, p, "Number of layers", pdu.nof_layers,
                    "1 with intra-slot hopping")
        if pdu.dmrs_config_type != 1:
            rep.add(m, p, "DMRS config type", pdu.dmrs_config_type,
                    "1 with intra-slot hopping")
        # Each hop needs at least one DM-RS symbol for its channel estimate.
        for hop, pred in ((0, lambda s: s < pdu.hop_symbol),
                          (1, lambda s: s >= pdu.hop_symbol)):
            if not any(pred(s) for s in pdu.dmrs_symbols):
                rep.add(m, p, "DMRS symbols", tuple(pdu.dmrs_symbols),
                        f"at least one DM-RS symbol in hop {hop}")
    _validate_alloc(rep, m, p, pdu.rb_start, pdu.rb_size, pdu.start_symbol,
                    pdu.nof_symbols, pdu.dmrs_symbols)
    if pdu.new_data and pdu.rv != 0:
        rep.add(m, p, "RV Index", pdu.rv, "0 when new_data (initial tx)")


def validate_pucch(pdu: pdus.PucchPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/ul_pucch_pdu.cpp + pucch_processor
    format 0/1/2 envelope (pucch_processor_impl.cpp:30-186)."""
    m, p = "ul_tti_request", "PUCCH"
    _in_range(rep, m, p, "RNTI", pdu.rnti, 1, MAX_RNTI)
    if pdu.format not in (0, 1, 2):
        rep.add(m, p, "PUCCH format", pdu.format, "{0, 1, 2} (as the reference)")
        return
    _in_range(rep, m, p, "Initial cyclic shift", pdu.initial_cyclic_shift, 0, 11)
    _in_range(rep, m, p, "nID PUCCH hopping", pdu.n_id, 0, MAX_NID)
    if pdu.format == 0:
        _in_range(rep, m, p, "Nr of symbols", pdu.nof_symbols, 1, 2)
        _in_range(rep, m, p, "HARQ bits", pdu.nof_harq_bits, 0, 2)
        if pdu.nof_prb != 1:
            rep.add(m, p, "PRB size", pdu.nof_prb, "1 for format 0")
    elif pdu.format == 1:
        _in_range(rep, m, p, "Nr of symbols", pdu.nof_symbols, 4, 14)
        _in_range(rep, m, p, "Time domain OCC", pdu.time_domain_occ, 0, 6)
        _in_range(rep, m, p, "HARQ bits", pdu.nof_harq_bits, 0, 2)
        if pdu.nof_prb != 1:
            rep.add(m, p, "PRB size", pdu.nof_prb, "1 for format 1")
    else:  # format 2
        _in_range(rep, m, p, "Nr of symbols", pdu.nof_symbols, 1, 2)
        _in_range(rep, m, p, "PRB size", pdu.nof_prb, 1, 16)
        _in_range(rep, m, p, "UCI payload bits", pdu.nof_uci_bits, 3, 1706)
    _in_range(rep, m, p, "PRB start", pdu.prb_start, 0, MAX_NOF_PRBS - 1)
    _in_range(rep, m, p, "Start symbol index", pdu.start_symbol, 0,
              NOF_OFDM_SYM_PER_SLOT - 1)
    if pdu.start_symbol + pdu.nof_symbols > NOF_OFDM_SYM_PER_SLOT:
        rep.add(m, p, "Start symbol + Nr of symbols",
                pdu.start_symbol + pdu.nof_symbols, f"<= {NOF_OFDM_SYM_PER_SLOT}")


def validate_prach(pdu: pdus.PrachPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/ul_prach_pdu.cpp + detector envelope
    (prach_detector_generic_thresholds.h validated combos)."""
    m, p = "ul_tti_request", "PRACH"
    max_root = MAX_PRACH_ROOT_LONG if pdu.format_is_long else MAX_PRACH_ROOT_SHORT
    _in_range(rep, m, p, "Root sequence index", pdu.root_sequence_index, 0, max_root)
    _in_range(rep, m, p, "Zero correlation zone", pdu.zero_correlation_zone, 0, MAX_ZCZ)
    _in_range(rep, m, p, "Nr of preamble indices", pdu.nof_preamble_indices, 1, 64)
    if pdu.restricted_set != 0:
        rep.add(m, p, "Restricted set", pdu.restricted_set,
                "0 (unrestricted; restricted type A/B pending)")


def validate_csi_rs(pdu: pdus.CsiRsPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/dl_csi_pdu.cpp."""
    m, p = "dl_tti_request", "CSI-RS"
    _in_range(rep, m, p, "Nr of RB", pdu.nof_rb, 1, MAX_NOF_PRBS)
    _in_range(rep, m, p, "Start RB", pdu.prb_start, 0, MAX_NOF_PRBS - 1)
    _in_range(rep, m, p, "Symbol", pdu.symbol, 0, 13)
    _in_range(rep, m, p, "Row", pdu.row, 1, 18)
    _in_range(rep, m, p, "Subcarrier offset", pdu.subcarrier_offset, 0, 11)
    _in_range(rep, m, p, "Scrambling id", pdu.scrambling_id, 0, 1023)
    if pdu.row in (13, 14, 16, 17):
        _in_range(rep, m, p, "Symbol l1", pdu.symbol_l1, pdu.symbol + 2, 13)


def validate_srs(pdu: pdus.SrsPdu, rep: ValidatorReport) -> None:
    """reference: lib/fapi/validators/ul_srs_pdu.cpp + srs_estimator envelope."""
    m, p = "ul_tti_request", "SRS"
    _in_range(rep, m, p, "Nr of RB", pdu.nof_rb, 4, MAX_NOF_PRBS)
    if pdu.comb_size not in (2, 4):
        rep.add(m, p, "Comb size", pdu.comb_size, "2 or 4")
    _in_range(rep, m, p, "Comb offset", pdu.comb_offset, 0, pdu.comb_size - 1)
    _in_range(rep, m, p, "Start symbol", pdu.start_symbol, 0, 13)
    _in_range(rep, m, p, "Nr of symbols", pdu.nof_symbols, 1, 4)
    _in_range(rep, m, p, "Sequence id", pdu.sequence_id, 0, 1023)
    nmax = 8 if pdu.comb_size == 2 else 12
    _in_range(rep, m, p, "Cyclic shift", pdu.cyclic_shift, 0, nmax - 1)
    if pdu.nof_antenna_ports not in (1, 2, 4):
        rep.add(m, p, "Nr of antenna ports", pdu.nof_antenna_ports, "1, 2 or 4")


def validate_dl_tti_request(req: pdus.DlTtiRequest) -> ValidatorReport:
    """Whole-message validation (reference: lib/fapi/message_validators.cpp)."""
    rep = ValidatorReport()
    for pdu in req.ssb:
        validate_ssb(pdu, rep)
    for pdu in req.pdcch:
        validate_pdcch(pdu, rep)
    for pdu in req.pdsch:
        validate_pdsch(pdu, rep)
    for pdu in req.csi_rs:
        validate_csi_rs(pdu, rep)
    return rep


def validate_ul_tti_request(req: pdus.UlTtiRequest) -> ValidatorReport:
    rep = ValidatorReport()
    for pdu in req.pusch:
        validate_pusch(pdu, rep)
    for pdu in req.pucch:
        validate_pucch(pdu, rep)
    for pdu in req.prach:
        validate_prach(pdu, rep)
    for pdu in req.srs:
        validate_srs(pdu, rep)
    return rep


def validate_tx_data_request(req: pdus.TxDataRequest,
                             dl_tti: pdus.DlTtiRequest) -> ValidatorReport:
    """tx_data PDUs must pair 1:1 with the slot's PDSCH PDUs
    (reference: fapi_to_phy_translator.cpp:582-641)."""
    rep = ValidatorReport()
    m, p = "tx_data_request", "TB"
    if req.slot != dl_tti.slot:
        rep.add(m, p, "slot", req.slot, f"== dl_tti slot {dl_tti.slot}")
    if len(req.tb_bits) != len(dl_tti.pdsch):
        rep.add(m, p, "Nr of TBs", len(req.tb_bits),
                f"== nr of PDSCH PDUs ({len(dl_tti.pdsch)})")
    return rep
