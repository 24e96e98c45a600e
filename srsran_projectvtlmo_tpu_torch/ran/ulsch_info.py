"""UL-SCH / UCI resource sizing on PUSCH, TS 38.212 Section 6.3.2.4.

Exact-arithmetic port of the reference derivation of how many resource
elements (and therefore encoded bits) each UCI field occupies when
multiplexed on PUSCH, and how many bits remain for the shared channel.
reference: lib/ran/pusch/ulsch_info.cpp:163-360 (get_ulsch_information),
include/srsran/ran/uci/uci_info.h (get_uci_crc_size).

All intermediate float expressions use float32 to mirror the reference's
single-precision `std::ceil` arguments.

The port's own copy of `srsran_projectvtlmo_tpu.ran.ulsch_info`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

NRE = 12


def uci_crc_size(nof_bits: int) -> int:
    """CRC bits attached to a UCI payload (TS 38.212 Sections 6.3.1.2.1/6.3.2.2.1)."""
    if nof_bits <= 11:
        return 0
    if nof_bits < 20:
        return 6
    return 11


def _ceil_f32(x: float) -> int:
    return int(math.ceil(np.float32(x)))


def _nof_re_uci_field(
    nof_payload_bits: int,
    beta_offset: float,
    nof_re_uci: int,
    sum_nof_cb_size: int,
    cap: int,
) -> int:
    """min(ceil((O+L)*beta*M_uci/sum K_r), cap) -- the with-SCH formula."""
    if nof_payload_bits == 0:
        return 0
    crc = uci_crc_size(nof_payload_bits)
    left = _ceil_f32(
        np.float32(nof_payload_bits + crc)
        * np.float32(beta_offset)
        * np.float32(nof_re_uci)
        / np.float32(sum_nof_cb_size)
    )
    return min(left, cap)


def _nof_re_uci_field_no_sch(
    nof_payload_bits: int,
    beta_offset: float,
    code_rate: float,
    qm: int,
    cap: int,
) -> int:
    if nof_payload_bits == 0:
        return 0
    crc = uci_crc_size(nof_payload_bits)
    left = _ceil_f32(
        np.float32(nof_payload_bits + crc)
        * np.float32(beta_offset)
        / (np.float32(code_rate) * np.float32(qm))
    )
    return min(left, cap)


@dataclass(frozen=True)
class UlschInformation:
    """Per-field RE and encoded-bit counts for one PUSCH transmission."""

    nof_harq_ack_re: int
    nof_harq_ack_rvd_re: int
    nof_csi_part1_re: int
    nof_csi_part2_re: int
    nof_ul_sch_re: int
    #: Encoded bits (RE * layers * Qm) per field.
    nof_ul_sch_bits: int
    nof_harq_ack_bits: int
    nof_harq_ack_rvd: int
    nof_csi_part1_bits: int
    nof_csi_part2_bits: int


def get_ulsch_information(
    *,
    nof_rb: int,
    start_symbol_index: int,
    nof_symbols: int,
    dmrs_symbols: tuple[int, ...],
    nof_layers: int,
    qm: int,
    target_code_rate: float,
    tbs: int,
    sum_nof_cb_size: int,
    nof_harq_ack_bits: int = 0,
    nof_csi_part1_bits: int = 0,
    nof_csi_part2_bits: int = 0,
    alpha_scaling: float = 1.0,
    beta_offset_harq_ack: float = 2.0,
    beta_offset_csi_part1: float = 2.0,
    beta_offset_csi_part2: float = 2.0,
    nof_cdm_groups_without_data: int = 2,
    nof_dmrs_re_per_prb_symbol: int = 6,
) -> UlschInformation:
    """reference: lib/ran/pusch/ulsch_info.cpp:163 (get_ulsch_information).

    `dmrs_symbols` are absolute OFDM symbol indices within the slot.
    `sum_nof_cb_size` is sum K_r = nof_cb * K (needed only when tbs > 0).
    """
    nof_symbols_dmrs = len(dmrs_symbols)
    nof_re_dmrs_per_rb = (
        nof_symbols_dmrs * nof_cdm_groups_without_data * nof_dmrs_re_per_prb_symbol
    )
    # Total REs available for UL data across the allocation.
    nof_re_total = nof_rb * (nof_symbols * NRE - nof_re_dmrs_per_rb)
    # REs that can potentially carry UCI (symbols without DM-RS only).
    nof_re_uci = (nof_symbols - nof_symbols_dmrs) * nof_rb * NRE
    # REs that can carry UCI from the first DM-RS symbol onwards.
    first_dmrs = min(dmrs_symbols)
    nof_re_uci_l0 = sum(
        nof_rb * NRE
        for sym in range(first_dmrs, start_symbol_index + nof_symbols)
        if sym not in dmrs_symbols
    )

    alpha_cap_l0 = _ceil_f32(np.float32(alpha_scaling) * np.float32(nof_re_uci_l0))
    alpha_cap = _ceil_f32(np.float32(alpha_scaling) * np.float32(nof_re_uci))

    # HARQ-ACK REs.
    if tbs > 0:
        nof_harq_ack_re = _nof_re_uci_field(
            nof_harq_ack_bits, beta_offset_harq_ack, nof_re_uci, sum_nof_cb_size,
            alpha_cap_l0,
        )
    else:
        nof_harq_ack_re = _nof_re_uci_field_no_sch(
            nof_harq_ack_bits, beta_offset_harq_ack, target_code_rate, qm,
            alpha_cap_l0,
        )

    # Reserved REs: computed as if the HARQ-ACK payload were 2 bits.
    nof_harq_ack_rvd_re = 0
    if nof_harq_ack_bits < 2:
        if tbs > 0:
            nof_harq_ack_rvd_re = _nof_re_uci_field(
                2, beta_offset_harq_ack, nof_re_uci, sum_nof_cb_size, alpha_cap_l0,
            )
        else:
            nof_harq_ack_rvd_re = _nof_re_uci_field_no_sch(
                2, beta_offset_harq_ack, target_code_rate, qm, alpha_cap_l0,
            )
    elif nof_harq_ack_bits == 2:
        nof_harq_ack_rvd_re = nof_harq_ack_re

    # CSI Part 1: for <=2 ACK bits the reserved ACK REs are subtracted instead
    # of the actual ones.
    ack_re_for_csi1 = nof_harq_ack_rvd_re if nof_harq_ack_bits <= 2 else nof_harq_ack_re
    if tbs > 0:
        nof_csi_part1_re = _nof_re_uci_field(
            nof_csi_part1_bits, beta_offset_csi_part1, nof_re_uci, sum_nof_cb_size,
            alpha_cap - ack_re_for_csi1,
        )
    elif nof_csi_part1_bits == 0:
        nof_csi_part1_re = 0
    elif nof_csi_part2_bits == 0:
        nof_csi_part1_re = nof_re_uci - ack_re_for_csi1
    else:
        nof_csi_part1_re = _nof_re_uci_field_no_sch(
            nof_csi_part1_bits, beta_offset_csi_part1, target_code_rate, qm,
            nof_re_uci - ack_re_for_csi1,
        )

    # CSI Part 2: for <=2 ACK bits the ACK REs are not subtracted at all.
    ack_re_for_csi2 = 0 if nof_harq_ack_bits <= 2 else nof_harq_ack_re
    if tbs > 0:
        nof_csi_part2_re = _nof_re_uci_field(
            nof_csi_part2_bits, beta_offset_csi_part2, nof_re_uci, sum_nof_cb_size,
            alpha_cap - ack_re_for_csi2 - nof_csi_part1_re,
        )
    elif nof_csi_part2_bits == 0:
        nof_csi_part2_re = 0
    else:
        nof_csi_part2_re = nof_re_uci - ack_re_for_csi2 - nof_csi_part1_re

    # SCH REs: only >2-bit HARQ-ACK REs are rate-matched around.
    nof_harq_ack_re_sch = nof_harq_ack_re if nof_harq_ack_bits > 2 else 0
    nof_re_ul_sch = (
        nof_re_total - nof_harq_ack_re_sch - nof_csi_part1_re - nof_csi_part2_re
        if tbs > 0
        else 0
    )

    bits_per_re = nof_layers * qm
    return UlschInformation(
        nof_harq_ack_re=nof_harq_ack_re,
        nof_harq_ack_rvd_re=nof_harq_ack_rvd_re,
        nof_csi_part1_re=nof_csi_part1_re,
        nof_csi_part2_re=nof_csi_part2_re,
        nof_ul_sch_re=nof_re_ul_sch,
        nof_ul_sch_bits=nof_re_ul_sch * bits_per_re,
        nof_harq_ack_bits=nof_harq_ack_re * bits_per_re,
        nof_harq_ack_rvd=nof_harq_ack_rvd_re * bits_per_re,
        nof_csi_part1_bits=nof_csi_part1_re * bits_per_re,
        nof_csi_part2_bits=nof_csi_part2_re * bits_per_re,
    )
