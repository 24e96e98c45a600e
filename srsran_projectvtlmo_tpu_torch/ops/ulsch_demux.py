"""UL-SCH / UCI multiplexing on PUSCH: exact TS 38.212 Section 6.2.7 placement.

The reference implements a streaming per-symbol demultiplexer state machine
(reference: lib/phy/upper/channel_processors/pusch/ulsch_demultiplex_impl.cpp:
configure_current_ofdm_symbol :331-448, re_set_select :75-96, placeholder
reversal :105-194).  Here the same algorithm runs once on the host per static
configuration and emits a `UlschDemuxPlan` of precomputed gather indices; the
transmitter and receiver share the plan, so the jitted programs contain only
gathers/scatters.

Placement algorithm (per OFDM symbol of the allocation, in time order):
  step 1: reserve REs for potential HARQ-ACK (payload <= 2 bits) from the
          first data symbol after the first DM-RS symbol (l1), evenly strided;
  step 2: HARQ-ACK payload > 2 bits: allocate ACK REs (rate-matched around);
  step 3: CSI part 1 from the first data symbol (l1_csi), skipping reserved;
  step 3bis: CSI part 2 from the remaining UCI REs (may overlap reserved);
  step 5: HARQ-ACK payload <= 2 bits: place ACK inside the reserved REs --
          these REs still carry SCH/CSI2 data, which the receiver punctures.

Scope matching the reference processor (pusch_processor_impl.cpp:311-312):
DM-RS config type 1, 2 CDM groups without data => DM-RS symbols carry no data
REs, so the codeword stream covers exactly the non-DM-RS symbols.

The port's own copy of `srsran_projectvtlmo_tpu.ops.ulsch_demux`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np


def _re_set_select(avail: np.ndarray, d: int, m_re_count: int) -> np.ndarray:
    """First `m_re_count` elements of the set, taking every d-th candidate.

    reference: ulsch_demultiplex_impl.cpp:75-96 (re_set_select).
    """
    positions = np.flatnonzero(avail)
    picked = positions[::d][:m_re_count]
    assert len(picked) == m_re_count, "insufficient REs for UCI selection"
    out = np.zeros_like(avail)
    out[picked] = True
    return out


@dataclass(frozen=True)
class UlschDemuxPlan:
    """Static gather plan for one PUSCH codeword.

    All `*_bit_idx` arrays index the flattened codeword softbit stream
    (symbol-major, RE order, `layers*qm` bits per RE) in field order.
    """

    nof_bits_per_re: int
    qm: int
    #: SCH softbit positions (length G_sch), in stream order.
    sch_bit_idx: np.ndarray
    #: HARQ-ACK softbit positions (length G_ack).
    ack_bit_idx: np.ndarray
    #: CSI part 1 / part 2 softbit positions.
    csi1_bit_idx: np.ndarray
    csi2_bit_idx: np.ndarray
    #: HARQ-ACK payload <= 2 bits: ACK REs puncture the SCH/CSI2 stream; the
    #: receiver zeroes these positions (same values as ack_bit_idx then).
    punct_bit_idx: np.ndarray
    nof_harq_ack_bits: int
    nof_csi_part1_bits: int
    nof_csi_part2_bits: int

    def field_bit_idx(self, name: str) -> np.ndarray:
        return {"ack": self.ack_bit_idx, "csi1": self.csi1_bit_idx,
                "csi2": self.csi2_bit_idx}[name]

    def field_payload(self, name: str) -> int:
        return {"ack": self.nof_harq_ack_bits, "csi1": self.nof_csi_part1_bits,
                "csi2": self.nof_csi_part2_bits}[name]


@functools.lru_cache(maxsize=None)
def build_ulsch_demux_plan(
    *,
    nof_prb: int,
    start_symbol_index: int,
    nof_symbols: int,
    dmrs_symbols: tuple[int, ...],
    qm: int,
    nof_layers: int,
    nof_harq_ack_bits: int = 0,
    nof_enc_harq_ack_bits: int = 0,
    nof_harq_ack_rvd: int = 0,
    nof_csi_part1_bits: int = 0,
    nof_enc_csi_part1_bits: int = 0,
    nof_csi_part2_bits: int = 0,
    nof_enc_csi_part2_bits: int = 0,
) -> UlschDemuxPlan:
    """Run the reference placement state machine over the whole allocation.

    `dmrs_symbols` are absolute symbol indices; encoded-bit counts come from
    `ran.ulsch_info.get_ulsch_information`.
    """
    nre = 12
    nof_bits_per_re = qm * nof_layers
    dmrs_set = set(dmrs_symbols)
    end_symbol = start_symbol_index + nof_symbols

    # l1: first non-DM-RS symbol after the first DM-RS symbol.
    first_dmrs = min(dmrs_set)
    l1 = next(s for s in range(first_dmrs, end_symbol) if s not in dmrs_set)
    # l1_csi: first non-DM-RS symbol of the allocation.
    l1_csi = next(s for s in range(start_symbol_index, end_symbol)
                  if s not in dmrs_set)

    m_rvd_count = 0
    m_harq_ack_count = 0
    m_csi_part1_count = 0
    m_csi_part2_count = 0

    sch_re: list[np.ndarray] = []
    ack_re: list[np.ndarray] = []
    csi1_re: list[np.ndarray] = []
    csi2_re: list[np.ndarray] = []

    stream_re_offset = 0
    for sym in range(start_symbol_index, end_symbol):
        if sym in dmrs_set:
            # 2 CDM groups without data: no data REs on DM-RS symbols.
            continue
        m_ulsch = nof_prb * nre
        ulsch_set = np.ones(m_ulsch, bool)
        uci_set = np.ones(m_ulsch, bool)
        rvd_set = np.zeros(m_ulsch, bool)
        ack_set = np.zeros(m_ulsch, bool)
        csi1_set = np.zeros(m_ulsch, bool)
        csi2_set = np.zeros(m_ulsch, bool)

        # Step 1: reserve potential REs for <=2-bit HARQ-ACK.
        m_uci = int(uci_set.sum())
        rem_rvd = (nof_harq_ack_rvd - m_rvd_count) // nof_bits_per_re
        if sym >= l1 and m_uci > 0 and rem_rvd > 0:
            d, m_re_count = 1, m_uci
            if rem_rvd < m_uci:
                d, m_re_count = m_uci // rem_rvd, rem_rvd
            rvd_set = _re_set_select(ulsch_set, d, m_re_count)
            m_rvd_count += m_re_count * nof_bits_per_re

        # Step 2: >2-bit HARQ-ACK (rate-matched around).
        rem_ack = (nof_enc_harq_ack_bits - m_harq_ack_count) // nof_bits_per_re
        if sym >= l1 and m_uci > 0 and nof_harq_ack_bits > 2 and rem_ack > 0:
            d, m_re_count = 1, m_uci
            if rem_ack < m_uci:
                d, m_re_count = m_uci // rem_ack, rem_ack
            ack_set = _re_set_select(uci_set, d, m_re_count)
            ulsch_set &= ~ack_set
            uci_set &= ~ack_set
            m_uci = int(uci_set.sum())
            m_harq_ack_count += m_re_count * nof_bits_per_re

        # Step 3: CSI part 1 (never on reserved REs).
        rem_csi1 = (nof_enc_csi_part1_bits - m_csi_part1_count) // nof_bits_per_re
        m_rvd = int(rvd_set.sum())
        if sym >= l1_csi and (m_uci - m_rvd) > 0 and rem_csi1 > 0:
            d, m_re_count = 1, m_uci - m_rvd
            if rem_csi1 < (m_uci - m_rvd):
                d, m_re_count = (m_uci - m_rvd) // rem_csi1, rem_csi1
            csi1_set = _re_set_select(uci_set & ~rvd_set, d, m_re_count)
            ulsch_set &= ~csi1_set
            uci_set &= ~csi1_set
            m_csi_part1_count += m_re_count * nof_bits_per_re

        # Step 3bis: CSI part 2 (may land on reserved REs).
        m_uci = int(uci_set.sum())
        rem_csi2 = (nof_enc_csi_part2_bits - m_csi_part2_count) // nof_bits_per_re
        if sym >= l1_csi and m_uci > 0 and rem_csi2 > 0:
            d, m_re_count = 1, m_uci
            if rem_csi2 < m_uci:
                d, m_re_count = m_uci // rem_csi2, rem_csi2
            csi2_set = _re_set_select(uci_set, d, m_re_count)
            ulsch_set &= ~csi2_set
            uci_set &= ~csi2_set
            m_csi_part2_count += m_re_count * nof_bits_per_re

        # Step 5: <=2-bit HARQ-ACK inside the reserved REs (puncturing).
        if m_rvd > 0 and nof_harq_ack_bits <= 2 and rem_ack > 0:
            d, m_re_count = 1, m_rvd
            if rem_ack < m_rvd:
                d, m_re_count = m_rvd // rem_ack, rem_ack
            ack_set = _re_set_select(rvd_set, d, m_re_count)
            m_harq_ack_count += m_re_count * nof_bits_per_re

        sch_re.append(np.flatnonzero(ulsch_set) + stream_re_offset)
        ack_re.append(np.flatnonzero(ack_set) + stream_re_offset)
        csi1_re.append(np.flatnonzero(csi1_set) + stream_re_offset)
        csi2_re.append(np.flatnonzero(csi2_set) + stream_re_offset)
        stream_re_offset += m_ulsch

    def _bits(re_lists: list[np.ndarray]) -> np.ndarray:
        res = np.concatenate(re_lists) if re_lists else np.empty(0, np.int64)
        return (res[:, None] * nof_bits_per_re
                + np.arange(nof_bits_per_re)[None, :]).reshape(-1).astype(np.int64)

    ack_bit_idx = _bits(ack_re)
    assert len(ack_bit_idx) == nof_enc_harq_ack_bits, \
        (len(ack_bit_idx), nof_enc_harq_ack_bits)
    csi1_bit_idx = _bits(csi1_re)
    assert len(csi1_bit_idx) == nof_enc_csi_part1_bits
    csi2_bit_idx = _bits(csi2_re)
    assert len(csi2_bit_idx) == nof_enc_csi_part2_bits
    sch_bit_idx = _bits(sch_re)
    punct = ack_bit_idx if nof_harq_ack_bits <= 2 else np.empty(0, np.int64)

    return UlschDemuxPlan(
        nof_bits_per_re=nof_bits_per_re,
        qm=qm,
        sch_bit_idx=sch_bit_idx,
        ack_bit_idx=ack_bit_idx,
        csi1_bit_idx=csi1_bit_idx,
        csi2_bit_idx=csi2_bit_idx,
        punct_bit_idx=punct,
        nof_harq_ack_bits=nof_harq_ack_bits,
        nof_csi_part1_bits=nof_csi_part1_bits,
        nof_csi_part2_bits=nof_csi_part2_bits,
    )


def placeholder_masks(nof_payload_bits: int, nof_field_bits: int, qm: int):
    """(x_mask, y_mask) over a field's encoded bits for 1/2-bit payloads.

    TS 38.212 Tables 5.3.3.1-1 / 5.3.3.2-1: with payload 1, every Qm-group is
    [c0, y, x, ..., x]; with payload 2, [ci, cj, x, ..., x].  Empty masks for
    payloads >= 3 (no placeholders) or Qm == 1.
    """
    x = np.zeros(nof_field_bits, bool)
    y = np.zeros(nof_field_bits, bool)
    if nof_payload_bits == 0 or nof_payload_bits > 2 or qm == 1:
        return x, y
    pos = np.arange(nof_field_bits) % qm
    if nof_payload_bits == 1:
        y |= pos == 1
        x |= pos >= 2
    else:
        x |= pos >= 2
    return x, y


def placeholder_fix_signs(
    bit_idx: np.ndarray, nof_payload_bits: int, qm: int, scr_bits: np.ndarray
) -> np.ndarray:
    """Receiver-side descrambling reversal for placeholder positions.

    After global descrambling (multiply by s_i = 1-2c_i), placeholder 'x' bits
    must be re-multiplied by s_i (they were transmitted as fixed 1) and 'y'
    bits by s_{i-1} * s_i (they repeat the previous *scrambled* bit).
    reference: ulsch_demultiplex_impl.cpp:105-194 (on_uci_placeholder_{1,2}bit).

    Returns int8 signs (length of bit_idx) to multiply the extracted LLRs by.
    """
    x_mask, y_mask = placeholder_masks(nof_payload_bits, len(bit_idx), qm)
    s = (1 - 2 * scr_bits.astype(np.int8))
    signs = np.ones(len(bit_idx), np.int8)
    signs[x_mask] = s[bit_idx[x_mask]]
    signs[y_mask] = s[bit_idx[y_mask]] * s[bit_idx[y_mask] - 1]
    return signs


def scramble_codeword_with_placeholders(
    codeword_bits: np.ndarray,
    scr_bits: np.ndarray,
    plan: UlschDemuxPlan,
) -> tuple[np.ndarray, np.ndarray]:
    """(effective scrambling mask, force-one mask) for the TX side.

    TS 38.211 Section 6.3.1.1: scrambled bit = 1 where the codeword carries an
    'x' placeholder; = previous scrambled bit where it carries 'y'.  Both are
    static index rewrites: y positions scramble with the previous position's
    mask (the encoder already sets the y bit value to the previous bit value),
    x positions override to 1.  Returns (mask, force_one) host arrays the
    jitted transmitter applies as `out = where(force_one, 1, bits ^ mask)`.
    """
    del codeword_bits  # shape only; masks are static
    g = len(scr_bits)
    mask = scr_bits.astype(np.uint8).copy()
    force_one = np.zeros(g, bool)
    for name in ("ack", "csi1", "csi2"):
        idx = plan.field_bit_idx(name)
        if not len(idx):
            continue
        x_mask, y_mask = placeholder_masks(plan.field_payload(name), len(idx), plan.qm)
        force_one[idx[x_mask]] = True
        mask[idx[y_mask]] = mask[idx[y_mask] - 1]
    return mask, force_one
