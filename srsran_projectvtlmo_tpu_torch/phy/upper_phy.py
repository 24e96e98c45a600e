"""Upper-PHY orchestration: the du_low-equivalent slot engine for one cell
(port of `srsran_projectvtlmo_tpu.phy.upper_phy`).

Consumes FAPI-shaped PDUs (`fapi.pdus`).  DL: SSB, PDCCH candidates,
precoded PDSCH and CSI-RS onto the cell's resource grids, then OFDM
modulation (`phy.dl_slot`).  UL: carrier OFDM demodulation once per slot,
then PUSCH (with the device-resident HARQ arena), PUCCH formats 0/1/2, SRS
and PRACH processing, producing CRC / RxData / UCI / SRS / RACH
indications.  Every tensor stays on one device, the card unless the caller
asks for the CPU; the host computes the per-slot sequences and fetches only
what an indication or a returned grid carries.

Replaces the reference's executor/pool machinery
(reference: lib/phy/upper/upper_phy_impl.h:46-130, upper_phy_factories.cpp,
downlink_processor_single_executor_impl.cpp, uplink_processor_impl.cpp:70-153)
with per-configuration cached plans and receivers: one per PDSCH/PUSCH shape
serves every UE and slot.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..fapi import validators as fapi_validators
from ..fapi.pdus import (
    CrcIndication, DlTtiRequest, RachIndication, RxDataIndication, SrsIndication,
    TxDataRequest, UciIndication, UlTtiRequest)
from ..models.pusch_rx import (
    PuschRxConfig, cached_demux_plan, cached_pusch_rx_from_grid, dmrs_reference, flatten_tb_bits)
from ..ops import ofdm as ofdm_mod
from ..ops import prach as prach_mod
from ..ops import prg as prg_mod
from ..ops import srs as srs_mod
from ..ops.ulsch_demux import placeholder_fix_signs
from ..ran.modulation import bits_per_symbol
from ..utils.cplx import np_to_pair, to_cplx
from ..utils import tables, tracing
from ..utils.tables import resolve_device, upload
from . import dl_slot
from . import pucch as pucch_mod
from .harq import RxBufferPool
from .prach_buffer import PrachBuffer
from .pusch_uci import PuschUciConfig, PuschUciProcessor

_LOG = logging.getLogger("upper_phy")


@dataclass
class ExpertPhyConfig:
    """Expert PHY knobs (reference: du_low_config.h:63-123).

    Every field is consumed: `pusch_decoder_max_iterations` sets the
    receivers' LDPC iteration budget (`pusch_config`, for `UpperPhy` and
    `parallel.multi_cell_phy`), `max_proc_delay_slots` the
    `phy.realtime.SlotPipeline` deadline budget, `log_level` the app's log
    level and `rx_symbols_filename` the rx-symbol capture file
    (`phy.rx_symbol_handler.RxSymbolFileDumper`); the last three are read by
    the simulator app (`apps.gnb_sim`).  The JAX config's
    `use_pallas_decoder` has no counterpart: the device picks the decoder
    (the CUDA kernel on the card, its plain version on the CPU).
    """

    pusch_decoder_max_iterations: int = 6
    max_proc_delay_slots: int = 2
    log_level: str = "warning"
    #: When set, completed UL slot grids append to this binary capture file
    #: (the reference's YAML `phy_rx_symbols_filename`,
    #: upper_phy_rx_symbol_handler_printer_decorator.h).
    rx_symbols_filename: str | None = None


@dataclass(frozen=True)
class CellConfig:
    """One cell's carrier.  The JAX config's `coreset_rb_start` has no
    counterpart: nothing reads it there either; the DL slot places each
    PDCCH candidate from its PDU's own `coreset_rb_start`."""

    nof_rb: int = 273
    dft_size: int = 4096
    numerology: int = 1
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    phys_cell_id: int = 1
    #: Subcarrier offset where the SSB sits in the carrier grid.
    ssb_subc_offset: int = 0
    #: Store the assembled DL resource grid as bfloat16 real pairs (the
    #: reference's cbf16 grid storage, lib/phy/support/resource_grid_impl.h:41-51).
    #: Assembly still ACCUMULATES in float32 (precoding, overlapping adds);
    #: only the materialized grid -- what the OFDM modulator reads and what
    #: the host fetches -- is quantized, to 2^-8 of the grid's peak per RE.
    grid_bf16: bool = True

    @property
    def nof_subc(self) -> int:
        return self.nof_rb * 12


def extract_pusch_allocation(grid: torch.Tensor, pdu) -> torch.Tensor:
    """Slice the PUSCH allocation out of batched carrier grids
    (B, P, 14, nsubc, 2) -> (B, P, nsym, nsub_alloc, 2), hop-aware: each
    symbol's rows come from that symbol's hop PRB (reference: per-hop RE
    extraction in the PUSCH demodulator)."""
    hop = getattr(pdu, "hop_symbol", None)
    k0 = pdu.rb_start * 12
    nsub = pdu.rb_size * 12
    s0, ns = pdu.start_symbol, pdu.nof_symbols
    if hop is None:
        return grid[:, :, s0:s0 + ns, k0:k0 + nsub, :]
    k1 = pdu.second_hop_prb * 12
    return torch.cat([grid[:, :, s0:hop, k0:k0 + nsub, :],
                      grid[:, :, hop:s0 + ns, k1:k1 + nsub, :]], dim=2)


def pusch_rx_key(cfg: PuschRxConfig) -> PuschRxConfig:
    """The cached dynamic-params receiver that serves cfg's PUSCH shape: rnti,
    n_id, the second-hop PRB and the slot beyond its place in the subframe
    are call inputs, normalized out of the key (rnti=0, n_id=0, second-hop
    PRB 0), so one receiver serves every UE and slot of one shape."""
    return dataclasses.replace(
        cfg, rnti=0, n_id=0, slot=cfg.slot % (1 << cfg.numerology), dynamic_params=True,
        second_hop_prb=0 if cfg.hop_symbol is not None else None)


def pusch_sequences(cfg: PuschRxConfig, plan=None):
    """The host inputs of the dynamic receiver for a PUSCH of cfg's values
    (rnti, n_id, absolute slot, second-hop PRB): (DM-RS reference pair
    (ndmrs, npil, 2) -- type 1/2, CRB-indexed, per-hop PRBs --, the
    descrambling bits (G,), their signs (G,) int8, and with a placement
    `plan` the UCI placeholder fix signs [ack, csi1, csi2], None for a field
    without bits)."""
    ref = np_to_pair(dmrs_reference(cfg))
    scr = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    fixes = None
    if plan is not None:
        qm = bits_per_symbol(cfg.modulation)
        fixes = [placeholder_fix_signs(idx, nbits, qm, scr) if nbits else None
                 for idx, nbits in ((plan.ack_bit_idx, cfg.nof_harq_ack_bits),
                                    (plan.csi1_bit_idx, cfg.nof_csi_part1_bits),
                                    (plan.csi2_bit_idx, cfg.nof_csi_part2_bits))]
    return ref, scr, 1 - 2 * scr.astype(np.int8), fixes


def _host(x) -> np.ndarray:
    """A device tensor (or a host array) as numpy; copying a tensor to the
    host waits for the device."""
    return tables.fetch(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def pusch_batch_key(pdu) -> tuple:
    """The PUSCH PDU fields that fix its receiver (`pusch_rx_key`), its slice
    of the carrier grid (the second-hop PRB) and its two-phase decision (the
    part-2 map): PDUs of one key run as rows of one `process_pusch_batch`
    call, their rnti, n_id, HARQ process and new-data flag riding per row."""
    return (pdu.rb_start, pdu.rb_size, pdu.modulation, pdu.target_code_rate,
            pdu.rv, pdu.nof_layers, pdu.start_symbol, pdu.nof_symbols,
            tuple(pdu.dmrs_symbols), pdu.nof_harq_ack_bits,
            getattr(pdu, "nof_csi_part1_bits", 0),
            tuple(getattr(pdu, "part2_size_map", ()) or ()),
            getattr(pdu, "dmrs_config_type", 1),
            getattr(pdu, "hop_symbol", None),
            getattr(pdu, "second_hop_prb", None))


def pusch_config(cell: CellConfig, expert: ExpertPhyConfig, slot: int, pdu, *,
                 nof_csi2: int, two_phase: bool) -> PuschRxConfig:
    """The PuschRxConfig of one PUSCH PDU on `cell` with its values (rnti,
    n_id, absolute slot, second-hop PRB); `pusch_rx_key` of it is the cached
    receiver's."""
    return PuschRxConfig(
        nof_rb=pdu.rb_size, modulation=pdu.modulation,
        target_code_rate=pdu.target_code_rate, nof_layers=pdu.nof_layers,
        nof_ofdm_symbols=pdu.nof_symbols,
        dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols),
        rv=pdu.rv, rnti=pdu.rnti, n_id=pdu.n_id,
        start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
        nof_rx_ports=cell.nof_rx_ports, dft_size=cell.dft_size,
        numerology=cell.numerology, slot=slot,
        nof_harq_ack_bits=getattr(pdu, "nof_harq_ack_bits", 0),
        nof_csi_part1_bits=getattr(pdu, "nof_csi_part1_bits", 0),
        nof_csi_part2_bits=0 if two_phase else nof_csi2,
        dmrs_config_type=getattr(pdu, "dmrs_config_type", 1),
        hop_symbol=getattr(pdu, "hop_symbol", None),
        second_hop_prb=getattr(pdu, "second_hop_prb", None),
        nof_ldpc_iterations=expert.pusch_decoder_max_iterations,
    )


def process_pusch_batch(cell: CellConfig, expert: ExpertPhyConfig, slot: int, pdus,
                        harq_pools, grid: torch.Tensor) -> tuple[list[list], int]:
    """B PUSCH PDUs of one `pusch_batch_key`, row b's on the carrier grid
    `grid[b]` ((B, P, 14, nsubc, 2) on the device) with its HARQ process in
    `harq_pools[b]`, through one call of the cached receiver of their shape.

    Every PDU runs through the dynamic-value receiver: the DM-RS reference
    (absolute slot + n_id, per-hop PRBs), the descrambling signs (rnti/n_id)
    and the UCI placeholder fix signs are per-row INPUTS, so one cached
    receiver per shape serves every UE, cell and slot -- including
    ACK/CSI-on-PUSCH, intra-slot hopping and DM-RS type 2 (reference analog:
    per-slot PDU churn, fapi_to_phy_translator.cpp:290-351).  CSI part 2
    with a varying part2_size_map runs the two-phase part1->part2 protocol
    (`PuschUciProcessor.phase_b_by_size`; reference:
    pusch_processor_impl.cpp:40-92).  The HARQ rows ride the batch:
    retransmitting rows bring their stored soft bits, new-data rows an
    all-zero row (the promotion sum is the identity on zeros), so one call
    serves any mix (reference: include/srsran/phy/upper/rx_buffer_pool.h:40-106).

    Returns (per row its CrcIndication, RxDataIndication and, with UCI, its
    UciIndication; the retransmissions decoded without their soft-combining
    history because their pool was exhausted).  The TB bits come to the
    host once, and only when some row passed its CRC.
    """
    dev = grid.device
    p0 = pdus[0]
    nof_ack = getattr(p0, "nof_harq_ack_bits", 0)
    nof_csi1 = getattr(p0, "nof_csi_part1_bits", 0)
    p2map = tuple(getattr(p0, "part2_size_map", ()) or ())
    const_csi2 = 0
    two_phase = False
    if nof_csi1 and p2map:
        if len(set(p2map)) == 1:
            const_csi2 = p2map[0]
        else:
            two_phase = True
    valued = [pusch_config(cell, expert, slot, pdu, nof_csi2=const_csi2, two_phase=two_phase)
              for pdu in pdus]
    rx_cfg = pusch_rx_key(valued[0])
    sub = extract_pusch_allocation(grid, p0)

    # The per-row host sequences (the span covers their host computation,
    # not the uploads): DM-RS references, descrambling signs and, with UCI
    # on PUSCH, placeholder fix signs.
    plan = None
    if nof_ack or nof_csi1:
        plan, _ = cached_demux_plan(rx_cfg, 0 if two_phase else const_csi2)
    with tracing.span("upper_phy.pusch_sequences"):
        seqs = [pusch_sequences(v, plan) for v in valued]  # (ref, scr, signs, fixes)
    ref_in = upload(np.stack([s[0] for s in seqs]), dev)
    signs_in = upload(np.stack([s[2] for s in seqs]), dev)
    uci_fix = None
    if plan is not None:
        uci_fix = tuple(None if seqs[0][3][k] is None else
                        upload(np.stack([s[3][k] for s in seqs]), dev, torch.int8)
                        for k in range(3))

    seg = rx_cfg.segmentation
    ncb, nbits = seg.nof_cb, seg.nof_cw_bits_per_cb
    buf_idxs, rows, dropped = [], [], 0
    for pool, pdu in zip(harq_pools, pdus):
        bi = pool.reserve(slot, pdu.rnti, pdu.harq_id, ncb, new_data=pdu.new_data)
        buf_idxs.append(bi)
        if bi is None and not pdu.new_data:
            dropped += 1
            _LOG.warning("HARQ pool exhausted: rnti=0x%x harq=%d retransmission "
                         "decodes without soft-combining history", pdu.rnti, pdu.harq_id)
        rows.append(pool.get_soft(bi, ncb, nbits)
                    if bi is not None and not pdu.new_data else None)
    harq_in = None
    if any(r is not None for r in rows):
        zeros = torch.zeros((ncb, nbits), dtype=torch.int8, device=dev)
        harq_in = torch.stack([zeros if r is None else r for r in rows])

    csi1_bits = csi1_metric = csi2_bits = csi2_metric = None
    if two_phase:
        proc = PuschUciProcessor(PuschUciConfig(rx=rx_cfg, part2_size_map=p2map), dev)
        res = proc.phase_a(sub, ref_in, signs_in, uci_fix)
        csi1_bits, csi1_metric = _host(res["csi1_bits"]), _host(res["csi1_metric"])
        out = proc.phase_b_by_size(res, csi1_bits, harq_in, [s[1] for s in seqs])
        csi2_bits, csi2_metric = out["csi2_bits"], out["csi2_metric"]
        ok = out["tb_crc_ok"]
    else:
        res = out = cached_pusch_rx_from_grid(rx_cfg, dev)(sub, harq_in, ref_in, signs_in,
                                                           uci_fix)
        ok = _host(out["tb_crc_ok"])
        if nof_csi1:
            csi1_bits, csi1_metric = _host(res["csi1_bits"]), _host(res["csi1_metric"])
        if const_csi2:
            csi2_bits, csi2_metric = _host(res["csi2_bits"]), _host(res["csi2_metric"])
    tb_bits = flatten_tb_bits(_host(out["tb_bits_cb"]), rx_cfg.tbs) if ok.any() else None
    if nof_ack:
        ack_bits, ack_metric = _host(res["harq_ack_bits"]), _host(res["harq_ack_metric"])

    inds = []
    for k, (pool, pdu) in enumerate(zip(harq_pools, pdus)):
        if buf_idxs[k] is not None:
            pool.store(buf_idxs[k], ncb, nbits, out["harq_soft"][k])
        row = [CrcIndication(slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                             tb_crc_ok=bool(ok[k])),
               RxDataIndication(slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                                tb_bits=tb_bits[k] if ok[k] else None)]
        if nof_ack or nof_csi1:
            uci = UciIndication(
                slot=slot, rnti=pdu.rnti,
                harq_bits=ack_bits[k] if nof_ack else np.empty(0, np.uint8),
                uci_bits=None,
                valid=bool(ack_metric[k] > 0.0) if nof_ack else bool(csi1_metric[k] > 0.0))
            if nof_csi1:
                uci.csi1_bits = csi1_bits[k]
                uci.csi1_valid = bool(csi1_metric[k] > 0.0)
            if csi2_bits is not None and csi2_bits[k] is not None and np.size(csi2_bits[k]):
                uci.csi2_bits = np.asarray(csi2_bits[k])
                uci.csi2_valid = bool(csi2_metric[k] > 0.0)
            row.append(uci)
        if ok[k]:
            pool.release(pdu.rnti, pdu.harq_id)
        inds.append(row)
    return inds, dropped


def dl_slot_on_device(program: dl_slot.DlSlotProgram, slot: int, requests, tx_datas):
    """The DL slots `requests` of `program`'s structure, one per batch row
    with its TxDataRequest (or None) in `tx_datas`, on the program's device:
    the host values, their upload and the slot program.  Returns the device
    tensors (grid (B, P, 14, nsubc, 2), samples (B, P, nsamples, 2)).  Spans:
    `upper_phy.dl_values` (inside it `dl_slot.host_values` and
    `dl_slot.upload`), then `dl_slot.run`."""
    with tracing.span("upper_phy.dl_values"):
        with tracing.span("dl_slot.host_values"):
            args = [program.value_args(r, dl_slot.build_dl_slot_inputs(program, r, d, slot))
                    for r, d in zip(requests, tx_datas)]
        stacked = program.stack_values(args)
    return program.run_stacked(slot, stacked)


class FapiValidationError(ValueError):
    """Raised when a slot message fails FAPI validation
    (reference: fapi message_validators reject + error.indication path)."""

    def __init__(self, report):
        self.report = report
        super().__init__("; ".join(str(e) for e in report.errors))


class UpperPhy:
    """One cell's upper PHY: DL slot assembly and UL slot processing, on
    `device`: the card unless the caller asks for the CPU.  The HARQ arena
    and the DL plans' index tables live there too."""

    def __init__(self, cfg: CellConfig, expert: ExpertPhyConfig | None = None, device="cuda"):
        self.cfg = cfg
        self.expert = expert or ExpertPhyConfig()
        self.device = resolve_device(device)
        self.harq_pool = RxBufferPool(device=self.device)
        #: PRACH occasions skipped because their capture buffer was not fully
        #: filled (late/lost symbols): detecting on zero-padded symbols would
        #: dilute the correlation peak against thresholds calibrated for full
        #: S-symbol combining and silently miss real preambles.
        self.nof_dropped_prach_occasions = 0
        #: Retransmissions decoded WITHOUT their soft-combining history
        #: because the HARQ rx-buffer pool was exhausted (the reference flags
        #: pool exhaustion, rx_buffer_pool_impl.cpp reserve failure path).
        self.nof_dropped_harq_reservations = 0

    # ------------------------------------------------------------------ DL --

    def process_dl_slot(self, request: DlTtiRequest, tx_data: TxDataRequest | None = None,
                        validate: bool = True, fetch: bool = True):
        """Build the DL slot and return (grid (nports, nsym, nsubc) complex64
        -- squeezed to (nsym, nsubc) for single-port cells -- and the OFDM
        samples (..., nsamples, 2) float32), numpy.

        With fetch=False the device tensors (grid real pair (P, 14, nsubc, 2),
        samples (P, nsamples, 2)) come back without a sync, so callers can
        pipeline slots (`phy.realtime.SlotPipeline`).

        The slot structure selects a cached `phy.dl_slot.DlSlotProgram`; the
        host computes the slot's values (TB bits, scrambling planes, DM-RS,
        PDCCH symbols, the SSB block, CSI-RS pilots) and uploads them, one
        pinned copy per dtype.  Spans (`utils.tracing`), in order:
        `upper_phy.dl_validate`, `upper_phy.dl_plan`, `upper_phy.dl_values`
        (`dl_slot.host_values`, `dl_slot.upload`), `dl_slot.run` and, with
        fetch=True, `upper_phy.dl_fetch` (on a card `upper_phy.dl_fetch_wait`
        inside: `utils.tables.fetch_dl_outputs`).
        """
        with tracing.entry("upper_phy.process_dl_slot"):
            if validate:
                with tracing.span("upper_phy.dl_validate"):
                    rep = fapi_validators.validate_dl_tti_request(request)
                    if tx_data is not None:
                        rep.errors.extend(
                            fapi_validators.validate_tx_data_request(tx_data, request).errors)
                if not rep.ok:
                    raise FapiValidationError(rep)
            slot = request.slot
            with tracing.span("upper_phy.dl_plan"):
                program = dl_slot.get_dl_slot_program(request, self.cfg, self.device)
            grid_pair, samples = dl_slot_on_device(program, slot, [request], [tx_data])
            if not fetch:
                return grid_pair[0], samples[0]
            with tracing.span("upper_phy.dl_fetch"):
                grid, samples = tables.fetch_dl_outputs(grid_pair[0], samples[0],
                                                        complex_grid=True)
                if self.cfg.nof_tx_ports == 1:
                    return grid[0], samples[0]
                return grid, samples

    # ------------------------------------------------------------------ UL --

    def process_ul_slot(self, request: UlTtiRequest, samples,
                        prach_samples: np.ndarray | PrachBuffer | None = None,
                        validate: bool = True) -> list:
        """Process one UL slot.

        Args:
          request: the slot's UL PDUs.
          samples: (nof_rx_ports, nsamples, 2) received baseband, numpy or a
            tensor.
          prach_samples: optional frequency-domain PRACH occasion -- either an
            (L, 2) single-port array, or a `phy.prach_buffer.PrachBuffer`
            filled by the lower-PHY occasion collector; with a buffer, each
            PRACH PDU selects its occasion via its `fd_occasion` attribute
            (default 0) and all ports are combined non-coherently.

        Returns a list of indication objects.  Spans (`utils.tracing`):
        `upper_phy.ul_validate`, `upper_phy.ul_ofdm` (the samples' upload
        and the carrier OFDM demodulation), the PUSCH receiver's, and
        `upper_phy.pucch`, `upper_phy.srs`, `upper_phy.prach` per PDU.
        """
        with tracing.entry("upper_phy.process_ul_slot"):
            return self._process_ul_slot(request, samples, prach_samples, validate)

    def _process_ul_slot(self, request, samples, prach_samples, validate) -> list:
        if validate:
            with tracing.span("upper_phy.ul_validate"):
                rep = fapi_validators.validate_ul_tti_request(request)
            if not rep.ok:
                raise FapiValidationError(rep)
        cfg = self.cfg
        slot = request.slot
        indications: list = []

        grid = None
        if request.pusch or request.pucch or request.srs:
            with tracing.span("upper_phy.ul_ofdm"):
                x = upload(samples, self.device, torch.float32)
                grid = ofdm_mod.ofdm_demodulate(x, cfg.nof_subc, cfg.dft_size, cfg.numerology,
                                                slot % (1 << cfg.numerology))  # (P, 14, nsubc, 2)

        for pdu in request.pusch:
            inds, dropped = process_pusch_batch(cfg, self.expert, slot, [pdu], [self.harq_pool],
                                                grid[None])
            self.nof_dropped_harq_reservations += dropped
            indications.extend(inds[0])

        for pdu in request.pucch:
            with tracing.span("upper_phy.pucch"):
                indications.append(self._process_pucch(slot, pdu, grid))

        for pdu in request.srs:
            with tracing.span("upper_phy.srs"):
                indications.append(self._process_srs(slot, pdu, grid, samples))

        if prach_samples is not None:
            for pdu in request.prach:
                with tracing.span("upper_phy.prach"):
                    ind = self._process_prach(slot, pdu, prach_samples)
                if ind is not None:
                    indications.append(ind)

        return indications

    def _process_prach(self, slot, pdu, prach_samples) -> RachIndication | None:
        """One PRACH PDU's detection; None where its occasion was dropped."""
        det_cfg = prach_mod.PrachDetectorConfig(
            sequence_length=prach_mod.LONG if pdu.format_is_long else prach_mod.SHORT,
            root_sequence_index=pdu.root_sequence_index,
            zero_correlation_zone=pdu.zero_correlation_zone,
            ncs_table="1.25kHz" if pdu.format_is_long else "short",
        )
        if isinstance(prach_samples, PrachBuffer):
            if not prach_samples.full:
                # Partially-captured occasion: skip detection rather than
                # combine all-zero symbols (see nof_dropped_prach_occasions).
                self.nof_dropped_prach_occasions += 1
                _LOG.warning("PRACH occasion at slot %d dropped: capture "
                             "buffer not fully filled", slot)
                return None
            # (S, P, L, 2) occasion -> (1, P, S, L, 2) detector input with
            # multi-port non-coherent combining.
            occ = np.transpose(prach_samples.occasion(getattr(pdu, "fd_occasion", 0)),
                               (1, 0, 2, 3))[None]
        else:
            occ = np.asarray(prach_samples)[None]
        dets = prach_mod.prach_detect(upload(occ, self.device, torch.float32), det_cfg)[0]
        return RachIndication(slot=slot, preambles=dets)

    def _process_srs(self, slot, pdu, grid, samples) -> SrsIndication:
        """Dispatch one SRS PDU: comb-RE extraction + channel/TA estimate ->
        SrsIndication (reference: lib/phy/upper/uplink_processor_impl.cpp
        process_srs, srs_estimator_generic_impl.cpp).  `samples` is the slot's
        raw baseband, kept in the signature of the JAX dispatcher."""
        scfg = srs_mod.SrsConfig(
            nof_rb=pdu.nof_rb, comb_size=pdu.comb_size,
            comb_offset=pdu.comb_offset, start_symbol=pdu.start_symbol,
            nof_symbols=pdu.nof_symbols, sequence_id=pdu.sequence_id,
            cyclic_shift=pdu.cyclic_shift,
            nof_antenna_ports=pdu.nof_antenna_ports,
        )
        k0 = pdu.prb_start * 12
        sub = grid[None, :, pdu.start_symbol:pdu.start_symbol + pdu.nof_symbols,
                   k0:k0 + pdu.nof_rb * 12, :]
        est = srs_mod.srs_estimate(sub, scfg)
        return SrsIndication(
            slot=slot, rnti=pdu.rnti, channel=_host(to_cplx(est["ce_pair"]))[0],
            noise_var=float(np.mean(_host(est["noise_var"]))),
            time_alignment_s=float(np.mean(_host(est["ta_s"]))),
        )

    def _process_pucch(self, slot, pdu, grid) -> UciIndication:
        # Slice the allocation out of the device grid for ALL rx ports --
        # (1, P, S, 12*nof_prb, 2) -- and hand it to the detector; the
        # reference combines every configured port
        # (pucch_detector_impl.cpp:225-241) and reads REs from the shared
        # grid without copying it off the device.
        k0 = pdu.prb_start * 12
        sub = grid[:, pdu.start_symbol:pdu.start_symbol + pdu.nof_symbols,
                   k0:k0 + pdu.nof_prb * 12, :][None]
        if pdu.format == 0:
            f0 = pucch_mod.PucchFormat0Config(
                n_id=pdu.n_id, slot=slot, start_symbol=pdu.start_symbol,
                nof_symbols=pdu.nof_symbols,
                initial_cyclic_shift=pdu.initial_cyclic_shift,
                nof_harq_bits=pdu.nof_harq_bits, sr_opportunity=pdu.sr_opportunity,
            )
            bits, metric, sr = pucch_mod.detect_pucch_format0(sub, f0)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=_host(bits)[0], uci_bits=None,
                                 valid=bool(_host(metric)[0] > 1.0),
                                 sr_detected=bool(_host(sr)[0]))
        if pdu.format == 1:
            hop = getattr(pdu, "second_hop_prb", None)
            f1 = pucch_mod.PucchFormat1Config(
                n_id=pdu.n_id, slot=slot, start_symbol=pdu.start_symbol,
                nof_symbols=pdu.nof_symbols,
                initial_cyclic_shift=pdu.initial_cyclic_shift,
                time_domain_occ=pdu.time_domain_occ, nof_harq_bits=pdu.nof_harq_bits,
                intra_slot_hopping=hop is not None,
            )
            if hop is not None:
                # Second-hop symbols take their 12 REs from the hop's PRB
                # (still on the device, all ports).
                half = pdu.nof_symbols // 2
                k1 = hop * 12
                s0, s1 = pdu.start_symbol, pdu.start_symbol + pdu.nof_symbols
                sub = torch.cat([grid[:, s0:s0 + half, k0:k0 + 12, :],
                                 grid[:, s0 + half:s1, k1:k1 + 12, :]], dim=1)[None]
            bits, metric = pucch_mod.detect_pucch_format1(sub, f1)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=_host(bits)[0], uci_bits=None,
                                 valid=bool(_host(metric)[0] > 1.0))
        if pdu.format == 2:
            f2 = pucch_mod.PucchFormat2Config(
                n_id=pdu.n_id, n_id0=pdu.n_id0, rnti=pdu.rnti, slot=slot,
                start_symbol=pdu.start_symbol, nof_symbols=pdu.nof_symbols,
                nof_prb=pdu.nof_prb, nof_uci_bits=pdu.nof_uci_bits,
            )
            bits, ok = pucch_mod.process_pucch_format2(sub, f2)
            return UciIndication(slot=slot, rnti=pdu.rnti,
                                 harq_bits=np.empty(0, np.uint8),
                                 uci_bits=_host(bits)[0],
                                 valid=bool(_host(ok)[0]))
        raise ValueError(f"unsupported PUCCH format {pdu.format}")
