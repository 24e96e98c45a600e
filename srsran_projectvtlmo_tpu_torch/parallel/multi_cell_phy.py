"""Multi-cell du_low: FAPI PDU sets per cell, cells batched on the mesh's
"cell" axis (port of `srsran_projectvtlmo_tpu.parallel.multi_cell_phy`).

The reference's du_low owns one independent upper_phy per cell
(reference: lib/du_low/du_low_impl.h:31-48).  Here cells with the same slot
*structure* batch into one call of one cached program: PUSCH PDUs of one
shape through the dynamic-params receiver, whose per-cell values (DM-RS
references, descrambling and UCI fix signs) ride as per-row inputs, and DL
slots of one plan through one `DlSlotProgram.run_stacked`.  Heterogeneous
structures go through each cell's own `UpperPhy` (same results, no batching
win).

Each rank of a cell axis larger than one serves the contiguous block of
cells at its "cell" coordinate and returns every cell's results: the
indications through all_gather_object, the DL grids and samples through
all_gather_into_tensor.  At world 1 (one process, one card) every cell rides
the batch axis of one program.

Two departures from the JAX class, both repairs:
  * one HARQ arena per cell: `harq_pools[c]` is `cell_phys[c].harq_pool`, so
    a retransmission keeps its soft bits when it changes between the
    batched and the per-cell path (the JAX class gives each cell a second
    arena of its own for the batched path);
  * `process_dl_slot(fetch=True)` returns real pairs (ncell, P, 14, nsubc, 2)
    and (ncell, P, nsamples, 2) on both paths, as its docstring says (the
    JAX fallback stacks `UpperPhy.process_dl_slot(fetch=True)`'s complex
    grids, port-squeezed for 1-port cells).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from ..fapi.pdus import CrcIndication, RxDataIndication, UciIndication, UlTtiRequest
from ..models.pusch_rx import (
    cached_demux_plan, cached_pusch_phase_b, cached_pusch_rx_from_grid, flatten_tb_bits)
from ..ops import ofdm as ofdm_mod
from ..phy import dl_slot as dl_mod
from ..phy.pusch_uci import PuschUciConfig, PuschUciProcessor, _phase_b_cfg
from ..phy.upper_phy import (
    CellConfig, ExpertPhyConfig, UpperPhy, _host, extract_pusch_allocation, pusch_rx_key,
    pusch_sequences)
from ..utils import tables, tracing
from ..utils.tables import resolve_device, upload
from .distributed import RanMesh, make_ran_mesh
from .mesh import block, gather, gather_objects

_LOG = logging.getLogger("multi_cell_phy")


def _static_key(pdu) -> tuple:
    """Shape-determining PUSCH PDU fields (params that may vary per cell ride
    as inputs instead).  The second-hop PRB and the part2 map are included so
    one batched grid slice / one host decision table serves every cell."""
    return (pdu.rb_start, pdu.rb_size, pdu.modulation, pdu.target_code_rate,
            pdu.rv, pdu.nof_layers, pdu.start_symbol, pdu.nof_symbols,
            tuple(pdu.dmrs_symbols), pdu.nof_harq_ack_bits,
            getattr(pdu, "nof_csi_part1_bits", 0),
            tuple(getattr(pdu, "part2_size_map", ()) or ()),
            getattr(pdu, "dmrs_config_type", 1),
            getattr(pdu, "hop_symbol", None),
            getattr(pdu, "second_hop_prb", None))


class MultiCellUpperPhy:
    """N same-carrier cells, batched per slot structure, on `device` (the
    card unless the caller asks for the CPU).  `cell_phys[c]` is cell c's
    `UpperPhy` on the rank that serves it, None elsewhere."""

    def __init__(self, cfg: CellConfig, nof_cells: int, ran_mesh: RanMesh | None = None,
                 expert: ExpertPhyConfig | None = None, device="cuda"):
        self.cfg = cfg
        self.nof_cells = nof_cells
        self.expert = expert or ExpertPhyConfig()
        self.device = resolve_device(device)
        self.rmesh = ran_mesh or make_ran_mesh(device=self.device)
        #: The cells this rank serves: its block of the cell axis.
        self.cells = range(nof_cells)[block(nof_cells, self.rmesh.mesh, "cell")]
        self.cell_phys = [UpperPhy(cfg, self.expert, self.device) if c in self.cells else None
                          for c in range(nof_cells)]
        #: One HARQ arena per cell, shared by the batched and the per-cell path.
        self.harq_pools = [None if p is None else p.harq_pool for p in self.cell_phys]
        #: Retransmissions of the batched path whose soft-combining history
        #: was lost to HARQ pool exhaustion (decoded against a zero buffer,
        #: store skipped) -- the reference flags pool exhaustion rather than
        #: losing it silently.
        self.nof_dropped_harq_reservations = 0

    # ------------------------------------------------------------------ DL --

    def process_dl_slot(self, requests, tx_datas=None, fetch: bool = False):
        """Assemble one DL slot for every cell: one batched `DlSlotProgram`
        call when all cells share the slot structure, per-cell dispatch
        otherwise.

        Args:
          requests: one DlTtiRequest per cell.
          tx_datas: optional list of TxDataRequest per cell.

        Returns (grids (ncell, P, 14, nsubc, 2), samples (ncell, P,
        nsamples, 2)): device tensors (the grid bf16 with `grid_bf16`), or
        float32 numpy with fetch=True.  The spans are `UpperPhy`'s.
        """
        with tracing.entry("multi_cell_phy.process_dl_slot"):
            assert len(requests) == self.nof_cells
            tx_datas = tx_datas or [None] * self.nof_cells
            slot = requests[0].slot
            with tracing.span("upper_phy.dl_plan"):
                batched = len({dl_mod.plan_key_for(r, self.cfg) for r in requests}) == 1
                if batched:
                    program = dl_mod.get_dl_slot_program(requests[0], self.cfg, self.device)
            if not batched:
                outs = [self.cell_phys[c].process_dl_slot(requests[c], tx_datas[c], fetch=False)
                        for c in self.cells]
                grid = torch.stack([g for g, _ in outs])
                samples = torch.stack([s for _, s in outs])
            else:
                with tracing.span("upper_phy.dl_values"):
                    with tracing.span("dl_slot.host_values"):
                        batch = []
                        for c in self.cells:
                            values = dl_mod.build_dl_slot_inputs(program, requests[c],
                                                                 tx_datas[c], slot)
                            batch.append(program.value_args(requests[c], values))
                    stacked = program.stack_values(batch)
                grid, samples = program.run_stacked(slot, stacked)
            mesh = self.rmesh.mesh
            grid, samples = gather(grid, mesh, "cell"), gather(samples, mesh, "cell")
            if not fetch:
                return grid, samples
            with tracing.span("upper_phy.dl_fetch"):
                return tables.fetch(grid), tables.fetch(samples)

    # ------------------------------------------------------------------ UL --

    def process_ul_slot(self, requests: list[UlTtiRequest], samples) -> list[list]:
        """Process one UL slot across all cells.

        Args:
          requests: one UlTtiRequest per cell (len == nof_cells).
          samples: (nof_cells, nof_rx_ports, nsamples, 2) received baseband,
            numpy or a tensor.

        Returns one list of indications per cell.

        PUSCH PDUs at one position of every request with one static key run
        as one batched receiver call.  Everything else (PUCCH, SRS,
        odd-shaped PUSCH) goes through the per-cell `UpperPhy`, as in JAX
        without PRACH samples.
        """
        with tracing.entry("multi_cell_phy.process_ul_slot"):
            return self._process_ul_slot(requests, samples)

    def _process_ul_slot(self, requests, samples) -> list[list]:
        assert len(requests) == self.nof_cells
        cfg = self.cfg
        slot = requests[0].slot
        out = {c: [] for c in self.cells}

        nof_pdus = {len(r.pusch) for r in requests}
        batchable = []
        if len(nof_pdus) == 1 and next(iter(nof_pdus)) > 0:
            for i in range(next(iter(nof_pdus))):
                if len({_static_key(r.pusch[i]) for r in requests}) == 1:
                    batchable.append(i)

        if batchable:
            with tracing.span("upper_phy.ul_ofdm"):
                x = upload(samples[self.cells.start:self.cells.stop], self.device, torch.float32)
                # (B, P, 14, nsubc, 2)
                grid = ofdm_mod.ofdm_demodulate(x, cfg.nof_subc, cfg.dft_size, cfg.numerology,
                                                slot % (1 << cfg.numerology))
            for i in batchable:
                self._process_pusch_batched(slot, [requests[c].pusch[i] for c in self.cells],
                                            grid, out)

        for c in self.cells:
            req = requests[c]
            rest = dataclasses.replace(
                req, pusch=tuple(p for i, p in enumerate(req.pusch) if i not in batchable))
            if rest.pusch or rest.pucch or rest.prach or rest.srs:
                out[c].extend(self.cell_phys[c].process_ul_slot(rest, samples[c], validate=False))
        return gather_objects([out[c] for c in self.cells], self.rmesh.mesh, "cell")

    def _process_pusch_batched(self, slot, pdus, grid, out):
        dev = self.device
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
        # One shape-keyed dynamic receiver for the whole cell batch, the one
        # each cell's UpperPhy caches for this shape.
        phy0 = self.cell_phys[self.cells.start]
        valued = [phy0._pusch_cfg(slot, pdu, nof_csi2=const_csi2, two_phase=two_phase)
                  for pdu in pdus]
        rx_cfg = pusch_rx_key(valued[0])
        sub = extract_pusch_allocation(grid, p0)

        # Per-cell DM-RS references, descrambling signs and, with UCI on
        # PUSCH, placeholder fix signs as per-row inputs.
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

        # HARQ riding the batch: retransmitting cells contribute their stored
        # soft bits, new-data cells an all-zero row (the promotion sum is the
        # identity on zeros), so one call serves any new-data/retx mix
        # (reference: include/srsran/phy/upper/rx_buffer_pool.h:40-106).
        seg = rx_cfg.segmentation
        ncb, nbits = seg.nof_cb, seg.nof_cw_bits_per_cb
        buf_idxs, rows = [], []
        for c, pdu in zip(self.cells, pdus):
            pool = self.harq_pools[c]
            bi = pool.reserve(slot, pdu.rnti, pdu.harq_id, ncb, new_data=pdu.new_data)
            buf_idxs.append(bi)
            if bi is None and not pdu.new_data:
                self.nof_dropped_harq_reservations += 1
                _LOG.warning("HARQ pool exhausted: cell=%d rnti=0x%x harq=%d retransmission "
                             "decodes without soft-combining history", c, pdu.rnti, pdu.harq_id)
            rows.append(pool.get_soft(bi, ncb, nbits)
                        if bi is not None and not pdu.new_data else None)
        harq_in = None
        if any(r is not None for r in rows):
            zeros = torch.zeros((ncb, nbits), dtype=torch.int8, device=dev)
            harq_in = torch.stack([zeros if r is None else r for r in rows])

        ncell = len(pdus)
        csi1_np = csi1_metric = csi2_rows = csi2_metric = None
        if two_phase:
            # The part-1 -> part-2 protocol over the batch: one phase-A call,
            # then one phase-B call per part-2 size on that size's rows.
            proc = PuschUciProcessor(PuschUciConfig(rx=rx_cfg, part2_size_map=p2map), dev)
            a = proc._phase_a(sub, None, ref_in, signs_in, uci_fix)
            csi1_np = _host(a["csi1_bits"])
            csi1_metric = _host(a["csi1_metric"])
            sizes = proc.csi2_sizes(csi1_np)
            ok = np.zeros(ncell, bool)
            bits, harq_soft, csi2_rows = [None] * ncell, [None] * ncell, [None] * ncell
            csi2_metric = np.zeros(ncell, np.float32)
            cfg_b = _phase_b_cfg(rx_cfg)
            for size in sorted(set(sizes)):
                idxs = [i for i, s in enumerate(sizes) if s == size]
                sel = torch.as_tensor(idxs, device=dev)
                csi2_fix = (proc.csi2_fix_signs(size, [seqs[i][1] for i in idxs])
                            if size else None)
                bout = cached_pusch_phase_b(cfg_b, size, dev)(
                    a["codeword_llr"][sel], None if harq_in is None else harq_in[sel], csi2_fix)
                ok_b, cb_b = _host(bout["tb_crc_ok"]), _host(bout["tb_bits_cb"])
                if size:
                    c2_bits, c2_metric = _host(bout["csi2_bits"]), _host(bout["csi2_metric"])
                for row, i in enumerate(idxs):
                    ok[i] = bool(ok_b[row])
                    bits[i] = flatten_tb_bits(cb_b[row][None], rx_cfg.tbs)[0]
                    harq_soft[i] = bout["harq_soft"][row]
                    if size:
                        csi2_rows[i] = c2_bits[row]
                        csi2_metric[i] = float(c2_metric[row])
            res = a
        else:
            res = cached_pusch_rx_from_grid(rx_cfg, dev)(sub, harq_in, ref_in, signs_in, uci_fix)
            ok = _host(res["tb_crc_ok"])
            bits = flatten_tb_bits(_host(res["tb_bits_cb"]), rx_cfg.tbs)
            harq_soft = res["harq_soft"]
            if nof_csi1:
                csi1_np = _host(res["csi1_bits"])
                csi1_metric = _host(res["csi1_metric"])
                if const_csi2:
                    csi2_rows = _host(res["csi2_bits"])
                    csi2_metric = _host(res["csi2_metric"])
        ack_bits = _host(res["harq_ack_bits"]) if nof_ack else None
        ack_metric = _host(res["harq_ack_metric"]) if nof_ack else None

        for k, (c, pdu) in enumerate(zip(self.cells, pdus)):
            if buf_idxs[k] is not None:
                self.harq_pools[c].store(buf_idxs[k], ncb, nbits, harq_soft[k])
            out[c].append(CrcIndication(slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                                        tb_crc_ok=bool(ok[k])))
            out[c].append(RxDataIndication(slot=slot, rnti=pdu.rnti, harq_id=pdu.harq_id,
                                           tb_bits=bits[k] if ok[k] else None))
            if nof_ack or nof_csi1:
                uci = UciIndication(
                    slot=slot, rnti=pdu.rnti,
                    harq_bits=ack_bits[k] if nof_ack else np.empty(0, np.uint8),
                    uci_bits=None,
                    valid=bool(ack_metric[k] > 0.0) if nof_ack else bool(csi1_metric[k] > 0.0))
                if nof_csi1:
                    uci.csi1_bits = csi1_np[k]
                    uci.csi1_valid = bool(csi1_metric[k] > 0.0)
                    if csi2_rows is not None and csi2_rows[k] is not None \
                            and np.size(csi2_rows[k]):
                        uci.csi2_bits = np.asarray(csi2_rows[k])
                        uci.csi2_valid = bool(csi2_metric[k] > 0.0)
                out[c].append(uci)
            if ok[k]:
                self.harq_pools[c].release(pdu.rnti, pdu.harq_id)
