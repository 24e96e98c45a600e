"""Multi-cell du_low: FAPI PDU sets per cell, cells batched on the mesh's
"cell" axis (port of `srsran_projectvtlmo_tpu.parallel.multi_cell_phy`).

The reference's du_low owns one independent upper_phy per cell
(reference: lib/du_low/du_low_impl.h:31-48).  Here cells with the same slot
*structure* batch into one call of one cached program, through the
dispatch `UpperPhy` runs as a batch of one: PUSCH PDUs of one
`pusch_batch_key` through `phy.upper_phy.process_pusch_batch`, whose
per-cell values (DM-RS references, descrambling and UCI fix signs, HARQ
rows) ride as per-row inputs, and DL slots of one plan through
`phy.upper_phy.dl_slot_on_device`.  Heterogeneous structures go through
each cell's own `UpperPhy` (same results, no batching win).

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

import torch

from ..fapi.pdus import UlTtiRequest
from ..ops import ofdm as ofdm_mod
from ..phy import dl_slot as dl_mod
from ..phy.upper_phy import (
    CellConfig, ExpertPhyConfig, UpperPhy, dl_slot_on_device, process_pusch_batch,
    pusch_batch_key)
from ..utils import tables, tracing
from ..utils.tables import resolve_device, upload
from .distributed import RanMesh, make_ran_mesh
from .mesh import block, gather, gather_objects


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
                grid, samples = dl_slot_on_device(program, slot,
                                                  [requests[c] for c in self.cells],
                                                  [tx_datas[c] for c in self.cells])
            mesh = self.rmesh.mesh
            grid, samples = gather(grid, mesh, "cell"), gather(samples, mesh, "cell")
            if not fetch:
                return grid, samples
            with tracing.span("upper_phy.dl_fetch"):
                return tables.fetch_dl_outputs(grid, samples, complex_grid=False)

    # ------------------------------------------------------------------ UL --

    def process_ul_slot(self, requests: list[UlTtiRequest], samples) -> list[list]:
        """Process one UL slot across all cells.

        Args:
          requests: one UlTtiRequest per cell (len == nof_cells).
          samples: (nof_cells, nof_rx_ports, nsamples, 2) received baseband,
            numpy or a tensor.

        Returns one list of indications per cell.

        PUSCH PDUs at one position of every request with one
        `pusch_batch_key` run as one `process_pusch_batch` call.  Everything else (PUCCH, SRS,
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
                if len({pusch_batch_key(r.pusch[i]) for r in requests}) == 1:
                    batchable.append(i)

        if batchable:
            with tracing.span("upper_phy.ul_ofdm"):
                x = upload(samples[self.cells.start:self.cells.stop], self.device, torch.float32)
                # (B, P, 14, nsubc, 2)
                grid = ofdm_mod.ofdm_demodulate(x, cfg.nof_subc, cfg.dft_size, cfg.numerology,
                                                slot % (1 << cfg.numerology))
            pools = [self.harq_pools[c] for c in self.cells]
            for i in batchable:
                inds, dropped = process_pusch_batch(
                    cfg, self.expert, slot, [requests[c].pusch[i] for c in self.cells], pools, grid)
                self.nof_dropped_harq_reservations += dropped
                for c, row in zip(self.cells, inds):
                    out[c].extend(row)

        for c in self.cells:
            req = requests[c]
            rest = dataclasses.replace(
                req, pusch=tuple(p for i, p in enumerate(req.pusch) if i not in batchable))
            if rest.pusch or rest.pucch or rest.prach or rest.srs:
                out[c].extend(self.cell_phys[c].process_ul_slot(rest, samples[c], validate=False))
        return gather_objects([out[c] for c in self.cells], self.rmesh.mesh, "cell")
