"""DL slot assembly on the device: PDSCH (precoded, rate-matched around
reserved REs) + PDCCH + SSB + CSI-RS onto multi-port resource grids, then
OFDM modulation (port of `srsran_projectvtlmo_tpu.phy.dl_slot`).

One `DlSlotProgram` per slot *structure* (`DlSlotPlanKey`: shapes only)
holds the RE index tables on the device, built once on the host.  The
slot-dependent VALUES -- TB bits, scrambling planes (rnti/n_id), the
redundancy version's buffer start, precoding weights, DM-RS, PDCCH symbols,
the SSB block and the CSI-RS pilots -- are per-call inputs, so a cell with a
changing UE set reuses one plan.

Write order, as in JAX: each PDSCH's data REs and DM-RS rows are WRITTEN
(one index_put_ per PDU at its flat RE index, reserved REs skipped in
mapping order); PDCCH, SSB and CSI-RS are then ADDED (index_add_ at their
host-computed RE indices, a slice add for the SSB), so where an SSB or a
CSI-RS sits on PDSCH REs the grid holds their sum.  Everything accumulates
in complex64; with `grid_bf16` the grid is stored as bfloat16 real pairs
once, at the end, and the OFDM modulator upcasts it.

On a card the assembly of one replay key (OFDM phase, batch size, buffer
starts) runs eagerly once, is captured as a CUDA graph on its second call
and replayed after that: one graph launch in place of the slot's ~190
kernels, the same kernels on the same inputs (`_SlotGraph`).

Precoding is a (P x L) complex matrix per PDSCH, 1-4 layers onto up to 4
ports; DM-RS type 1 maps layers {0,1} to CDM group 0 (even subcarriers,
fd-OCC +/+ and +/-) and layers {2,3} to CDM group 1 (odd subcarriers), per
TS 38.211 Table 7.4.1.1.2-1.
reference: lib/phy/support/resource_grid_mapper_impl.cpp,
include/srsran/phy/generic_functions/precoding/channel_precoder.h:49-61,
lib/phy/upper/channel_processors/pdsch_processor_concurrent_impl.cpp:31-58.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..fapi.pdus import DlTtiRequest, PdcchPdu, PdschPdu
from ..models.pdsch_tx import PdschTxConfig
from ..models.sch_tx import build_sch_symbols_tx_dyn, sch_k0_prime, sch_scramble_planes
from ..ops import ofdm as ofdm_mod
from ..ops.csi_rs import CsiRsConfig, csi_rs_pattern
from ..ops.dmrs import dmrs_type1_sequence
from ..ops.precoding import identity_precoder, layer_map
from ..ran.pdcch_mapping import (
    cce_to_reg_interleaved, cce_to_reg_non_interleaved, pdcch_coreset_prbs, pdcch_re_indices)
from ..ran.re_pattern import reserved_mask_window
from ..utils import cuda_graphs, tracing
from ..utils.cplx import from_cplx, np_to_pair, to_cplx
from ..utils.tables import resolve_device, upload_many
from . import pbch as pbch_mod
from . import pdcch as pdcch_mod


def _pdsch_cfg(pdu: PdschPdu, cell) -> PdschTxConfig:
    return PdschTxConfig(
        nof_rb=pdu.rb_size, modulation=pdu.modulation,
        target_code_rate=pdu.target_code_rate, nof_layers=pdu.nof_layers,
        nof_ofdm_symbols=pdu.nof_symbols,
        dmrs_symbols=tuple(s - pdu.start_symbol for s in pdu.dmrs_symbols),
        rv=pdu.rv, rnti=pdu.rnti, n_id=pdu.n_id,
        start_symbol=pdu.start_symbol, rb_start=pdu.rb_start,
        dft_size=cell.dft_size, numerology=cell.numerology,
        reserved=tuple(getattr(pdu, "reserved", ()) or ()),
    )


def _pdsch_re_index(pdu: PdschPdu, cfg: PdschTxConfig, nsubc: int) -> np.ndarray:
    """Flat (symbol * nsubc + subcarrier) index of one PDSCH's REs: its data
    REs in mapping order (symbol-major, reserved REs skipped; reference:
    pdsch_processor_impl.cpp:77-96), then each DM-RS symbol's whole row."""
    cols = pdu.rb_start * 12 + np.arange(cfg.nof_subc)
    abs_data = [pdu.start_symbol + int(s) for s in cfg.data_symbols]
    dmrs_abs = [pdu.start_symbol + int(s) for s in cfg.dmrs_symbols]
    free = ~reserved_mask_window(cfg.reserved, pdu.rb_start, pdu.rb_size, abs_data)
    assert not reserved_mask_window(cfg.reserved, pdu.rb_start, pdu.rb_size, dmrs_abs).any(), \
        "reserved REs on PDSCH DM-RS symbols are unsupported (the scheduler " \
        "must not collide CSI-RS/CORESET with DM-RS; reference merges them " \
        "into one pattern but asserts no DM-RS collision upstream)"
    rows = [sym * nsubc + cols[free[di]] for di, sym in enumerate(abs_data)]
    rows += [sym * nsubc + cols for sym in dmrs_abs]
    idx = np.concatenate(rows).astype(np.int64)
    assert len(idx) == cfg.nof_data_re + len(dmrs_abs) * cfg.nof_subc
    return idx


def _precoding_matrix(pdu: PdschPdu, nof_ports: int) -> np.ndarray:
    """(P, L, 2) float32 precoding weights for the PDU."""
    if getattr(pdu, "precoding", None) is None:
        return identity_precoder(nof_ports, pdu.nof_layers)
    w = np.asarray(pdu.precoding, np.float32)  # (P, L, 2)
    assert w.shape == (nof_ports, pdu.nof_layers, 2), \
        f"precoding shape {w.shape} != ({nof_ports}, {pdu.nof_layers}, 2)"
    return w


def _pdcch_plan(pdu: PdcchPdu, cell):
    """Host index plan for one PDCCH candidate: (prbs, data_idx, dmrs_idx),
    the RE indices flat over (symbol, subcarrier).  The CORESET starts at
    the PDU's `coreset_rb_start`."""
    if pdu.interleaved:
        regs = cce_to_reg_interleaved(
            pdu.coreset_nof_rb, pdu.duration, pdu.reg_bundle_size,
            pdu.interleaver_size, pdu.shift_index,
            pdu.aggregation_level, pdu.cce_index)
    else:
        regs = cce_to_reg_non_interleaved(pdu.aggregation_level, pdu.cce_index)
    offsets = pdu.coreset_rb_start + np.arange(pdu.coreset_nof_rb)
    prbs = pdcch_coreset_prbs(regs, pdu.duration, offsets)
    data_idx, dmrs_idx = pdcch_re_indices(prbs, pdu.duration, pdu.start_symbol, cell.nof_subc)
    return prbs, data_idx, dmrs_idx


def _csi_cfg(pdu, slot: int) -> CsiRsConfig:
    return CsiRsConfig(
        nof_rb=pdu.nof_rb, prb_start=pdu.prb_start, row=pdu.row, k_ref=pdu.k_ref,
        symbol=pdu.symbol, density=pdu.density, symbol_l1=getattr(pdu, "symbol_l1", 8),
        subcarrier_offset=pdu.subcarrier_offset, scrambling_id=pdu.scrambling_id, slot=slot)


#: Per-layer fd-OCC within its CDM group: w_f(k') for k' in {0, 1}.
_OCC = {0: (1.0, 1.0), 1: (1.0, -1.0), 2: (1.0, 1.0), 3: (1.0, -1.0)}


def _occ_table(nof_layers: int, npil: int) -> np.ndarray:
    """(2 combs, L, npil) complex64: layer l's fd-OCC on its CDM group's comb."""
    occ = np.zeros((2, nof_layers, npil), np.complex64)
    for l in range(nof_layers):
        occ[l // 2, l, 0::2], occ[l // 2, l, 1::2] = _OCC[l]
    return occ


def _shape_pdsch(pdu: PdschPdu) -> PdschPdu:
    """Strip value-only fields so the plan key covers shape alone.

    rnti/n_id (scrambling sequence), rv (buffer start) and the precoding
    weights ride as call inputs -- a steady-state cell with a CHANGING UE
    set uses exactly one DL plan per slot structure (reference analog:
    per-slot PDU churn is the normal case,
    lib/fapi_adaptor/phy/fapi_to_phy_translator.cpp:290-351)."""
    return dataclasses.replace(pdu, rnti=0, n_id=0, rv=0, precoding=None)


def _shape_pdcch(pdu: PdcchPdu) -> PdcchPdu:
    """PDCCH value-only fields (scrambling/CRC-mask identities and the
    precoding vector) stripped; the candidate's CCE/REG geometry stays."""
    return dataclasses.replace(pdu, rnti=0, n_id=0, n_rnti=0, precoding=None)


def _shape_csi_rs(pdu):
    """CSI-RS value-only field (the Gold-sequence scrambling identity)
    stripped; the row/k_ref/density RE geometry stays."""
    return dataclasses.replace(pdu, scrambling_id=0)


def _port_vector(precoding, nof_ports: int) -> np.ndarray:
    """(P, 2) float32 single-layer port weights; None = port 0 only."""
    if precoding is None:
        w = np.zeros((nof_ports, 2), np.float32)
        w[0, 0] = 1.0
        return w
    w = np.asarray(precoding, np.float32)
    assert w.shape == (nof_ports, 2), f"port precoding shape {w.shape} != ({nof_ports}, 2)"
    return w


@dataclass(frozen=True)
class DlSlotPlanKey:
    """The plan-cache key: everything shape/index-determining, NOT the slot
    and not per-UE values (PDU tuples are `_shape_pdsch`/`_shape_pdcch`
    normalized)."""
    cell_nof_rb: int
    cell_dft_size: int
    numerology: int
    nof_tx_ports: int
    pdsch: tuple[PdschPdu, ...]
    pdcch: tuple[PdcchPdu, ...]
    nof_ssb: int
    #: Shape-normalized CSI-RS PDUs (row/k_ref/density determine the per-port
    #: RE layout; scrambling values ride as inputs).
    csi_rs: tuple = ()
    ssb_k0: tuple[int, ...] = ()


def _stack(*entries):
    """Entries of one value tree (nested tuples of arrays and ints) stacked on
    a new leading axis: arrays with np.stack, ints into a tuple, one per entry."""
    if isinstance(entries[0], tuple):
        return tuple(_stack(*xs) for xs in zip(*entries))
    if isinstance(entries[0], int):
        return tuple(entries)
    return np.stack(entries)


_LEAVES = (np.ndarray, torch.Tensor)


def _arrays(tree) -> list:
    """The arrays (numpy or torch) of a value tree, in order."""
    if isinstance(tree, _LEAVES):
        return [tree]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _arrays(t)]
    return []


def _replace_arrays(tree, it):
    if isinstance(tree, _LEAVES):
        return next(it)
    if isinstance(tree, tuple):
        out = [_replace_arrays(t, it) for t in tree]
        return DlSlotValues._make(out) if isinstance(tree, DlSlotValues) else tuple(out)
    return tree


def _tiled_base(views: list[torch.Tensor]) -> torch.Tensor | None:
    """The flat tensor that `views`, in order, tile whole (as `upload_many`
    returns the arrays of one dtype), or None."""
    base = views[0]._base
    if base is None or base.dim() != 1:
        return None
    at = base.storage_offset()
    for v in views:
        if v._base is not base or v.storage_offset() != at or not v.is_contiguous():
            return None
        at += v.numel()
    return base if at == base.storage_offset() + base.numel() else None


class DlSlotValues(NamedTuple):
    """`stack_values`' output: the batch size, then the value inputs of
    `DlSlotProgram` (its docstring) with a batch axis in front of each array,
    on the device; it unpacks into `_assemble(slot_in_sf, *values)`."""
    batch: int
    tb_bits: tuple
    pdsch_dmrs: tuple
    pdcch_syms: tuple
    pdcch_dmrs: tuple
    ssb_grids: tuple
    csi_vals: tuple
    pdsch_scr: tuple
    pdsch_k0p: tuple
    pdsch_w: tuple
    pdcch_w: tuple
    ssb_w: tuple


#: Replay keys per program that keep a CUDA graph, the least recently used
#: evicted first: 4 redundancy versions x 2 OFDM phases of one batch size.
GRAPH_KEYS = 8


class _SlotGraph:
    """`DlSlotProgram._assemble` of one replay key captured as a CUDA graph.

    Its static inputs have `stack_values`' layout: one flat tensor per dtype
    holding the arrays of that dtype in order, with a view for each.  `run`
    copies a call's uploads into them (one `copy_` per dtype), replays, and
    returns clones of the static outputs, which the next replay overwrites."""

    def __init__(self, fn, args, pool):
        slot_in_sf, stacked = args
        arrays = _arrays(stacked)
        groups: dict[torch.dtype, list[int]] = {}
        for i, a in enumerate(arrays):
            groups.setdefault(a.dtype, []).append(i)
        self.groups = list(groups.values())
        self.flat, self.views = [], [None] * len(arrays)
        for idx in self.groups:
            flat = torch.empty(sum(arrays[i].numel() for i in idx), dtype=arrays[idx[0]].dtype,
                               device=arrays[idx[0]].device)
            for i, part in zip(idx, flat.split([arrays[i].numel() for i in idx])):
                self.views[i] = part.view(arrays[i].shape)
            self.flat.append(flat)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.out = fn(slot_in_sf, _replace_arrays(stacked, iter(self.views)))

    def run(self, args) -> tuple[torch.Tensor, torch.Tensor]:
        arrays = _arrays(args[1])
        for flat, idx in zip(self.flat, self.groups):
            src = _tiled_base([arrays[i] for i in idx])
            if src is not None and src.numel() == flat.numel():
                flat.copy_(src)
            else:
                for i in idx:
                    self.views[i].copy_(arrays[i])
        self.graph.replay()
        return self.out[0].clone(), self.out[1].clone()


class DlSlotProgram:
    """The DL slot assembly of one slot structure on `device` (the card
    unless the caller asks for the CPU).

    Value inputs (`value_args`, in this order; `stack_values` puts a batch
    axis in front of each array, moves them to the device and names them, a
    `DlSlotValues`):
      tb_bits:     tuple of (TBS_i,) uint8
      pdsch_dmrs:  tuple of (ndmrs, npil, 2) float32 base pilot sequences
      pdcch_syms:  tuple of (n_data, 2) float32 candidate data symbols
      pdcch_dmrs:  tuple of (n_dmrs, 2) float32 candidate DM-RS values
      ssb_grids:   tuple of (4, 240, 2) float32 assembled SSB blocks
      csi_vals:    tuple of (n_re, 2) float32, flat in (port, symbol, subc)
      pdsch_scr:   tuple of per-PDU tuples of (nj, Qm, E/Qm) uint8 planes
      pdsch_k0p:   tuple of ints, each PDU's circular-buffer start (rv)
      pdsch_w:     tuple of (P, L, 2) float32 precoding matrices
      pdcch_w, ssb_w: tuples of (P, 2) float32 port vectors
    """

    def __init__(self, key: DlSlotPlanKey, cell, device="cuda"):
        self.key = key
        self.cell = cell
        self.device = dev = resolve_device(device)
        nsubc = cell.nof_subc
        p = key.nof_tx_ports
        self.pdsch_cfgs = [_pdsch_cfg(pdu, cell) for pdu in key.pdsch]
        self.pdsch_tx = [build_sch_symbols_tx_dyn(cfg) for cfg in self.pdsch_cfgs]
        self.pdsch_re = [torch.as_tensor(_pdsch_re_index(pdu, cfg, nsubc), device=dev)
                         for pdu, cfg in zip(key.pdsch, self.pdsch_cfgs)]
        self.pdsch_occ = [torch.as_tensor(_occ_table(cfg.nof_layers, 6 * cfg.nof_rb), device=dev)
                          for cfg in self.pdsch_cfgs]

        # PDCCH: each candidate's data REs, then its DM-RS REs, in the order
        # of the values `build_dl_slot_inputs` makes; and where its DM-RS
        # pilots sit in the per-symbol Gold sequences.
        self.pdcch_dmrs_index: list[tuple[int, np.ndarray]] = []
        self.pdcch_re = []
        for pdu in key.pdcch:
            prbs, data_idx, dmrs_idx = _pdcch_plan(pdu, cell)
            self.pdcch_dmrs_index.append(pdcch_mod.pdcch_dmrs_index(pdu.duration, prbs))
            self.pdcch_re.append(torch.as_tensor(
                np.concatenate([data_idx, dmrs_idx]).astype(np.int64), device=dev))

        # CSI-RS: every port's REs, flat over (port, symbol, subcarrier).
        self.csi_re = []
        for pdu in key.csi_rs:
            pat = csi_rs_pattern(_csi_cfg(pdu, slot=0))  # layout; values arrive per slot
            assert len(pat) <= p, f"CSI-RS row {pdu.row} needs {len(pat)} ports > cell's {p}"
            idx = [(port * 14 + int(sym)) * nsubc + subc
                   for port, (symbols, subc, _) in enumerate(pat) for sym in symbols]
            self.csi_re.append(torch.as_tensor(np.concatenate(idx).astype(np.int64), device=dev))

        # On a card: the replay keys and their `_SlotGraph`s (`_replay`).
        self._replays = None
        if dev.type == "cuda":
            self._replays = cuda_graphs.GraphReplays(dev, GRAPH_KEYS, "dl_graph", "DL slot")

    def _dmrs_rows(self, i: int, pil: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Base pilots (B, ndmrs, npil) and weights (B, P, L) complex -> the
        DM-RS symbols' rows (B, P, ndmrs, 2 npil): the precoded CDM-group
        pilots, comb 0 on even and comb 1 on odd subcarriers."""
        rows = torch.einsum("bpl,cln,bmn->bpmnc", w, self.pdsch_occ[i], pil)
        return rows.reshape(rows.shape[:3] + (-1,))

    def _assemble(self, slot_in_sf: int, b: int, tb_bits, pdsch_dmrs, pdcch_syms, pdcch_dmrs,
                  ssb_grids, csi_vals, pdsch_scr, pdsch_k0p, pdsch_w, pdcch_w, ssb_w):
        """Batched slot assembly of `b` entries: every array input has a
        leading batch axis.  Returns (grid (B, P, 14, nsubc, 2), samples
        (B, P, nsamples, 2))."""
        p = self.key.nof_tx_ports
        nsubc = self.cell.nof_subc
        grid = torch.zeros((b, p, 14 * nsubc), dtype=torch.complex64, device=self.device)

        for i, cfg in enumerate(self.pdsch_cfgs):
            w = to_cplx(pdsch_w[i])  # (B, P, L)
            syms = self.pdsch_tx[i](tb_bits[i], pdsch_scr[i], pdsch_k0p[i])  # (B, G/Qm)
            ports = torch.einsum("bpl,blm->bpm", w, layer_map(syms, cfg.nof_layers))
            dmrs = self._dmrs_rows(i, to_cplx(pdsch_dmrs[i]), w)
            grid[:, :, self.pdsch_re[i]] = torch.cat([ports, dmrs.reshape(b, p, -1)], dim=-1)

        # The adds go through the grid's float32 view (index_add_ on real
        # pairs); every index list is free of repeats.
        for i, idx in enumerate(self.pdcch_re):
            vals = torch.cat([to_cplx(pdcch_syms[i]), to_cplx(pdcch_dmrs[i])], dim=-1)
            weighted = to_cplx(pdcch_w[i])[:, :, None] * vals[:, None, :]  # (B, P, n)
            torch.view_as_real(grid).index_add_(2, idx, torch.view_as_real(weighted))

        grid4 = grid.view(b, p, 14, nsubc)
        for k, k0 in enumerate(self.key.ssb_k0):
            blk = to_cplx(ssb_grids[k])  # (B, 4, 240)
            grid4[:, :, 0:4, k0:k0 + blk.shape[-1]] += \
                to_cplx(ssb_w[k])[:, :, None, None] * blk[:, None]

        flat = torch.view_as_real(grid).view(b, p * 14 * nsubc, 2)
        for i, idx in enumerate(self.csi_re):
            flat.index_add_(1, idx, csi_vals[i])

        grid_pair = from_cplx(grid4, torch.bfloat16 if self.cell.grid_bf16 else torch.float32)
        samples = ofdm_mod.ofdm_modulate(grid_pair, self.cell.dft_size, self.cell.numerology,
                                         slot_in_sf)
        return grid_pair, samples

    def value_args(self, request: DlTtiRequest, values) -> tuple:
        """The per-slot value inputs of `_assemble` on the host (see the class
        docstring): `build_dl_slot_inputs`' `values`, then the per-UE values
        of the request's PDUs (scrambling planes and buffer start from
        rnti/n_id/rv, precoding weights and port vectors)."""
        p = self.key.nof_tx_ports
        scr = tuple(_scramble_planes(cfg, pdu.rnti, pdu.n_id)
                    for pdu, cfg in zip(request.pdsch, self.pdsch_cfgs))
        k0p = tuple(sch_k0_prime(cfg, pdu.rv) for pdu, cfg in zip(request.pdsch, self.pdsch_cfgs))
        ws = tuple(_precoding_matrix(pdu, p) for pdu in request.pdsch)
        pw = tuple(_port_vector(pdu.precoding, p) for pdu in request.pdcch)
        sw = tuple(_port_vector(pdu.precoding, p) for pdu in request.ssb)
        return tuple(tuple(v) for v in values) + (scr, k0p, ws, pw, sw)

    def stack_values(self, value_args_batch) -> DlSlotValues:
        """Stack per-entry `value_args` tuples on a leading batch axis (slots of
        one cell, or one slot of many same-structure cells) and move the
        arrays to the device, one pinned upload per dtype; the buffer starts
        stay host ints, one per entry (span `dl_slot.upload`)."""
        with tracing.span("dl_slot.upload"):
            stacked = _stack(*value_args_batch)
            on_dev = upload_many(_arrays(stacked), self.device)
            return DlSlotValues(len(value_args_batch), *_replace_arrays(stacked, iter(on_dev)))

    @torch.no_grad()
    def run_stacked(self, slot: int, stacked):
        """The batched slot assembly on `stack_values` output (span
        `dl_slot.run`: the host issuing the slot's device work), through a
        CUDA graph on a card (`_replay`), eagerly elsewhere.  Returns (grid
        (B, P, 14, nsubc, 2), samples (B, P, nsamples, 2)), the caller's own."""
        with tracing.span("dl_slot.run"):
            slot_in_sf = slot % (1 << self.cell.numerology)
            if self.device.type != "cuda":
                return self._assemble(slot_in_sf, *stacked)
            return self._replay(slot_in_sf, stacked)

    def _replay(self, slot_in_sf: int, stacked):
        """`_assemble` through the CUDA graph of its replay key
        (`utils.cuda_graphs.GraphReplays`: eager on the key's first call,
        captured as a `_SlotGraph` on its second, replayed after that).  The
        key is what the eager program branches on, on the host: the OFDM
        phase, the batch size and the buffer starts; every other input is a
        device value.  Counts `dl_graph_captures` per capture and
        `dl_graph_replays` per replay (0 on an eager call).

        The graphs of one program share one memory pool, so a replay may write
        over memory that holds another graph's static outputs.  That is safe
        because every call returns clones of the static outputs, taken before
        the next replay can start."""
        key = (slot_in_sf, stacked.batch, stacked.pdsch_k0p)
        with self._replays.outputs(key, self._assemble_stacked, (slot_in_sf, stacked),
                                   _SlotGraph) as out:
            return out

    def _assemble_stacked(self, slot_in_sf: int, stacked):
        return self._assemble(slot_in_sf, *stacked)


@functools.lru_cache(maxsize=512)
def _scramble_planes(cfg, rnti: int, n_id: int):
    with tracing.span("dl_slot.scramble_planes"):  # on a cache miss only
        return sch_scramble_planes(cfg, rnti, n_id)


@functools.lru_cache(maxsize=64)
def _cached_program(key: DlSlotPlanKey, cell, device: torch.device) -> DlSlotProgram:
    with tracing.span("dl_slot.build_plan"):  # on a cache miss only
        return DlSlotProgram(key, cell, device)


def plan_key_for(request: DlTtiRequest, cell) -> DlSlotPlanKey:
    return DlSlotPlanKey(
        cell_nof_rb=cell.nof_rb,
        cell_dft_size=cell.dft_size,
        numerology=cell.numerology,
        nof_tx_ports=cell.nof_tx_ports,
        pdsch=tuple(_shape_pdsch(p) for p in request.pdsch),
        pdcch=tuple(_shape_pdcch(p) for p in request.pdcch),
        nof_ssb=len(request.ssb),
        csi_rs=tuple(_shape_csi_rs(p) for p in getattr(request, "csi_rs", ())),
        ssb_k0=tuple(cell.ssb_subc_offset + s.ssb_offset_pointa * 12 for s in request.ssb),
    )


def get_dl_slot_program(request: DlTtiRequest, cell, device="cuda") -> DlSlotProgram:
    """The cached plan of the request's slot structure on `device`."""
    return _cached_program(plan_key_for(request, cell), cell, resolve_device(device))


def build_dl_slot_inputs(program: DlSlotProgram, request: DlTtiRequest, tx_data, slot: int):
    """Host per-slot VALUE inputs of one cell's DL slot, numpy: (tb_bits,
    pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb_grids, csi_vals), as
    `DlSlotProgram.value_args` takes them."""
    tb_bits, pdsch_dmrs = [], []
    for i, pdu in enumerate(request.pdsch):
        sch_cfg = program.pdsch_cfgs[i]
        tb = (tx_data.tb_bits[i] if tx_data is not None
              else np.zeros(sch_cfg.tbs, np.uint8))
        assert len(tb) == sch_cfg.tbs, f"TB size {len(tb)} != {sch_cfg.tbs}"
        tb_bits.append(np.asarray(tb, np.uint8))
        ref = np.stack([dmrs_type1_sequence(slot, s, pdu.n_id, pdu.rb_size,
                                            prb_start=pdu.rb_start)
                        for s in pdu.dmrs_symbols])
        pdsch_dmrs.append(np_to_pair(ref))

    pdcch_syms, pdcch_dmrs = [], []
    for i, pdu in enumerate(request.pdcch):
        payload = getattr(pdu, "payload", None)
        if payload is None:
            payload = np.zeros(pdu.nof_dci_bits, np.uint8)
        pdcch_syms.append(pdcch_mod.pdcch_symbol_pairs(
            pdcch_mod.PdcchCandidateConfig(
                nof_dci_bits=pdu.nof_dci_bits, aggregation_level=pdu.aggregation_level,
                rnti=pdu.rnti, n_id=pdu.n_id, n_rnti=pdu.n_rnti),
            np.asarray(payload, np.uint8)))
        pdcch_dmrs.append(pdcch_mod.pdcch_dmrs_pairs(slot, pdu.start_symbol, pdu.duration,
                                                     *program.pdcch_dmrs_index[i], pdu.n_id))

    ssb_grids = []
    for ssb in request.ssb:
        msg = pbch_mod.PbchMessage(
            sfn=ssb.sfn, ssb_idx=ssb.ssb_block_index, half_radio_frame=ssb.half_radio_frame,
            n_id=ssb.phys_cell_id, l_max=ssb.l_max, mib_payload=ssb.mib_payload)
        ssb_grids.append(pbch_mod.ssb_block_pairs(msg))

    csi_vals = []
    for pdu in request.csi_rs:
        pat = csi_rs_pattern(_csi_cfg(pdu, slot))
        csi_vals.append(np_to_pair(np.concatenate([v.reshape(-1) for (_, _, v) in pat])))

    return tb_bits, pdsch_dmrs, pdcch_syms, pdcch_dmrs, ssb_grids, csi_vals
