"""UL-SCH transmitter matching PuschRxConfig: the UE-side emulator.

Port of `srsran_projectvtlmo_tpu.models.ulsch_tx.build_ulsch_tx_slot`, SCH
only: the SCH codeword chain (`models/sch_tx`), scrambling through the
shared TS 38.212 Section 6.2.7 placement plan (`ops/ulsch_demux`), layer
mapping, DM-RS type 1 with fd-OCC for 1-4 layers, OFDM modulation.  The
receiver's loopback tests and `chip_smoke.py` make their slots with it (the
reference exercises its PUSCH Rx the same way,
tests/integrationtests/phy/upper/channel_processors/pxsch_bler_test.cpp:332-458).

UCI fields raise NotImplementedError (ROADMAP A7), as do DM-RS type 2 and
intra-slot hopping (ROADMAP A6b), which the port's receiver lacks too.
"""

from __future__ import annotations

import numpy as np
import torch

from srsran_projectvtlmo_tpu.ops import prg as prg_mod
from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
from srsran_projectvtlmo_tpu.ops.ulsch_demux import (
    build_ulsch_demux_plan, scramble_codeword_with_placeholders)
from srsran_projectvtlmo_tpu.ran.modulation import bits_per_symbol

from ..ops import ofdm as ofdm_mod
from ..ops.modulation import modulate
from ..ops.precoding import layer_map
from ..utils.cplx import from_cplx
from ..utils.tables import resolve_device
from .pusch_rx import PuschRxConfig
from .sch_tx import build_sch_codeword_tx


def _check_scope(cfg: PuschRxConfig) -> None:
    deferred = [
        (cfg.nof_harq_ack_bits or cfg.nof_csi_part1_bits or cfg.nof_csi_part2_bits,
         "UCI on PUSCH (ROADMAP A7)"),
        (cfg.hop_symbol is not None, "intra-slot frequency hopping (ROADMAP A6b)"),
        (cfg.dmrs_config_type != 1, "DM-RS type 2 (ROADMAP A6b)"),
    ]
    for cond, what in deferred:
        if cond:
            raise NotImplementedError(f"not ported yet: {what}")
    if not 1 <= cfg.nof_layers <= 4:
        raise ValueError("1-4 layers")


def build_ulsch_tx_slot(cfg: PuschRxConfig, device="cpu"):
    """fn: tb_bits (B, TBS) uint8 on `device` ->
    (grid_pair (B[, L], 14, nsubc, 2), samples_pair (B[, L], nsamples, 2)),
    float32; the layer axis is squeezed at 1 layer, as in the JAX program."""
    _check_scope(cfg)
    dev = resolve_device(device)
    qm = bits_per_symbol(cfg.modulation)
    nlayers = cfg.nof_layers
    plan = build_ulsch_demux_plan(
        nof_prb=cfg.nof_rb, start_symbol_index=cfg.start_symbol,
        nof_symbols=cfg.nof_ofdm_symbols,
        dmrs_symbols=tuple(cfg.start_symbol + s for s in cfg.dmrs_symbols),
        qm=qm, nof_layers=nlayers)
    sch_codeword_tx = build_sch_codeword_tx(cfg, len(plan.sch_bit_idx))
    scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    mask, force_one = scramble_codeword_with_placeholders(None, scr_bits, plan)
    sch_idx = torch.as_tensor(plan.sch_bit_idx, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    force_one = torch.as_tensor(force_one, device=dev)

    ref = np.stack([dmrs_type1_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
                                        prb_start=cfg.rb_start)
                    for s in cfg.dmrs_symbols])  # (ndmrs, npil) complex64
    # Type-1 CDM: fd-OCC (+,+)/(+,-) over adjacent pilot pairs within each
    # CDM group; layers {0,1} on group 0 (even subcarriers), layers {2,3} on
    # group 1 (odd subcarriers) -- TS 38.211 Table 6.4.1.1.3-1 ports 0-3
    # (reference: dmrs_pusch_estimator_impl.cpp:43-53).
    pilots = np.zeros((nlayers, len(cfg.dmrs_symbols), cfg.nof_subc), np.complex64)
    for l in range(nlayers):
        occ = np.ones(ref.shape[-1], np.float32)
        if l % 2:
            occ[1::2] = -1.0
        pilots[l][:, 2 * np.arange(6 * cfg.nof_rb) + l // 2] = ref * occ
    pilots = torch.as_tensor(pilots, device=dev)
    data_syms = torch.as_tensor(np.asarray(cfg.data_symbols, np.int64), device=dev)
    dmrs_syms = torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int64), device=dev)
    slot_in_subframe = cfg.slot % (1 << cfg.numerology)

    @torch.no_grad()
    def tx(tb_bits: torch.Tensor):
        if tb_bits.device != dev or tuple(tb_bits.shape[1:]) != (cfg.tbs,):
            raise ValueError(f"tb_bits must be (B, {cfg.tbs}) on {dev}, "
                             f"got {tuple(tb_bits.shape)} on {tb_bits.device}")
        b = tb_bits.shape[0]
        cw = torch.zeros((b, cfg.nof_codeword_bits), dtype=torch.uint8, device=dev)
        cw[:, sch_idx] = sch_codeword_tx(tb_bits)
        tx_bits = torch.where(force_one, 1, cw ^ mask).to(torch.uint8)
        layer_syms = layer_map(modulate(tx_bits, cfg.modulation), nlayers)  # (B, L, G/(qm L))
        grid = torch.zeros((b, nlayers, cfg.nof_ofdm_symbols, cfg.nof_subc),
                           dtype=torch.complex64, device=dev)
        grid[:, :, data_syms] = layer_syms.reshape(b, nlayers, len(cfg.data_symbols),
                                                   cfg.nof_subc)
        grid[:, :, dmrs_syms] = pilots
        grid_pair = from_cplx(grid)
        samples = ofdm_mod.ofdm_modulate(grid_pair, cfg.dft_size, cfg.numerology,
                                         slot_in_subframe)
        if nlayers == 1:
            return grid_pair[:, 0], samples[:, 0]
        return grid_pair, samples

    return tx
