"""UL-SCH transmitter matching PuschRxConfig: the UE-side emulator.

Port of `srsran_projectvtlmo_tpu.models.ulsch_tx.build_ulsch_tx_slot`: the
SCH codeword chain (`models/sch_tx`) multiplexed with encoded UCI through the
shared TS 38.212 Section 6.2.7 placement plan (`ops/ulsch_demux`), scrambling
with placeholders, layer mapping, DM-RS type 1 or 2 with fd-OCC for 1-4
layers (per-hop DM-RS PRB start with intra-slot hopping), OFDM modulation.
The UCI encoders (short block, RM(32, K), CRC + polar) run on the device.
The receiver's loopback tests and `chip_smoke.py` make their slots with it
(the reference exercises its PUSCH Rx the same way,
tests/integrationtests/phy/upper/channel_processors/pxsch_bler_test.cpp:332-458).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ofdm as ofdm_mod
from ..ops import prg as prg_mod
from ..ops import short_block
from ..ops.modulation import modulate
from ..ops.precoding import layer_map
from ..ops.uci import polar_uci_encode
from ..ops.ulsch_demux import scramble_codeword_with_placeholders
from ..ran.modulation import bits_per_symbol
from ..utils.cplx import from_cplx
from ..utils.tables import on_device, resolve_device
from .pusch_rx import PuschRxConfig, dmrs_reference, dmrs_subcarriers
from .sch_tx import build_sch_codeword_tx


def _check_scope(cfg: PuschRxConfig) -> None:
    if cfg.hop_symbol is not None and cfg.second_hop_prb is None:
        raise ValueError("hop_symbol needs second_hop_prb")


def _short_table(k: int, e: int, qm: int) -> np.ndarray:
    """(2^K, E) uint8: the placeholder-aware codeword of every K <= 2 message."""
    return np.stack([short_block.encode_host(
        np.array([(m >> (k - 1 - i)) & 1 for i in range(k)], np.uint8), e, qm)
        for m in range(1 << k)])


def _msg_weights(k: int) -> np.ndarray:
    return np.array([1 << (k - 1 - i) for i in range(k)], np.int32)


def _rm_basis(k: int) -> np.ndarray:
    return short_block.BASIS[:k].astype(np.int32)


def _tile_index(e: int) -> np.ndarray:
    return np.arange(e, dtype=np.int64) % 32


def _uci_field_encoder(nof_payload_bits: int, nof_enc_bits: int, qm: int):
    """Device encoder bits (B, K) -> (B, E) uint8 (TS 38.212 Sections 5.3.3, 6.3.2).

    K <= 2 gathers from the 2^K placeholder-aware codeword table; K <= 11 is
    the RM(32, K) basis product tiled cyclically; K >= 12 is CRC6/11 +
    polar (n_max=10, ibil) with the 2-codeblock split.
    """
    k, e = nof_payload_bits, nof_enc_bits
    if k <= 2:
        def enc(bits):
            dev = bits.device
            idx = (bits.to(torch.int32) * on_device(_msg_weights, k, device=dev)).sum(dim=-1)
            return on_device(_short_table, k, e, qm, device=dev)[idx]
        return enc
    if k <= 11:
        def enc(bits):
            dev = bits.device
            rm32 = (bits.to(torch.int32)[:, :, None]
                    * on_device(_rm_basis, k, device=dev)).sum(dim=1) & 1
            return rm32[:, on_device(_tile_index, e, device=dev)].to(torch.uint8)
        return enc
    return lambda bits: polar_uci_encode(bits, e)


def build_ulsch_tx_slot(cfg: PuschRxConfig, device="cuda", *,
                        nof_csi_part2_bits: int | None = None):
    """fn(tb_bits (B, TBS) uint8, ack_bits=None, csi1_bits=None, csi2_bits=None)
    on `device` -> (grid_pair (B[, L], 14, nsubc, 2), samples_pair (B[, L],
    nsamples, 2)), float32; the layer axis is squeezed at 1 layer, as in the
    JAX program.  Each configured UCI field needs its (B, K) payload bits;
    `nof_csi_part2_bits` overrides cfg's CSI part-2 size (a two-phase size
    bucket).  Runs on the card unless `device` names the CPU."""
    _check_scope(cfg)
    dev = resolve_device(device)
    qm = bits_per_symbol(cfg.modulation)
    nlayers = cfg.nof_layers
    plan, info = cfg.demux_plan(nof_csi_part2_bits)
    csi2_payload = cfg.nof_csi_part2_bits if nof_csi_part2_bits is None else nof_csi_part2_bits
    sch_codeword_tx = build_sch_codeword_tx(cfg, info.nof_ul_sch_bits)
    scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    mask, force_one = scramble_codeword_with_placeholders(None, scr_bits, plan)
    sch_idx = torch.as_tensor(plan.sch_bit_idx, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    force_one = torch.as_tensor(force_one, device=dev)
    # ACK last: a <=2-bit ACK punctures SCH/CSI2 positions.
    fields = [(name, torch.as_tensor(plan.field_bit_idx(name), device=dev),
               _uci_field_encoder(payload, len(plan.field_bit_idx(name)), qm))
              for name, payload in (("csi1", cfg.nof_csi_part1_bits), ("csi2", csi2_payload),
                                    ("ack", cfg.nof_harq_ack_bits)) if payload]

    ref = dmrs_reference(cfg)  # (ndmrs, npil) complex64
    pil0, comb_delta, _ = dmrs_subcarriers(cfg)
    # fd-OCC (+,+)/(+,-) over adjacent pilot pairs within each CDM group;
    # layers {0,1} on group 0, layers {2,3} on group 1 -- TS 38.211 Table
    # 6.4.1.1.3-1/2 ports 0-3 (reference: dmrs_pusch_estimator_impl.cpp:43-66).
    pilots = np.zeros((nlayers, len(cfg.dmrs_symbols), cfg.nof_subc), np.complex64)
    for l in range(nlayers):
        occ = np.ones(ref.shape[-1], np.float32)
        if l % 2:
            occ[1::2] = -1.0
        pilots[l][:, pil0 + (l // 2) * comb_delta] = ref * occ
    pilots = torch.as_tensor(pilots, device=dev)
    data_syms = torch.as_tensor(np.asarray(cfg.data_symbols, np.int64), device=dev)
    dmrs_syms = torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int64), device=dev)
    slot_in_subframe = cfg.slot % (1 << cfg.numerology)

    @torch.no_grad()
    def tx(tb_bits: torch.Tensor, ack_bits: torch.Tensor | None = None,
           csi1_bits: torch.Tensor | None = None, csi2_bits: torch.Tensor | None = None):
        if tb_bits.device != dev or tuple(tb_bits.shape[1:]) != (cfg.tbs,):
            raise ValueError(f"tb_bits must be (B, {cfg.tbs}) on {dev}, "
                             f"got {tuple(tb_bits.shape)} on {tb_bits.device}")
        payloads = {"ack": ack_bits, "csi1": csi1_bits, "csi2": csi2_bits}
        b = tb_bits.shape[0]
        cw = torch.zeros((b, cfg.nof_codeword_bits), dtype=torch.uint8, device=dev)
        cw[:, sch_idx] = sch_codeword_tx(tb_bits)
        for name, idx, enc in fields:
            if payloads[name] is None:
                raise ValueError(f"{name} payload bits required")
            cw[:, idx] = enc(payloads[name])
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
