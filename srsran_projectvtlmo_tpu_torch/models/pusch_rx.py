"""PUSCH receive slot (port of `srsran_projectvtlmo_tpu.models.pusch_rx`).

One slot program: OFDM demodulation -> DM-RS channel estimation -> MMSE or
ZF equalization with CFO derotation -> soft demapping -> descrambling -> UCI
demultiplexing and decoding (HARQ-ACK, CSI parts 1 and 2: short block, or
CRC + polar) -> rate recovery (+ HARQ combining) -> LDPC decoding, early
stop or fixed iterations (the CUDA kernel on the card) -> CB/TB CRC checks.
Codeblocks and slots batch on leading axes.

Every setting of the JAX `PuschRxConfig` is carried: DM-RS types 1 and 2,
intra-slot frequency hopping (1 layer), 1-4 layers over 1-4 rx ports,
`dynamic_params` (per-row DM-RS references, descrambling and placeholder fix
signs as call inputs) and the CSI part-1 -> part-2 protocol
(`decode_sch=False` is phase A; `build_pusch_phase_b` finishes a size
bucket).  Without UCI the demapper runs bit-major, which is already the
rate dematcher's order; with UCI it runs in row layout through the TS 38.212
Section 6.2.7 placement plan; demapping and descrambling are one stage,
`ops.pusch_demap` (a hand-written kernel on the card).  The combinations the
JAX program asserts against raise ValueError with its reason.
reference: lib/phy/upper/channel_processors/pusch/pusch_processor_impl.cpp:115-298,
pusch_decoder_impl.cpp:294-398.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ofdm as ofdm_mod
from ..ops import prg as prg_mod
from ..ops import short_block
from ..ops import uci as uci_mod
from ..ops.channel_estimate import estimate_channel_hop, noise_residual_share
from ..ops.crc import crc_check_device, crc_check_device_cbs
from ..ops.dmrs import (
    dmrs_type1_sequence, dmrs_type2_sequence, dmrs_type2_subcarriers)
from ..ops.equalization import apply_weights_ports_first, mmse_weights, zf_weights
from ..ops.evm import evm as evm_fn
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc.decode_cuda import ldpc_decode, ldpc_decode_es
from ..ops.ldpc.segment import tb_crc_name
from ..ops.pusch_demap import demap_descramble_cuda, demap_route
from ..ops.ulsch_demux import build_ulsch_demux_plan, placeholder_fix_signs
from ..ran.modulation import bits_per_symbol
from ..ran.ulsch_info import get_ulsch_information
from ..utils import tracing
from ..utils.cplx import from_cplx, np_to_pair, to_cplx
from ..utils.tables import resolve_device
from .sch_config import SchChainConfig


@dataclass(frozen=True)
class PuschRxConfig(SchChainConfig):
    """The JAX `PuschRxConfig`'s fields and defaults, less the TPU decoder
    selection (`use_pallas_decoder`)."""

    nof_rx_ports: int = 1
    dft_size: int = 4096
    numerology: int = 1
    slot: int = 0
    nof_ldpc_iterations: int = 6
    ldpc_early_stop: bool = True
    equalizer: str = "mmse"
    grid_bf16: bool = True
    nof_harq_ack_bits: int = 0
    nof_csi_part1_bits: int = 0
    nof_csi_part2_bits: int = 0
    alpha_scaling: float = 1.0
    beta_offset_harq_ack: float = 2.0
    beta_offset_csi_part1: float = 2.0
    beta_offset_csi_part2: float = 2.0
    compensate_cfo: bool = True
    emit_harq_soft: bool = True
    dynamic_params: bool = False
    decode_sch: bool = True
    dmrs_config_type: int = 1
    hop_symbol: int | None = None
    second_hop_prb: int | None = None
    #: Scale the DM-RS noise estimate to the per-RE noise of the data: undo
    #: the smoothing residual's shrink and, with CDM, the pair despreading's
    #: halving (`ops.channel_estimate.noise_residual_share`).  False keeps
    #: the JAX package's estimate, 5.4 dB low on 2-layer PUSCH, whose LLRs
    #: then clip in int8 and lose TBs near the decoding threshold.
    unbiased_noise: bool = True

    @property
    def scs_hz(self) -> float:
        return 15e3 * (1 << self.numerology)

    def symbol_epochs_s(self) -> tuple[float, ...]:
        """Start time (s) of each slot symbol's useful part (CP excluded)."""
        cps = ofdm_mod.cp_lengths(self.dft_size, self.numerology,
                                  self.slot % (1 << self.numerology))
        fs = self.dft_size * self.scs_hz
        t, out = 0, []
        for cp_len in cps:
            out.append((t + cp_len) / fs)
            t += cp_len + self.dft_size
        return tuple(out)

    def ulsch_info(self, nof_csi_part2_bits: int | None = None):
        """Per-field RE/bit budget (reference: lib/ran/pusch/ulsch_info.cpp:163)."""
        seg = self.segmentation
        return get_ulsch_information(
            nof_rb=self.nof_rb, start_symbol_index=self.start_symbol,
            nof_symbols=self.nof_ofdm_symbols,
            dmrs_symbols=tuple(self.start_symbol + s for s in self.dmrs_symbols),
            nof_layers=self.nof_layers, qm=bits_per_symbol(self.modulation),
            target_code_rate=self.target_code_rate, tbs=self.tbs,
            sum_nof_cb_size=seg.nof_cb * seg.nof_bits_per_cb,
            nof_harq_ack_bits=self.nof_harq_ack_bits,
            nof_csi_part1_bits=self.nof_csi_part1_bits,
            nof_csi_part2_bits=(self.nof_csi_part2_bits
                                if nof_csi_part2_bits is None else nof_csi_part2_bits),
            alpha_scaling=self.alpha_scaling,
            beta_offset_harq_ack=self.beta_offset_harq_ack,
            beta_offset_csi_part1=self.beta_offset_csi_part1,
            beta_offset_csi_part2=self.beta_offset_csi_part2)

    def demux_plan(self, nof_csi_part2_bits: int | None = None):
        """(TS 38.212 Section 6.2.7 placement plan, `ulsch_info`) for this config."""
        csi2 = self.nof_csi_part2_bits if nof_csi_part2_bits is None else nof_csi_part2_bits
        info = self.ulsch_info(csi2)
        return build_ulsch_demux_plan(
            nof_prb=self.nof_rb, start_symbol_index=self.start_symbol,
            nof_symbols=self.nof_ofdm_symbols,
            dmrs_symbols=tuple(self.start_symbol + s for s in self.dmrs_symbols),
            qm=bits_per_symbol(self.modulation), nof_layers=self.nof_layers,
            nof_harq_ack_bits=self.nof_harq_ack_bits,
            nof_enc_harq_ack_bits=info.nof_harq_ack_bits,
            nof_harq_ack_rvd=info.nof_harq_ack_rvd,
            nof_csi_part1_bits=self.nof_csi_part1_bits,
            nof_enc_csi_part1_bits=info.nof_csi_part1_bits,
            nof_csi_part2_bits=csi2,
            nof_enc_csi_part2_bits=info.nof_csi_part2_bits), info


@functools.lru_cache(maxsize=None)
def cached_demux_plan(cfg: PuschRxConfig, nof_csi_part2_bits: int | None = None):
    """Per-config cache of the placement plan: it depends on shape only, so
    callers that build per-UE fix signs reuse it across UEs."""
    return cfg.demux_plan(nof_csi_part2_bits)


def _check_scope(cfg: PuschRxConfig) -> None:
    """Raise ValueError where the JAX program asserts."""
    hopping = cfg.hop_symbol is not None
    invalid = [
        (hopping and cfg.second_hop_prb is None, "hop_symbol needs second_hop_prb"),
        (hopping and cfg.nof_layers != 1, "frequency hopping supported for 1 layer"),
        (not cfg.decode_sch and not (cfg.nof_csi_part1_bits > 0 and cfg.nof_csi_part2_bits == 0),
         "decode_sch=False is phase A of the CSI protocol (csi1>0, csi2=0)"),
        (hopping and cfg.dmrs_config_type == 2, "DM-RS type 2 supports the non-hopping path"),
        (hopping and len({_hop_of(cfg, cfg.start_symbol + s) for s in cfg.dmrs_symbols}) < 2,
         "each hop needs at least one DM-RS symbol"),
        (cfg.equalizer not in ("mmse", "zf"), f"unknown equalizer {cfg.equalizer!r}"),
    ]
    for bad, why in invalid:
        if bad:
            raise ValueError(why)


def _hop_of(cfg: PuschRxConfig, sym_abs: int) -> int:
    return 1 if cfg.hop_symbol is not None and sym_abs >= cfg.hop_symbol else 0


def dmrs_reference(cfg: PuschRxConfig) -> np.ndarray:
    """(ndmrs, npil) complex64 DM-RS values of the configured type and hops.
    The sequence is CRB-indexed, so second-hop symbols draw it from the
    second hop's PRB."""
    if cfg.dmrs_config_type == 2:
        return np.stack([dmrs_type2_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id,
                                             cfg.nof_rb, prb_start=cfg.rb_start)
                         for s in cfg.dmrs_symbols])
    return np.stack([dmrs_type1_sequence(
        cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
        prb_start=cfg.second_hop_prb if _hop_of(cfg, cfg.start_symbol + s) else cfg.rb_start)
        for s in cfg.dmrs_symbols])


def dmrs_subcarriers(cfg: PuschRxConfig) -> tuple[np.ndarray, int, int]:
    """(CDM group 0's pilot subcarriers, CDM group spacing, pilot-pair spacing)."""
    if cfg.dmrs_config_type == 2:
        return dmrs_type2_subcarriers(cfg.nof_rb).astype(np.int64), 2, 6
    return 2 * np.arange(6 * cfg.nof_rb, dtype=np.int64), 1, 4


def flatten_tb_bits(tb_bits_cb, tbs: int):
    """(B, C, Kpay) per-codeblock payload bits -> (B, tbs) TB bits (numpy or tensor)."""
    return tb_bits_cb.reshape(tb_bits_cb.shape[0], -1)[:, :tbs]


def decode_uci_field(llr_field: torch.Tensor, nof_payload_bits: int, qm: int):
    """Decode one UCI field from its extracted (B, G_field) LLRs.

    Returns (bits (B, K) uint8, metric (B,) float32): the short-block ML
    detection metric for K <= 11, the CRC verdict (as float) for the polar
    path (reference: lib/phy/upper/channel_processors/uci/uci_decoder_impl.cpp:30-123).
    """
    if nof_payload_bits <= 11:
        return short_block.detect(llr_field, nof_payload_bits, qm)
    bits, ok = uci_mod.uci_decode(torch.clamp(llr_field, -127, 127).to(torch.int8),
                                  nof_payload_bits, qm)
    return bits, ok.to(torch.float32)


def _cb_groups(cfg: PuschRxConfig, g: int):
    """Equal-E codeblock groups as contiguous ranges: [(E, first CB, end CB,
    first bit, end bit)] of a G-bit SCH stream (the smaller E comes first)."""
    es = cfg.cb_rate_match_sizes(g)
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)
    out = []
    for j, e in enumerate(es):
        if out and out[-1][0] == e:
            out[-1][2] = j + 1
        else:
            out.append([int(e), j, j + 1])
    return [(e, a, b, int(offsets[a]), int(offsets[b])) for e, a, b in out]


def _decode_sch_groups(cfg: PuschRxConfig, parts, cb_ranges, harq_buffer):
    """Per equal-E group HARQ combining + LDPC decode + CB/TB CRC.

    Early stop takes each CB's CRC verdict and sweep count from the decoder;
    fixed iterations run `nof_ldpc_iterations` sweeps and check the CB CRC
    on the hard bits afterwards (all-true when the CBs carry none).

    parts: per group (B, nof_cb_in_group, N) dematched soft bits; cb_ranges
    the groups' [a, b) codeblock ranges.
    """
    seg = cfg.segmentation
    b = parts[0].shape[0]
    if harq_buffer is not None:
        parts = [rm.harq_combine(harq_buffer[:, a:bnd], part)
                 for (a, bnd), part in zip(cb_ranges, parts)]
    soft = torch.cat(parts, dim=1) if cfg.emit_harq_soft else None

    kp = seg.nof_payload_bits_per_cb
    crc_cb = "CRC24B" if seg.cb_crc_bits else tb_crc_name(seg)
    hards, oks, its = [], [], []
    for part in parts:
        cg = part.shape[1]
        llr = part.reshape(b * cg, -1).contiguous()
        if cfg.ldpc_early_stop:
            h, _, ok, it = ldpc_decode_es(llr, seg.base_graph, seg.lifting_size, crc_cb, kp,
                                          nof_iterations=cfg.nof_ldpc_iterations)
            oks.append(ok.reshape(b, cg))
            its.append(it.reshape(b, cg))
        else:
            h, _ = ldpc_decode(llr, seg.base_graph, seg.lifting_size,
                               nof_iterations=cfg.nof_ldpc_iterations)
        hards.append(h.reshape(b, cg, -1))
    hard = torch.cat(hards, dim=1)
    if cfg.ldpc_early_stop:
        cb_ok, iters = torch.cat(oks, dim=1), torch.cat(its, dim=1)
    else:
        cb_ok = (crc_check_device(hard[:, :, :kp], "CRC24B") if seg.cb_crc_bits
                 else torch.ones((b, seg.nof_cb), dtype=torch.bool, device=hard.device))
        iters = torch.full((b, seg.nof_cb), cfg.nof_ldpc_iterations, dtype=torch.int32,
                           device=hard.device)
    payload = hard[:, :, :kp - seg.cb_crc_bits]
    return {
        "tb_crc_ok": crc_check_device_cbs(payload, tb_crc_name(seg), cfg.tbs + seg.tb_crc_bits),
        "cb_crc_ok": cb_ok,
        "tb_bits_cb": payload,
        "ldpc_iterations": iters,
        "harq_soft": soft,
    }


def _dematch_rows(cfg: PuschRxConfig, sch_llr: torch.Tensor, groups):
    """Row-layout SCH LLRs (B, G_sch) -> per equal-E group (B, C_g, N)."""
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    b = sch_llr.shape[0]
    return [rm.rate_dematch(sch_llr[:, x0:x1].reshape(b, cb1 - cb0, e), seg.base_graph,
                            seg.lifting_size, seg.nof_filler_bits_per_cb, cfg.rv, e, qm)
            for e, cb0, cb1, x0, x1 in groups]


def _static_fix(plan, name: str, cfg: PuschRxConfig, scr_bits, dev):
    idx, payload = plan.field_bit_idx(name), plan.field_payload(name)
    fix = placeholder_fix_signs(idx, payload, bits_per_symbol(cfg.modulation), scr_bits)
    return torch.as_tensor(fix.astype(np.int32), device=dev)


def _scaled(noise_var: torch.Tensor, scale: float) -> torch.Tensor:
    return noise_var if scale == 1.0 else noise_var * scale


def build_pusch_phase_b(cfg: PuschRxConfig, nof_csi_part2_bits: int, device="cuda"):
    """Phase B of the CSI part-1 -> part-2 protocol, one program per part-2
    size bucket: codeword LLRs from phase A (`decode_sch=False`) -> CSI part 2
    decode + SCH rate recovery (+ HARQ combining) + LDPC decode + CRCs.

    Returns fn(llr (B, G) int8, harq_buffer=None, csi2_fix=None): `csi2_fix`
    is the (B, E_csi2) placeholder fix-sign input in dynamic mode; baked from
    cfg's scrambling otherwise.
    reference: pusch_processor_impl.cpp:40-92 (csi-part1-feedback),
    ulsch_demultiplex_impl.cpp:241 (set_csi_part2).
    """
    dev = resolve_device(device)
    qm = bits_per_symbol(cfg.modulation)
    plan, info = cfg.demux_plan(nof_csi_part2_bits)
    groups = _cb_groups(cfg, info.nof_ul_sch_bits)
    csi2_idx = torch.as_tensor(plan.csi2_bit_idx, device=dev)
    sch_idx = torch.as_tensor(plan.sch_bit_idx, device=dev)
    csi2_fix_static = None
    if not cfg.dynamic_params and nof_csi_part2_bits:
        scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
        csi2_fix_static = _static_fix(plan, "csi2", cfg, scr_bits, dev)

    @torch.no_grad()
    def phase_b(llr: torch.Tensor, harq_buffer: torch.Tensor | None = None,
                csi2_fix: torch.Tensor | None = None) -> dict:
        if tuple(llr.shape[1:]) != (cfg.nof_codeword_bits,) or llr.device != dev:
            raise ValueError(f"llr must be (B, {cfg.nof_codeword_bits}) on {dev}, "
                             f"got {tuple(llr.shape)} on {llr.device}")
        out = {}
        if nof_csi_part2_bits:
            if cfg.dynamic_params and csi2_fix is None:
                raise ValueError("dynamic_params phase B takes csi2_fix")
            fix = csi2_fix.to(torch.int32) if cfg.dynamic_params else csi2_fix_static
            with tracing.span("pusch_rx.uci"):
                out["csi2_bits"], out["csi2_metric"] = decode_uci_field(
                    llr[:, csi2_idx].to(torch.int32) * fix, nof_csi_part2_bits, qm)
        with tracing.span("pusch_rx.dematch"):
            parts = _dematch_rows(cfg, llr[:, sch_idx], groups)
        with tracing.span("pusch_rx.decode"):
            out.update(_decode_sch_groups(cfg, parts, [(a, bnd) for _, a, bnd, _, _ in groups],
                                          harq_buffer))
        return out

    return phase_b


@functools.lru_cache(maxsize=None)
def cached_pusch_phase_b(cfg: PuschRxConfig, nof_csi_part2_bits: int, device="cuda"):
    return build_pusch_phase_b(cfg, nof_csi_part2_bits, device)


def build_pusch_rx_from_grid(cfg: PuschRxConfig, device="cuda"):
    """fn(grid (B, P, nsym, nsubc_alloc, 2), harq_buffer=None, ref_dmrs=None,
    dyn_signs=None, dyn_uci_fix=None) -> result dict.

    The grid covers exactly the PUSCH allocation; with hopping, the caller
    gathers each symbol's rows from that symbol's hop.  Config-derived
    tables (DM-RS references, descrambling and fix signs, placement indices,
    epochs) are built once here and kept on `device`: the card unless the
    caller asks for the CPU.  With `dynamic_params` the rnti/n_id/slot-derived
    values are call inputs instead: `ref_dmrs` (B, ndmrs, npil, 2) float32,
    `dyn_signs` (B, G) int8 descrambling signs, and with UCI `dyn_uci_fix` =
    (ack, csi1, csi2) placeholder fix signs, each (B, E_field) or None.
    `fn.demap_kernel` says whether the demap stage bound here is the
    hand-written kernel of `ops.pusch_demap` (on a card) or its plain version.
    """
    _check_scope(cfg)
    dev = resolve_device(device)
    demap_fn = demap_route(dev)
    qm = bits_per_symbol(cfg.modulation)
    nlayers, nports = cfg.nof_layers, cfg.nof_rx_ports
    nre = cfg.nof_data_re
    plan, info = cfg.demux_plan()
    groups = _cb_groups(cfg, info.nof_ul_sch_bits)
    cb_ranges = [(a, bnd) for _, a, bnd, _, _ in groups]
    has_uci = bool(cfg.nof_harq_ack_bits or cfg.nof_csi_part1_bits or cfg.nof_csi_part2_bits)
    hopping = cfg.hop_symbol is not None
    cdm = nlayers > 1 or cfg.dmrs_config_type == 2

    ref = dmrs_reference(cfg)  # (ndmrs, npil) complex64
    ndmrs, npil = ref.shape
    ref_pair = torch.as_tensor(np_to_pair(ref), device=dev)
    pil0, comb_delta, cdm_stride = dmrs_subcarriers(cfg)
    comb_subc = [torch.as_tensor(pil0 + comb * comb_delta, device=dev)
                 for comb in range((nlayers + 1) // 2)]
    dmrs_syms = torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int64), device=dev)
    data_syms = torch.as_tensor(np.asarray(cfg.data_symbols, np.int64), device=dev)
    scr_bits = prg_mod.gold_sequence_bits(cfg.scrambling_cinit(), cfg.nof_codeword_bits)
    signs = torch.as_tensor(1 - 2 * scr_bits.astype(np.int8), device=dev)  # (G,) row layout
    if has_uci:
        field_idx = {name: torch.as_tensor(plan.field_bit_idx(name), device=dev)
                     for name in ("ack", "csi1", "csi2")}
        punct_idx = torch.as_tensor(plan.punct_bit_idx, device=dev)
        sch_idx = torch.as_tensor(plan.sch_bit_idx, device=dev)
        static_fix = {name: _static_fix(plan, name, cfg, scr_bits, dev)
                      for name in ("ack", "csi1", "csi2")}
    epochs = cfg.symbol_epochs_s()
    dmrs_epochs = tuple(epochs[cfg.start_symbol + int(s)] for s in cfg.dmrs_symbols)
    all_epochs = torch.as_tensor(np.asarray(
        [epochs[cfg.start_symbol + s] for s in range(cfg.nof_ofdm_symbols)], np.float32),
        device=dev)
    data_epochs = torch.as_tensor(np.asarray(
        [epochs[cfg.start_symbol + s] for s in cfg.data_symbols], np.float32), device=dev)
    # Per hop: [a, b) ranges on the DM-RS and the data symbol axes (both are
    # sorted, so a hop is a contiguous range of each).
    nhops = 2 if hopping else 1

    def hop_ranges(syms):
        n0 = sum(1 for s in syms if not _hop_of(cfg, cfg.start_symbol + s))
        return [(0, n0), (n0, len(syms))] if hopping else [(0, len(syms))]

    dmrs_hops, data_hops = hop_ranges(cfg.dmrs_symbols), hop_ranges(cfg.data_symbols)
    # Per hop (one with CDM): the factor from the estimate's noise variance
    # to the per-RE noise (1.0: the JAX package's estimate).
    if not cfg.unbiased_noise:
        noise_scale = [1.0] * len(dmrs_hops)
    elif cdm:
        noise_scale = [2.0 / noise_residual_share(cfg.nof_rb, cdm_stride, ndmrs)]
    else:
        noise_scale = [1.0 / noise_residual_share(cfg.nof_rb, 2, d1 - d0) for d0, d1 in dmrs_hops]
    ones_pair = torch.zeros((ndmrs, npil // 2, 2), dtype=torch.float32, device=dev)
    ones_pair[..., 0] = 1.0
    weights_fn = {"mmse": mmse_weights, "zf": zf_weights}[cfg.equalizer]
    grid_shape = (nports, cfg.nof_ofdm_symbols, cfg.nof_subc, 2)

    def estimate(grid, ref_dmrs):
        """-> per hop MMSE/ZF weights (B, S, L, P, 2) and post-eq noise
        (B, S, L); TA (B,); CFO (B,) or None."""
        pilots = grid[:, :, dmrs_syms]  # (B, P, ndmrs, nsubc, 2)
        rx_pilots = pilots[:, :, :, comb_subc[0]].float()
        if not cdm:
            # One estimate per hop (the whole allocation without hopping);
            # per-hop TA and CFO are then averaged
            # (reference: port_channel_estimator_average_impl.cpp:238-330).
            ws, nvs, tas, cfos = [], [], [], []
            for (d0, d1), scale in zip(dmrs_hops, noise_scale):
                one_hop = (d0, d1) == (0, ndmrs)
                ref_k = (ref_dmrs[:, None, d0:d1] if ref_dmrs is not None
                         else ref_pair if one_hop else ref_pair[d0:d1])
                est = estimate_channel_hop(rx_pilots if one_hop else rx_pilots[:, :, d0:d1],
                                           ref_k, cfg.nof_rb, 2, cfg.scs_hz,
                                           dmrs_epochs[d0:d1])  # leading (B, P)
                h_sub = est["ce_pair"].permute(0, 2, 1, 3)[..., None, :]  # (B, S, P, 1, 2)
                w_k, nv_k = weights_fn(h_sub, _scaled(est["noise_var"], scale))
                ws.append(w_k)
                nvs.append(nv_k)
                tas.append(est["time_alignment_s"])
                if d1 - d0 >= 2:
                    cfos.append(est["cfo_hz"])
            ta = tas[0] if nhops == 1 else (tas[0] + tas[1]) / 2
            cfo = None
            if cfg.compensate_cfo and cfos:
                cfo = (cfos[0] if len(cfos) == 1 else (cfos[0] + cfos[1]) / 2).mean(dim=-1)
            return ws, nvs, ta.mean(dim=-1), cfo
        # CDM: despread the fd-OCC over adjacent pilot pairs into per-layer
        # LSEs (layers {0,1} on CDM group 0, {2,3} on group 1), then estimate
        # each (layer, port) at the pilot-pair stride
        # (reference: dmrs_pusch_estimator_impl.cpp:43-66).
        ref_c = to_cplx(ref_dmrs)[:, None] if ref_dmrs is not None else to_cplx(ref_pair)
        layer_lse = []
        for comb in range((nlayers + 1) // 2):
            yp = to_cplx(rx_pilots if comb == 0 else pilots[:, :, :, comb_subc[comb]].float())
            pairs = (yp * ref_c.conj()).reshape(yp.shape[:-1] + (npil // 2, 2))
            layer_lse.append(pairs.mean(dim=-1))
            if 2 * comb + 1 < nlayers:
                layer_lse.append((pairs[..., 0] - pairs[..., 1]) * 0.5)
        est = estimate_channel_hop(from_cplx(torch.stack(layer_lse)), ones_pair,
                                   cfg.nof_rb, cdm_stride, cfg.scs_hz, dmrs_epochs)  # (L, B, P)
        h_sub = est["ce_pair"].permute(1, 3, 2, 0, 4)  # (B, S, P, L, 2)
        w, nv = weights_fn(h_sub, _scaled(est["noise_var"].mean(dim=0), noise_scale[0]))
        cfo = (est["cfo_hz"].mean(dim=(0, 2))
               if cfg.compensate_cfo and ndmrs >= 2 else None)
        return [w], [nv], est["time_alignment_s"][0].mean(dim=-1), cfo

    def equalize(grid, ws, nvs, cfo_b):
        """-> the data symbols' REs (B, nre*L, 2), layer-minor, and their
        post-eq noise (B, nre*L)."""
        b = grid.shape[0]
        if not hopping:
            # Every slot symbol in the grid's layout, CFO derotation fused in.
            rot = None
            if cfo_b is not None:
                ang = (2.0 * math.pi) * cfo_b[:, None] * all_epochs[None, :]
                rot = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
            eq = apply_weights_ports_first(ws[0], grid.float(), rot)[:, data_syms]
            nv = nvs[0][:, None].expand(b, len(cfg.data_symbols), cfg.nof_subc, nlayers)
            return eq.reshape(b, nre * nlayers, 2), nv.reshape(b, nre * nlayers)
        data = grid.float()[:, :, data_syms]  # (B, P, T, S, 2)
        eq = torch.cat([apply_weights_ports_first(w_k, data[:, :, t0:t1])
                        for w_k, (t0, t1) in zip(ws, data_hops)], dim=1)  # (B, T, S, 1, 2)
        nv = torch.cat([nv_k[:, None].expand(b, t1 - t0, cfg.nof_subc, 1)
                        for nv_k, (t0, t1) in zip(nvs, data_hops)], dim=1)
        if cfo_b is not None:
            # Post-hoc derotation of the concatenated hops.
            ang = (2.0 * math.pi) * cfo_b[:, None] * data_epochs[None, :]
            cr, ci = torch.cos(ang)[:, :, None, None], torch.sin(ang)[:, :, None, None]
            er, ei = eq[..., 0], eq[..., 1]
            eq = torch.stack([er * cr + ei * ci, ei * cr - er * ci], dim=-1)
        return eq.reshape(b, nre, 2), nv.reshape(b, nre)

    def metrics(eq, nvs, nv_flat, ta):
        if hopping:
            snr = (1.0 / torch.clamp(nv_flat, min=1e-9)).mean(dim=-1)
        else:
            snr = (1.0 / torch.clamp(nvs[0], min=1e-9)).mean(dim=(-1, -2))
        return {"evm": evm_fn(eq, cfg.modulation),
                "snr_db": 10.0 * torch.log10(torch.clamp(snr, min=1e-9)),
                "ta_s": ta}

    def demap(eq, nv_flat, dyn_signs, bit_major):
        """Demap + descrambling (`ops.pusch_demap`: the kernel on the card)
        -> bit-major (B, Qm, N) int8, which is already the rate dematcher's
        deinterleaved order (no UCI: the SCH placement is the identity), or
        the row layout (B, G) the UCI placement indexes."""
        return demap_fn(eq.contiguous(), nv_flat.contiguous(),
                        signs if dyn_signs is None else dyn_signs.contiguous(),
                        cfg.modulation, bit_major)

    def dematch_bit_major(llr_bm):
        """Per equal-E codeblock group: (B, C_g, N) circular-buffer LLRs."""
        b = llr_bm.shape[0]
        seg = cfg.segmentation
        return [rm.rate_dematch_bit_major(
            llr_bm[:, :, x0 // qm:x1 // qm].reshape(b, qm, cb1 - cb0, e // qm), seg.base_graph,
            seg.lifting_size, seg.nof_filler_bits_per_cb, cfg.rv, e, qm)
            for e, cb0, cb1, x0, x1 in groups]

    def field(llr, name, fix):
        return llr[:, field_idx[name]].to(torch.int32) * fix

    @torch.no_grad()
    def rx(grid: torch.Tensor, harq_buffer: torch.Tensor | None = None,
           ref_dmrs: torch.Tensor | None = None, dyn_signs: torch.Tensor | None = None,
           dyn_uci_fix=None) -> dict:
        if tuple(grid.shape[1:]) != grid_shape or grid.device != dev:
            raise ValueError(f"grid must be (B,) + {grid_shape} on {dev}, "
                             f"got {tuple(grid.shape)} on {grid.device}")
        if cfg.dynamic_params:
            if ref_dmrs is None or dyn_signs is None:
                raise ValueError("dynamic_params programs take (grid, harq, ref_dmrs, dyn_signs)")
            if has_uci and dyn_uci_fix is None:
                raise ValueError("dynamic_params with UCI takes dyn_uci_fix=(ack, csi1, csi2)")
        else:
            ref_dmrs = dyn_signs = dyn_uci_fix = None
        b = grid.shape[0]
        with tracing.span("pusch_rx.estimate"):
            ws, nvs, ta, cfo_b = estimate(grid, ref_dmrs)
        with tracing.span("pusch_rx.equalize"):
            eq, nv_flat = equalize(grid, ws, nvs, cfo_b)
        no_ack = {"harq_ack_bits": torch.zeros((b, 0), dtype=torch.uint8, device=dev),
                  "harq_ack_metric": torch.zeros((b,), dtype=torch.float32, device=dev)}
        if not has_uci:
            with tracing.span("pusch_rx.demap"):
                llr_bm = demap(eq, nv_flat, dyn_signs, bit_major=True)
            with tracing.span("pusch_rx.dematch"):
                parts = dematch_bit_major(llr_bm)
            with tracing.span("pusch_rx.decode"):
                out = _decode_sch_groups(cfg, parts, cb_ranges, harq_buffer)
            with tracing.span("pusch_rx.metrics"):
                out.update(metrics(eq, nvs, nv_flat, ta), **no_ack)
            return out

        with tracing.span("pusch_rx.demap"):
            llr = demap(eq, nv_flat, dyn_signs, bit_major=False)  # (B, G) int8
        fix = dict(static_fix)
        if dyn_uci_fix is not None:
            fix = {name: (f.to(torch.int32) if f is not None else None)
                   for name, f in zip(("ack", "csi1", "csi2"), dyn_uci_fix)}
        out = dict(no_ack)
        with tracing.span("pusch_rx.uci"):
            if cfg.nof_harq_ack_bits:
                out["harq_ack_bits"], out["harq_ack_metric"] = decode_uci_field(
                    field(llr, "ack", fix["ack"]), cfg.nof_harq_ack_bits, qm)
            if len(plan.punct_bit_idx):
                # <=2-bit ACK punctures: those positions carry no SCH/CSI2
                # information (ulsch_demultiplex_impl.cpp:493/499).
                llr[:, punct_idx] = 0
            if cfg.nof_csi_part1_bits:
                out["csi1_bits"], out["csi1_metric"] = decode_uci_field(
                    field(llr, "csi1", fix["csi1"]), cfg.nof_csi_part1_bits, qm)
            if not cfg.decode_sch:
                # Phase A: the part-2 and SCH placement depend on the part-2
                # size, a host decision from the decoded part 1; hand the
                # descrambled, punct-zeroed codeword LLRs to phase B.
                out["codeword_llr"] = llr
            elif cfg.nof_csi_part2_bits:
                out["csi2_bits"], out["csi2_metric"] = decode_uci_field(
                    field(llr, "csi2", fix["csi2"]), cfg.nof_csi_part2_bits, qm)
        if cfg.decode_sch:
            with tracing.span("pusch_rx.dematch"):
                parts = _dematch_rows(cfg, llr[:, sch_idx], groups)
            with tracing.span("pusch_rx.decode"):
                out.update(_decode_sch_groups(cfg, parts, cb_ranges, harq_buffer))
        with tracing.span("pusch_rx.metrics"):
            out.update(metrics(eq, nvs, nv_flat, ta))
        return out

    rx.demap_kernel = demap_fn is demap_descramble_cuda
    return rx


@functools.lru_cache(maxsize=None)
def cached_pusch_rx_from_grid(cfg: PuschRxConfig, device="cuda"):
    return build_pusch_rx_from_grid(cfg, device)


def build_pusch_rx_slot(cfg: PuschRxConfig, device="cuda"):
    """fn(samples (B, P, nsamples, 2) float32, harq_buffer=None) -> result dict.

    Result keys (as the JAX program): tb_crc_ok (B,), cb_crc_ok (B, C),
    tb_bits_cb (B, C, Kpay) uint8, ldpc_iterations (B, C) int32, harq_soft
    (B, C, N) int8, snr_db, evm, ta_s (B,), harq_ack_bits (B, K_ack),
    harq_ack_metric (B,), and with CSI csi1/csi2_bits and _metric.  Runs on
    the card unless `device` names the CPU, where the LDPC decoder takes its
    plain torch version.
    """
    from_grid = build_pusch_rx_from_grid(cfg, device)

    @torch.no_grad()
    def rx(samples: torch.Tensor, harq_buffer: torch.Tensor | None = None) -> dict:
        with tracing.span("pusch_rx.ofdm_demodulate"):
            grid = ofdm_mod.ofdm_demodulate(
                samples, cfg.nof_subc, cfg.dft_size, cfg.numerology,
                cfg.slot % (1 << cfg.numerology), out_dtype="bf16" if cfg.grid_bf16 else "f32")
        return from_grid(grid, harq_buffer)

    return rx


@functools.lru_cache(maxsize=None)
def cached_pusch_rx(cfg: PuschRxConfig, device="cuda"):
    """`build_pusch_rx_slot(cfg, device)`, built once per (cfg, device)."""
    return build_pusch_rx_slot(cfg, device)
