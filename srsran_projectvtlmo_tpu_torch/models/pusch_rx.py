"""PUSCH receive slot (port of `srsran_projectvtlmo_tpu.models.pusch_rx`).

One slot program: OFDM demodulation -> DM-RS channel estimation -> MMSE
equalization with CFO derotation -> bit-major soft demapping ->
descrambling -> rate recovery (+ HARQ combining) -> LDPC decoding, early
stop or fixed iterations (the CUDA kernel on the card) -> CB/TB CRC checks.
Codeblocks and slots batch on leading axes.

Scope of this port: the SCH-only bit-major path (no UCI), DM-RS type 1
without hopping, per-slot constant cell parameters, MMSE, 1-4 layers over
1-4 rx ports, HARQ combining, both decoder modes.  Other settings raise
NotImplementedError naming the ROADMAP item that will carry them.
reference: lib/phy/upper/channel_processors/pusch/pusch_processor_impl.cpp:115-298,
pusch_decoder_impl.cpp:294-398.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from srsran_projectvtlmo_tpu.ops import prg as prg_mod
from srsran_projectvtlmo_tpu.ops.dmrs import dmrs_type1_sequence
from srsran_projectvtlmo_tpu.ran.modulation import bits_per_symbol

from ..ops import ofdm as ofdm_mod
from ..ops.channel_estimate import estimate_channel_hop
from ..ops.crc import crc_check_device, crc_check_device_cbs
from ..ops.demodulation import soft_demap
from ..ops.equalization import apply_weights_ports_first, mmse_weights
from ..ops.evm import evm as evm_fn
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc.decode_cuda import ldpc_decode, ldpc_decode_es
from ..ops.ldpc.segment import tb_crc_name
from ..utils.cplx import from_cplx, np_to_pair, to_cplx
from ..utils.tables import resolve_device
from .sch_config import SchChainConfig


@dataclass(frozen=True)
class PuschRxConfig(SchChainConfig):
    """The JAX `PuschRxConfig`'s fields and defaults, less the TPU decoder
    selection (`use_pallas_decoder`) and the UCI rate-matching factors
    (`alpha_scaling`, `beta_offset_*`), which come with UCI (ROADMAP A7)."""

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
    compensate_cfo: bool = True
    emit_harq_soft: bool = True
    dynamic_params: bool = False
    decode_sch: bool = True
    dmrs_config_type: int = 1
    hop_symbol: int | None = None
    second_hop_prb: int | None = None

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


def _check_scope(cfg: PuschRxConfig) -> None:
    deferred = [
        (cfg.nof_harq_ack_bits or cfg.nof_csi_part1_bits or cfg.nof_csi_part2_bits
         or not cfg.decode_sch, "UCI on PUSCH (ROADMAP A7)"),
        (cfg.hop_symbol is not None, "intra-slot frequency hopping (ROADMAP A6b)"),
        (cfg.dmrs_config_type != 1, "DM-RS type 2 (ROADMAP A6b)"),
        (cfg.dynamic_params, "dynamic_params (ROADMAP A6b)"),
        (cfg.equalizer != "mmse", f"equalizer {cfg.equalizer!r} (ROADMAP A6b)"),
    ]
    for cond, what in deferred:
        if cond:
            raise NotImplementedError(f"not ported yet: {what}")
    if not 1 <= cfg.nof_layers <= 4 or not 1 <= cfg.nof_rx_ports <= 4:
        raise ValueError("1-4 layers over 1-4 rx ports")


def flatten_tb_bits(tb_bits_cb, tbs: int):
    """(B, C, Kpay) per-codeblock payload bits -> (B, tbs) TB bits (numpy or tensor)."""
    return tb_bits_cb.reshape(tb_bits_cb.shape[0], -1)[:, :tbs]


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


def build_pusch_rx_from_grid(cfg: PuschRxConfig, device="cpu"):
    """fn(grid (B, P, nsym, nsubc_alloc, 2), harq_buffer=None) -> result dict.

    The grid covers exactly the PUSCH allocation.  Config-derived tables
    (DM-RS references, descrambling signs, epochs) are built once here and
    kept on `device`.
    """
    _check_scope(cfg)
    dev = resolve_device(device)
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    nlayers, nports = cfg.nof_layers, cfg.nof_rx_ports
    es = cfg.cb_rate_match_sizes()
    offsets = np.concatenate([[0], np.cumsum(es)]).astype(int)
    groups: dict[int, list[int]] = {}
    for j in range(seg.nof_cb):
        groups.setdefault(int(es[j]), []).append(j)

    ref = np.stack([dmrs_type1_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
                                        prb_start=cfg.rb_start)
                    for s in cfg.dmrs_symbols])  # (ndmrs, npil) complex64
    ref_pair = torch.as_tensor(np_to_pair(ref), device=dev)
    pil_subc = torch.as_tensor(2 * np.arange(6 * cfg.nof_rb), device=dev)
    dmrs_syms = torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int64), device=dev)
    data_syms = torch.as_tensor(np.asarray(cfg.data_symbols, np.int64), device=dev)
    nre = cfg.nof_data_re
    descr = 1 - 2 * prg_mod.gold_sequence_bits(cfg.scrambling_cinit(),
                                               cfg.nof_codeword_bits).astype(np.int32)
    signs_bm = torch.as_tensor(np.ascontiguousarray(descr.reshape(nre * nlayers, qm).T),
                               device=dev)  # (qm, nre*L)
    epochs = cfg.symbol_epochs_s()
    dmrs_epochs = tuple(epochs[cfg.start_symbol + int(s)] for s in cfg.dmrs_symbols)
    all_epochs = torch.as_tensor(np.asarray(
        [epochs[cfg.start_symbol + s] for s in range(cfg.nof_ofdm_symbols)], np.float32),
        device=dev)
    ndmrs, npil = ref.shape
    ones_pair = torch.zeros((ndmrs, npil // 2, 2), dtype=torch.float32, device=dev)
    ones_pair[..., 0] = 1.0
    use_cfo = cfg.compensate_cfo and ndmrs >= 2
    grid_shape = (nports, cfg.nof_ofdm_symbols, cfg.nof_subc, 2)

    def estimate(grid):
        """-> MMSE weights (B, S, L, P, 2), post-eq noise (B, S, L), TA (B,), CFO (B,)|None."""
        pilots = grid[:, :, dmrs_syms]  # (B, P, ndmrs, nsubc, 2)
        rx_pilots = pilots[:, :, :, pil_subc].float()
        if nlayers == 1:
            est = estimate_channel_hop(rx_pilots, ref_pair, cfg.nof_rb, 2, cfg.scs_hz,
                                       dmrs_epochs)  # leading (B, P)
            h_sub = est["ce_pair"].permute(0, 2, 1, 3)[..., None, :]  # (B, S, P, 1, 2)
            noise = est["noise_var"]  # (B, P)
            ta = est["time_alignment_s"].mean(dim=-1)
            cfo_b = est["cfo_hz"].mean(dim=-1) if use_cfo else None
        else:
            # Type-1 CDM: despread the fd-OCC over adjacent pilot pairs into
            # per-layer LSEs (layers {0,1} on even subcarriers, {2,3} on odd),
            # then estimate each (layer, port) at pilot stride 4
            # (reference: dmrs_pusch_estimator_impl.cpp:43-53).
            ref_c = to_cplx(ref_pair)
            layer_lse = []
            for comb in range((nlayers + 1) // 2):
                yp = to_cplx(rx_pilots if comb == 0
                             else pilots[:, :, :, pil_subc + comb].float())
                pairs = (yp * ref_c.conj()).reshape(yp.shape[:-1] + (npil // 2, 2))
                layer_lse.append(pairs.mean(dim=-1))
                if 2 * comb + 1 < nlayers:
                    layer_lse.append((pairs[..., 0] - pairs[..., 1]) * 0.5)
            est = estimate_channel_hop(from_cplx(torch.stack(layer_lse)), ones_pair,
                                       cfg.nof_rb, 4, cfg.scs_hz, dmrs_epochs)  # (L, B, P)
            h_sub = est["ce_pair"].permute(1, 3, 2, 0, 4)  # (B, S, P, L, 2)
            noise = est["noise_var"].mean(dim=0)  # (B, P)
            ta = est["time_alignment_s"][0].mean(dim=-1)
            cfo_b = est["cfo_hz"].mean(dim=(0, 2)) if use_cfo else None
        w, nv = mmse_weights(h_sub, noise)
        return w, nv, ta, cfo_b

    def equalize(grid, w, cfo_b):
        """Every slot symbol in the grid's layout, CFO derotation fused in;
        -> the data symbols' REs (B, nre*L, 2), layer-minor."""
        rot = None
        if cfo_b is not None:
            ang = (2.0 * math.pi) * cfo_b[:, None] * all_epochs[None, :]
            rot = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)
        eq = apply_weights_ports_first(w, grid.float(), rot)[:, data_syms]  # (B, T, S, L, 2)
        return eq.reshape(grid.shape[0], nre * nlayers, 2)

    def demap(eq, nv):
        """Bit-major demap + descrambling -> (B, Qm, nre*L) int8, which is
        already the rate dematcher's deinterleaved order."""
        b = eq.shape[0]
        nv_flat = nv[:, None].expand(b, len(cfg.data_symbols), cfg.nof_subc, nlayers)
        llr_bm = soft_demap(eq, nv_flat.reshape(b, nre * nlayers), cfg.modulation,
                            bit_major=True)
        return torch.clamp(llr_bm.to(torch.int32) * signs_bm, -127, 127).to(torch.int8)

    def dematch(llr_bm):
        """Per equal-E codeblock group: (B, C_g, N) circular-buffer LLRs."""
        b = llr_bm.shape[0]
        parts, ranges = [], []
        for e_val, js in groups.items():
            width = e_val // qm
            re0 = offsets[js[0]] // qm
            x4 = llr_bm[:, :, re0:re0 + len(js) * width].reshape(b, qm, len(js), width)
            parts.append(rm.rate_dematch_bit_major(x4, seg.base_graph, seg.lifting_size,
                                                   seg.nof_filler_bits_per_cb, cfg.rv,
                                                   e_val, qm))
            ranges.append((js[0], js[-1] + 1))
        return parts, ranges

    @torch.no_grad()
    def rx(grid: torch.Tensor, harq_buffer: torch.Tensor | None = None) -> dict:
        if tuple(grid.shape[1:]) != grid_shape or grid.device != dev:
            raise ValueError(f"grid must be (B,) + {grid_shape} on {dev}, "
                             f"got {tuple(grid.shape)} on {grid.device}")
        b = grid.shape[0]
        with record_function("pusch_rx.estimate"):
            w, nv, ta, cfo_b = estimate(grid)
        with record_function("pusch_rx.equalize"):
            eq = equalize(grid, w, cfo_b)
        with record_function("pusch_rx.demap"):
            llr_bm = demap(eq, nv)
        with record_function("pusch_rx.dematch"):
            parts, ranges = dematch(llr_bm)
        with record_function("pusch_rx.decode"):
            out = _decode_sch_groups(cfg, parts, ranges, harq_buffer)
        with record_function("pusch_rx.metrics"):
            snr = (1.0 / torch.clamp(nv, min=1e-9)).mean(dim=(-1, -2))
            out.update({
                "evm": evm_fn(eq, cfg.modulation),
                "snr_db": 10.0 * torch.log10(torch.clamp(snr, min=1e-9)),
                "ta_s": ta,
                "harq_ack_bits": torch.zeros((b, 0), dtype=torch.uint8, device=dev),
                "harq_ack_metric": torch.zeros((b,), dtype=torch.float32, device=dev),
            })
        return out

    return rx


def build_pusch_rx_slot(cfg: PuschRxConfig, device="cpu"):
    """fn(samples (B, P, nsamples, 2) float32, harq_buffer=None) -> result dict.

    Result keys (as the JAX program): tb_crc_ok (B,), cb_crc_ok (B, C),
    tb_bits_cb (B, C, Kpay) uint8, ldpc_iterations (B, C) int32, harq_soft
    (B, C, N) int8, snr_db, evm, ta_s (B,), harq_ack_bits (B, 0),
    harq_ack_metric (B,).
    """
    from_grid = build_pusch_rx_from_grid(cfg, device)

    @torch.no_grad()
    def rx(samples: torch.Tensor, harq_buffer: torch.Tensor | None = None) -> dict:
        with record_function("pusch_rx.ofdm_demodulate"):
            grid = ofdm_mod.ofdm_demodulate(
                samples, cfg.nof_subc, cfg.dft_size, cfg.numerology,
                cfg.slot % (1 << cfg.numerology), out_dtype="bf16" if cfg.grid_bf16 else "f32")
        return from_grid(grid, harq_buffer)

    return rx
