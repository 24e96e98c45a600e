"""PUCCH processors: formats 0, 1 and 2, TS 38.211 Section 6.3.2
(port of `srsran_projectvtlmo_tpu.phy.pucch`).

Format 0: sequence-selection detection -- correlate the received PRB against
the 12 cyclic-shift candidates of the base sequence, combined over rx ports.
Format 1: OCC-despread coherent detection with DM-RS channel estimation, per
hop with intra-slot hopping.
Format 2: per-RB LS estimation, MRC over ports, QPSK demapping, descrambling
and UCI decoding (short block / polar), DM-RS on subcarriers {1, 4, 7, 10} of
each RB.
The candidate sequences and pilots are host tables, built once per
configuration and kept on the device; the detection itself is a few complex
tensor ops.
reference: lib/phy/upper/channel_processors/pucch_processor_impl.cpp:30-186,
pucch_detector_impl.cpp, pucch_demodulator_impl.cpp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import prg as prg_mod
from ..ops import uci as uci_mod
from ..ops.demodulation import soft_demap
from ..ops.low_papr import low_papr_sequence, pucch_group_sequence
from ..ran.modulation import Modulation
from ..utils.cplx import to_cplx
from ..utils.tables import on_device

NRE = 12

#: Detection thresholds: the detectors' normalized metrics target ~1%
#: false-alarm probability, like the reference's constant THRESHOLD = 4.0
#: on its unit-variance statistics (reference: pucch_detector_impl.cpp:279-286,
#: pucch_detector_format0.h:50).
F0_DETECTION_THRESHOLD = 4.0
F1_DETECTION_THRESHOLD = 4.0


def _with_ports(rx: torch.Tensor) -> torch.Tensor:
    """Accept (B, S, N, 2) single-port or (B, P, S, N, 2) multi-port REs: every
    processor combines all rx ports, as the reference does
    (pucch_detector_impl.cpp:225-241)."""
    if rx.dim() == 4:
        return rx[:, None]
    if rx.dim() != 5:
        raise ValueError(f"expected 4-D or 5-D PUCCH REs, got shape {tuple(rx.shape)}")
    return rx


def _cyclic_shift_hopping(n_id: int, slot: int, symbol: int) -> int:
    """n_cs(n_s, l) from the Gold sequence with c_init = n_id (Section 6.3.2.2.2)."""
    offset = 8 * (14 * slot + symbol)
    bits = prg_mod.gold_sequence_bits(n_id, offset + 8)[offset:offset + 8]
    return int((bits * (1 << np.arange(8))).sum())


@functools.lru_cache(maxsize=None)
def _f0_candidates(n_id: int, slot: int, start_symbol: int, nof_symbols: int, m0: int):
    """(12, nof_symbols, 12) complex64: candidate sequences per cyclic shift."""
    u, v = pucch_group_sequence(n_id)
    cands = np.empty((12, nof_symbols, NRE), np.complex64)
    for mcs in range(12):
        for s in range(nof_symbols):
            ncs = _cyclic_shift_hopping(n_id, slot, start_symbol + s)
            alpha = 2 * np.pi * ((m0 + mcs + ncs) % NRE) / NRE
            cands[mcs, s] = low_papr_sequence(u, v, alpha, NRE)
    return cands


@dataclass(frozen=True)
class PucchFormat0Config:
    n_id: int
    slot: int
    start_symbol: int
    nof_symbols: int  # 1 or 2
    initial_cyclic_shift: int  # m0
    nof_harq_bits: int  # 0, 1 or 2
    sr_opportunity: bool = False


def _f0_cand_conj(cfg: PucchFormat0Config) -> np.ndarray:
    return np.conj(_f0_candidates(cfg.n_id, cfg.slot, cfg.start_symbol, cfg.nof_symbols,
                                  cfg.initial_cyclic_shift))


def _f0_mcs_map(nof_harq_bits: int) -> np.ndarray:
    return np.asarray({1: [0, 6], 2: [0, 3, 6, 9]}.get(nof_harq_bits, [0]), np.int64)


@torch.no_grad()
def detect_pucch_format0(rx_prb_pair: torch.Tensor, cfg: PucchFormat0Config):
    """Detect format 0 on (B, [P,] nof_symbols, 12, 2) received REs.

    Returns (harq_bits (B, nof_harq) uint8, detection_metric (B,), sr (B,) bool).
    """
    dev = rx_prb_pair.device
    y = to_cplx(_with_ports(rx_prb_pair))  # (B, P, S, 12)
    # Reference detection metric (pucch_detector_format0.cpp:130-190): per
    # (candidate, symbol, port) corr = |mean(y conj(c))|^2, noise = avg LSE
    # power minus corr, accumulated over symbols and rx ports; metric =
    # sum_corr^2 / sum(noise*corr), threshold 4.0.
    lse_mean = torch.einsum("bpsn,msn->bmps", y, on_device(_f0_cand_conj, cfg, device=dev)) / NRE
    corr_s = lse_mean.abs() ** 2  # (B, 12, P, S)
    avg_pwr = (y.abs() ** 2).mean(dim=-1)  # (B, P, S); |c| = 1
    noise_s = torch.clamp(avg_pwr[:, None] - corr_s, min=0.0)
    sum_corr = corr_s.sum(dim=(-1, -2))  # (B, 12)
    sum_nv = (noise_s * corr_s).sum(dim=(-1, -2))
    metric = torch.where(sum_nv > 1e-30, sum_corr * sum_corr / sum_nv,
                         torch.where(sum_corr > 1e-12, 1e9, 0.0))
    metric = metric / F0_DETECTION_THRESHOLD  # normalized: > 1 = detection

    cand_metric = metric[:, on_device(_f0_mcs_map, cfg.nof_harq_bits, device=dev)]
    det, best = cand_metric.max(dim=-1)
    if cfg.nof_harq_bits == 2:
        # Gray: index -> (b0, b1): 0->00, 1->01, 2->11, 3->10
        bits = torch.stack([(best == 2) | (best == 3), (best == 1) | (best == 2)],
                           dim=-1).to(torch.uint8)
    elif cfg.nof_harq_bits == 1:
        bits = best[:, None].to(torch.uint8)
    else:
        bits = torch.zeros((y.shape[0], 0), dtype=torch.uint8, device=dev)
    return bits, det, det > 1.0


@dataclass(frozen=True)
class PucchFormat1Config:
    n_id: int
    slot: int
    start_symbol: int
    nof_symbols: int  # 4..14
    initial_cyclic_shift: int
    time_domain_occ: int
    nof_harq_bits: int  # 1 or 2
    #: Intra-slot frequency hopping: the first hop holds floor(N/2) symbols,
    #: each hop despread with its own OCC and its own channel estimate.  The
    #: caller gathers each symbol's 12 REs from that symbol's hop PRB
    #: (reference: pucch_detector_impl.cpp:172-176).
    intra_slot_hopping: bool = False


def _f1_hop_ranges(cfg: PucchFormat1Config) -> list[tuple[int, int]]:
    if not cfg.intra_slot_hopping:
        return [(0, cfg.nof_symbols)]
    half = cfg.nof_symbols // 2
    return [(0, half), (half, cfg.nof_symbols)]


#: TS 38.211 Table 6.3.2.4.1-2 phi rows for spreading factor 4: the table is
#: Walsh-Hadamard ordered, not the DFT rows; every other spreading factor's
#: table equals phi(i, m) = i*m mod N.
_F1_OCC_PHI_N4 = ((0, 0, 0, 0), (0, 2, 0, 2), (0, 0, 2, 2), (0, 2, 2, 0))


def _f1_occ_weights(i: int, n: int) -> np.ndarray:
    """w_i(m) = exp(2 pi j phi_i(m) / N), TS 38.211 Table 6.3.2.4.1-2."""
    if n == 4:
        phi = np.asarray(_F1_OCC_PHI_N4[i % 4])
    else:
        phi = (i * np.arange(max(n, 1))) % max(n, 1)
    return np.exp(2j * np.pi * phi / max(n, 1)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _f1_tables(cfg: PucchFormat1Config):
    """(sequences (S, 12) complex64, per hop: data OCC weights, DM-RS OCC
    weights, data symbol indices, DM-RS symbol indices)."""
    u, v = pucch_group_sequence(cfg.n_id)
    # DM-RS on even relative symbols, data on odd (Section 6.3.2.4.2/6.4.1.3.1).
    seqs = []
    for s in range(cfg.nof_symbols):
        ncs = _cyclic_shift_hopping(cfg.n_id, cfg.slot, cfg.start_symbol + s)
        alpha = 2 * np.pi * ((cfg.initial_cyclic_shift + ncs) % NRE) / NRE
        seqs.append(low_papr_sequence(u, v, alpha, NRE))
    hops = []
    for a, b in _f1_hop_ranges(cfg):
        dmrs_idx = np.asarray([s for s in range(a, b) if s % 2 == 0], np.int64)
        data_idx = np.asarray([s for s in range(a, b) if s % 2 == 1], np.int64)
        hops.append((_f1_occ_weights(cfg.time_domain_occ, len(data_idx)),
                     _f1_occ_weights(cfg.time_domain_occ, len(dmrs_idx)), data_idx, dmrs_idx))
    return np.stack(seqs), tuple(hops)


def _f1_seq_conj(cfg: PucchFormat1Config) -> np.ndarray:
    return np.conj(_f1_tables(cfg)[0])


def _f1_hop_table(cfg: PucchFormat1Config, hop: int, item: int) -> np.ndarray:
    return _f1_tables(cfg)[1][hop][item]


@torch.no_grad()
def detect_pucch_format1(rx_prb_pair: torch.Tensor, cfg: PucchFormat1Config):
    """Detect format 1 on (B, [P,] nof_symbols, 12, 2) received REs.

    Returns (harq_bits (B, nof_harq) uint8, metric (B,)).
    """
    dev = rx_prb_pair.device
    y = to_cplx(_with_ports(rx_prb_pair))  # (B, P, S, 12)
    # Despread the base sequence from every symbol, per rx port.
    z = (y * on_device(_f1_seq_conj, cfg, device=dev)[None, None]).sum(dim=-1) / NRE  # (B, P, S)

    # Per hop and per rx port: OCC despread with the hop's own spreading
    # factor and a per-(hop, port) channel estimate; the decision variable
    # combines over hops and ports (x = sum d conj(h)), and the detection
    # statistic accumulates corr/noise over both
    # (reference: pucch_detector_impl.cpp:225-241).
    x = sum_corr = sum_nv = 0.0
    hops = _f1_hop_ranges(cfg)
    for k in range(len(hops)):
        w_data, w_dmrs, data_idx, dmrs_idx = (
            on_device(_f1_hop_table, cfg, k, i, device=dev) for i in range(4))
        dmrs, data = z[:, :, dmrs_idx], z[:, :, data_idx]  # (B, P, Nd)
        h = (dmrs * w_dmrs.conj()[None, None]).sum(dim=-1) / len(w_dmrs)
        d = (data * w_data.conj()[None, None]).sum(dim=-1) / len(w_data)
        x = x + (d * h.conj()).sum(dim=1)  # (B,)
        corr_d, corr_x = h.abs() ** 2, d.abs() ** 2  # (B, P)
        nv_dmrs = torch.clamp(((dmrs - h[..., None] * w_dmrs[None, None]).abs() ** 2)
                              .mean(dim=-1), min=0.0)
        nv_data = torch.clamp(((data - d[..., None] * w_data[None, None]).abs() ** 2)
                              .mean(dim=-1), min=0.0)
        sum_corr = sum_corr + (corr_d + corr_x).sum(dim=1)
        sum_nv = sum_nv + (nv_dmrs * corr_d + nv_data * corr_x).sum(dim=1)

    if cfg.nof_harq_bits == 1:
        bits = (x.real <= 0).to(torch.uint8)[:, None]
    else:
        bits = torch.stack([x.real <= 0, x.imag <= 0], dim=-1).to(torch.uint8)
    # Matched-filter energy over the noise estimate (reference:
    # pucch_detector_impl.cpp:277-286), divided by the hop count and the rx
    # port count so that the threshold keeps its ~1% false-alarm point with
    # hopping and at every port count.
    scale = len(hops) * y.shape[1]
    metric = torch.where(sum_nv > 1e-30, sum_corr * sum_corr / (sum_nv * scale),
                         torch.where(sum_corr > 1e-12, 1e9, 0.0))
    return bits, metric / F1_DETECTION_THRESHOLD


@dataclass(frozen=True)
class PucchFormat2Config:
    n_id: int         # scrambling (data)
    n_id0: int        # DM-RS scrambling
    rnti: int
    slot: int
    start_symbol: int
    nof_symbols: int  # 1 or 2
    nof_prb: int
    nof_uci_bits: int


def _f2_data_subc(nof_prb: int) -> np.ndarray:
    base = np.asarray([0, 2, 3, 5, 6, 8, 9, 11])
    return (np.arange(nof_prb)[:, None] * 12 + base[None, :]).reshape(-1)


def _f2_dmrs_subc(nof_prb: int) -> np.ndarray:
    base = np.asarray([1, 4, 7, 10])
    return (np.arange(nof_prb)[:, None] * 12 + base[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _f2_dmrs_ref(cfg: PucchFormat2Config) -> np.ndarray:
    """(S, 4*nof_prb) complex64 DM-RS pilots (Section 6.4.1.3.2)."""
    out = []
    for s in range(cfg.nof_symbols):
        sym = cfg.start_symbol + s
        cinit = ((1 << 17) * (14 * cfg.slot + sym + 1) * (2 * cfg.n_id0 + 1)
                 + 2 * cfg.n_id0) % (1 << 31)
        bits = prg_mod.gold_sequence_bits(cinit, 8 * cfg.nof_prb).astype(np.float32)
        vals = (1 - 2 * bits) / np.sqrt(2)
        out.append(vals[0::2] + 1j * vals[1::2])
    return np.stack(out).astype(np.complex64)


def _f2_signs(cfg: PucchFormat2Config) -> np.ndarray:
    """Descrambling signs of the E = 16 * nof_prb * nof_symbols coded bits."""
    cinit = ((cfg.rnti << 15) + cfg.n_id) & 0x7FFFFFFF
    e = 16 * cfg.nof_prb * cfg.nof_symbols
    return 1 - 2 * prg_mod.gold_sequence_bits(cinit, e).astype(np.int32)


@torch.no_grad()
def process_pucch_format2(rx_prbs_pair: torch.Tensor, cfg: PucchFormat2Config):
    """Demodulate and decode format 2 on (B, [P,] nof_symbols, 12*nof_prb, 2) REs.

    Rx ports are maximum-ratio combined with per-port noise weighting
    (reference: pucch_demodulator_impl.cpp, channel equalizer 1xN).

    Returns (uci_bits (B, K) uint8, valid (B,)).
    """
    dev = rx_prbs_pair.device
    y = to_cplx(_with_ports(rx_prbs_pair))  # (B, P, S, 12*PRB)
    ref = on_device(_f2_dmrs_ref, cfg, device=dev)  # (S, 4*PRB)

    pilots = y[..., on_device(_f2_dmrs_subc, cfg.nof_prb, device=dev)]
    lse = pilots * ref.conj()[None, None] / (ref.abs() ** 2)[None, None]
    # Channel estimate per RB (average its 4 pilots), repeated over its 8 data REs.
    lse_rb = lse.reshape(lse.shape[:-1] + (cfg.nof_prb, 4)).mean(dim=-1)  # (B, P, S, PRB)
    h_data = lse_rb.repeat_interleave(8, dim=-1)
    noise = ((pilots - lse_rb.repeat_interleave(4, dim=-1) * ref[None, None]).abs() ** 2
             ).mean(dim=(-1, -2))  # (B, P)
    inv_nv = (1.0 / torch.clamp(noise, min=1e-9))[:, :, None, None]
    d = y[..., on_device(_f2_data_subc, cfg.nof_prb, device=dev)]
    # MRC over the port axis: eq = sum_p d conj(h)/nv / sum_p |h|^2/nv, with
    # post-equalization noise variance 1 / sum_p |h|^2/nv
    # (reference equalize_mmse_1xn.h:44-96 with per-port noise).
    num = (d * h_data.conj() * inv_nv).sum(dim=1)  # (B, S, 8*PRB)
    den = torch.clamp((h_data.abs() ** 2 * inv_nv).sum(dim=1), min=1e-12)
    eq = (num / den).reshape(y.shape[0], -1)
    pair = torch.stack([eq.real, eq.imag], dim=-1)
    llr = soft_demap(pair, (1.0 / den).reshape(y.shape[0], -1), Modulation.QPSK)  # (B, E)
    llr = torch.clamp(llr.to(torch.int32) * on_device(_f2_signs, cfg, device=dev)[None],
                      -127, 127).to(torch.int8)
    return uci_mod.uci_decode(llr, cfg.nof_uci_bits, bits_per_symbol=2)
