"""PRACH preamble generation and detection, TS 38.211 Section 6.3.3
(port of `srsran_projectvtlmo_tpu.ops.prach`).

Generation: Zadoff-Chu roots x_u(n) = exp(-j pi u n(n+1) / L) with the standard
logical->physical root mapping (data/prach_tables.npz) and cyclic shifts
C_v = v * N_cs (unrestricted set).

Detection mirrors the reference's frequency-domain correlator
(reference: lib/phy/upper/channel_processors/prach_detector_generic_impl.cpp:89-339):
per root sequence, conj-multiply the received occasion spectrum, zero-padded
IDFT to the time domain (`torch.fft.ifft`, cuFFT on the card), accumulate
power per N_cs-shift window, compare the window peak against the occasion
noise floor.  All roots and windows batch into one pass of tensor ops; the
host tables (root spectra, window gathers) are built once per configuration
and kept on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..ran.prach_preamble import preamble_info
from ..utils.cplx import to_cplx
from ..utils.tables import fetch, on_device

LONG = 839
SHORT = 139

_DATA = Path(__file__).resolve().parent.parent / "data" / "prach_tables.npz"
_THRESH = Path(__file__).resolve().parent.parent / "data" / "prach_thresholds.npz"

#: TS 38.211 Tables 6.3.3.1-5/6/7, unrestricted set: zeroCorrelationZone -> N_cs.
NCS_UNRESTRICTED = {
    "1.25kHz": (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419),
    "5kHz": (0, 13, 26, 33, 38, 41, 49, 55, 64, 76, 93, 119, 139, 209, 279, 419),
    "short": (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69),
}

#: prach_subcarrier_spacing / prach_format_type enums of the reference's
#: calibration table (prach_detector_generic_thresholds.h).
_SCS_ENUM = {15e3: 0, 30e3: 1, 60e3: 2, 120e3: 3, 1.25e3: 4, 5e3: 5}
_FMT_ENUM = {"0": 0, "1": 1, "2": 2, "3": 3, "A1": 4, "A2": 5, "A3": 6,
             "B1": 7, "B4": 8, "C0": 9, "C2": 10, "A1_B1": 11, "A2_B2": 12,
             "A3_B3": 13}


@functools.lru_cache(maxsize=1)
def _root_luts():
    with np.load(_DATA) as z:
        return z["long_root_lut"].astype(int), z["short_root_lut"].astype(int)


def physical_root(logical_index: int, long_format: bool) -> int:
    long_lut, short_lut = _root_luts()
    lut = long_lut if long_format else short_lut
    return int(lut[logical_index % len(lut)])


def zc_sequence(u: int, length: int, cyclic_shift: int = 0) -> np.ndarray:
    """Time-domain ZC root sequence with cyclic shift, complex64 (host)."""
    n = (np.arange(length) + cyclic_shift) % length
    phase = -np.pi * u * n * (n + 1) / length
    return np.exp(1j * phase).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def zc_freq(u: int, length: int) -> np.ndarray:
    """DFT of the unshifted root sequence (host, cached)."""
    return np.fft.fft(zc_sequence(u, length)).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def _threshold_table():
    with np.load(_THRESH) as z:
        return {k: z[k].copy() for k in z.files}


def threshold_and_margin(nof_rx_ports: int, scs_hz: float, fmt: str,
                         zcz: int, combine_symbols: bool):
    """(threshold, margin, flag) from the reference's validated calibration
    table; the reference's own defaults for uncovered combinations
    (reference: prach_detector_generic_thresholds.h:152-168: 2.0/5 long,
    0.3/12 short; flag "red" = combination not validated)."""
    t = _threshold_table()
    sel = ((t["nof_rx_ports"] == nof_rx_ports)
           & (t["scs"] == _SCS_ENUM[scs_hz])
           & (t["format"] == _FMT_ENUM[fmt])
           & (t["zcz"] == zcz)
           & (t["combine"] == combine_symbols))
    idx = np.flatnonzero(sel)
    if len(idx):
        i = int(idx[0])
        flag = {0: "red", 1: "orange", 2: "green"}[int(t["flag"][i])]
        return float(t["threshold"][i]), int(t["margin"][i]), flag
    if fmt in ("0", "1", "2", "3"):
        return 2.0, 5, "red"
    return 0.3, 12, "red"


@dataclass(frozen=True)
class PrachDetectorConfig:
    """Static detection configuration for one occasion format."""

    sequence_length: int          # 839 or 139
    root_sequence_index: int      # logical start index
    zero_correlation_zone: int    # index into the N_cs table
    ncs_table: str = "1.25kHz"
    nof_preambles: int = 64
    #: Preamble format ("0".."3" long; "A1".."C2" short); None = "0" for long
    #: sequences, "C0" for short.
    format: str | None = None
    #: Numerology for short formats (RA SCS = 15 kHz << numerology).
    numerology: int = 0
    #: Combine the occasion's repeated preamble symbols before correlation
    #: (reference: prach_detector_generic_impl.cpp:222-243).
    combine_symbols: bool = True
    #: Detection threshold override; None resolves the reference's validated
    #: (threshold, margin) calibration table at detect time
    #: (reference: prach_detector_generic_thresholds.h:42-55).
    threshold: float | None = None

    @property
    def fmt(self) -> str:
        if self.format is not None:
            return self.format
        return "0" if self.sequence_length == LONG else "C0"

    @property
    def preamble(self):
        return preamble_info(self.fmt, self.numerology)

    @property
    def ncs(self) -> int:
        return NCS_UNRESTRICTED[self.ncs_table][self.zero_correlation_zone]

    @functools.cached_property
    def plan(self) -> tuple[np.ndarray, np.ndarray, int]:
        """(roots (R,), preamble index of first shift per root (R,), shifts/root)."""
        l = self.sequence_length
        shifts_per_root = l // self.ncs if self.ncs else 1
        roots, first = [], []
        count = 0
        logical = self.root_sequence_index
        while count < self.nof_preambles:
            roots.append(physical_root(logical, l == LONG))
            first.append(count)
            count += shifts_per_root
            logical += 1
        return np.asarray(roots), np.asarray(first), shifts_per_root


def prach_generate(cfg: PrachDetectorConfig, preamble_index: int) -> np.ndarray:
    """Frequency-domain preamble (host): DFT of the cyclically shifted root."""
    roots, _, spr = cfg.plan
    seq = zc_sequence(roots[preamble_index // spr], cfg.sequence_length,
                      (preamble_index % spr) * cfg.ncs)
    return np.fft.fft(seq).astype(np.complex64) / np.sqrt(cfg.sequence_length)


@functools.lru_cache(maxsize=None)
def _detector_tables(cfg: PrachDetectorConfig, nfft: int, margin: int):
    """Host plan mirroring the reference detector's window geometry
    (reference: prach_detector_generic_impl.cpp:128-275).

    Returns (conj root spectra (R, L) complex64, window gather idx (nwin,
    win_len), reference-energy gather idx (nwin, win_len + 2*margin),
    win_len, max_delay_limit, and the (root, window) of each preamble index,
    two (nof_preambles,) int64 arrays).
    """
    roots, first, spr = cfg.plan
    l = cfg.sequence_length
    cp_prach = cfg.preamble.cp_prach
    ncs = cfg.ncs
    conj_freq = np.stack([np.conj(zc_freq(int(u), l)) for u in roots])
    # win_width = min(N_cs, cp_prach) (cp_prach when Ncs == 0), at IDFT rate.
    win_seq = min(ncs, cp_prach) if ncs else cp_prach
    win_len = max((win_seq * nfft) // l, 1)
    # A preamble with shift C_v = v*Ncs peaks at lag (tau - C_v) mod L:
    # window v starts at (nfft - (Ncs*v*nfft)//L) mod nfft.
    starts = [(nfft - (ncs * v * nfft) // l) % nfft for v in range(spr)]
    win_idx = (np.asarray(starts)[:, None] + np.arange(win_len)[None, :]) % nfft
    ref_idx = ((np.asarray(starts)[:, None] - margin)
               + np.arange(win_len + 2 * margin)[None, :]) % nfft
    # Spurious-peak guard: accept delays < 0.8 * max_delay
    # (reference: prach_detector_generic_impl.cpp:165-167, 326-327).
    max_delay_seq = cp_prach if ncs == 0 else min(max(ncs, 1) - 1, cp_prach)
    max_delay = (max_delay_seq * nfft) // l
    gr = np.zeros(cfg.nof_preambles, np.int64)
    gv = np.zeros(cfg.nof_preambles, np.int64)
    for r in range(len(roots)):
        for v in range(spr):
            if first[r] + v < cfg.nof_preambles:
                gr[first[r] + v], gv[first[r] + v] = r, v
    return (conj_freq.astype(np.complex64), win_idx.astype(np.int64),
            ref_idx.astype(np.int64), win_len, max_delay, gr, gv)


def _table(cfg, nfft, margin, i):
    return _detector_tables(cfg, nfft, margin)[i]


def _delay_ok(cfg, nfft, margin):
    tables = _detector_tables(cfg, nfft, margin)
    return np.arange(tables[3]) < 0.8 * tables[4]


def _detect(rx_freq_pair: torch.Tensor, cfg: PrachDetectorConfig, nfft: int, margin: int):
    """Reference-faithful detection metric over (B, P, S, L) occasions.

    Per (port, symbol): correlate with each root spectrum, IDFT to the delay
    domain, modulus square; per shift window accumulate the numerator
    (window power scaled nfft/L) and the noise denominator (reference energy
    over window +/- margin minus the window sample), then metric = num/|den|
    (reference: prach_detector_generic_impl.cpp:200-315).  Returns the
    per-preamble peak metric and its lag as a TA in sequence samples, each
    (B, nof_preambles), on the device.
    """
    dev = rx_freq_pair.device
    tab = functools.partial(on_device, _table, cfg, nfft, margin, device=dev)
    win_idx, ref_idx = tab(1), tab(2)
    l = cfg.sequence_length
    rx = to_cplx(rx_freq_pair)  # (B, P, S, L)
    if cfg.combine_symbols:
        rx = rx.sum(dim=2, keepdim=True)  # coherent symbol combining
    prod = rx[:, :, :, None, :] * tab(0)[None, None, None]
    power = torch.fft.ifft(prod, n=nfft, dim=-1).abs() ** 2  # (B, P, S', R, nfft)

    w = power[..., win_idx.reshape(-1)].reshape(power.shape[:-1] + tuple(win_idx.shape))
    w = w * (np.float32(nfft) / np.float32(l))  # (B, P, S', R, nwin, win_len)
    eref = power[..., ref_idx.reshape(-1)].reshape(power.shape[:-1] + tuple(ref_idx.shape))
    eref = eref.sum(dim=-1)  # (B, P, S', R, nwin)

    # Non-coherent accumulation over ports (and symbols when not combined).
    num = w.sum(dim=(1, 2))  # (B, R, nwin, win_len)
    diff = eref[..., None] - w
    diff = torch.where(diff.abs() < 1e-30, 1e-9, diff)
    metric = num / diff.sum(dim=(1, 2)).abs()

    # Neglect delays beyond 0.8 * max_delay (adjacent-window spill).
    ok = on_device(_delay_ok, cfg, nfft, margin, device=dev)
    metric = torch.where(ok, metric, -torch.inf)
    peak, argpeak = metric.max(dim=-1)
    # Reorder the per-(root, window) peaks into preamble order on the device,
    # so one compact (B, nof_preambles) pair crosses to the host
    # (reference: prach_detector_generic_impl.cpp:300-339).
    gr, gv = tab(5), tab(6)
    ta = argpeak[:, gr, gv].float() * np.float32(l / nfft)
    return peak[:, gr, gv], ta


def prach_detect(rx_freq_pair: torch.Tensor, cfg: PrachDetectorConfig, oversampling: int = 2):
    """Detect preambles in received occasion spectra.

    rx_freq_pair: (B, L, 2) single port and symbol, or (B, P, S, L, 2)
    multi-port with S repeated preamble symbols (combined non-coherently
    across ports, coherently across symbols when cfg.combine_symbols).

    Returns per batch row a list of (preamble_index, time_advance_samples,
    metric), the metric normalized by the configuration's validated
    threshold (> 1.0 = detection; reference:
    prach_detector_generic_impl.cpp:332-333).
    """
    if rx_freq_pair.dim() == 3:
        rx_freq_pair = rx_freq_pair[:, None, None]
    nof_ports = rx_freq_pair.shape[1]
    # Reference IDFT sizes: 1024 long / 256 short
    # (channel_processor_factories.h:202-203), scalable via `oversampling`.
    nfft = (1024 if cfg.sequence_length == LONG else 256) * max(1, oversampling // 2)
    if cfg.threshold is not None:
        thr, margin = cfg.threshold, 5
    else:
        thr, margin, _ = threshold_and_margin(nof_ports, cfg.preamble.scs_hz, cfg.fmt,
                                              cfg.zero_correlation_zone, cfg.combine_symbols)
    metric, ta = _detect(rx_freq_pair, cfg, nfft, margin)
    # One compact (B, nof_preambles) fetch; the threshold scan is a numpy
    # vector compare.
    both = fetch(torch.stack([metric, ta]))
    metric, ta = both[0], both[1]
    return [[(int(i), float(ta[b, i]), float(metric[b, i] / thr))
             for i in np.flatnonzero(metric[b] > thr)] for b in range(metric.shape[0])]
