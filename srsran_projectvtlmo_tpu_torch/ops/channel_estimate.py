"""Port channel estimation from DM-RS pilots (port of `srsran_projectvtlmo_tpu.ops.channel_estimate`).

Per (port, layer): least-squares estimates at the pilots, CFO from the phase
drift between the first two DM-RS symbols with derotation to epoch 0, an
average over the DM-RS symbols, raised-cosine smoothing over the pilots
extended by virtual pilots, noise variance from the smoothing residual, time
alignment from a 4096-point IDFT, and linear interpolation to every
subcarrier.  All leading axes are batch axes.
reference: lib/phy/upper/signal_processors/port_channel_estimator_average_impl.cpp:39-374.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.cplx import from_cplx, to_cplx
from ..utils.tables import on_device

#: Raised-cosine prototype: roll-off 0.2, 3-symbol span, 10 samples per symbol
#: (reference: port_channel_estimator_average_impl.cpp:41-46).
RC_FILTER = np.array([
    -0.0641253, -0.0660711, -0.0611526, -0.0485918, -0.0281126, 0.0000000, 0.0348830, 0.0751249,
    0.1188406, 0.1637874, 0.2075139, 0.2475302, 0.2814857, 0.3073415, 0.3235207, 0.3290274,
    0.3235207, 0.3073415, 0.2814857, 0.2475302, 0.2075139, 0.1637874, 0.1188406, 0.0751249,
    0.0348830, 0.0000000, -0.0281126, -0.0485918, -0.0611526, -0.0660711, -0.0641253,
], dtype=np.float32)


@functools.lru_cache(maxsize=None)
def rc_filter(nof_rb: int, stride: int) -> np.ndarray:
    """Resampled, normalized raised-cosine taps for pilots every `stride` REs."""
    nof_rb = min(nof_rb, 3)
    half_out = (nof_rb * 10 + 1) // 2 // stride
    n_first = len(RC_FILTER) // 2 - half_out * stride
    taps = RC_FILTER[n_first:n_first + (2 * half_out + 1) * stride:stride].copy()
    return (taps / taps.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def interp_plan(npil: int, stride: int, nsubc: int) -> tuple[np.ndarray, np.ndarray]:
    """Left pilot index (nsubc,) int64 and weight (nsubc,) float32 for linear
    interpolation from pilots at k*stride, edges held constant (reference:
    interpolator_linear_impl.cpp:60-77).  Same float32 arithmetic as JAX."""
    xp = np.arange(npil, dtype=np.float32) * np.float32(stride)
    x = np.arange(nsubc, dtype=np.float32)
    idx = np.clip(np.searchsorted(xp, x, side="right") - 1, 0, npil - 2)
    w = np.clip((x - xp[idx]) / (xp[idx + 1] - xp[idx]), 0.0, 1.0).astype(np.float32)
    return idx.astype(np.int64), w


def _interp_index(npil: int, stride: int, nsubc: int) -> np.ndarray:
    return interp_plan(npil, stride, nsubc)[0]


def _interp_weight(npil: int, stride: int, nsubc: int) -> np.ndarray:
    return interp_plan(npil, stride, nsubc)[1]


@functools.lru_cache(maxsize=None)
def noise_residual_share(nof_rb: int, stride: int, nof_symbols: int) -> float:
    """The share of the per-pilot noise variance that `estimate_channel_hop`'s
    `noise_var` keeps: the residual of each DM-RS symbol's LSE against the
    raised-cosine smoothing of their mean, E|n_s - F(mean n)|^2 / sigma^2 =
    1 - 2 f_0 / N + sum f_k^2 / N over N symbols and the taps f (centre f_0),
    away from the band edges.  Dividing by it makes the estimate unbiased;
    the JAX package does not (0.57 for one DM-RS symbol at stride 4: -2.4 dB)."""
    taps = rc_filter(nof_rb, stride).astype(np.float64)
    return float(1.0 - (2.0 * taps[len(taps) // 2] - (taps ** 2).sum()) / nof_symbols)


def _float32(values: tuple[float, ...]) -> np.ndarray:
    return np.asarray(values, np.float32)


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """numpy.unwrap over the last axis (discont pi, period 2 pi)."""
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    corr = torch.where(dd.abs() < math.pi, 0.0, ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(corr, dim=-1)], dim=-1)


def _virtual_pilots(lse: torch.Tensor, n_v: int, is_start: bool) -> torch.Tensor:
    """Linear fit of magnitude and unwrapped phase over the n_v pilots at one
    band edge, evaluated at the n_v positions just outside it (reference:
    port_channel_estimator_average_impl.cpp:686-720 compute_v_pilots)."""
    base = lse[..., :n_v] if is_start else lse[..., -n_v:]
    idx = torch.arange(n_v, dtype=torch.float32, device=lse.device)
    mean_x = (n_v - 1) / 2.0
    denom = (n_v - 1) * n_v * (2 * n_v - 1) / 6.0 - n_v * mean_x * mean_x

    def fit(y):
        mean_y = y.mean(dim=-1, keepdim=True)
        slope = ((y * idx).sum(dim=-1, keepdim=True) - mean_x * mean_y * n_v) / denom
        return slope, mean_y - slope * mean_x

    s_abs, i_abs = fit(base.abs())
    s_arg, i_arg = fit(unwrap(torch.angle(base)))
    iv = idx + (-n_v if is_start else n_v)
    mag, arg = s_abs * iv + i_abs, s_arg * iv + i_arg  # mag may extrapolate below 0
    return torch.complex(mag * torch.cos(arg), mag * torch.sin(arg))


def estimate_channel_hop(rx_pilots_pair: torch.Tensor, ref_pilots_pair: torch.Tensor,
                         nof_rb: int, stride: int = 2, scs_hz: float = 30e3,
                         dmrs_epochs_s: tuple[float, ...] | None = None) -> dict:
    """Estimate one hop's channel for one (port, layer) from its pilots.

    rx_pilots_pair: (..., nsym_dmrs, npilots, 2); ref_pilots_pair:
    (nsym_dmrs, npilots, 2) or (npilots, 2).  `dmrs_epochs_s` are the DM-RS
    symbols' start times, used for the CFO estimate and derotation.

    Returns ce_pair (..., nsubc, 2), noise_var, rsrp, epre,
    time_alignment_s and cfo_hz, each (...).
    """
    y = to_cplx(rx_pilots_pair)
    r = to_cplx(ref_pilots_pair)
    if r.dim() < y.dim() - 1:
        r = r[None]
    lse_sym = y * r.conj() / (r.abs() ** 2)
    nsym = rx_pilots_pair.shape[-3]

    if nsym >= 2:
        have_epochs = dmrs_epochs_s is not None and len(dmrs_epochs_s) == nsym
        if have_epochs:
            epochs = np.asarray(dmrs_epochs_s, np.float32)
        else:
            epochs = np.arange(nsym, dtype=np.float32) / np.float32(scs_hz)
        dt = float(epochs[1] - epochs[0])
        xcorr = (lse_sym[..., 1, :] * lse_sym[..., 0, :].conj()).sum(dim=-1)
        cfo_hz = torch.angle(xcorr) / (2.0 * math.pi * dt)
        if have_epochs:
            ep = on_device(_float32, tuple(dmrs_epochs_s), device=y.device)
            rot = torch.polar(torch.ones_like(cfo_hz[..., None] * ep),
                              -2.0 * math.pi * cfo_hz[..., None] * ep)
            lse_sym = lse_sym * rot[..., None]
    else:
        cfo_hz = torch.zeros(rx_pilots_pair.shape[:-3], dtype=torch.float32, device=y.device)

    lse = lse_sym.mean(dim=-2)

    taps = rc_filter(nof_rb, stride)
    npil = lse.shape[-1]
    n_v = min(12, len(taps) // 2)
    if nof_rb == 1:
        n_v = npil
    n_v = max(min(n_v, npil), 2) if npil >= 2 else 0
    enlarged = torch.cat([_virtual_pilots(lse, n_v, True), lse,
                          _virtual_pilots(lse, n_v, False)], dim=-1)
    k = len(taps) // 2
    padded = torch.nn.functional.pad(torch.view_as_real(enlarged), (0, 0, k, k))
    win = torch.view_as_complex(padded).unfold(-1, len(taps), 1)
    smoothed = (win * on_device(rc_filter, nof_rb, stride, device=y.device)
                ).sum(dim=-1)[..., n_v:n_v + npil]

    resid = lse_sym - smoothed[..., None, :]
    noise_var = (resid.abs() ** 2).sum(dim=(-1, -2)) / max(nsym * npil - 1, 1)
    epre = (y.abs() ** 2).mean(dim=(-1, -2))
    noise_var = torch.maximum(noise_var, 1e-9 * epre + 1e-30)

    # Time alignment (time_alignment_estimator_dft_impl.cpp, DFT size 4096):
    # smoothed estimates at their stride-spaced bins, strongest |tap| in the
    # first max_ta samples (delay) against the last max_ta (advance).
    nfft = 4096
    pad = torch.zeros(smoothed.shape[:-1] + (nfft,), dtype=smoothed.dtype, device=y.device)
    pad[..., 0:npil * stride:stride] = smoothed
    imp = torch.fft.ifft(pad, dim=-1).abs()
    max_ta = (144 // 2) * nfft // 2048
    d_val, d_idx = imp[..., :max_ta].max(dim=-1)
    a_val, a_idx = imp[..., nfft - max_ta:].max(dim=-1)
    rate = float(np.float32(nfft) * np.float32(scs_hz))
    ta_s = torch.where(d_val >= a_val, d_idx.float(), -(max_ta - a_idx).float()) / rate

    idx_t = on_device(_interp_index, npil, stride, nof_rb * 12, device=y.device)
    w_t = on_device(_interp_weight, npil, stride, nof_rb * 12, device=y.device)
    f0, f1 = smoothed[..., idx_t], smoothed[..., idx_t + 1]
    ce = f0 + (f1 - f0) * w_t

    return {
        "ce_pair": from_cplx(ce),
        "noise_var": noise_var,
        "rsrp": (smoothed.abs() ** 2).mean(dim=-1),
        "epre": epre,
        "time_alignment_s": ta_s,
        "cfo_hz": cfo_hz,
    }
