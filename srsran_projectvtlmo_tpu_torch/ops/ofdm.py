"""OFDM modulation / demodulation, TS 38.211 Section 5.3, and the PRACH
occasion's (de)modulation (port of `srsran_projectvtlmo_tpu.ops.ofdm`).

Real-pair I/O; the FFT is `torch.fft` (cuFFT on the card), as the JAX package
left it to XLA.
reference: lib/phy/lower/modulation/ofdm_modulator_impl.cpp:56-101,
ofdm_demodulator_impl.cpp:94.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.cplx import from_cplx, to_cplx
from ..utils.tables import on_device

SYMBOLS_PER_SLOT = 14
SYMBOLS_PER_SLOT_EXTENDED = 12


def nof_symbols_per_slot(cp: str = "normal") -> int:
    return SYMBOLS_PER_SLOT if cp == "normal" else SYMBOLS_PER_SLOT_EXTENDED


def cp_lengths(dft_size: int, mu: int, slot_in_subframe: int, cp: str = "normal") -> list[int]:
    """CP lengths in samples for the symbols of one slot.

    Normal CP: 144 * (dft/2048) samples, plus 16 * 2^mu * (dft/2048) on the
    first symbol of each half subframe (the 16-kappa term is not scaled by
    2^-mu).  Extended CP: 512 * (dft/2048) on all 12 symbols.
    """
    if cp == "extended":
        return [512 * dft_size // 2048] * SYMBOLS_PER_SLOT_EXTENDED
    base = 144 * dft_size // 2048
    extra = 16 * (1 << mu) * dft_size // 2048
    out = []
    for l_slot in range(SYMBOLS_PER_SLOT):
        l_sub = slot_in_subframe * SYMBOLS_PER_SLOT + l_slot
        out.append(base + (extra if l_sub in (0, 7 * (1 << mu)) else 0))
    return out


def slot_sample_count(dft_size: int, mu: int, slot_in_subframe: int = 0,
                      cp: str = "normal") -> int:
    return sum(cp_lengths(dft_size, mu, slot_in_subframe, cp)) + nof_symbols_per_slot(cp) * dft_size


@functools.lru_cache(maxsize=None)
def phase_compensation(dft_size: int, mu: int, slot_in_subframe: int, center_freq_hz: float,
                       cp: str = "normal") -> np.ndarray:
    """Per-symbol factors exp(-j 2 pi f_c t_start_l), complex64."""
    srate = dft_size * 15e3 * (1 << mu)
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    t, out = 0.0, []
    for l in range(nof_symbols_per_slot(cp)):
        t_start = (t + cps[l]) / srate
        out.append(np.exp(-2j * np.pi * center_freq_hz * t_start))
        t += cps[l] + dft_size
    return np.asarray(out, dtype=np.complex64)


def ofdm_modulate(grid_pair: torch.Tensor, dft_size: int, mu: int, slot_in_subframe: int = 0,
                  center_freq_hz: float = 0.0, scale: float = 1.0,
                  cp: str = "normal") -> torch.Tensor:
    """(..., nsym, nsubc, 2) grid -> (..., nsamples, 2) baseband.

    Subcarrier k maps to DFT bin (k - nsubc/2) mod dft.
    """
    nsym = nof_symbols_per_slot(cp)
    grid = to_cplx(grid_pair)
    nsubc = grid.shape[-1]
    half = nsubc // 2
    mid = torch.zeros(grid.shape[:-1] + (dft_size - nsubc,), dtype=grid.dtype, device=grid.device)
    bins = torch.cat([grid[..., half:], mid, grid[..., :half]], dim=-1)
    x = torch.fft.ifft(bins, dim=-1) * (dft_size * scale)
    phase = on_device(phase_compensation, dft_size, mu, slot_in_subframe, center_freq_hz, cp,
                      device=grid.device)
    x = x * phase.reshape(nsym, 1)
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    pieces = []
    for l in range(nsym):
        pieces += [x[..., l, dft_size - cps[l]:], x[..., l, :]]
    return from_cplx(torch.cat(pieces, dim=-1))


def ofdm_demodulate(samples_pair: torch.Tensor, nsubc: int, dft_size: int, mu: int,
                    slot_in_subframe: int = 0, center_freq_hz: float = 0.0,
                    scale: float = 1.0, cp: str = "normal",
                    out_dtype: str = "f32") -> torch.Tensor:
    """(..., nsamples, 2) baseband -> (..., nsym, nsubc, 2) grid.

    out_dtype "bf16" stores the grid as bfloat16 real pairs (the reference's
    cbf16 resource grid, lib/phy/support/resource_grid_impl.h:41-51).
    """
    nsym = nof_symbols_per_slot(cp)
    x = to_cplx(samples_pair)
    cps = cp_lengths(dft_size, mu, slot_in_subframe, cp)
    offs, t = [], 0
    for l in range(nsym):
        offs.append(t + cps[l])
        t += cps[l] + dft_size
    syms = torch.stack([x[..., o:o + dft_size] for o in offs], dim=-2)
    bins = torch.fft.fft(syms, dim=-1) / dft_size
    phase = on_device(phase_compensation, dft_size, mu, slot_in_subframe, center_freq_hz, cp,
                      device=x.device)
    bins = bins * phase.conj().reshape(nsym, 1)
    half = nsubc // 2
    grid = torch.cat([bins[..., dft_size - half:], bins[..., :nsubc - half]], dim=-1) * scale
    return from_cplx(grid, torch.bfloat16 if out_dtype == "bf16" else torch.float32)


# ----------------------------------------------------------- PRACH demod ----

def prach_window_samples(sequence_length: int, prach_scs_hz: float, sample_rate_hz: float) -> int:
    """Samples per PRACH sequence repetition: fs / prach_scs."""
    n = sample_rate_hz / prach_scs_hz
    if abs(n - round(n)) >= 1e-6:
        raise ValueError("sample rate must be a multiple of the PRACH SCS")
    return int(round(n))


def _prach_bins(sequence_length: int, freq_offset_subc: int, nwin: int) -> np.ndarray:
    return (freq_offset_subc + np.arange(sequence_length)) % nwin


def prach_demodulate(samples_pair: torch.Tensor, sequence_length: int, freq_offset_subc: int,
                     prach_scs_hz: float, sample_rate_hz: float) -> torch.Tensor:
    """(..., nwin, 2) one sequence-length window (CP already skipped, nwin =
    fs / prach_scs) -> (..., sequence_length, 2) frequency samples, the first
    occupied subcarrier `freq_offset_subc` bins above the window's DC.
    reference: lib/phy/lower/modulation/ofdm_prach_demodulator_impl.cpp.
    """
    nwin = prach_window_samples(sequence_length, prach_scs_hz, sample_rate_hz)
    bins = torch.fft.fft(to_cplx(samples_pair), dim=-1) / np.float32(np.sqrt(nwin))
    idx = on_device(_prach_bins, sequence_length, freq_offset_subc, nwin,
                    device=samples_pair.device)
    return from_cplx(bins[..., idx])


def prach_modulate(freq_pair: torch.Tensor, sequence_length: int, freq_offset_subc: int,
                   prach_scs_hz: float, sample_rate_hz: float) -> torch.Tensor:
    """Inverse of `prach_demodulate`: place the occasion and IFFT to time (UE side)."""
    nwin = prach_window_samples(sequence_length, prach_scs_hz, sample_rate_hz)
    z = to_cplx(freq_pair)
    bins = torch.zeros(z.shape[:-1] + (nwin,), dtype=z.dtype, device=z.device)
    bins[..., on_device(_prach_bins, sequence_length, freq_offset_subc, nwin,
                        device=z.device)] = z
    return from_cplx(torch.fft.ifft(bins, dim=-1) * np.float32(np.sqrt(nwin)))
