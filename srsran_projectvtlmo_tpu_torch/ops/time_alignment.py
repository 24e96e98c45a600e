"""Standalone time-alignment estimator (port of `srsran_projectvtlmo_tpu.ops.time_alignment`).

IDFT of the pilot LSE products, signed wrapped argmax of the power.
reference: lib/phy/support/time_alignment_estimator/
time_alignment_estimator_dft_impl.cpp:45-76.
"""

from __future__ import annotations

import torch

from ..utils.cplx import to_cplx


def estimate_time_alignment(lse_pair: torch.Tensor, stride_re: int = 1,
                            scs_hz: float = 30e3) -> torch.Tensor:
    """(..., npilots, 2) pilot LSE products -> TA seconds (...,) float32."""
    lse = to_cplx(lse_pair)
    npil = lse.shape[-1]
    nfft = 1
    while nfft < 4 * npil:
        nfft <<= 1
    power = torch.fft.ifft(lse, n=nfft, dim=-1).abs() ** 2
    peak = power.argmax(dim=-1)
    delay = torch.where(peak > nfft // 2, peak - nfft, peak)
    return delay.float() / (nfft * stride_re * scs_hz)
