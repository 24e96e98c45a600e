"""int8 log-likelihood-ratio semantics (port of `srsran_projectvtlmo_tpu.utils.llr`).

LLRs are int8 in [-LLR_MAX, LLR_MAX]; the reserved values +/-LLR_INFTY = +/-127
mark fixed bits.  Positive LLR means bit 0.
reference: include/srsran/phy/upper/log_likelihood_ratio.h:43-45,150-156,
lib/phy/upper/log_likelihood_ratio.cpp:39-97.
"""

from __future__ import annotations

import torch

LLR_MAX = 120
LLR_INFTY = 127


def llr_saturating_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturated LLR sum: a + (-a) = 0, otherwise an infinite summand dominates."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    plain = torch.clamp(a32 + b32, -LLR_MAX, LLR_MAX)
    out = torch.where(a32.abs() == LLR_INFTY, a32,
                      torch.where(b32.abs() == LLR_INFTY, b32, plain))
    return torch.where(a32 == -b32, 0, out).to(torch.int8)


def llr_promotion_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturated sum that promotes overflow to +/-LLR_INFTY (HARQ combining)."""
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    s = a32 + b32
    plain = torch.where(s.abs() > LLR_MAX, torch.sign(s) * LLR_INFTY, s)
    out = torch.where(a32.abs() == LLR_INFTY, a32,
                      torch.where(b32.abs() == LLR_INFTY, b32, plain))
    return torch.where(a32 == -b32, 0, out).to(torch.int8)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C++ std::round: halves round away from zero."""
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def llr_quantize(value: torch.Tensor, range_limit: float) -> torch.Tensor:
    """Clip float LLRs to +/-range_limit and quantize to int8 with scale LLR_MAX."""
    clipped = torch.clamp(value, -range_limit, range_limit)
    scaled = clipped / range_limit * LLR_MAX
    return round_half_away(scaled).to(torch.int8)


def llr_to_hard_bit(llr: torch.Tensor) -> torch.Tensor:
    """value <= 0 -> bit 1 (a null LLR resolves to 1)."""
    return (llr <= 0).to(torch.uint8)
