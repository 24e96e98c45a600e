"""Error-vector magnitude (port of `srsran_projectvtlmo_tpu.ops.evm`).

RMS distance between equalized symbols and their nearest constellation
points (unit-power tables).
reference: lib/phy/upper/channel_modulation/evm_calculator_generic_impl.cpp.
"""

from __future__ import annotations

import torch

from ..ran.modulation import Modulation
from .demodulation import demap_axis_tables, demap_tables


def evm(symbols_pair: torch.Tensor, mod: Modulation) -> torch.Tensor:
    """(..., nsym, 2) equalized symbols -> EVM (...) float32.

    Square Gray QAM uses the per-axis nearest-level closed form; other
    constellations a nearest-point search.
    """
    x = symbols_pair.float()
    axis_tabs = demap_axis_tables(mod)
    if axis_tabs is not None:
        pam = axis_tabs[0]
        a = float(pam[1] - pam[0]) / 2.0 if len(pam) > 1 else 1.0
        lo, hi = float(pam[0]), float(pam[-1])
        level = torch.clamp((2.0 * torch.round((x / a - 1.0) / 2.0) + 1.0) * a, lo, hi)
        return torch.sqrt(((x - level) ** 2).sum(-1).mean(-1))
    c_pair, c_norm, _ = demap_tables(mod)
    pts = torch.as_tensor(c_pair, device=x.device)
    metric = torch.as_tensor(c_norm, device=x.device) - 2.0 * (
        x[..., 0:1] * pts[:, 0] + x[..., 1:2] * pts[:, 1])
    nearest = pts[metric.argmin(dim=-1)]
    return torch.sqrt(((x - nearest) ** 2).sum(-1).mean(-1))
