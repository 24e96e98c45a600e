"""Layer mapping and channel precoding (TS 38.211 Sections 7.3.1.3-7.3.1.5).

Port of `srsran_projectvtlmo_tpu.ops.precoding`.  Codeword -> layers is a
reshape; layers -> antenna ports is one einsum over the precoding matrix.
reference: include/srsran/phy/generic_functions/precoding/channel_precoder.h:49-61.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cplx import from_cplx, to_cplx


def layer_map(symbols: torch.Tensor, nof_layers: int) -> torch.Tensor:
    """(..., G) codeword symbols -> (..., nof_layers, G / nof_layers).

    TS 38.211 Table 7.3.1.3-1: x^(l)(i) = d(nof_layers * i + l).
    """
    g = symbols.shape[-1]
    return symbols.reshape(symbols.shape[:-1] + (g // nof_layers, nof_layers)).transpose(-1, -2)


def layer_demap(layers: torch.Tensor) -> torch.Tensor:
    """(..., L, M) -> (..., L*M), the inverse of layer_map."""
    x = layers.transpose(-1, -2)
    return x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))


def precode(layers_pair: torch.Tensor, weights_pair: torch.Tensor) -> torch.Tensor:
    """Apply a precoding matrix.

    layers_pair: (..., L, M, 2) layer symbols (M resource elements);
    weights_pair: (P, L, 2) or (..., P, L, 2).  Returns (..., P, M, 2).
    """
    return from_cplx(torch.einsum("...pl,...lm->...pm", to_cplx(weights_pair),
                                  to_cplx(layers_pair)))


def identity_precoder(nof_ports: int, nof_layers: int, scale: float | None = None) -> np.ndarray:
    """One-layer-per-port mapping (or wideband identity-like matrix), real pair."""
    w = np.zeros((nof_ports, nof_layers), np.complex64)
    for l in range(nof_layers):
        w[l % nof_ports, l] = 1.0
    if scale is None:
        scale = 1.0 / np.sqrt(max(1, nof_layers // nof_ports) if nof_ports >= nof_layers
                              else nof_layers)
    w *= scale
    return np.stack([w.real, w.imag], -1).astype(np.float32)
