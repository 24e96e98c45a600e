"""Complex values as real pairs (port of `srsran_projectvtlmo_tpu.utils.cplx`).

Public functions take and return `(..., 2)` real pairs, the JAX package's
convention; complex tensors are fine inside functions.
"""

from __future__ import annotations

import numpy as np
import torch


def to_cplx(pair: torch.Tensor) -> torch.Tensor:
    """(..., 2) real pair (any float dtype) -> complex64."""
    return torch.complex(pair[..., 0].float(), pair[..., 1].float())


def from_cplx(z: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """complex -> (..., 2) real pair."""
    return torch.stack([z.real, z.imag], dim=-1).to(dtype)


def np_to_pair(z: np.ndarray, dtype=np.float32) -> np.ndarray:
    return np.stack([z.real, z.imag], axis=-1).astype(dtype)
