"""Constellation tables, TS 38.211 Section 5.1 (BPSK ... 256QAM, Gray-coded).

A copy of `srsran_projectvtlmo_tpu.ops.modulation.constellation` (that module
imports jax); the demapper and EVM tables are built from it.
"""

from __future__ import annotations

import functools

import numpy as np

from srsran_projectvtlmo_tpu.ran.modulation import Modulation, bits_per_symbol


@functools.lru_cache(maxsize=None)
def constellation(mod: Modulation) -> np.ndarray:
    """Complex64 table of 2^Qm points; index = bits MSB-first (b0 is MSB)."""
    qm = bits_per_symbol(mod)
    idx = np.arange(1 << qm)
    b = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(np.float64)
    s = 1.0 - 2.0 * b
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK):
        pts = s[:, 0] * (1 + 1j) / np.sqrt(2)
    elif mod == Modulation.QPSK:
        pts = (s[:, 0] + 1j * s[:, 1]) / np.sqrt(2)
    elif mod == Modulation.QAM16:
        pts = (s[:, 0] * (2 - s[:, 2]) + 1j * s[:, 1] * (2 - s[:, 3])) / np.sqrt(10)
    elif mod == Modulation.QAM64:
        pts = (s[:, 0] * (4 - s[:, 2] * (2 - s[:, 4]))
               + 1j * s[:, 1] * (4 - s[:, 3] * (2 - s[:, 5]))) / np.sqrt(42)
    elif mod == Modulation.QAM256:
        pts = (s[:, 0] * (8 - s[:, 2] * (4 - s[:, 4] * (2 - s[:, 6])))
               + 1j * s[:, 1] * (8 - s[:, 3] * (4 - s[:, 5] * (2 - s[:, 7])))) / np.sqrt(170)
    else:
        raise ValueError(mod)
    return pts.astype(np.complex64)
