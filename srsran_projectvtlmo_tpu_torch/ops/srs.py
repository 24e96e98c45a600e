"""Sounding Reference Signal (SRS) sequences and channel estimation
(port of `srsran_projectvtlmo_tpu.ops.srs`).

TS 38.211 Section 6.4.1.4: SRS sequences are cyclic shifts of low-PAPR base
sequences on a comb (K_TC = 2 or 4); estimation runs the DM-RS estimator
(`ops/channel_estimate.estimate_channel_hop`) on the comb's REs of every rx
port at once, the ports riding as a batch axis.
reference: lib/phy/upper/signal_processors/srs/srs_estimator_generic_impl.cpp.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.cplx import np_to_pair
from ..utils.tables import on_device
from .channel_estimate import estimate_channel_hop
from .low_papr import low_papr_sequence


@dataclass(frozen=True)
class SrsConfig:
    nof_rb: int
    comb_size: int = 2          # K_TC
    comb_offset: int = 0
    start_symbol: int = 13
    nof_symbols: int = 1
    sequence_id: int = 0        # n_SRS_ID
    cyclic_shift: int = 0
    nof_antenna_ports: int = 1

    @property
    def sequence_length(self) -> int:
        return self.nof_rb * 12 // self.comb_size

    def alpha(self, port: int = 0) -> float:
        n_max = 8 if self.comb_size == 2 else 12
        n_cs = (self.cyclic_shift + n_max * port // self.nof_antenna_ports) % n_max
        return 2 * np.pi * n_cs / n_max


@functools.lru_cache(maxsize=None)
def srs_sequence(cfg: SrsConfig, port: int = 0) -> np.ndarray:
    """(M,) complex64 SRS sequence for one antenna port."""
    return low_papr_sequence(cfg.sequence_id % 30, 0, cfg.alpha(port), cfg.sequence_length)


def srs_subcarriers(cfg: SrsConfig) -> np.ndarray:
    return (cfg.comb_offset + cfg.comb_size * np.arange(cfg.sequence_length)).astype(np.int64)


def _sequence_pair(cfg: SrsConfig) -> np.ndarray:
    return np_to_pair(srs_sequence(cfg))


def srs_estimate(rx_symbols_pair: torch.Tensor, cfg: SrsConfig) -> dict:
    """Estimate the SRS channel.

    rx_symbols_pair: (B, nof_rx_ports, nof_symbols, nof_rb*12, 2) received
    REs of the SRS symbols over the sounded bandwidth.

    Returns ce_pair (B, P, nsubc, 2), the wideband estimate per rx port, and
    noise_var, epre, ta_s, each (B, P).
    """
    dev = rx_symbols_pair.device
    pilots = rx_symbols_pair[..., on_device(srs_subcarriers, cfg, device=dev), :].float()
    est = estimate_channel_hop(pilots, on_device(_sequence_pair, cfg, device=dev),
                               cfg.nof_rb, cfg.comb_size)
    return {"ce_pair": est["ce_pair"], "noise_var": est["noise_var"], "epre": est["epre"],
            "ta_s": est["time_alignment_s"]}
