"""Receiver warmup: build slot-receiver variants ahead of real-time use
(port of `srsran_projectvtlmo_tpu.phy.warmup`).

Sequences (DM-RS, scrambling) depend on the slot index within the frame, so a
steady-state cell needs one receiver per slot variant.  The reference
pre-instantiates processor pools per slot (reference: lib/phy/upper/
upper_phy_factories.cpp downlink/uplink_processor_pool, processor_pool_helpers.h);
here the pool is the cache of `cached_ulsch_tx` / `cached_pusch_rx`, filled
by building each variant and running it once on the device: that first call
moves its tables to the card.
On the card the CUDA decoder library is built first.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.pusch_rx import cached_pusch_rx
from ..models.ulsch_tx import cached_ulsch_tx
from ..ops.ldpc import decode_cuda
from ..utils.tables import resolve_device


def slots_per_frame(numerology: int) -> int:
    return 10 * (1 << numerology)


def precompile_pusch(cfg, nof_slots: int | None = None, *, progress=None, device="cuda"):
    """Build and run once the PUSCH rx (and matching tx) for every slot variant.

    Args:
      cfg: a PuschRxConfig (slot field is overridden per variant).
      nof_slots: variants to build (default: one frame).
      progress: optional callback(slot, seconds).
      device: where the variants run: the card unless the caller asks for
        the CPU.

    Returns dict slot -> (tx_fn, rx_fn).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        decode_cuda.build()
    n = nof_slots if nof_slots is not None else slots_per_frame(cfg.numerology)
    out = {}
    rng = np.random.default_rng(0)
    for slot in range(n):
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, slot=slot)
        tx = cached_ulsch_tx(c, dev)
        rx = cached_pusch_rx(c, dev)
        tb = torch.as_tensor(rng.integers(0, 2, (1, c.tbs)).astype(np.uint8), device=dev)
        _, samples = tx(tb)
        result = rx(samples[:, None] if c.nof_layers == 1 else samples)
        result["tb_crc_ok"].cpu()  # waits for the device
        out[slot] = (tx, rx)
        if progress:
            progress(slot, time.perf_counter() - t0)
    return out
