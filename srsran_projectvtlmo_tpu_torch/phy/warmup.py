"""Receiver warmup: build slot-receiver variants ahead of real-time use
(port of `srsran_projectvtlmo_tpu.phy.warmup`).

Sequences (DM-RS, scrambling) depend on the slot index within the frame, so a
steady-state cell needs one receiver per slot variant.  The reference
pre-instantiates processor pools per slot (reference: lib/phy/upper/
upper_phy_factories.cpp downlink/uplink_processor_pool, processor_pool_helpers.h);
here the pool is the cache of `cached_ulsch_tx` / `cached_pusch_rx`, filled
by building each variant and running it once on the device: that first call
moves its tables to the card.  The FAPI entry point
(`UpperPhy.process_ul_slot`) runs the dynamic-params receiver of
`cached_pusch_rx_from_grid` under the key `upper_phy.pusch_rx_key`, one per
slot within the subframe: the warmup builds and runs those too.
On the card the CUDA decoder library is built first.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..models.pusch_rx import cached_demux_plan, cached_pusch_rx, cached_pusch_rx_from_grid
from ..models.ulsch_tx import cached_ulsch_tx
from ..ops import ofdm as ofdm_mod
from ..ops.ldpc import decode_cuda
from ..utils.tables import resolve_device, upload
from .upper_phy import pusch_rx_key, pusch_sequences


def slots_per_frame(numerology: int) -> int:
    return 10 * (1 << numerology)


def precompile_pusch(cfg, nof_slots: int | None = None, *, progress=None, device="cuda"):
    """Build and run once the PUSCH rx (and matching tx) for every slot
    variant, and the FAPI entry point's receiver of each variant's key.

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
    keys = set()
    rng = np.random.default_rng(0)
    for slot in range(n):
        t0 = time.perf_counter()
        c = dataclasses.replace(cfg, slot=slot)
        tx = cached_ulsch_tx(c, dev)
        rx = cached_pusch_rx(c, dev)
        tb = torch.as_tensor(rng.integers(0, 2, (1, c.tbs)).astype(np.uint8), device=dev)
        _, samples = tx(tb)
        samples = samples[:, None] if c.nof_layers == 1 else samples
        result = rx(samples)
        result["tb_crc_ok"].cpu()  # waits for the device
        key = pusch_rx_key(c)
        if key not in keys:
            keys.add(key)
            _run_fapi_receiver(c, key, samples, dev)
        out[slot] = (tx, rx)
        if progress:
            progress(slot, time.perf_counter() - t0)
    return out


def _run_fapi_receiver(c, key, samples: torch.Tensor, dev: torch.device) -> None:
    """Build `cached_pusch_rx_from_grid(key)` and run it once, as
    `phy.upper_phy.process_pusch_batch` runs it, on the allocation of `samples`
    (B, P, nsamples, 2); with hopping both hops take the first hop's rows,
    which only the decoded values see."""
    from_grid = cached_pusch_rx_from_grid(key, dev)
    grid = ofdm_mod.ofdm_demodulate(samples, c.nof_subc, c.dft_size, c.numerology,
                                    c.slot % (1 << c.numerology))
    k0 = c.rb_start * 12
    sub = grid[:, :, c.start_symbol:c.start_symbol + c.nof_ofdm_symbols, k0:k0 + c.nof_subc]
    plan = None
    if c.nof_harq_ack_bits or c.nof_csi_part1_bits:
        plan, _ = cached_demux_plan(key, key.nof_csi_part2_bits)
    ref, _, signs, fixes = pusch_sequences(c, plan)
    uci_fix = None if fixes is None else tuple(
        None if f is None else upload(f, dev, torch.int8)[None] for f in fixes)
    result = from_grid(sub, None, upload(ref, dev)[None], upload(signs.copy(), dev)[None],
                       uci_fix)
    result["tb_crc_ok"].cpu()  # waits for the device
