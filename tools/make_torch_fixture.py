#!/usr/bin/env python3
"""Write the transmit-side fixture that `chip_smoke.py` decodes on the card.

Runs the JAX UL-SCH transmitter (`models/ulsch_tx.build_ulsch_tx_slot`) at
the north-star PUSCH shape (273 PRB, QAM256 R=948/1024, 2 layers, DFT 4096,
30 kHz SCS) on random TB bits from a numpy seed, and the JAX LDPC encoder on
CRC-terminated random codeblocks for the kernel-vs-plain cases; stores both
with `srsran_projectvtlmo_tpu_torch.fixture.pack_fixture`.  The machine with
the GPU has no JAX, so this runs where JAX does (its CPU is enough):

    JAX_PLATFORMS=cpu python tools/make_torch_fixture.py \
        [--out srsran_projectvtlmo_tpu_torch/data/northstar_fixture.npz]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

DEFAULT_OUT = os.path.join(os.path.dirname(HERE), "srsran_projectvtlmo_tpu_torch", "data",
                           "northstar_fixture.npz")
#: (bg, z, crc order): the lifting sizes chip_smoke.py checks the kernel at.
LDPC_CASES = ((1, 384, 24), (1, 208, 24), (1, 352, 24), (2, 2, 16), (2, 40, 24), (2, 104, 24))


def ldpc_codewords(bg: int, z: int, order: int, count: int, rng):
    """CRC-terminated random codeblocks with filler, JAX-encoded.

    Returns ((bg, z, kp, order, filler), codewords (count, (nv-2)*z) uint8)."""
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.ops.crc import crc_host
    from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
    from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph

    from srsran_projectvtlmo_tpu_torch.fixture import CRC_BY_ORDER

    k = (22 if bg == 1 else 10) * z
    filler = min(z // 4, k - order - 1)
    kp = k - filler
    payload = rng.integers(0, 2, (count, kp - order)).astype(np.uint8)
    crc = np.stack([crc_host(p, CRC_BY_ORDER[order]) for p in payload])
    info = np.concatenate([payload, crc, np.zeros((count, filler), np.uint8)], -1)
    cw = np.asarray(ldpc_encode(jnp.asarray(info), BaseGraph(bg), z))
    return (bg, z, kp, order, filler), cw[:, 2 * z:]


def make_fixture(nof_rb: int, modulation: str, target_code_rate: float, nof_layers: int,
                 nof_rx_ports: int, dft_size: int, batch: int, seed: int,
                 ldpc_cases=LDPC_CASES, ldpc_count: int = 4) -> dict:
    """Arrays of one fixture (see `srsran_projectvtlmo_tpu_torch.fixture`)."""
    import jax.numpy as jnp
    from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig
    from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
    from srsran_projectvtlmo_tpu.ran.modulation import Modulation

    from srsran_projectvtlmo_tpu_torch.fixture import pack_fixture

    cfg = PuschRxConfig(nof_rb=nof_rb, modulation=Modulation[modulation],
                        target_code_rate=target_code_rate, nof_rx_ports=nof_rx_ports,
                        nof_layers=nof_layers, dft_size=dft_size, numerology=1)
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, (batch, cfg.tbs)).astype(np.uint8)
    grids = np.asarray(build_ulsch_tx_slot(cfg)(jnp.asarray(tb))[0])
    if nof_layers == 1:
        grids = grids[:, None]
    fields = {"nof_rb": nof_rb, "modulation": modulation,
              "target_code_rate": target_code_rate, "nof_rx_ports": nof_rx_ports,
              "nof_layers": nof_layers, "dft_size": dft_size, "numerology": 1,
              "tbs": cfg.tbs}
    cases = [ldpc_codewords(bg, z, order, ldpc_count, rng) for bg, z, order in ldpc_cases]
    return pack_fixture(fields, grids, tb, cases)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    arrays = make_fixture(273, "QAM256", 948.0 / 1024.0, 2, 4, 4096, args.batch, args.seed)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
