"""Multi-cell slot pipelines sharded over a device mesh (port of
`srsran_projectvtlmo_tpu.parallel.multi_cell`).

Cells (or slots in flight) ride the leading batch axis, sharded over the
mesh's "cell" axis: every per-cell program in models/ is already batched
over that axis, so partitioning is purely data parallel -- no cross-cell
collectives on the hot path, matching the reference's independent per-cell
upper PHYs (reference: lib/du_low/du_low_impl.h:31-48: one upper_phy per
cell).  Each rank runs the program on its block of cells; the outputs are
gathered along the axis so every rank returns the whole batch.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.pusch_rx import PuschRxConfig, build_pusch_rx_slot
from ..models.ulsch_tx import build_ulsch_tx_slot
from .mesh import gather_tree, shard_leading


def build_multi_cell_pusch_rx(cfg: PuschRxConfig, mesh: DeviceMesh | None, axis: str = "cell",
                              device="cuda"):
    """fn(samples (ncells, P, nsamp, 2)) -> the receiver's result dict for
    every cell; ncells divisible by the axis size."""
    rx = build_pusch_rx_slot(cfg, device)

    def sharded_rx(samples: torch.Tensor) -> dict:
        return gather_tree(rx(shard_leading(samples, mesh, axis)), mesh, axis)

    return sharded_rx


def build_multi_cell_ulsch_tx(cfg: PuschRxConfig, mesh: DeviceMesh | None, axis: str = "cell",
                              device="cuda"):
    """fn(tb_bits (ncells, TBS) uint8) -> (layer grids, samples) of every cell."""
    tx = build_ulsch_tx_slot(cfg, device)

    def sharded_tx(tb_bits: torch.Tensor):
        return gather_tree(tx(shard_leading(tb_bits, mesh, axis)), mesh, axis)

    return sharded_tx
