"""Multi-process execution: `torch.distributed` bring-up and the (cell, sp)
mesh (port of `srsran_projectvtlmo_tpu.parallel.distributed`).

The reference distributes cells across machines through its executor
topology and the O-RAN 7.2 fronthaul split (reference:
apps/services/worker_manager.h:59-82, lib/du_low/du_low_impl.h:31-48 one
upper_phy per cell).  Here cells ride the "cell" mesh axis (pure data
parallel, no cross-cell collectives on the hot path) and the intra-cell axes
(codeblock batches, baseband samples with overlap-save halos) ride "sp".

PyTorch's idiom is SPMD: one process per card, each running the same
program on its block of the sharded axis, with a
`torch.distributed.device_mesh.DeviceMesh` naming the axes.  One process on
one card with no process group is the default: the mesh is then `None`, of
size (1, 1), and every function of `parallel/` runs its block (the whole
input) with no collective.  Where a process group exists, the functions run
its collectives, at size 1 too.  The backend follows the device: NCCL for
"cuda", gloo for "cpu".
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("cell", "sp")


def backend_for(device) -> str:
    """The process-group backend of `device`: NCCL for the card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(device="cuda") -> bool:
    """Initialize the default process group from torchrun's environment.

    Env contract (torchrun's, the counterpart of the JAX package's
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID):
      MASTER_ADDR, MASTER_PORT  the rendezvous of rank 0,
      WORLD_SIZE, RANK          the group and this process's place in it,
      LOCAL_RANK                this process's card on its host.
    On the card it selects card LOCAL_RANK first.  Returns True only when it
    initialized a group of more than one process.
    """
    env = os.environ
    if any(k not in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return False
    world = int(env["WORLD_SIZE"])
    if world <= 1 or dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend_for(device),
                            init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                            world_size=world, rank=int(env["RANK"]))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True)
class RanMesh:
    """The framework's canonical 2D mesh: ("cell", "sp").

    "cell" is the slot/cell data-parallel axis, laid out across hosts first
    so that cell traffic (none on the hot path) stays off the inter-host
    links; "sp" is the intra-cell sequence/codeblock axis, laid out within a
    host so that its collectives (halo exchanges, codeword gathers) ride
    NVLink.  `mesh` is a `DeviceMesh` when a process group exists and None
    at world 1 without one.
    """

    mesh: DeviceMesh | None
    nof_cells: int
    nof_sp: int


def mesh_shape(ndev: int, nhost: int, nof_cell_shards: int | None = None,
               nof_sp_shards: int | None = None) -> tuple[int, int]:
    """(cell, sp) shard counts of `ndev` devices on `nhost` hosts, with the
    JAX package's defaulting and assertions: the cell axis spans hosts, the
    sp axis each host's devices; on one host cell x sp factor the devices
    (2 cell shards when their count is even and at least 4)."""
    if nof_cell_shards is None and nof_sp_shards is None:
        nof_cell_shards = nhost if nhost > 1 else (2 if ndev % 2 == 0 and ndev >= 4 else 1)
        nof_sp_shards = ndev // nof_cell_shards
    elif nof_cell_shards is None:
        nof_cell_shards = ndev // nof_sp_shards
    elif nof_sp_shards is None:
        nof_sp_shards = ndev // nof_cell_shards
    assert nof_cell_shards * nof_sp_shards == ndev, \
        f"{nof_cell_shards} x {nof_sp_shards} != {ndev} devices"
    if nhost > 1:
        assert nof_cell_shards % nhost == 0 or nhost % nof_cell_shards == 0, \
            "cell axis must align with host boundaries for locality"
    return nof_cell_shards, nof_sp_shards


def make_ran_mesh(nof_cell_shards: int | None = None, nof_sp_shards: int | None = None,
                  device="cuda") -> RanMesh:
    """Build the (cell, sp) mesh over every rank of the default group
    (`mesh_shape`, with a host of torchrun's LOCAL_WORLD_SIZE ranks in the
    place of a JAX process).  Ranks are laid out row-major, hosts along the
    cell axis, as torchrun numbers them."""
    ndev = world_size()
    nhost = max(ndev // int(os.environ.get("LOCAL_WORLD_SIZE", ndev)), 1)
    cells, sp = mesh_shape(ndev, nhost, nof_cell_shards, nof_sp_shards)
    mesh = None
    if dist.is_initialized():
        mesh = init_device_mesh(torch.device(device).type, (cells, sp), mesh_dim_names=AXES)
    return RanMesh(mesh=mesh, nof_cells=cells, nof_sp=sp)
