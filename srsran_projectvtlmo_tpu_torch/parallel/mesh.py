"""Device meshes and sharding helpers (port of
`srsran_projectvtlmo_tpu.parallel.mesh`).

The reference parallelizes with per-thread executors and CPU affinity
(reference: apps/services/worker_manager.h:59-82).  Here a mesh axis carries
cells/slots (data parallel) or codeblock batches.  Every sharded function of
`parallel/` takes and returns global tensors, as the JAX functions do: each
rank computes its contiguous block along the sharded axis (`shard_leading`)
and gathers the other blocks with one collective per output (`gather`).
A mesh of None is one process with no process group: its axes have size 1,
the block is the whole tensor and nothing is gathered.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .distributed import world_size


def cell_mesh(nof_devices: int | None = None, axis: str = "cell",
              device="cuda") -> DeviceMesh | None:
    """The 1-D mesh over the world, its one axis named `axis`; None at world
    1 without a process group."""
    n = nof_devices or world_size()
    assert n == world_size(), f"a {n}-device mesh over a world of {world_size()}"
    if not dist.is_initialized():
        return None
    return init_device_mesh(torch.device(device).type, (n,), mesh_dim_names=(axis,))


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def block(n: int, mesh: DeviceMesh | None, axis: str) -> slice:
    """This rank's contiguous block of `n` rows sharded over `axis`; `n`
    must divide evenly, as a JAX sharding requires."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide over the {size} shards of axis {axis!r}")
    per = n // size
    i = axis_index(mesh, axis)
    return slice(i * per, (i + 1) * per)


def shard_leading(x, mesh: DeviceMesh | None, axis: str = "cell"):
    """This rank's contiguous block of x's leading dim sharded over `axis`."""
    return x[block(x.shape[0], mesh, axis)]


def gather(x: torch.Tensor, mesh: DeviceMesh | None, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's block of `dim` along `axis`, concatenated in axis order:
    one all_gather_into_tensor in the axis's group (bool travels as uint8)."""
    if mesh is None:
        return x
    n = axis_size(mesh, axis)
    src = x.movedim(dim, 0)
    wire = src.view(torch.uint8) if src.dtype == torch.bool else src
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, wire.contiguous(), group=mesh.get_group(axis))
    if src.dtype == torch.bool:
        out = out.view(torch.bool)
    return out.movedim(0, dim)


def gather_tree(tree, mesh: DeviceMesh | None, axis: str):
    """`gather` on the leading dim of every tensor of a dict or tuple of
    outputs (None and non-tensor values pass through)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(gather_tree(v, mesh, axis) for v in tree)
    if isinstance(tree, torch.Tensor):
        return gather(tree, mesh, axis)
    return tree


def gather_objects(items: list, mesh: DeviceMesh | None, axis: str) -> list:
    """Every rank's list of picklable items along `axis`, concatenated in
    axis order (one all_gather_object in the axis's group)."""
    if mesh is None:
        return items
    parts = [None] * axis_size(mesh, axis)
    dist.all_gather_object(parts, items, group=mesh.get_group(axis))
    return [x for part in parts for x in part]
