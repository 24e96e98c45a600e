"""Config-derived constant tables, built once on the host and kept on each device."""

from __future__ import annotations

import functools

import torch


def on_device(fn, *args, device) -> torch.Tensor:
    """fn(*args), a host table (numpy), as a tensor on `device`.

    Cached per (fn, args, device): a hot path that needs the table every
    call neither rebuilds it nor copies it to the card again.  The cached
    tensor is shared, so callers must not write to it.
    """
    return _cached(fn, args, torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached(fn, args, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fn(*args), device=device)


def resolve_device(device) -> torch.device:
    """`device` as a torch.device, a bare "cuda" pinned to the current card
    so that it compares equal to the device of the tensors made there."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
