"""Config-derived constant tables, built once on the host and kept on each
device, the uploads of per-slot host values and the fetches of results.
`upload` and `fetch` count the bytes they move (`utils.tracing` counters
`h2d_bytes`, `d2h_bytes`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import tracing


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


def upload(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array (or a tensor) on `device`.  To the card a host array goes
    through pinned memory without blocking, so that the upload does not wait
    for the work already queued on the device.  Counts `h2d_bytes`: the
    bytes handed to the device, none for a tensor already there."""
    if isinstance(a, torch.Tensor):
        out = a.to(device=device, dtype=dtype)
        if a.device != out.device:
            tracing.count("h2d_bytes", out.numel() * out.element_size())
        return out
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    tracing.count("h2d_bytes", t.numel() * t.element_size())
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_many(arrays: list[np.ndarray], device: torch.device) -> list[torch.Tensor]:
    """Host arrays on `device`, one `upload` per dtype: the arrays of a dtype
    travel concatenated and come back as views of one tensor, in order."""
    out: list[torch.Tensor | None] = [None] * len(arrays)
    by_dtype: dict[np.dtype, list[int]] = {}
    for i, a in enumerate(arrays):
        by_dtype.setdefault(np.asarray(a).dtype, []).append(i)
    for idx in by_dtype.values():
        flat = upload(np.concatenate([np.ravel(arrays[i]) for i in idx]), device)
        parts = flat.split([np.size(arrays[i]) for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(np.shape(arrays[i]))
    return out


def fetch(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, numpy; from the card the copy waits for
    the work queued before it.  bfloat16 crosses as such and becomes float32
    on the host (numpy has no bfloat16).  Counts `d2h_bytes`."""
    tracing.count("d2h_bytes", t.numel() * t.element_size())
    h = t.cpu()
    return (h.float() if h.dtype == torch.bfloat16 else h).numpy()
