"""Config-derived constant tables, built once on the host and kept on each
device, the uploads of per-slot host values and the fetches of results.
`upload`, `fetch`, `fetch_many` and `fetch_dl_outputs` count the bytes they
move (`utils.tracing` counters `h2d_bytes`, `d2h_bytes`)."""

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


def fetch_dl_outputs(grid: torch.Tensor, samples: torch.Tensor,
                     complex_grid: bool) -> tuple[np.ndarray, np.ndarray]:
    """A DL slot's grid real pair (..., 2), bfloat16 or float32, and its
    samples on the host, numpy, in fresh arrays that are the caller's own:
    the grid complex64 (...) with `complex_grid`, else float32 (..., 2), the
    samples float32 as `fetch` gives them.

    From the card both tensors are copied without blocking into pinned
    staging from torch's caching host allocator (reused after warm-up),
    queued behind the work on the current stream, and the host waits once,
    on an event recorded after the copies (span `upper_phy.dl_fetch_wait`).
    The arrays are then built from the staging with no temporaries: one copy
    that widens the grid to float32 (exact), viewed as complex64, and one
    copy of the samples.  Counts `d2h_bytes` as `fetch` does, and
    `dl_pinned_fetches`: 1 for a fetch from the card, 0 otherwise."""
    tracing.count("d2h_bytes", sum(t.numel() * t.element_size() for t in (grid, samples)))
    pinned = grid.device.type == "cuda"
    tracing.count("dl_pinned_fetches", int(pinned))
    if pinned:
        staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (grid, samples)]
        for dst, src in zip(staged, (grid, samples)):
            dst.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(grid.device))
        with tracing.span("upper_phy.dl_fetch_wait"):
            done.synchronize()
        grid, samples = staged
    g = _host_copy(grid)
    return (g.view(np.complex64)[..., 0] if complex_grid else g), _host_copy(samples)


def fetch_many(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Tensors' values on the host, numpy, as `fetch` gives them, behind one
    wait: from the card each is copied without blocking into pinned staging
    (torch's caching host allocator), the host waits once on an event
    recorded after the copies and copies each out into a fresh array.
    Counts `d2h_bytes` as `fetch` does."""
    tracing.count("d2h_bytes", sum(t.numel() * t.element_size() for t in tensors))
    if not tensors or tensors[0].device.type != "cuda":
        return [(t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy() for t in tensors]
    staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for dst, src in zip(staged, tensors):
        dst.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(tensors[0].device))
    done.synchronize()
    return [_host_copy(t) for t in staged]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's values in a fresh C-ordered numpy array, bfloat16
    widened to float32 in the same copy."""
    if t.dtype != torch.bfloat16:
        return t.numpy().copy()
    out = np.empty(tuple(t.shape), np.float32)
    torch.from_numpy(out).copy_(t)
    return out
