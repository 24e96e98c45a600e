"""Sample/sequence-axis sharding with overlap-save halo exchange (port of
`srsran_projectvtlmo_tpu.parallel.sample_shard`).

The signal-processing analog of context parallelism (SURVEY Section 5.7): a
slot's sample stream splits over the mesh's "sp" axis, and stages whose
windows span a shard boundary (FIR filtering, CP-offset DFT windows) take
halo samples from a neighbour instead of gathering the whole stream.

Reference counterparts: the lower PHY streams samples symbol-by-symbol on
one thread and never parallelizes the sample axis
(reference: lib/phy/lower/lower_phy_baseband_processor.cpp:78-196,
lib/phy/lower/modulation/ofdm_demodulator_impl.cpp:94).

The halo exchange is one all_gather of every rank's halo piece in the sp
group, each rank keeping its neighbour's: one collective that runs the same
on gloo and NCCL, at any axis size including 1, with no send/receive
pairing to order; the pieces are at most one DFT window per rank.  The
functions take and return global tensors: each rank filters or demodulates
its block and the blocks are gathered back.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops import ofdm as ofdm_mod
from ..utils.cplx import from_cplx, to_cplx
from .mesh import axis_index, axis_size, block, gather, shard_leading


def _pad_samples(samples, n: int) -> torch.Tensor:
    """(..., nsamples, 2) zero-padded to a multiple of n samples."""
    x = torch.as_tensor(samples)
    pad = (-x.shape[-2]) % n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-2] + (pad, x.shape[-1]))], dim=-2)
    return x


def shard_samples(samples, mesh: DeviceMesh | None, axis: str = "sp",
                  batch_axis: str | None = None) -> torch.Tensor:
    """The (..., nsamples, 2) stream zero-padded to a multiple of the `axis`
    size: the global tensor whose blocks the functions below take (sample
    axis over `axis`, the leading batch dim over `batch_axis`)."""
    return _pad_samples(samples, axis_size(mesh, axis))


def _local(x: torch.Tensor, mesh, axis: str, batch_axis: str | None) -> torch.Tensor:
    """This rank's block: samples (dim -2) over `axis`, batch (dim 0) over `batch_axis`."""
    x = x[..., block(x.shape[-2], mesh, axis), :]
    return shard_leading(x, mesh, batch_axis) if batch_axis is not None else x


def _ring_halo(x: torch.Tensor, n: int, mesh, axis: str, from_right: bool) -> torch.Tensor:
    """An n-sample halo (axis -2) from a neighbour along `axis`.

    from_right=False: the LAST n samples of the left neighbour (stream
    history; zeros on the first shard).  from_right=True: the FIRST n
    samples of the right neighbour (stream future; zeros on the last shard).
    """
    piece = x[..., :n, :] if from_right else x[..., -n:, :]
    pieces = gather(piece[None], mesh, axis)  # (axis size, ..., n, 2)
    src = axis_index(mesh, axis) + (1 if from_right else -1)
    if 0 <= src < pieces.shape[0]:
        return pieces[src]
    return torch.zeros_like(piece)


def fir_filter_overlap_save(samples, taps, mesh: DeviceMesh | None, axis: str = "sp",
                            batch_axis: str | None = None) -> torch.Tensor:
    """Causal FIR filter over a sample-axis-sharded stream.

    y[n] = sum_k taps[k] x[n-k], computed on each rank's block after an
    (ntaps-1)-sample halo from the left neighbour (the overlap-save method):
    one halo collective per call regardless of stream length.  Zero initial
    state, matching scipy.signal.lfilter.

    Args:
      samples: (..., nsamples, 2) real-pair stream; nsamples divisible by
        the `axis` size.
      taps: (ntaps,) real or (ntaps, 2) complex-pair filter taps.

    Returns the filtered stream, the input's shape.
    """
    taps = np.asarray(taps, np.float32)
    if taps.ndim == 1:
        taps = np.stack([taps, np.zeros_like(taps)], -1)
    ntaps = taps.shape[0]
    halo_n = ntaps - 1
    x = torch.as_tensor(samples)
    if x.shape[-2] % axis_size(mesh, axis):
        raise ValueError(f"{x.shape[-2]} samples do not divide over axis {axis!r}")
    x = _local(x, mesh, axis, batch_axis)
    ext = torch.cat([_ring_halo(x, halo_n, mesh, axis, from_right=False), x], dim=-2) \
        if halo_n else x
    xr, xi = ext[..., 0], ext[..., 1]
    n_local = x.shape[-2]
    acc_r = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    acc_i = torch.zeros_like(acc_r)
    for k in range(ntaps):
        # y[n] += h[k] * x[n-k]: x index (halo_n + n - k) into ext.
        seg_r = xr[..., halo_n - k:halo_n - k + n_local]
        seg_i = xi[..., halo_n - k:halo_n - k + n_local]
        hr, hi = float(taps[k, 0]), float(taps[k, 1])
        acc_r = acc_r + hr * seg_r - hi * seg_i
        acc_i = acc_i + hr * seg_i + hi * seg_r
    y = gather(torch.stack([acc_r, acc_i], dim=-1), mesh, axis, dim=-2)
    return gather(y, mesh, batch_axis) if batch_axis is not None else y


def _demod_plan(nsamples_padded: int, n_shards: int, dft_size: int, mu: int,
                slot_in_subframe: int, cp: str):
    """Static owner/offset tables for sample-sharded OFDM demodulation."""
    cps = ofdm_mod.cp_lengths(dft_size, mu, slot_in_subframe, cp)
    nsym = len(cps)
    shard = nsamples_padded // n_shards
    offs, owners = [], []
    t = 0
    for l in range(nsym):
        off = t + cps[l]
        offs.append(off)
        owners.append(off // shard)
        t += cps[l] + dft_size
    per_shard = max(sum(1 for o in owners if o == d) for d in range(n_shards))
    local_off = np.zeros((n_shards, per_shard), np.int32)
    sym_id = np.zeros((n_shards, per_shard), np.int32)
    valid = np.zeros((n_shards, per_shard), bool)
    fill = [0] * n_shards
    halo_n = 0
    for l, (off, d) in enumerate(zip(offs, owners)):
        j = fill[d]
        local_off[d, j] = off - d * shard
        sym_id[d, j] = l
        valid[d, j] = True
        fill[d] += 1
        halo_n = max(halo_n, off + dft_size - (d + 1) * shard)
    halo_n = max(int(halo_n), 0)
    if halo_n > shard:
        raise ValueError(
            f"shard of {shard} samples too small for {dft_size}-point windows:"
            f" needs {halo_n}-sample halo; use fewer shards")
    return local_off, sym_id, valid, halo_n, per_shard, nsym, shard


def sharded_ofdm_demodulate(samples_pair, nsubc: int, dft_size: int, mu: int,
                            mesh: DeviceMesh | None, slot_in_subframe: int = 0,
                            center_freq_hz: float = 0.0, scale: float = 1.0,
                            cp: str = "normal", axis: str = "sp",
                            batch_axis: str | None = None) -> torch.Tensor:
    """OFDM slot demodulation with the time-sample axis sharded over `axis`.

    Each rank owns the DFT windows that start inside its block and takes up
    to one window of halo samples from its right neighbour.  The same
    arithmetic as `ops.ofdm.ofdm_demodulate`.

    Args:
      samples_pair: (..., nsamples, 2) slot baseband.

    Returns the (..., nsym, nsubc, 2) resource grid, whole on every rank.
    """
    n = axis_size(mesh, axis)
    x = _pad_samples(samples_pair, n)
    local_off, sym_id, valid, halo_n, per_shard, nsym, _ = _demod_plan(
        x.shape[-2], n, dft_size, mu, slot_in_subframe, cp)
    x = _local(x, mesh, axis, batch_axis)
    d = axis_index(mesh, axis)
    ext = torch.cat([x, _ring_halo(x, max(halo_n, 1), mesh, axis, from_right=True)], dim=-2)
    xc = to_cplx(ext)
    wins = [xc[..., int(local_off[d, p]):int(local_off[d, p]) + dft_size] if valid[d, p]
            else xc.new_zeros(xc.shape[:-1] + (dft_size,)) for p in range(per_shard)]
    bins = torch.fft.fft(torch.stack(wins, dim=-2), dim=-1) / dft_size
    phase = ofdm_mod.phase_compensation(dft_size, mu, slot_in_subframe, center_freq_hz, cp)
    ph = torch.as_tensor(np.conj(phase)[sym_id[d]], device=x.device)
    bins = bins * ph[:, None]
    half = nsubc // 2
    grid = torch.cat([bins[..., dft_size - half:], bins[..., :nsubc - half]], dim=-1) * scale
    stacked = gather(from_cplx(grid), mesh, axis, dim=-3)  # (..., n * per_shard, nsubc, 2)
    # Shard order -> slot symbol order.
    order = np.full(nsym, -1, np.int64)
    for s in range(n):
        for p in range(per_shard):
            if valid[s, p]:
                order[sym_id[s, p]] = s * per_shard + p
    assert (order >= 0).all()
    grid = stacked.index_select(-3, torch.as_tensor(order, device=stacked.device))
    return gather(grid, mesh, batch_axis) if batch_axis is not None else grid
