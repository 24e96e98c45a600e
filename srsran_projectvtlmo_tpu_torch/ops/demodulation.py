"""Max-log soft demapping, BPSK ... 256QAM (port of `srsran_projectvtlmo_tpu.ops.demodulation`).

For square Gray QAM the I and Q axes separate: each bit's max-log LLR is a
difference of per-axis PAM distance minima, taken over a shared dyadic min
pyramid (min is exact, so the pyramid is bit-exact with a full masked min).
Then the reference's quantization: clip at the range limit (24 for BPSK and
QPSK, 20 for the QAM orders), scale to +/-120, round half away from zero.
reference: lib/phy/upper/channel_modulation/demodulation_mapper_*.cpp.

The tables are built on the host exactly as in the JAX package; the device
work is elementwise float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ran.modulation import Modulation, bits_per_symbol
from ..utils.llr import llr_quantize
from .modulation import constellation

RANGE_LIMIT = 20.0


def range_limit(mod: Modulation) -> float:
    if mod in (Modulation.BPSK, Modulation.PI_2_BPSK, Modulation.QPSK):
        return 24.0
    return RANGE_LIMIT


@functools.lru_cache(maxsize=None)
def demap_tables(mod: Modulation):
    """(points (M, 2) float32, |point|^2 (M,) float32, bits (M, Qm) bool)."""
    pts = constellation(mod)
    qm = bits_per_symbol(mod)
    idx = np.arange(len(pts))
    bits = ((idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(bool)
    c_pair = np.stack([pts.real, pts.imag], axis=-1).astype(np.float32)
    return c_pair, (np.abs(pts) ** 2).astype(np.float32), bits


def _dyadic_cover(idx: tuple[int, ...]) -> list[tuple[int, int]]:
    """Cover a sorted index set by maximal aligned dyadic blocks [(level, j)]."""
    runs, blocks = [], []
    start = prev = idx[0]
    for i in idx[1:]:
        if i != prev + 1:
            runs.append((start, prev + 1))
            start = i
        prev = i
    runs.append((start, prev + 1))
    for a, b in runs:
        while a < b:
            lev = 0
            while a % (2 << lev) == 0 and a + (2 << lev) <= b:
                lev += 1
            blocks.append((lev, a >> lev))
            a += 1 << lev
    return blocks


@functools.lru_cache(maxsize=None)
def demap_axis_tables(mod: Modulation):
    """(pam (Mp,) float32, bit_axis (Qm,) 0=I/1=Q, bits_pam (Mp, Qm) bool), or
    None when the constellation does not separate into two Gray PAM axes."""
    pts = constellation(mod)
    qm = bits_per_symbol(mod)
    if qm < 2:
        return None
    m = len(pts)
    bits = ((np.arange(m)[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1).astype(bool)
    re, im = pts.real.astype(np.float32), pts.imag.astype(np.float32)
    pam = np.unique(re)
    if len(pam) * len(pam) != m or not np.array_equal(pam, np.unique(im)):
        return None
    bit_axis = np.zeros(qm, np.int8)
    bits_pam = np.zeros((len(pam), qm), bool)
    for b in range(qm):
        by_re, axis_i = {}, True
        for j in range(m):
            if re[j] in by_re and by_re[re[j]] != bits[j, b]:
                axis_i = False
                break
            by_re[re[j]] = bits[j, b]
        bit_axis[b] = 0 if axis_i else 1
        vals = re if axis_i else im
        for pi, level in enumerate(pam):
            vset = np.unique(bits[np.flatnonzero(vals == level), b])
            if len(vset) != 1:
                return None
            bits_pam[pi, b] = bool(vset[0])
    return pam.astype(np.float32), bit_axis, bits_pam


@functools.lru_cache(maxsize=None)
def demap_min_plan(mod: Modulation):
    """(max_level, {(bit, value): [(level, j)]}) pyramid covers per bit set."""
    _, _, bits_pam = demap_axis_tables(mod)
    covers, max_level = {}, 0
    for b in range(bits_pam.shape[1]):
        for v in (False, True):
            blocks = _dyadic_cover(tuple(int(i) for i in np.flatnonzero(bits_pam[:, b] == v)))
            covers[(b, v)] = blocks
            max_level = max(max_level, max(lev for lev, _ in blocks))
    return max_level, covers


def _bit_metrics(x: torch.Tensor, mod: Modulation) -> list[torch.Tensor]:
    """Per bit, (min over points with bit 1) - (min over points with bit 0) of
    |c|^2 - 2 Re(y c*), each (..., nsym) float32."""
    qm = bits_per_symbol(mod)
    axis_tabs = demap_axis_tables(mod)
    if axis_tabs is not None:
        pam, bit_axis, _ = axis_tabs
        max_level, covers = demap_min_plan(mod)
        pyramids = []
        for ax in range(2):
            x2 = 2.0 * x[..., ax]
            pyr = [[float(p * p) - x2 * float(p) for p in pam]]
            for _ in range(max_level):
                prev = pyr[-1]
                pyr.append([torch.minimum(prev[2 * j], prev[2 * j + 1])
                            for j in range(len(prev) // 2)])
            pyramids.append(pyr)

        def set_min(bit, val, ax):
            parts = [pyramids[ax][lev][j] for lev, j in covers[(bit, val)]]
            return functools.reduce(torch.minimum, parts)

        return [set_min(b, True, int(bit_axis[b])) - set_min(b, False, int(bit_axis[b]))
                for b in range(qm)]
    c_pair, c_norm, bits = demap_tables(mod)
    metric = torch.stack([float(c_norm[k]) - 2.0 * (x[..., 0] * float(c_pair[k, 0])
                                                     + x[..., 1] * float(c_pair[k, 1]))
                          for k in range(len(c_norm))], dim=-1)
    inf = torch.tensor(float("inf"), device=x.device)
    out = []
    for b in range(qm):
        mask1 = torch.as_tensor(bits[:, b], device=x.device)
        out.append(torch.where(mask1, metric, inf).min(dim=-1).values
                   - torch.where(mask1, inf, metric).min(dim=-1).values)
    return out


def soft_demap(symbols_pair: torch.Tensor, noise_var: torch.Tensor, mod: Modulation,
               bit_major: bool = False) -> torch.Tensor:
    """Max-log soft demapping.

    symbols_pair: (..., nsym, 2) equalized symbols; noise_var broadcastable
    against (..., nsym).  Returns (..., nsym * Qm) int8 LLRs (positive = bit
    0), or with `bit_major` the planes (B, Qm, ...) stacked at axis 1, each
    quantized to int8 before stacking.  A non-positive noise variance gives 0.
    """
    x = symbols_pair.float()
    if mod == Modulation.PI_2_BPSK:
        odd = (torch.arange(x.shape[-2], device=x.device) % 2 == 1)[:, None]
        x = torch.where(odd, torch.stack([x[..., 1], -x[..., 0]], -1), x)
    llrs = _bit_metrics(x, mod)
    limit = range_limit(mod)
    if bit_major:
        nv = noise_var
        return torch.stack([llr_quantize(torch.where(nv > 0, p / torch.clamp(nv, min=1e-38), 0.0),
                                         limit) for p in llrs], dim=1)
    llr = torch.stack(llrs, dim=-1)
    nv = noise_var[..., None]
    llr = llr_quantize(torch.where(nv > 0, llr / torch.clamp(nv, min=1e-38), 0.0), limit)
    return llr.reshape(llr.shape[:-2] + (llr.shape[-2] * llr.shape[-1],))


def hard_demap(llrs: torch.Tensor) -> torch.Tensor:
    """LLR <= 0 -> bit 1 (uint8)."""
    return (llrs <= 0).to(torch.uint8)
