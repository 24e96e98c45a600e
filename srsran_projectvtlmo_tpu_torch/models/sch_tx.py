"""Shared SCH transmit codeword chain: segmentation + CRCs + LDPC encode +
rate match (+ scrambling + modulation).

Port of `srsran_projectvtlmo_tpu.models.sch_tx`, bit-exact with it.  The
returned functions run on the device of the TB bits they are given; the
config-derived tables are cached per device.

The dynamic-value chain (`build_sch_symbols_tx_dyn`, which the DL slot runs)
takes the scrambling planes (rnti/n_id) and the redundancy version's
circular-buffer start k0' as call inputs, so one chain serves every UE and
every redundancy version of a shape.  rv is a host integer: the bit selection
is one circular slice of the filler-less buffer at k0', where the JAX program
selects among four static slices with a one-hot vector.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np
import torch

from ..ops import prg as prg_mod
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc.encode import ldpc_encode
from ..ops.ldpc.segment import segment_tx
from ..ops.modulation import modulate, modulate_planes
from ..ran.modulation import bits_per_symbol
from ..utils.tables import on_device
from .sch_config import SchChainConfig


def sch_rate_match_groups(cfg: SchChainConfig, g: int | None = None):
    """Equal-E codeblock groups [(e, [cb indices])] for this configuration."""
    es = cfg.cb_rate_match_sizes(g)
    groups: dict[int, list[int]] = {}
    for j in range(cfg.segmentation.nof_cb):
        groups.setdefault(int(es[j]), []).append(j)
    return list(groups.items())


def build_sch_codeword_tx(cfg: SchChainConfig, g: int | None = None):
    """fn: tb_bits (B, TBS) uint8 -> unscrambled codeword bits (B, G) uint8.

    `g` defaults to the full codeword size; UL-SCH with UCI rate-matched
    around passes the reduced G.
    """
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    c, z, k = seg.nof_cb, seg.lifting_size, seg.nof_bits_per_cb
    groups = sch_rate_match_groups(cfg, g)

    def tx(tb_bits: torch.Tensor) -> torch.Tensor:
        b = tb_bits.shape[0]
        cbs = segment_tx(tb_bits, seg)  # (B, C, K)
        cw = ldpc_encode(cbs.reshape(b * c, k), seg.base_graph, z).reshape(b, c, -1)[:, :, 2 * z:]
        # Equal-E codeblocks are contiguous and share one rate-match plan.
        return torch.cat([rm.rate_match(cw[:, js[0]:js[-1] + 1], seg.base_graph, z,
                                        seg.nof_filler_bits_per_cb, cfg.rv, e, qm).reshape(b, -1)
                          for e, js in groups], dim=-1)

    return tx


def build_sch_symbols_tx(cfg: SchChainConfig):
    """fn: tb_bits (B, TBS) -> data symbols (B, nof_data_re * L) complex64."""
    codeword_tx = build_sch_codeword_tx(cfg)

    def tx(tb_bits: torch.Tensor) -> torch.Tensor:
        scramble = on_device(prg_mod.gold_sequence_bits, cfg.scrambling_cinit(),
                             cfg.nof_codeword_bits, device=tb_bits.device)
        return modulate(codeword_tx(tb_bits) ^ scramble, cfg.modulation)

    return tx


def sch_rate_match_indices(cfg: SchChainConfig, rv: int, g: int | None = None):
    """Host per-group rate-match gather indices for a redundancy version:
    one (E,) int64 array per equal-E codeblock group."""
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    return tuple(rm.rate_match_plan(seg.base_graph, seg.lifting_size,
                                    seg.nof_filler_bits_per_cb, rv, e, qm)
                 for e, _ in sch_rate_match_groups(cfg, g))


def sch_k0_prime(cfg: SchChainConfig, rv: int) -> int:
    """rv's circular-buffer start mapped into the FILLER-LESS buffer.

    The TS 38.212 bit selection walks the circular buffer from k0 skipping
    filler positions -- identical to walking the buffer with filler removed
    from position k0' (k0 is always z-aligned, outside the filler span)."""
    seg = cfg.segmentation
    z = seg.lifting_size
    k0 = rm.k0_index(seg.base_graph, rv, seg.nof_cw_bits_per_cb, z)
    filler_start = seg.nof_bits_per_cb - 2 * z - seg.nof_filler_bits_per_cb
    filler_end = seg.nof_bits_per_cb - 2 * z
    assert not (filler_start < k0 < filler_end), "k0 inside filler span"
    return k0 - (seg.nof_filler_bits_per_cb if k0 >= filler_end else 0)


def sch_scramble_planes(cfg: SchChainConfig, rnti: int, n_id: int, g: int | None = None):
    """Host: per-group bit-major scrambling planes (nj, Qm, E/Qm) uint8."""
    qm = bits_per_symbol(cfg.modulation)
    vcfg = dataclasses.replace(cfg, rnti=rnti, n_id=n_id)
    scr = prg_mod.gold_sequence_bits(vcfg.scrambling_cinit(), cfg.nof_codeword_bits)
    out, off = [], 0
    for e, js in sch_rate_match_groups(cfg, g):
        nj = len(js)
        blk = scr[off:off + nj * e].reshape(nj, e // qm, qm)
        out.append(np.ascontiguousarray(blk.transpose(0, 2, 1)))
        off += nj * e
    return tuple(out)


def _circular(buf: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """buf[..., start:start + length] with the last axis read circularly."""
    n = buf.shape[-1]
    pieces, pos = [], start % n
    while length > 0:
        take = min(length, n - pos)
        pieces.append(buf[..., pos:pos + take])
        length -= take
        pos = 0
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def build_sch_planes_tx_dyn(cfg: SchChainConfig, g: int | None = None):
    """fn(tb_bits (B, TBS), scr_planes, k0p) -> per equal-E group the
    scrambled bit planes (B, nj, Qm, E/Qm) uint8: the transmitted codeword
    bits, plane i holding bit i of each symbol.

    `scr_planes` holds one (nj, Qm, E/Qm) array per group, or (B, nj, Qm,
    E/Qm) with a row per TB; `k0p` is `sch_k0_prime` of the redundancy
    version, one int for every row or one per row.  The Section 5.4.2.2 bit
    interleaver needs no permutation: plane i is the contiguous slice
    [i E/Qm, (i+1) E/Qm) of the selected bits."""
    seg = cfg.segmentation
    qm = bits_per_symbol(cfg.modulation)
    c, z, k = seg.nof_cb, seg.lifting_size, seg.nof_bits_per_cb
    groups = sch_rate_match_groups(cfg, g)
    for _, js in groups:
        assert js == list(range(js[0], js[-1] + 1)), "E groups not contiguous"
    filler_start = k - 2 * z - seg.nof_filler_bits_per_cb
    filler_end = k - 2 * z

    def tx(tb_bits: torch.Tensor, scr_planes, k0p: int | Sequence[int]) -> list[torch.Tensor]:
        b = tb_bits.shape[0]
        cbs = segment_tx(tb_bits, seg)
        cw = ldpc_encode(cbs.reshape(b * c, k), seg.base_graph, z).reshape(b, c, -1)[:, :, 2 * z:]
        buf = torch.cat([cw[:, :, :filler_start], cw[:, :, filler_end:]], dim=-1)
        starts = [k0p] * b if isinstance(k0p, int) else list(k0p)
        planes = []
        for (e, js), scr in zip(groups, scr_planes):
            sub = buf[:, js[0]:js[-1] + 1]
            if len(set(starts)) == 1:
                sel = _circular(sub, starts[0], e)
            else:
                sel = torch.stack([_circular(sub[i], s, e) for i, s in enumerate(starts)])
            planes.append(sel.reshape(b, len(js), qm, e // qm) ^ scr)
        return planes

    return tx


def build_sch_symbols_tx_dyn(cfg: SchChainConfig, g: int | None = None):
    """fn(tb_bits (B, TBS), scr_planes, k0p) -> (B, G/Qm) complex64 symbols:
    `build_sch_planes_tx_dyn` mapped by `modulate_planes` (square QAM)."""
    planes_tx = build_sch_planes_tx_dyn(cfg, g)

    def tx(tb_bits: torch.Tensor, scr_planes, k0p: int | Sequence[int]) -> torch.Tensor:
        b = tb_bits.shape[0]
        return torch.cat([modulate_planes(p, cfg.modulation).reshape(b, -1)
                          for p in planes_tx(tb_bits, scr_planes, k0p)], dim=-1)

    return tx
