"""Shared SCH transmit codeword chain: segmentation + CRCs + LDPC encode +
rate match (+ scrambling + modulation).

Port of `srsran_projectvtlmo_tpu.models.sch_tx` (`build_sch_codeword_tx`,
`build_sch_symbols_tx`, `sch_rate_match_groups`), bit-exact with it.  The
returned functions run on the device of the TB bits they are given; the
config-derived tables are cached per device.  The dynamic-value chain
`build_sch_symbols_tx_dyn` comes with the DL slot (ROADMAP A10).
"""

from __future__ import annotations

import torch

from ..ops import prg as prg_mod
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc.encode import ldpc_encode
from ..ops.ldpc.segment import segment_tx
from ..ops.modulation import modulate
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
