"""PDSCH transmit slot model (port of `srsran_projectvtlmo_tpu.models.pdsch_tx`).

`PdschTxConfig` is the SCH configuration of one PDSCH, with the reserved RE
patterns it rate-matches around; the DL slot (`phy/dl_slot`) builds one per
PDU.  `build_pdsch_tx_slot` is the single-layer PDSCH alone: SCH codeword
chain (`models/sch_tx`) + DM-RS type 1 + OFDM modulation, as the JAX program.
reference: lib/phy/upper/channel_processors/pdsch_processor_concurrent_impl.cpp:31-311.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ofdm as ofdm_mod
from ..ops.dmrs import dmrs_type1_sequence
from ..ran.re_pattern import inclusion_count
from ..utils.cplx import from_cplx
from ..utils.tables import resolve_device
from .sch_config import SchChainConfig
from .sch_tx import build_sch_symbols_tx


@dataclass(frozen=True)
class PdschTxConfig(SchChainConfig):
    dft_size: int = 4096
    numerology: int = 1
    slot: int = 0
    #: Reserved RE patterns (ran.re_pattern.RePattern, ABSOLUTE carrier
    #: PRBs/symbols) the PDSCH rate-matches around -- CSI-RS, CORESET
    #: (reference: pdsch_processor_impl.cpp:77-96 compute_nof_data_re).
    #: Patterns shrink nof_data_re (and therefore every rate-match E) and
    #: punch holes in the DL slot's RE mapping.
    reserved: tuple = ()

    @property
    def nof_data_re(self) -> int:
        base = self.nof_subc * len(self.data_symbols)
        if not self.reserved:
            return base
        abs_syms = [self.start_symbol + s for s in self.data_symbols]
        return base - inclusion_count(self.reserved, self.rb_start, self.nof_rb, abs_syms)


def build_pdsch_tx_slot(cfg: PdschTxConfig, device="cuda"):
    """fn: tb_bits (B, TBS) on `device` -> (grid_pair (B, 14, nsubc, 2),
    iq samples (B, nsamples, 2)), one layer, no reserved REs.  Runs on the
    card unless `device` names the CPU."""
    dev = resolve_device(device)
    sch_tx = build_sch_symbols_tx(cfg)
    ref = np.stack([dmrs_type1_sequence(cfg.slot, cfg.start_symbol + s, cfg.n_id, cfg.nof_rb,
                                        prb_start=cfg.rb_start)
                    for s in cfg.dmrs_symbols])
    pilots = np.zeros((len(cfg.dmrs_symbols), cfg.nof_subc), np.complex64)
    pilots[:, 0::2] = ref
    pilots = torch.as_tensor(pilots, device=dev)
    data_syms = torch.as_tensor(np.asarray(cfg.data_symbols, np.int64), device=dev)
    dmrs_syms = torch.as_tensor(np.asarray(cfg.dmrs_symbols, np.int64), device=dev)

    @torch.no_grad()
    def tx(tb_bits: torch.Tensor):
        b = tb_bits.shape[0]
        grid = torch.zeros((b, cfg.nof_ofdm_symbols, cfg.nof_subc), dtype=torch.complex64,
                           device=dev)
        grid[:, data_syms] = sch_tx(tb_bits).reshape(b, len(cfg.data_symbols), cfg.nof_subc)
        grid[:, dmrs_syms] = pilots
        grid_pair = from_cplx(grid)
        samples = ofdm_mod.ofdm_modulate(grid_pair, cfg.dft_size, cfg.numerology,
                                         cfg.slot % (1 << cfg.numerology))
        return grid_pair, samples

    return tx


@functools.lru_cache(maxsize=None)
def _cached_tx(cfg: PdschTxConfig, device: torch.device):
    return build_pdsch_tx_slot(cfg, device)


def pdsch_tx_slot(tb_bits: torch.Tensor, cfg: PdschTxConfig):
    """`build_pdsch_tx_slot` on the device of `tb_bits`, built once per config."""
    return _cached_tx(cfg, tb_bits.device)(tb_bits)
