"""Shared derived parameters for SCH slot configurations.

A copy of `srsran_projectvtlmo_tpu.models.sch_config` (whose package
`__init__` imports jax); the tests hold every derived field equal to the
original.  TS 38.214 Section 5.1.3, TS 38.212 Section 5.4.2,
TS 38.211 Sections 7.3.1.1/6.3.1.1.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..ran.modulation import Modulation, bits_per_symbol
from ..ran.sch import (
    SchSegmentation, sch_segmentation_info, tbs_calculator)


@dataclass(frozen=True)
class SchChainConfig:
    nof_rb: int
    modulation: Modulation
    target_code_rate: float
    nof_layers: int = 1
    nof_ofdm_symbols: int = 14
    #: DM-RS symbol indices relative to start_symbol.
    dmrs_symbols: tuple[int, ...] = (2,)
    rv: int = 0
    rnti: int = 0x4601
    n_id: int = 1
    #: First OFDM symbol (absolute, used by the DM-RS c_init) and first PRB.
    start_symbol: int = 0
    rb_start: int = 0

    @property
    def nof_subc(self) -> int:
        return self.nof_rb * 12

    @property
    def data_symbols(self) -> tuple[int, ...]:
        return tuple(s for s in range(self.nof_ofdm_symbols) if s not in self.dmrs_symbols)

    @property
    def nof_data_re(self) -> int:
        return self.nof_subc * len(self.data_symbols)

    @functools.cached_property
    def tbs(self) -> int:
        nof_re = min(156, 12 * len(self.data_symbols)) * self.nof_rb
        return tbs_calculator(nof_re=nof_re, target_code_rate=self.target_code_rate,
                              modulation_bits=bits_per_symbol(self.modulation),
                              nof_layers=self.nof_layers)

    @functools.cached_property
    def segmentation(self) -> SchSegmentation:
        return sch_segmentation_info(self.tbs, self.target_code_rate)

    @property
    def nof_codeword_bits(self) -> int:
        return self.nof_data_re * bits_per_symbol(self.modulation) * self.nof_layers

    def cb_rate_match_sizes(self, g: int | None = None) -> list[int]:
        """Per-CB rate-matched size E_j (TS 38.212 Section 5.4.2.1)."""
        if g is None:
            g = self.nof_codeword_bits
        c = self.segmentation.nof_cb
        nl, qm = self.nof_layers, bits_per_symbol(self.modulation)
        es = []
        for j in range(c):
            if j <= c - (g // (nl * qm) % c) - 1:
                es.append(nl * qm * (g // (nl * qm * c)))
            else:
                es.append(nl * qm * (-(-g // (nl * qm * c))))
        if sum(es) != g:
            raise AssertionError(f"rate-match sizes sum to {sum(es)}, not G={g}")
        return es

    def scrambling_cinit(self) -> int:
        """TS 38.211 Sections 7.3.1.1 (DL, q=0) / 6.3.1.1 (UL)."""
        return ((self.rnti << 15) + self.n_id) & 0x7FFFFFFF
