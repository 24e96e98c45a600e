"""PUSCH UCI multiplexing with the CSI part-1 -> part-2 two-phase protocol
(port of `srsran_projectvtlmo_tpu.phy.pusch_uci`).

The reference sizes CSI part 2 from the decoded part-1 payload inside the
demultiplexer (reference: lib/phy/upper/channel_processors/pusch/
pusch_processor_impl.cpp:40-92 csi-part1-feedback, ulsch_demultiplex_impl.cpp
set_csi_part2 :241).  The part-2 size is a host decision, so the protocol
runs as two device phases around it:

  phase A: the PUSCH receiver with `decode_sch=False` -- estimate, equalize,
      demap, descramble -> codeword LLRs; HARQ-ACK and CSI part 1 decoded on
      the device (their Section 6.2.7 placement does not depend on part 2).
  host: csi2_size = part2_size_map[int(csi1 bits)], the csi1 bits copied to
      the host for it.
  phase B (`models.pusch_rx.build_pusch_phase_b`, one per part-2 size):
      CSI part 2 decode, the SCH gather of that size's placement plan, rate
      recovery (+ HARQ combining) and LDPC decoding.

Both phases take `dynamic_params`: DM-RS references, descrambling signs and
placeholder fix signs ride as call inputs.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..models.pusch_rx import (
    PuschRxConfig, cached_pusch_phase_b, cached_pusch_rx_from_grid, flatten_tb_bits)
from ..ops.ulsch_demux import placeholder_fix_signs
from ..ran.modulation import bits_per_symbol
from ..utils.tables import fetch, resolve_device


@dataclass(frozen=True)
class PuschUciConfig:
    #: rx.nof_harq_ack_bits / rx.nof_csi_part1_bits hold the phase-A payloads.
    rx: PuschRxConfig
    #: part2_size_map[value(csi1 bits)] -> nof csi2 bits (0 = absent).
    part2_size_map: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def _phase_a_cfg(rx: PuschRxConfig) -> PuschRxConfig:
    return dataclasses.replace(rx, decode_sch=False, nof_csi_part2_bits=0)


@functools.lru_cache(maxsize=None)
def _phase_b_cfg(rx: PuschRxConfig) -> PuschRxConfig:
    return dataclasses.replace(rx, decode_sch=True, nof_csi_part2_bits=0)


class PuschUciProcessor:
    """Two-phase PUSCH processor with HARQ-ACK / CSI1 / CSI2 decoding, on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: PuschUciConfig, device="cuda"):
        rx = cfg.rx
        if rx.nof_csi_part1_bits <= 0:
            raise ValueError("two-phase CSI needs part-1 bits")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._qm = bits_per_symbol(rx.modulation)
        self._cfg_b = _phase_b_cfg(rx)
        self._rx_a = cached_pusch_rx_from_grid(_phase_a_cfg(rx), self.device)

    def csi2_sizes(self, csi1_bits: np.ndarray) -> list[int]:
        """Host decision point: CSI part-2 sizes from decoded part-1 rows."""
        k = self.cfg.rx.nof_csi_part1_bits
        weights = 1 << np.arange(k - 1, -1, -1)
        values = (np.asarray(csi1_bits).astype(np.int64) * weights).sum(-1)
        return [int(self.cfg.part2_size_map[int(v)]) for v in values]

    def csi2_fix_signs(self, csi2_size: int, scr_bits) -> torch.Tensor:
        """(B, E_csi2) int8 placeholder fix signs for the dynamic phase B
        (one row per batch element's scrambling sequence)."""
        plan, _ = self._cfg_b.demux_plan(csi2_size)
        rows = [placeholder_fix_signs(plan.csi2_bit_idx, csi2_size, self._qm, s)
                for s in scr_bits]
        return torch.as_tensor(np.stack(rows), dtype=torch.int8, device=self.device)

    def phase_a(self, grid_pair: torch.Tensor, ref_dmrs=None, dyn_signs=None,
                dyn_uci_fix=None) -> dict:
        """Phase A on an extracted-allocation grid batch: the receiver's
        device outputs with `decode_sch=False` (codeword LLRs, HARQ-ACK, CSI
        part 1, channel metrics).  Dynamic mode takes the receiver's call
        inputs as `process` does."""
        if self.cfg.rx.dynamic_params:
            return self._rx_a(grid_pair, None, ref_dmrs, dyn_signs, dyn_uci_fix)
        return self._rx_a(grid_pair)

    def _phase_b(self, csi2_size: int, llr: torch.Tensor, harq_buffer, scr_bits) -> dict:
        """Phase B of one part-2 size on codeword LLR rows `llr`; in dynamic
        mode the CSI part-2 fix signs follow from the rows' scrambling bits."""
        csi2_fix = None
        if self.cfg.rx.dynamic_params and csi2_size:
            csi2_fix = self.csi2_fix_signs(csi2_size, scr_bits)
        return cached_pusch_phase_b(self._cfg_b, csi2_size, self.device)(llr, harq_buffer,
                                                                         csi2_fix)

    def phase_b_by_size(self, a: dict, csi1_bits: np.ndarray, harq_buffer=None,
                        scr_bits=None) -> dict:
        """Phase B once per distinct part-2 size, on that size's rows of
        phase A's output `a`, the sizes read from its CSI part 1 `csi1_bits`
        on the host; `harq_buffer` and `scr_bits` as `process` takes them.

        Returns the results per row, in batch order: `tb_crc_ok` (B,) bool,
        `csi2_metric` (B,) float32 and `csi2_bits` (a list: each row's bits,
        None where its part 2 is empty) on the host, `csi2_size` (the rows'
        sizes), and `tb_bits_cb` and `harq_soft` (B, ...) on the device."""
        sizes = self.csi2_sizes(csi1_bits)
        b = len(sizes)
        ok, csi2_metric = np.zeros(b, bool), np.zeros(b, np.float32)
        csi2_bits, tb_bits_cb, harq_soft = [None] * b, [None] * b, [None] * b
        for size in sorted(set(sizes)):
            idxs = [i for i, s in enumerate(sizes) if s == size]
            sel = torch.as_tensor(idxs, device=self.device)
            out = self._phase_b(size, a["codeword_llr"][sel],
                                None if harq_buffer is None else harq_buffer[sel],
                                None if scr_bits is None else [scr_bits[i] for i in idxs])
            ok[idxs] = fetch(out["tb_crc_ok"])
            if size:
                bits = fetch(out["csi2_bits"])
                csi2_metric[idxs] = fetch(out["csi2_metric"])
            for row, i in enumerate(idxs):
                tb_bits_cb[i], harq_soft[i] = out["tb_bits_cb"][row], out["harq_soft"][row]
                if size:
                    csi2_bits[i] = bits[row]
        return dict(tb_crc_ok=ok, tb_bits_cb=torch.stack(tb_bits_cb),
                    harq_soft=torch.stack(harq_soft), csi2_size=sizes, csi2_bits=csi2_bits,
                    csi2_metric=csi2_metric)

    def process(self, grid_pair: torch.Tensor, harq_buffer: torch.Tensor | None = None,
                ref_dmrs=None, dyn_signs=None, dyn_uci_fix=None, scr_bits=None) -> dict:
        """Run both phases on an extracted-allocation grid batch of one
        part-2 size.

        Static mode (rx.dynamic_params=False): only `grid_pair` (and
        optionally `harq_buffer`).  Dynamic mode also takes the receiver's
        call inputs (`ref_dmrs`, `dyn_signs`, `dyn_uci_fix` = (ack_fix,
        csi1_fix, None)) and `scr_bits`, the per-row Gold scrambling bits,
        from which the phase-B CSI part-2 fix signs follow once the size is
        known.  Device tensors and host arrays come back as in the JAX
        processor: the decisions (`csi1_*`, `csi2_size`, `tb_bits`, ACK) on
        the host.  Rows whose part 1 selects different part-2 sizes raise,
        as in JAX; `phase_b_by_size` serves them.
        """
        rx = self.cfg.rx
        if rx.dynamic_params and (ref_dmrs is None or dyn_signs is None or scr_bits is None):
            raise ValueError("dynamic mode takes (ref_dmrs, dyn_signs, scr_bits)")
        a = self.phase_a(grid_pair, ref_dmrs, dyn_signs, dyn_uci_fix)
        csi1_np = fetch(a["csi1_bits"])
        sizes = self.csi2_sizes(csi1_np)
        if len(set(sizes)) != 1:
            raise ValueError("mixed csi2 sizes in one batch not supported yet")
        csi2_size = sizes[0]

        out = dict(self._phase_b(csi2_size, a["codeword_llr"], harq_buffer, scr_bits))
        out["csi1_bits"] = csi1_np
        out["csi1_metric"] = fetch(a["csi1_metric"])
        out["csi1_valid"] = out["csi1_metric"] > 0.0
        out["csi2_size"] = csi2_size
        if csi2_size:
            out["csi2_valid"] = fetch(out["csi2_metric"]) > 0.0
        out["tb_bits"] = flatten_tb_bits(fetch(out["tb_bits_cb"]), rx.tbs)
        out["snr_db"], out["evm"], out["ta_s"] = a["snr_db"], a["evm"], a["ta_s"]
        if rx.nof_harq_ack_bits:
            out["harq_ack_bits"] = fetch(a["harq_ack_bits"])
            out["harq_ack_metric"] = fetch(a["harq_ack_metric"])
        return out
