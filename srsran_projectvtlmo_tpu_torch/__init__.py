"""srsran_projectvtlmo_tpu_torch: the 5G NR upper PHY on PyTorch and CUDA.

A port of `srsran_projectvtlmo_tpu` (JAX) to PyTorch, with the Pallas TPU
kernels rewritten by hand for NVIDIA Hopper (`csrc/`).  The JAX package stays
the reference; every public function here keeps its array conventions so the
parity tests are plain array comparisons:

  * complex values as real pairs `(..., 2)` in float32 or bfloat16;
  * LLRs as int8 in [-120, 120], with +/-127 as the fixed-bit value;
  * bits as uint8.

Layout (mirrors the JAX package):
  fapi/          FAPI-shaped PDUs and indications, their validators (host)
  ran/           LDPC parameters, modulation schemes, SCH segmentation, UL-SCH
                 UCI budgets, PRACH formats, cyclic shifts and configurations
                 (host)
  utils/         int8 LLR semantics, complex pairs, device-cached tables
  ops/           CRC, PRG, DM-RS, OFDM (and the PRACH occasion), estimation,
                 equalization, demapping, EVM, UCI placement, short-block codes,
                 UCI encode/decode, low-PAPR sequences, PRACH, SRS
  ops/ldpc/      graphs, rate matching, the encoder, the plain decoder and its
                 CUDA kernel
  ops/polar/     polar code construction, allocation, encoder, rate matching and
                 the SSC decoder
  models/        SCH configuration, the UL-SCH transmitter, the PUSCH receive slot
  phy/           the FAPI entry point (`upper_phy.UpperPhy`, UL and DL), the DL
                 slot assembly, the HARQ arena, PUCCH formats 0/1/2, PRACH
                 buffers, the two-phase (CSI part 1 -> part 2) PUSCH UCI
                 processor, the realtime slot machinery, receiver warmup,
                 error accounting, the rx-symbol handler and the lower PHY
                 (`lower.LowerPhy`)
  parallel/      the multi-cell upper PHY and the (cell, sp) mesh
  ofh/, radio/   the split-7.2 fronthaul framing and the baseband gateways (host)
  apps/          the gNB slot simulator (`python -m ...apps.gnb_sim`)
  entry.py       the entry step and the multi-device dry run
  native.py      the host C++ helper library, built with c++ at first use
  csrc/          CUDA C++ sources, built with nvcc at first use, and the host
                 C++ helpers
  data/          base graphs, polar, low-PAPR and PRACH tables and the
                 north-star test fixture

This package imports torch and never jax, and nothing of the JAX package:
it keeps its own copies of the host modules it needs (`fapi/*`, `ran/*`,
`ops/prg`, `ops/dmrs`, `ops/ulsch_demux`, `ops/polar/code`, `ops/low_papr`,
`ops/csi_rs`, `ofh/*`, `radio/*`, `phy/error_handler`,
`phy/rx_symbol_handler`, `utils/sanitizer`, `utils/bits`, `utils/log`) and
of their data files.  Its tracing (`utils/tracing`) is its own: spans on
torch.profiler's clock and per-call byte counters of the FAPI entries.
"""

__version__ = "0.1.0"
