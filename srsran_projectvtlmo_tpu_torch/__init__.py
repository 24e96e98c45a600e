"""srsran_projectvtlmo_tpu_torch: the 5G NR upper PHY on PyTorch and CUDA.

A port of `srsran_projectvtlmo_tpu` (JAX) to PyTorch, with the Pallas TPU
kernels rewritten by hand for NVIDIA Hopper (`csrc/`).  The JAX package stays
the reference; every public function here keeps its array conventions so the
parity tests are plain array comparisons:

  * complex values as real pairs `(..., 2)` in float32 or bfloat16;
  * LLRs as int8 in [-120, 120], with +/-127 as the fixed-bit value;
  * bits as uint8.

Layout (mirrors the JAX package):
  ran/           LDPC parameters, modulation schemes, SCH segmentation (host)
  utils/         int8 LLR semantics, complex pairs
  ops/           CRC, PRG, DM-RS, OFDM, estimation, equalization, demapping, EVM
  ops/ldpc/      graphs, rate matching, the encoder, the plain decoder and its
                 CUDA kernel
  models/        SCH configuration, the UL-SCH transmitter, the PUSCH receive slot
  csrc/          CUDA C++ sources, built with nvcc at first use
  data/          base graphs and the north-star test fixture

This package imports torch and never jax, and nothing of the JAX package:
it keeps its own copies of the host modules it needs (`ran/*`, `ops/prg`,
`ops/dmrs`, `ops/ulsch_demux`) and of the base-graph data.
"""

__version__ = "0.1.0"
