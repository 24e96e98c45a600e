"""srsran_projectvtlmo_tpu_torch: the 5G NR upper PHY on PyTorch and CUDA.

A port of `srsran_projectvtlmo_tpu` (JAX) to PyTorch, with the Pallas TPU
kernels rewritten by hand for NVIDIA Hopper (`csrc/`).  The JAX package stays
the reference; every public function here keeps its array conventions so the
parity tests are plain array comparisons:

  * complex values as real pairs `(..., 2)` in float32 or bfloat16;
  * LLRs as int8 in [-120, 120], with +/-127 as the fixed-bit value;
  * bits as uint8.

Layout (mirrors the JAX package):
  utils/         int8 LLR semantics, complex pairs
  ops/           CRC, OFDM, estimation, equalization, demapping, EVM
  ops/ldpc/      graphs, rate recovery, the plain decoder and its CUDA kernel
  models/        SCH configuration and the PUSCH receive slot
  csrc/          CUDA C++ sources, built with nvcc at first use

This package imports torch and never jax.  It reuses the JAX package's
jax-free host modules (`ran/*`, `ops/prg`, `ops/dmrs`, `ops/ulsch_demux`)
and reads its data files by path.
"""

__version__ = "0.1.0"
