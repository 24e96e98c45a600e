"""Codeblock-axis sharding: one transport block's LDPC work split across
cards (port of `srsran_projectvtlmo_tpu.parallel.cb_shard`).

The north-star scaling config shards codeblocks over the intra-cell axis
(SURVEY Section 2.4 item 1: the reference forks CB batches onto thread
pools, pusch_decoder_impl.cpp:309-385).  Each rank decodes its contiguous
block of codeblock rows with `ops/ldpc/decode_cuda` -- the CUDA kernel on a
card tensor, the plain decoder on a CPU tensor -- with no traffic during
decoding, then one all_gather per output.  The JAX `use_pallas` flag of the
fixed-iteration builder has no counterpart: the tensor's device picks the
decoder.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.ldpc.decode_cuda import ldpc_decode, ldpc_decode_es
from ..ran.ldpc_params import BaseGraph
from .mesh import gather_tree, shard_leading


def build_sharded_ldpc_decode(mesh: DeviceMesh | None, bg: BaseGraph, z: int,
                              nof_iterations: int = 6, *, axis: str = "cb"):
    """fn(llrs (B, N) int8) -> (hard (B, K) uint8, soft (B, K) int8): fixed
    iterations; B divisible by the axis size."""
    def decode(llrs: torch.Tensor):
        local = shard_leading(llrs, mesh, axis).contiguous()
        return gather_tree(ldpc_decode(local, bg, z, nof_iterations=nof_iterations), mesh, axis)

    return decode


def build_sharded_ldpc_decode_es(mesh: DeviceMesh | None, bg: BaseGraph, z: int,
                                 crc_name: str, nof_crc_covered_bits: int,
                                 max_iterations: int = 6, *, axis: str = "cb"):
    """The production CB-axis decode: CRC-gated early stop on each rank's
    block.  fn(llrs (B, N) int8) -> (hard (B, K), soft (B, K), crc_ok (B,),
    iterations (B,)); B divisible by the axis size."""
    def decode(llrs: torch.Tensor):
        local = shard_leading(llrs, mesh, axis).contiguous()
        out = ldpc_decode_es(local, bg, z, crc_name, nof_crc_covered_bits,
                             nof_iterations=max_iterations)
        return gather_tree(out, mesh, axis)

    return decode
