// Layered scaled min-sum LDPC decoder for NVIDIA Hopper (sm_90a), in two
// modes of one kernel: early stop (per-codeblock CRC after each sweep) and
// fixed iterations.
//
// Early-stop mode replaces the Pallas TPU kernels
//   srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py: ldpc_decode_pallas_es_bm
//     (kernel _make_kernel_delta_es_bm), for z % 128 == 0,
//   srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py: _ldpc_decode_pallas_es_packed
//     (kernel _make_kernel_packed_es_bm), its packed-lane form for the other 48 z,
//   srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py: ldpc_decode_pallas_es
//     (kernel _make_kernel_delta_es), the same function on a transposed
//     (nv-2, B, z) layout.
// Fixed-iteration mode replaces
//   srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas.py: ldpc_decode_pallas (v1,
//     _make_kernel, roll-in/roll-back) and ldpc_decode_pallas_v3
//     (_make_kernel_delta, delta-roll),
//   srsran_projectvtlmo_tpu/ops/ldpc/decode_pallas_v2.py: ldpc_decode_pallas_v2
//     (layer fori_loop over scalar-prefetched tables).
// All six compute one function per mode; their variety came from TPU lane
// rotations that are correct only on whole 128-lane registers, the cost of
// int8 transposes and compile time.  Here a cyclic shift is an index offset
// (i + s) mod z into shared memory, so one kernel serves every BG1/BG2
// lifting size 2 <= z <= 384.
//
// Arithmetic, bit-exact with ops/ldpc/decode.py (the plain torch version) and
// with the JAX package:
//   v2c  = sat_sub(soft, c2v_old)            (clip +/-120, +/-127 dominates, a - a = 0)
//   min1/min2/argmin of |v2c| over the row, running minima start at 120,
//   strict < so the first edge wins ties; sign bit = v2c < 0
//   c2v  = +/- floor(min * sf + 0.5) in float32 (mul and add rounded separately:
//          no FMA contraction)
//   soft = promotion_sum(c2v, v2c)           (overflow promotes to +/-127)
// The second pass of a row recomputes v2c from the unchanged soft value and
// the previous c2v instead of keeping up to 19 values in an indexed local
// array; a row touches each of its columns once, so this is exact.
//
// Layout: one CTA per codeblock, one thread per check lane i < z (blockDim =
// z rounded up to a warp).  Shared memory holds, per codeblock,
//   soft bits   int8  [nv][z]   (values stay in [-127, 127]),
//   c2v state   u32   [m][z]    sign bits (0..18) | argmin (19..23) | scaled min1 (24..30),
//               u8    [m][z]    scaled min2;
// the sign product is the parity of the sign bits.  The state lives in the
// check domain and never rotates.  BG1 at z = 384 needs 114,432 bytes in
// both modes, so two CTAs fit on one SM.  Codeblocks are independent CTAs,
// so the batch needs no padding rows (the JAX wrappers pad to their tile
// with +127 rows in early-stop mode and 0 rows in fixed mode).
//
// Early stop: after each full sweep every thread XORs the packed zero-basis
// CRC row of each of its systematic bits with hard decision soft <= 0 (the
// mask is zero past the kp payload bits, so filler is excluded), the block
// XOR-reduces, and the codeblock stops when the result is 0.  `iterations` is
// the 1-based sweep count; a codeblock that never passes reports
// max_iterations and crc_ok = 0.  The JAX kernels run a tile of codeblocks to
// the tile's last convergence and snapshot each codeblock when it first
// passes; stopping a codeblock at that sweep gives the same soft bits, so one
// CTA per codeblock is bit-exact with those tile-wide snapshot semantics.
//
// Fixed iterations: no CRC work; exactly max_iterations sweeps, then the
// outputs.  A codeblock that converges early keeps sweeping, and its soft
// values keep growing, so the two modes differ exactly on such codeblocks.
//
// What bounds it on the card: the rows run in sequence with a block barrier
// between them (46 per BG1 sweep) and each edge costs a few dependent integer
// ALU operations on shared memory.  Device-memory traffic is the int8 input
// and outputs once per codeblock, far below HBM bandwidth.  The design keeps
// every iteration's state in shared memory, so no row touches device memory,
// and sizes that state so two CTAs share an SM and one hides the other's
// barrier waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLlrMax = 120;
constexpr int kLlrInf = 127;

__device__ __forceinline__ int sat_sub(int a, int b) {
  if (a == b) return 0;
  if (abs(a) == kLlrInf) return a;
  if (abs(b) == kLlrInf) return -b;
  return min(max(a - b, -kLlrMax), kLlrMax);
}

__device__ __forceinline__ int promotion_sum(int a, int b) {
  if (a == -b) return 0;
  if (abs(a) == kLlrInf) return a;
  if (abs(b) == kLlrInf) return b;
  const int s = a + b;
  if (s > kLlrMax) return kLlrInf;
  if (s < -kLlrMax) return -kLlrInf;
  return s;
}

__device__ __forceinline__ int scale_mag(int mag, float sf) {
  return static_cast<int>(floorf(__fadd_rn(__fmul_rn(static_cast<float>(mag), sf), 0.5f)));
}

// Edge e of a row: column in the low 16 bits, shift in the high 16.
__device__ __forceinline__ int soft_index(int edge, int lane, int z) {
  int j = lane + (edge >> 16);
  if (j >= z) j -= z;
  return (edge & 0xFFFF) * z + j;
}

// kEarlyStop selects the mode; crc_mask, crc_ok and iterations are read and
// written only in early-stop mode (null in fixed mode).
template <bool kEarlyStop>
__global__ void ldpc_decode_kernel(
    const int8_t* __restrict__ llr, const int* __restrict__ row_ptr,
    const int* __restrict__ edges, const int* __restrict__ crc_mask,
    uint8_t* __restrict__ hard, int8_t* __restrict__ soft_out,
    uint8_t* __restrict__ crc_ok, int* __restrict__ iterations,
    int z, int nv, int m, int kb, int max_iterations, float sf) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* state = reinterpret_cast<uint32_t*>(smem);
  uint8_t* min2s = smem + 4 * m * z;
  int8_t* soft = reinterpret_cast<int8_t*>(min2s + m * z);
  __shared__ int warp_acc[32];
  __shared__ int block_ok;

  const int cb = blockIdx.x;
  const int lane = threadIdx.x;
  const bool active = lane < z;
  const int8_t* x = llr + static_cast<size_t>(cb) * (nv - 2) * z;

  for (int k = lane; k < nv * z; k += blockDim.x) soft[k] = k < 2 * z ? 0 : x[k - 2 * z];
  for (int k = lane; k < m * z; k += blockDim.x) {
    state[k] = 0;  // c2v = 0 before the first sweep
    min2s[k] = 0;
  }
  __syncthreads();

  int used = max_iterations;
  int ok = 0;
  for (int it = 0; it < max_iterations; ++it) {
    for (int r = 0; r < m; ++r) {
      if (active) {
        const int e0 = row_ptr[r];
        const int deg = row_ptr[r + 1] - e0;
        const uint32_t old = state[r * z + lane];
        const int old_sb = old & 0x7FFFF;
        const int old_am = (old >> 19) & 0x1F;
        const int old_m1 = old >> 24;
        const int old_m2 = min2s[r * z + lane];
        const int old_sp = __popc(old_sb) & 1;

        int m1 = kLlrMax, m2 = kLlrMax, am = 0, sb = 0;
        for (int e = 0; e < deg; ++e) {
          const int v = soft[soft_index(edges[e0 + e], lane, z)];
          const int mag = e == old_am ? old_m2 : old_m1;
          const int v2c = sat_sub(v, ((old_sp ^ (old_sb >> e)) & 1) ? -mag : mag);
          const int a = abs(v2c);
          if (a < m1) {
            m2 = m1;
            am = e;
            m1 = a;
          } else {
            m2 = min(m2, a);
          }
          sb |= (v2c < 0) << e;
        }
        const int s1 = scale_mag(m1, sf);
        const int s2 = scale_mag(m2, sf);
        const int sp = __popc(sb) & 1;

        for (int e = 0; e < deg; ++e) {
          const int idx = soft_index(edges[e0 + e], lane, z);
          const int mag = e == old_am ? old_m2 : old_m1;
          const int v2c = sat_sub(soft[idx], ((old_sp ^ (old_sb >> e)) & 1) ? -mag : mag);
          const int new_mag = e == am ? s2 : s1;
          const int c2v = ((sp ^ (sb >> e)) & 1) ? -new_mag : new_mag;
          soft[idx] = static_cast<int8_t>(promotion_sum(c2v, v2c));
        }
        state[r * z + lane] = static_cast<uint32_t>(sb) | (static_cast<uint32_t>(am) << 19) |
                              (static_cast<uint32_t>(s1) << 24);
        min2s[r * z + lane] = static_cast<uint8_t>(s2);
      }
      __syncthreads();
    }

    if constexpr (kEarlyStop) {
      int acc = 0;
      if (active) {
        for (int c = 0; c < kb; ++c) {
          if (soft[c * z + lane] <= 0) acc ^= crc_mask[c * z + lane];
        }
      }
      for (int off = 16; off > 0; off >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
      if ((lane & 31) == 0) warp_acc[lane >> 5] = acc;
      __syncthreads();
      if (lane == 0) {
        int t = 0;
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t ^= warp_acc[w];
        block_ok = t == 0;
      }
      __syncthreads();
      if (block_ok) {
        ok = 1;
        used = it + 1;
        break;
      }
    }
  }

  const size_t base = static_cast<size_t>(cb) * kb * z;
  for (int k = lane; k < kb * z; k += blockDim.x) {
    const int v = min(max(static_cast<int>(soft[k]), -kLlrInf), kLlrInf);
    soft_out[base + k] = static_cast<int8_t>(v);
    hard[base + k] = v <= 0;
  }
  if constexpr (kEarlyStop) {
    if (lane == 0) {
      crc_ok[cb] = static_cast<uint8_t>(ok);
      iterations[cb] = used;
    }
  }
}

// Shared memory bytes one codeblock needs: 4 + 1 bytes of c2v state per
// (row, lane) and one soft byte per (column, lane).
size_t smem_bytes(int z, int nv, int m) { return static_cast<size_t>(z) * (5 * m + nv); }

// One CTA per codeblock on `stream`.  Returns the CUDA error code of the
// attribute call or the launch (0 on success); never synchronises.
template <bool kEarlyStop>
int launch(const void* llr, const void* row_ptr, const void* edges, const void* crc_mask,
           void* hard, void* soft_out, void* crc_ok, void* iterations,
           int batch, int z, int nv, int m, int kb, int max_iterations, float sf,
           void* stream) {
  const size_t smem = smem_bytes(z, nv, m);
  cudaError_t err = cudaFuncSetAttribute(ldpc_decode_kernel<kEarlyStop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const int threads = ((z + 31) / 32) * 32;
  ldpc_decode_kernel<kEarlyStop><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(llr), static_cast<const int*>(row_ptr),
      static_cast<const int*>(edges), static_cast<const int*>(crc_mask),
      static_cast<uint8_t*>(hard), static_cast<int8_t*>(soft_out),
      static_cast<uint8_t*>(crc_ok), static_cast<int*>(iterations),
      z, nv, m, kb, max_iterations, sf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Early-stop mode: hard, soft, crc_ok and iterations per codeblock.
extern "C" int ldpc_decode_es_launch(
    const void* llr, const void* row_ptr, const void* edges, const void* crc_mask,
    void* hard, void* soft_out, void* crc_ok, void* iterations,
    int batch, int z, int nv, int m, int kb, int max_iterations, float sf, void* stream) {
  return launch<true>(llr, row_ptr, edges, crc_mask, hard, soft_out, crc_ok, iterations,
                      batch, z, nv, m, kb, max_iterations, sf, stream);
}

// Fixed-iteration mode: exactly nof_iterations sweeps, then hard and soft.
extern "C" int ldpc_decode_launch(
    const void* llr, const void* row_ptr, const void* edges, void* hard, void* soft_out,
    int batch, int z, int nv, int m, int kb, int nof_iterations, float sf, void* stream) {
  return launch<false>(llr, row_ptr, edges, nullptr, hard, soft_out, nullptr, nullptr,
                       batch, z, nv, m, kb, nof_iterations, sf, stream);
}
