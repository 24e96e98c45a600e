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
// with the JAX package, for scaling factors in (0, 1]:
//   v2c  = sat_sub(soft, c2v_old)            (clip +/-120, +/-127 dominates, a - a = 0)
//   min1/min2/argmin of |v2c| over the row, running minima start at 120,
//   strict < so the first edge wins ties; sign bit = v2c < 0
//   c2v  = +/- lut[min], lut[m] = floor(m * sf + 0.5) in float32, built on
//          the host by numpy (decode.scale_table), so it rounds as the plain
//          decoder does
//   soft = promotion_sum(c2v, v2c)           (overflow promotes to +/-127)
// With sf <= 1 every c2v lies in [-120, 120], never +/-127.  Shared memory
// then holds +/-127 as +/-121, v2c carries it as a magnitude of 242 or more,
// and both saturating rules become clamps with no test for the fixed-bit
// value (see decode_row).  tests/test_torch_ldpc_plan.py holds these forms
// against the general ones over every input they can see, and a numpy mirror
// of this kernel's row schedule against the plain decoder.
//
// Layout: one CTA per codeblock, one thread per check lane i < z (blockDim =
// z rounded up to a warp).  Shared memory holds, per codeblock,
//   c2v state   u32   [m][z]    sign bits (0..18) | argmin (19..23) | scaled min1 (24..31),
//               u8    [m][z]    scaled min2,
//   soft bits   int8  [nv][z]   (values in [-121, 121]);
// the sign product is the parity of the sign bits.  The state lives in the
// check domain and never rotates.  BG1 at z = 384 needs 114,432 bytes, so two
// CTAs fit on one SM.  Codeblocks are independent CTAs, so the batch needs no
// padding rows (the JAX wrappers pad to their tile with +127 rows in
// early-stop mode and 0 rows in fixed mode).
//
// The graph comes as a kernel parameter (`Plan`, built by
// ops/ldpc/decode_cuda.kernel_plan): CSR row pointers, one (shift, col * z)
// pair per edge, the row groups and the scale table.  Parameters sit in the
// constant bank, so the edge loop reads the graph with uniform constant
// loads and never touches device memory; the rotated index is
// col * z + umin(i + shift, i + shift - z), two instructions.  Each row runs
// a copy of the row update compiled for its degree (3..10 or 19: every
// BG1/BG2 row), so the edge loops are fully unrolled with no guards: a row's
// soft loads issue together, and its v2c values and indices stay in
// registers between the min pass and the update pass.
//
// Row groups: consecutive rows that share no column touch disjoint soft bits,
// so they run between the same pair of block barriers with the same bits out
// (the wrapper computes the groups: 32 barriers per BG1 sweep instead of 46,
// 28 for BG2 instead of 42).
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
// What bounds it on the card: integer issue.  About ten operations per edge
// and check lane per sweep are essential (PERF.md counts them); this scalar
// int32 form issues about 32 (the rotated index, the c2v sign and magnitude
// selects, the clamps, the min/argmin chain, the sign bits) plus a per-row
// share, and with two codeblocks per SM (shared memory allows no more at
// z = 384) that keeps Hopper's 16-lane integer pipes nearly saturated.
// Device-memory traffic is the int8 input and outputs once per codeblock,
// far below HBM bandwidth.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kLlrMax = 120;
constexpr int kLlrInf = 127;
constexpr int kSoftInf = 121;  // +/-127 as held in shared memory
constexpr int kMaxRows = 46;      // BG1
constexpr int kMaxEdges = 316;    // BG1
constexpr int kMaxThreads = 384;  // largest lifting size
constexpr uint32_t kSignMask = (1u << 19) - 1;

// The kernel's view of one (base graph, z, scaling factor), built by
// decode_cuda.kernel_plan.  Its layout is decode_cuda.PLAN_DTYPE: the
// assertions below fix every offset, and tests/test_torch_ldpc_plan.py holds
// them (and kMaxRows, kMaxEdges) against that dtype.
struct Plan {
  int z, nv, m, kb, ngroups;
  int group_end[kMaxRows];    // exclusive last row of group g
  int row_ptr[kMaxRows + 1];  // row r's edges: edge[row_ptr[r]:row_ptr[r+1]]
  int2 edge[kMaxEdges];       // {shift, column * z}; 8-byte aligned, one 64-bit load
  int8_t lut[128];            // floor(m * sf + 0.5), m = 0..127
};
static_assert(offsetof(Plan, z) == 0, "PLAN_DTYPE");
static_assert(offsetof(Plan, nv) == 4, "PLAN_DTYPE");
static_assert(offsetof(Plan, m) == 8, "PLAN_DTYPE");
static_assert(offsetof(Plan, kb) == 12, "PLAN_DTYPE");
static_assert(offsetof(Plan, ngroups) == 16, "PLAN_DTYPE");
static_assert(offsetof(Plan, group_end) == 20, "PLAN_DTYPE");
static_assert(offsetof(Plan, row_ptr) == 204, "PLAN_DTYPE");
static_assert(offsetof(Plan, edge) == 392, "PLAN_DTYPE");
static_assert(offsetof(Plan, lut) == 2920, "PLAN_DTYPE");
static_assert(sizeof(Plan) == 3048, "PLAN_DTYPE");

// Soft values in shared memory: [-120, 120], and +/-121 for the fixed-bit
// value +/-127, so the promotion sum is one clamp to [-121, 121].  An input
// LLR is read only once, by the first row that touches its column, through
// clamp(a - 0): loading it as clamp(a, -120, 120) (+/-127 as +/-121) gives
// the same bits.
__device__ __forceinline__ uint32_t encode_soft4(uint32_t w) {
  uint32_t out = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int a = static_cast<int8_t>(w >> (8 * b));
    const int e = a == kLlrInf ? kSoftInf
                               : (a == -kLlrInf ? -kSoftInf : min(max(a, -kLlrMax), kLlrMax));
    out |= static_cast<uint32_t>(e & 0xFF) << (8 * b);
  }
  return out;
}

__device__ __forceinline__ int decode_soft(int a) {
  return a == kSoftInf ? kLlrInf : (a == -kSoftInf ? -kLlrInf : a);
}

// One layered update of row r, of degree D, at check lane `lane`.  v2c holds
// an infinite soft value as +/-(242..362): |v| >= 120 never becomes a minimum,
// and v + c2v clamps back to +/-121 since |c2v| <= 120, so no later step
// tests for it.
template <int D>
__device__ __forceinline__ void decode_row(const Plan& plan, int r, int lane, int z,
                                           uint32_t* __restrict__ state,
                                           uint8_t* __restrict__ min2s,
                                           int8_t* __restrict__ soft,
                                           const int8_t* __restrict__ lut) {
  const int e0 = plan.row_ptr[r];
  const int si = r * z + lane;
  int idx[D];
  int v2c[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const int2 ed = plan.edge[e0 + e];
    const unsigned j = static_cast<unsigned>(lane + ed.x);
    idx[e] = ed.y + static_cast<int>(min(j, j - static_cast<unsigned>(z)));  // (lane + shift) mod z
    v2c[e] = soft[idx[e]];
  }

  const uint32_t old = state[si];
  const int old_s1 = static_cast<int>(old >> 24);
  const int old_s2 = min2s[si];
  const int old_am = static_cast<int>((old >> 19) & 0x1F);
  // Bit e set: the previous c2v of edge e is negative.
  const uint32_t old_neg = old ^ ((__popc(old & kSignMask) & 1) ? kSignMask : 0u);

  int m1 = kLlrMax, m2 = kLlrMax, am = 0;
  uint32_t sb = 0;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const int a = v2c[e];
    const int mag = e == old_am ? old_s2 : old_s1;
    const int c = ((old_neg >> e) & 1u) ? -mag : mag;
    const int b = min(max(a, -kLlrMax), kLlrMax);  // a - b = +/-1 for +/-121
    const int v = min(max(b - c, -kLlrMax), kLlrMax) + 2 * kSoftInf * (a - b);
    v2c[e] = v;
    const int av = abs(v);
    if (av < m1) am = e;
    m2 = min(m2, max(av, m1));
    m1 = min(m1, av);
    sb |= (static_cast<uint32_t>(v) >> 31) << e;
  }

  const int s1 = lut[m1];
  const int s2 = lut[m2];
  const uint32_t neg = sb ^ ((__popc(sb) & 1) ? kSignMask : 0u);
#pragma unroll
  for (int e = 0; e < D; ++e) {
    const int mag = e == am ? s2 : s1;
    const int s = v2c[e] + (((neg >> e) & 1u) ? -mag : mag);
    soft[idx[e]] = static_cast<int8_t>(min(max(s, -kSoftInf), kSoftInf));
  }
  state[si] = sb | (static_cast<uint32_t>(am) << 19) | (static_cast<uint32_t>(s1) << 24);
  min2s[si] = static_cast<uint8_t>(s2);
}

// Row r with its degree as a compile-time constant: every BG1/BG2 row has
// degree 3..10 or 19 (the wrapper checks), and the branch is uniform.
__device__ __forceinline__ void decode_row_any(const Plan& plan, int r, int lane, int z,
                                               uint32_t* state, uint8_t* min2s, int8_t* soft,
                                               const int8_t* lut) {
  switch (plan.row_ptr[r + 1] - plan.row_ptr[r]) {
    case 3: decode_row<3>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 4: decode_row<4>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 5: decode_row<5>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 6: decode_row<6>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 7: decode_row<7>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 8: decode_row<8>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 9: decode_row<9>(plan, r, lane, z, state, min2s, soft, lut); break;
    case 10: decode_row<10>(plan, r, lane, z, state, min2s, soft, lut); break;
    default: decode_row<19>(plan, r, lane, z, state, min2s, soft, lut); break;
  }
}

// kEarlyStop selects the mode; crc_mask, crc_ok and iterations are read and
// written only in early-stop mode (null in fixed mode).
template <bool kEarlyStop>
__global__ void __launch_bounds__(kMaxThreads, 2) ldpc_decode_kernel(
    const int8_t* __restrict__ llr, const int* __restrict__ crc_mask,
    uint8_t* __restrict__ hard, int8_t* __restrict__ soft_out,
    uint8_t* __restrict__ crc_ok, int* __restrict__ iterations, int max_iterations,
    const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int8_t lut[128];
  __shared__ int warp_acc[kMaxThreads / 32];
  __shared__ int block_ok;

  const int z = plan.z, nv = plan.nv, m = plan.m, kb = plan.kb;
  uint32_t* state = reinterpret_cast<uint32_t*>(smem);
  uint8_t* min2s = smem + 4 * m * z;
  int8_t* soft = reinterpret_cast<int8_t*>(min2s + m * z);

  const int cb = blockIdx.x;
  const int lane = threadIdx.x;
  const bool active = lane < z;
  const int n_in = (nv - 2) * z;
  const int8_t* x = llr + static_cast<size_t>(cb) * n_in;
  // 16-byte copies where the sizes allow (BG1/BG2 at even z of 8 and up); at
  // BG1 z=384 the byte loops alone take 6-9% longer (PERF.md section 6).
  const bool wide = ((reinterpret_cast<uintptr_t>(x) | (5 * m * z) | (2 * z) | n_in) & 15) == 0;

  // c2v = 0 before the first sweep: zero the state words (the last word may
  // run into the first soft bytes, which are punctured columns and 0 too).
  const int state_words = (5 * m * z + 3) / 4;
  for (int k = lane; k < state_words; k += blockDim.x) state[k] = 0;
  for (int k = lane; k < 2 * z; k += blockDim.x) soft[k] = 0;
  if (wide) {
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(soft + 2 * z);
    for (int k = lane; k < n_in / 16; k += blockDim.x) {
      const uint4 w = src[k];
      dst[k] = make_uint4(encode_soft4(w.x), encode_soft4(w.y), encode_soft4(w.z),
                          encode_soft4(w.w));
    }
  } else {
    for (int k = lane; k < n_in; k += blockDim.x) {
      soft[2 * z + k] = static_cast<int8_t>(encode_soft4(static_cast<uint8_t>(x[k])));
    }
  }
  for (int k = lane; k < 128; k += blockDim.x) lut[k] = plan.lut[k];
  __syncthreads();

  int used = max_iterations;
  int ok = 0;
  for (int it = 0; it < max_iterations; ++it) {
    for (int g = 0; g < plan.ngroups; ++g) {
      if (active) {
        const int end = plan.group_end[g];
        for (int r = g ? plan.group_end[g - 1] : 0; r < end; ++r) {
          decode_row_any(plan, r, lane, z, state, min2s, soft, lut);
        }
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
  if (wide) {  // 4 soft values per word
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(soft);
    for (int k = lane; k < kb * z / 4; k += blockDim.x) {
      const uint32_t w = s4[k];
      uint32_t out = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out |= static_cast<uint32_t>(decode_soft(static_cast<int8_t>(w >> (8 * b))) & 0xFF)
               << (8 * b);
      }
      reinterpret_cast<uint32_t*>(soft_out + base)[k] = out;
      reinterpret_cast<uint32_t*>(hard + base)[k] = __vcmples4(w, 0u) & 0x01010101u;
    }
  } else {
    for (int k = lane; k < kb * z; k += blockDim.x) {
      const int v = soft[k];
      soft_out[base + k] = static_cast<int8_t>(decode_soft(v));
      hard[base + k] = v <= 0;
    }
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
int launch(const void* llr, const void* crc_mask, void* hard, void* soft_out, void* crc_ok,
           void* iterations, int batch, int max_iterations, const void* plan_words,
           void* stream) {
  Plan plan;
  memcpy(&plan, plan_words, sizeof(Plan));
  if (plan.z < 2 || plan.z > kMaxThreads || plan.m > kMaxRows || plan.ngroups > kMaxRows ||
      plan.row_ptr[plan.m] > kMaxEdges) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int r = 0; r < plan.m; ++r) {
    const int d = plan.row_ptr[r + 1] - plan.row_ptr[r];
    if (d != 19 && (d < 3 || d > 10)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(plan.z, plan.nv, plan.m);
  cudaError_t err = cudaFuncSetAttribute(ldpc_decode_kernel<kEarlyStop>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const int threads = ((plan.z + 31) / 32) * 32;
  ldpc_decode_kernel<kEarlyStop><<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(llr), static_cast<const int*>(crc_mask),
      static_cast<uint8_t*>(hard), static_cast<int8_t*>(soft_out),
      static_cast<uint8_t*>(crc_ok), static_cast<int*>(iterations), max_iterations, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Early-stop mode: hard, soft, crc_ok and iterations per codeblock.
extern "C" int ldpc_decode_es_launch(const void* llr, const void* crc_mask, void* hard,
                                     void* soft_out, void* crc_ok, void* iterations, int batch,
                                     int max_iterations, const void* plan, void* stream) {
  return launch<true>(llr, crc_mask, hard, soft_out, crc_ok, iterations, batch, max_iterations,
                      plan, stream);
}

// Fixed-iteration mode: exactly nof_iterations sweeps, then hard and soft.
extern "C" int ldpc_decode_launch(const void* llr, void* hard, void* soft_out, int batch,
                                  int nof_iterations, const void* plan, void* stream) {
  return launch<false>(llr, nullptr, hard, soft_out, nullptr, nullptr, batch, nof_iterations,
                       plan, stream);
}
