// The PUSCH receiver's demap stage in one pass for NVIDIA Hopper (sm_90a):
// max-log soft demapping of the equalised symbols, division by their noise,
// the reference's int8 quantisation and the descrambling, from
// (eq, noise, signs) to int8 LLRs.
//
// It replaces no TPU kernel: the JAX package leaves this stage to XLA, and
// the port's plain torch version (ops/pusch_demap.demap_descramble_plain, which
// calls ops/demodulation.soft_demap) runs it as about 270 elementwise passes
// over the (rows, positions) tensor for 256QAM, each a kernel of its own in
// the receiver's CUDA graph.  Here each thread takes one position of one row
// and keeps everything between the loads and the stores in registers.
//
// Arithmetic, bit-exact with the plain version as PyTorch runs it on the
// card (every step rounds as torch's elementwise kernel does; built with
// -fmad=false, and each step written with an _rn intrinsic besides):
//   pi/2-BPSK: odd positions take (x1, -x0);
//   square QAM, per axis a (x = eq[a]) and PAM level p (float32, ascending):
//     metric = fl(p*p) - fl(fl(2 x) * p);
//   each bit's set minimum over the same dyadic blocks as
//   ops/demodulation.demap_min_plan: the pyramid of pairwise minima, then
//   the maximal aligned blocks that cover the set (min is exact, so only
//   the operands matter); a NaN propagates, as in torch.minimum;
//   BPSK: metric_k = fl(|c_k|^2) - 2 fl(fl(x0 c_k0) + fl(x1 c_k1));
//   llr = min(bit 1) - min(bit 0);
//   v = noise > 0 ? llr / max(noise, 1e-38f) : 0      (IEEE division)
//   q = clamp(v, -L, L) * fl(1/L) * 120, rounded half away from zero
//       (torch divides a tensor by a Python scalar as a multiply by the
//       scalar's float reciprocal, aten BinaryDivTrueKernel.cu);
//   out = clamp(q * sign, -127, 127) as int8.
// L is 24 for BPSK and QPSK, 20 for the QAM orders.
//
// Layouts: eq (rows, n, 2) float32, noise (rows, n) float32, signs int8 with
// position p's bit b at p * Qm + b of its row (a row stride of 0 shares one
// row of signs across the batch), out (rows, Qm, n) bit-major (the rate
// dematcher's order) or (rows, n * Qm) symbol-major (the UCI placement's).
//
// What bounds it on the card: bytes.  Per position it reads 8 + 4 + Qm bytes
// and writes Qm, at 3.35 TB/s at most.  The work per position (for 256QAM
// 32 metrics, the plain version's 72 minima, 8 IEEE divisions and
// quantisations) is a few hundred instructions, so at the cell's shape the
// instruction throughput, not the bytes, sets the kernel's time; every index
// into the pyramid is a template constant, so it lives in registers.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;  // 256QAM: 16 PAM levels per axis
constexpr int kLlrMax = 120;
constexpr int kLlrInf = 127;

// The constellation and quantisation constants of one modulation, built by
// ops/pusch_demap.kernel_tables.  Its layout is pusch_demap.TABLES_DTYPE: the
// assertions below fix every offset, and tests/test_torch_pusch_demap.py
// holds them against that dtype.
struct Tables {
  float level[kMaxLevels];     // square QAM: the PAM levels of one axis, ascending
  float level_sq[kMaxLevels];  // level * level in float32
  float point[2][2];           // BPSK: the point of bit value b, (re, im)
  float point_norm[2];         // |point|^2 in float32
  float limit;                 // the range limit L
  float inv_limit;             // 1 / L in float32
};
static_assert(offsetof(Tables, level) == 0, "TABLES_DTYPE");
static_assert(offsetof(Tables, level_sq) == 64, "TABLES_DTYPE");
static_assert(offsetof(Tables, point) == 128, "TABLES_DTYPE");
static_assert(offsetof(Tables, point_norm) == 144, "TABLES_DTYPE");
static_assert(offsetof(Tables, limit) == 152, "TABLES_DTYPE");
static_assert(offsetof(Tables, inv_limit) == 156, "TABLES_DTYPE");
static_assert(sizeof(Tables) == 160, "TABLES_DTYPE");

// Axis bit j (0: the sign bit) of the PAM level with ascending index i, K
// bits per axis, TS 38.211 5.1's Gray levels (1-2b0)(2^(K-1) - (1-2b1)(...)):
// in units where the levels are the odd integers, v0 is the level and
// v(t+1) = 2^(K-1-t) - |v(t)|; bit t is v(t) < 0.  The wrapper checks the
// constellation against this before every first launch of a modulation.
__host__ __device__ constexpr int pam_bit(int k, int j, int i) {
  int v = 2 * i - ((1 << k) - 1);
  for (int t = 0; t < j; ++t) v = (1 << (k - 1 - t)) - (v < 0 ? -v : v);
  return v < 0 ? 1 : 0;
}

// Every level of the aligned block (lev, blk) has bit j equal to val.
__host__ __device__ constexpr bool block_in(int k, int j, int val, int lev, int blk) {
  for (int i = blk << lev; i < (blk + 1) << lev; ++i) {
    if (pam_bit(k, j, i) != val) return false;
  }
  return true;
}

// The pyramid of one axis is one array of (2 << K) - 1 nodes, level by
// level: the 2^K metrics, then 2^(K-1) pairwise minima, ..., the root.
// Node n's level and block:
__host__ __device__ constexpr int node_level(int k, int n) {
  int lev = 0;
  while (n >= (1 << (k - lev))) n -= 1 << (k - lev++);
  return lev;
}
__host__ __device__ constexpr int node_block(int k, int n) {
  int lev = 0;
  while (n >= (1 << (k - lev))) n -= 1 << (k - lev++);
  return n;
}
// The index of node n's first child (the second follows it).
__host__ __device__ constexpr int first_child(int k, int n) {
  int start = 0;
  for (int l = 0; l < node_level(k, n) - 1; ++l) start += 1 << (k - l);
  return start + 2 * node_block(k, n);
}
// Node n is a block of (axis bit j, value val)'s dyadic cover: inside the
// set, its parent not (the maximal aligned blocks, which demap_min_plan's
// greedy cover of the set's runs also finds).
__host__ __device__ constexpr bool in_cover(int k, int j, int val, int n) {
  const int lev = node_level(k, n), blk = node_block(k, n);
  return block_in(k, j, val, lev, blk) && (lev == k || !block_in(k, j, val, lev + 1, blk >> 1));
}

__host__ __device__ constexpr int first_in_cover(int k, int j, int val) {
  int n = 0;
  while (!in_cover(k, j, val, n)) ++n;
  return n;
}

template <int K, int N>
constexpr int kFirstChild = first_child(K, N);
template <int K, int J, int V, int N>
constexpr bool kInCover = in_cover(K, J, V, N);
template <int K, int J, int V>
constexpr int kFirstInCover = first_in_cover(K, J, V);

// 16QAM's covers, as demap_min_plan gives them (nodes 0-3 the levels, 4-5
// the pairs): the sign bit one pair per value, the other bit levels {0, 3}
// against {1, 2}.
static_assert(kInCover<2, 0, 1, 4> && kInCover<2, 0, 0, 5> && !kInCover<2, 0, 1, 0>, "cover");
static_assert(kInCover<2, 1, 1, 0> && kInCover<2, 1, 1, 3> && kInCover<2, 1, 0, 1> &&
              !kInCover<2, 1, 1, 4>, "cover");
static_assert(kFirstChild<2, 4> == 0 && kFirstChild<2, 5> == 2 && kFirstChild<2, 6> == 4, "tree");

// torch.minimum on the card: NaN if either operand is NaN, else the smaller.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Every index below is a template constant, so the nodes stay in registers.
template <int K, int... I>
__device__ __forceinline__ void build_pyramid(float (&node)[(2 << K) - 1],
                                              std::integer_sequence<int, I...>) {
  ((node[(1 << K) + I] = nan_min(node[kFirstChild<K, (1 << K) + I>],
                                 node[kFirstChild<K, (1 << K) + I> + 1])), ...);
}

template <int K, int J, int V, int N>
__device__ __forceinline__ void cover_step(const float (&node)[(2 << K) - 1], float& acc) {
  if constexpr (kInCover<K, J, V, N> && N != kFirstInCover<K, J, V>) {
    acc = nan_min(acc, node[N]);
  }
}

// The minimum over the set of (axis bit J, value V): over its cover's nodes.
template <int K, int J, int V, int... N>
__device__ __forceinline__ float set_min(const float (&node)[(2 << K) - 1],
                                         std::integer_sequence<int, N...>) {
  float acc = node[kFirstInCover<K, J, V>];
  (cover_step<K, J, V, N>(node, acc), ...);
  return acc;
}

template <int K, int... J>
__device__ __forceinline__ void bit_llrs(const float (&node)[(2 << K) - 1], float (&llr)[K],
                                         std::integer_sequence<int, J...>) {
  using Nodes = std::make_integer_sequence<int, (2 << K) - 1>;
  ((llr[J] = __fsub_rn(set_min<K, J, 1>(node, Nodes{}), set_min<K, J, 0>(node, Nodes{}))), ...);
}

// The K bit metrics of one axis, x the equalised component.
template <int K>
__device__ __forceinline__ void axis_metrics(float x, const Tables& t, float (&llr)[K]) {
  float node[(2 << K) - 1];
  const float x2 = __fmul_rn(2.0f, x);
#pragma unroll
  for (int i = 0; i < (1 << K); ++i) node[i] = __fsub_rn(t.level_sq[i], __fmul_rn(x2, t.level[i]));
  build_pyramid<K>(node, std::make_integer_sequence<int, (1 << K) - 1>{});
  bit_llrs<K>(node, llr, std::make_integer_sequence<int, K>{});
}

// llr / noise, clipped, scaled to +/-120, rounded half away from zero, times
// the descrambling sign, saturated at +/-127.
__device__ __forceinline__ int8_t quantize(float llr, float noise, int sign, const Tables& t) {
  float v = 0.0f;
  if (noise > 0.0f) v = __fdiv_rn(llr, fmaxf(noise, 1e-38f));
  if (v == v) v = fminf(fmaxf(v, -t.limit), t.limit);
  const float s = __fmul_rn(__fmul_rn(v, t.inv_limit), static_cast<float>(kLlrMax));
  const float sgn = static_cast<float>((0.0f < s) - (s < 0.0f));
  const float r = __fmul_rn(sgn, floorf(__fadd_rn(fabsf(s), 0.5f)));
  const int q = static_cast<int>(static_cast<int8_t>(r)) * sign;
  return static_cast<int8_t>(q < -kLlrInf ? -kLlrInf : (q > kLlrInf ? kLlrInf : q));
}

template <int QM, bool kBitMajor, bool kPi2>
__global__ void __launch_bounds__(kThreads)
    pusch_demap_kernel(const float2* __restrict__ eq, const float* __restrict__ noise,
                       const int8_t* __restrict__ signs, int8_t* __restrict__ out, int n,
                       long long signs_row_stride, const Tables t) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const long long row = blockIdx.y;
  float2 x = eq[row * n + p];
  const float nv = noise[row * n + p];
  float llr[QM];
  if constexpr (QM == 1) {
    if (kPi2 && (p & 1)) x = make_float2(x.y, -x.x);
    float metric[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float dot = __fadd_rn(__fmul_rn(x.x, t.point[k][0]), __fmul_rn(x.y, t.point[k][1]));
      metric[k] = __fsub_rn(t.point_norm[k], __fmul_rn(2.0f, dot));
    }
    llr[0] = __fsub_rn(metric[1], metric[0]);  // the min of each one-point set
  } else {
    constexpr int K = QM / 2;
    float axis[2][K];
    axis_metrics<K>(x.x, t, axis[0]);
    axis_metrics<K>(x.y, t, axis[1]);
#pragma unroll
    for (int b = 0; b < QM; ++b) llr[b] = axis[b % 2][b / 2];
  }
  const int8_t* sg = signs + row * signs_row_stride + static_cast<long long>(p) * QM;
#pragma unroll
  for (int b = 0; b < QM; ++b) {
    const int8_t q = quantize(llr[b], nv, sg[b], t);
    if (kBitMajor) {
      out[(row * QM + b) * n + p] = q;
    } else {
      out[row * static_cast<long long>(n) * QM + static_cast<long long>(p) * QM + b] = q;
    }
  }
}

template <int QM, bool kBitMajor, bool kPi2>
int launch(const void* eq, const void* noise, const void* signs, void* out, int rows, int n,
           long long signs_row_stride, const Tables& t, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, rows);
  pusch_demap_kernel<QM, kBitMajor, kPi2><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(eq), static_cast<const float*>(noise),
      static_cast<const int8_t*>(signs), static_cast<int8_t*>(out), n, signs_row_stride, t);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBitMajor>
int dispatch(int qm, bool pi2, const void* eq, const void* noise, const void* signs, void* out,
             int rows, int n, long long signs_row_stride, const Tables& t, void* stream) {
  switch (qm) {
    case 1:
      return pi2 ? launch<1, kBitMajor, true>(eq, noise, signs, out, rows, n, signs_row_stride,
                                              t, stream)
                 : launch<1, kBitMajor, false>(eq, noise, signs, out, rows, n,
                                               signs_row_stride, t, stream);
    case 2:
      return launch<2, kBitMajor, false>(eq, noise, signs, out, rows, n, signs_row_stride, t,
                                         stream);
    case 4:
      return launch<4, kBitMajor, false>(eq, noise, signs, out, rows, n, signs_row_stride, t,
                                         stream);
    case 6:
      return launch<6, kBitMajor, false>(eq, noise, signs, out, rows, n, signs_row_stride, t,
                                         stream);
    case 8:
      return launch<8, kBitMajor, false>(eq, noise, signs, out, rows, n, signs_row_stride, t,
                                         stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One launch on `stream` for `rows` rows of `n` positions of a modulation of
// `qm` bits (pi2: pi/2-BPSK); bit_major picks the output layout.  Returns the
// CUDA error code of the launch (0 on success); never synchronises.
extern "C" int pusch_demap_launch(const void* eq, const void* noise, const void* signs,
                                  void* out, int rows, int n, int qm, int pi2, int bit_major,
                                  long long signs_row_stride, const void* tables, void* stream) {
  if (rows < 0 || n < 0 || rows > 65535 || (pi2 && qm != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || n == 0) return 0;
  Tables t;
  memcpy(&t, tables, sizeof(Tables));
  return bit_major ? dispatch<true>(qm, pi2, eq, noise, signs, out, rows, n, signs_row_stride,
                                    t, stream)
                   : dispatch<false>(qm, pi2, eq, noise, signs, out, rows, n, signs_row_stride,
                                     t, stream);
}
