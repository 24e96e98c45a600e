// Native host-side helpers of srsran_projectvtlmo_tpu_torch (a copy of the
// JAX package's native/host_kernels.cpp, held equal to it below this comment
// by tests/test_torch_host_tools.py).
//
// The reference implements its host hot paths in C++ (bit packing in
// srsvec, CRC tables, lock-free SPSC sample queues); the port keeps the
// device math in torch ops and CUDA kernels and uses this small library for
// the host runtime: bit packing, table CRC, an SPSC float ring buffer for IQ
// streaming, and raw IQ file IO. Exposed with a plain C ABI for ctypes and
// built by native.py with the host C++ compiler.
//
// reference: lib/srsvec/bit.cpp (packing), lib/phy/upper/channel_coding/
// crc_calculator_lut_impl.cpp (table CRC), external/rigtorp SPSCQueue
// (sample queues), include/srsran/support/file_vector.h (binary IQ format).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- bits ----

// Pack bits (one per byte, 0/1) into uint32 words, LSB first.
void pack_bits_u32(const uint8_t* bits, uint32_t* words, int64_t nof_bits) {
  int64_t nof_words = (nof_bits + 31) / 32;
  for (int64_t w = 0; w < nof_words; ++w) {
    uint32_t acc = 0;
    int64_t base = w * 32;
    int64_t end = nof_bits - base < 32 ? nof_bits - base : 32;
    for (int64_t i = 0; i < end; ++i) {
      acc |= static_cast<uint32_t>(bits[base + i] & 1) << i;
    }
    words[w] = acc;
  }
}

void unpack_bits_u32(const uint32_t* words, uint8_t* bits, int64_t nof_bits) {
  for (int64_t n = 0; n < nof_bits; ++n) {
    bits[n] = (words[n / 32] >> (n % 32)) & 1;
  }
}

// ----------------------------------------------------------------- crc -----

// Long-division CRC over unpacked MSB-first bits.
// `poly` includes the leading term's low bits (e.g. 0x864CFB for CRC24A),
// `order` in {6, 11, 16, 24}. Equivalent to the zero-augmented remainder.
uint32_t crc_bits(const uint8_t* bits, int64_t nof_bits, uint32_t poly, int order) {
  uint32_t mask = (1u << order) - 1;
  uint32_t top = 1u << (order - 1);
  uint32_t rem = 0;
  for (int64_t n = 0; n < nof_bits; ++n) {
    uint32_t fb = ((rem & top) ? 1u : 0u) ^ (bits[n] & 1u);
    rem = (rem << 1) & mask;
    if (fb) {
      rem ^= poly & mask;
    }
  }
  return rem;
}

// --------------------------------------------------------- SPSC ring -------

struct SpscRing {
  std::vector<float> data;
  int64_t capacity;  // in float pairs (samples)
  std::atomic<int64_t> head{0};
  std::atomic<int64_t> tail{0};
};

void* spsc_create(int64_t capacity_samples) {
  auto* r = new SpscRing();
  r->capacity = capacity_samples;
  r->data.resize(static_cast<size_t>(capacity_samples) * 2);
  return r;
}

void spsc_destroy(void* ring) { delete static_cast<SpscRing*>(ring); }

// Returns samples actually written.
int64_t spsc_write(void* ring, const float* iq, int64_t nof_samples) {
  auto* r = static_cast<SpscRing*>(ring);
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  int64_t free_samples = r->capacity - (head - tail) - 1;
  int64_t n = nof_samples < free_samples ? nof_samples : free_samples;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = ((head + i) % r->capacity) * 2;
    r->data[idx] = iq[i * 2];
    r->data[idx + 1] = iq[i * 2 + 1];
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Returns samples actually read; missing samples are zero-filled.
int64_t spsc_read(void* ring, float* iq, int64_t nof_samples) {
  auto* r = static_cast<SpscRing*>(ring);
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t avail = head - tail;
  int64_t n = nof_samples < avail ? nof_samples : avail;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = ((tail + i) % r->capacity) * 2;
    iq[i * 2] = r->data[idx];
    iq[i * 2 + 1] = r->data[idx + 1];
  }
  for (int64_t i = n; i < nof_samples; ++i) {
    iq[i * 2] = 0.0f;
    iq[i * 2 + 1] = 0.0f;
  }
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ------------------------------------------------------------ IQ files -----

int64_t iq_file_write(const char* path, const float* iq, int64_t nof_samples) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int64_t written = static_cast<int64_t>(std::fwrite(iq, sizeof(float) * 2, nof_samples, f));
  std::fclose(f);
  return written;
}

int64_t iq_file_read(const char* path, float* iq, int64_t max_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int64_t read = static_cast<int64_t>(std::fread(iq, sizeof(float) * 2, max_samples, f));
  std::fclose(f);
  return read;
}

}  // extern "C"
