// Spark Murmur3_x86_32 partition hash, folded left to right over the
// key columns of a batch.
//
// Replaces spark_rapids_tpu/kernels/murmur3.py murmur3_columns_kernel
// (the Pallas kernel over row blocks). Semantics follow
// spark_rapids_tpu/ops/hashing.py: seed 42, a null leaves the running
// hash unchanged, floats and doubles fold -0.0 to 0.0, decimals of
// precision <= 18 hash as long, strings hash whole little-endian 4-byte
// words and then each tail byte sign-extended from int8.
//
// Bound on the H100: bytes. Each row reads its key columns once (data,
// validity, and for strings the byte row and its length) and writes 4
// bytes; the arithmetic is a handful of integer ops per word, far below
// the card's integer rate. The design does one thread per row with
// native uint32 arithmetic, so neighbouring threads read neighbouring
// addresses of every fixed-width column; the column descriptors travel
// as a kernel argument, so a launch needs no device-side allocation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;

// kind: 0 int32, 1 int64, 2 float32, 3 float64, 4 bytes
struct ColDesc {
  long long kind;
  long long char_cap;
  const void* data;      // values, or the uint8[n, char_cap] byte matrix
  const bool* valid;
  const int* lengths;    // bytes only
};

struct Cols {
  ColDesc c[kMaxCols];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = rotl(k1, 15);
  return k1 * 0x1B873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t len) {
  h1 ^= len;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t hash_int(uint32_t v, uint32_t seed) {
  return fmix(mix_h1(seed, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t hash_long(uint64_t v, uint32_t seed) {
  uint32_t h1 = mix_h1(seed, mix_k1((uint32_t)(v & 0xFFFFFFFFull)));
  h1 = mix_h1(h1, mix_k1((uint32_t)(v >> 32)));
  return fmix(h1, 8u);
}

__global__ void murmur3_kernel(Cols cols, int n_cols, int n_rows,
                               uint32_t seed, int* out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    uint32_t h = seed;
    for (int ci = 0; ci < n_cols; ++ci) {
      const ColDesc& c = cols.c[ci];
      if (!c.valid[r]) continue;
      switch (c.kind) {
        case 0:
          h = hash_int((uint32_t)((const int*)c.data)[r], h);
          break;
        case 1:
          h = hash_long((uint64_t)((const long long*)c.data)[r], h);
          break;
        case 2: {
          uint32_t b = ((const uint32_t*)c.data)[r];
          if ((b << 1) == 0u) b = 0u;  // -0.0 hashes as 0.0
          h = hash_int(b, h);
          break;
        }
        case 3: {
          uint64_t b = ((const uint64_t*)c.data)[r];
          if ((b << 1) == 0ull) b = 0ull;
          h = hash_long(b, h);
          break;
        }
        default: {
          const unsigned char* row =
              (const unsigned char*)c.data + (size_t)r * c.char_cap;
          int len = c.lengths[r];
          int aligned = len - (len % 4);
          uint32_t h1 = h;
          for (int off = 0; off < aligned; off += 4) {
            uint32_t word = (uint32_t)row[off] |
                            ((uint32_t)row[off + 1] << 8) |
                            ((uint32_t)row[off + 2] << 16) |
                            ((uint32_t)row[off + 3] << 24);
            h1 = mix_h1(h1, mix_k1(word));
          }
          for (int off = aligned; off < len; ++off) {
            int sb = (int)(signed char)row[off];
            h1 = mix_h1(h1, mix_k1((uint32_t)sb));
          }
          h = fmix(h1, (uint32_t)len);
        }
      }
    }
    out[r] = (int)h;
  }
}

}  // namespace

// descs: n_cols x 5 int64 words laid out as ColDesc. Returns
// cudaGetLastError() after the launch.
extern "C" int murmur3_launch(const void* descs, int n_cols, int n_rows,
                              int seed, void* out, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols) return (int)cudaErrorInvalidValue;
  Cols cols;
  const ColDesc* d = (const ColDesc*)descs;
  for (int i = 0; i < n_cols; ++i) cols.c[i] = d[i];
  if (n_rows <= 0) return 0;
  int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  murmur3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cols, n_cols, n_rows, (uint32_t)seed, (int*)out);
  return (int)cudaGetLastError();
}
