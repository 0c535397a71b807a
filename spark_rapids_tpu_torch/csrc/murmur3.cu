// Spark Murmur3_x86_32 partition hash, folded left to right over the
// key columns of a batch, with the partition id in the same launch.
//
// Replaces spark_rapids_tpu/kernels/murmur3.py murmur3_columns_kernel
// (the Pallas kernel over row blocks). Semantics follow
// spark_rapids_tpu/ops/hashing.py: seed 42, a null leaves the running
// hash unchanged, bool/byte/short/int/date hash as Spark's hashInt of the
// sign-extended value, floats and doubles fold -0.0 to 0.0, decimals of
// precision <= 18 hash as long, strings hash whole little-endian 4-byte
// words and then each tail byte sign-extended from int8. With n_parts >
// 0 the kernel writes pmod(hash, n_parts) instead of the hash: Spark
// HashPartitioning's partition id.
//
// Bound on the H100: bytes. Each row reads its key columns once (data,
// validity, and for strings the used bytes of its row and its length)
// and writes 4 bytes; the arithmetic is a handful of integer ops per
// word, far below the card's integer rate. The design:
//   - each thread takes R consecutive rows with independent hash chains,
//     so every fixed-width column arrives in one load a thread as wide as
//     R values are (at R = 4: 4 B for bool/byte, 8 B for short, 16 B for
//     int/float/date, 32 B for long/double), validity in one load, and
//     the R results leave in one store. R follows the batch: 4 from 2^20
//     rows, 2 from 2^18, else 1, so that a batch still gives the card as
//     many threads as it holds (measured: at 64 to 65,536 rows one row a
//     thread was fastest, since a thread's rows run one after another);
//   - every column is read in its own width: 1- and 2-byte columns need
//     no widening copy before the launch;
//   - string rows are 8-byte aligned (char_cap is a multiple of 8), so a
//     row is read 16 (or 8) bytes at a time up to its length and the
//     tail bytes come out of the last word; rows whose width or address
//     is not a multiple of 8 are read a byte at a time. Staging a
//     block's tile of 64-byte rows in shared memory with coalesced
//     16-byte loads, then hashing from there, was measured slower than
//     each thread's own 16-byte loads (the tile is read whole, the row
//     only up to its length, and the second half of each sector a thread
//     reads comes from L1), so rows of every width are read directly;
//   - the column descriptors travel as a kernel argument, so a launch
//     needs no device-side allocation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kFourRowsFrom = 1 << 20;
constexpr int kTwoRowsFrom = 1 << 18;

enum Kind : long long {
  kInt32 = 0,
  kInt64 = 1,
  kFloat32 = 2,
  kFloat64 = 3,
  kBytes = 4,
  kInt8 = 5,
  kInt16 = 6
};

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

// R consecutive values from row r0: one aligned load when all of them
// are in range and the column is aligned to their width.
template <typename T, int R>
struct alignas(R * sizeof(T)) Vec {
  T x[R];
};

template <typename T, int kRows>
__device__ __forceinline__ void load_rows(const void* data, int r0, int n,
                                          T (&v)[kRows]) {
  const T* p = (const T*)data;
  if (r0 + kRows <= n && ((uintptr_t)p % sizeof(Vec<T, kRows>)) == 0) {
    Vec<T, kRows> q = *(const Vec<T, kRows>*)(p + r0);
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = q.x[j];
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = r0 + j < n ? p[r0 + j] : T(0);
}

// hashUnsafeBytes over one row of ``len`` bytes: whole 4-byte words, then
// the tail bytes sign-extended, then fmix with the length.
__device__ __forceinline__ uint32_t hash_string(const unsigned char* row,
                                               int len, long long cap,
                                               uint32_t h1) {
  const int full = len >> 2;  // whole 4-byte words
  const int tail = len & 3;
  uint32_t last = 0;          // the word that holds the tail bytes
  if (((cap | (long long)(uintptr_t)row) & 15) == 0) {
    const uint4* p = (const uint4*)row;
    for (int c = 0; 16 * c < len; ++c) {
      uint4 q = p[c];
      uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int wi = 4 * c + i;
        if (wi < full) h1 = mix_h1(h1, mix_k1(w[i]));
        else if (wi == full) last = w[i];
      }
    }
  } else if (((cap | (long long)(uintptr_t)row) & 7) == 0) {
    const uint2* p = (const uint2*)row;
    for (int c = 0; 8 * c < len; ++c) {
      uint2 q = p[c];
      uint32_t w[2] = {q.x, q.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int wi = 2 * c + i;
        if (wi < full) h1 = mix_h1(h1, mix_k1(w[i]));
        else if (wi == full) last = w[i];
      }
    }
  } else {
    for (int wi = 0; wi < full; ++wi) {
      const unsigned char* b = row + 4 * wi;
      h1 = mix_h1(h1, mix_k1((uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                             ((uint32_t)b[2] << 16) |
                             ((uint32_t)b[3] << 24)));
    }
    for (int k = 0; k < tail; ++k)
      last |= (uint32_t)row[4 * full + k] << (8 * k);
  }
  for (int k = 0; k < tail; ++k) {
    int sb = (int)(signed char)(last >> (8 * k));
    h1 = mix_h1(h1, mix_k1((uint32_t)sb));
  }
  return fmix(h1, (uint32_t)len);
}

template <int kRows>
__global__ void __launch_bounds__(kThreads) murmur3_kernel(
    Cols cols, int n_cols, int n_rows, uint32_t seed, int n_parts,
    int* __restrict__ out) {
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q * kRows < n_rows; q += (long long)gridDim.x * blockDim.x) {
    const int r0 = (int)(q * kRows);
    uint32_t h[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) h[j] = seed;
    for (int ci = 0; ci < n_cols; ++ci) {
      const ColDesc& c = cols.c[ci];
      unsigned char ok[kRows];
      load_rows<unsigned char, kRows>(c.valid, r0, n_rows, ok);
      switch (c.kind) {
        case kInt8: {
          signed char v[kRows];
          load_rows<signed char, kRows>(c.data, r0, n_rows, v);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (ok[j]) h[j] = hash_int((uint32_t)(int)v[j], h[j]);
          break;
        }
        case kInt16: {
          short v[kRows];
          load_rows<short, kRows>(c.data, r0, n_rows, v);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            if (ok[j]) h[j] = hash_int((uint32_t)(int)v[j], h[j]);
          break;
        }
        case kInt32:
        case kFloat32: {
          uint32_t v[kRows];
          load_rows<uint32_t, kRows>(c.data, r0, n_rows, v);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            uint32_t b = v[j];
            if (c.kind == kFloat32 && (b << 1) == 0u) b = 0u;  // -0.0
            if (ok[j]) h[j] = hash_int(b, h[j]);
          }
          break;
        }
        case kInt64:
        case kFloat64: {
          uint64_t v[kRows];
          load_rows<uint64_t, kRows>(c.data, r0, n_rows, v);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            uint64_t b = v[j];
            if (c.kind == kFloat64 && (b << 1) == 0ull) b = 0ull;
            if (ok[j]) h[j] = hash_long(b, h[j]);
          }
          break;
        }
        default: {
          int len[kRows];
          load_rows<int, kRows>(c.lengths, r0, n_rows, len);
          const unsigned char* base = (const unsigned char*)c.data;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (!ok[j]) continue;
            int l = len[j] < c.char_cap ? len[j] : (int)c.char_cap;
            h[j] = hash_string(base + (size_t)(r0 + j) * c.char_cap, l,
                               c.char_cap, h[j]);
          }
        }
      }
    }
    int res[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      int v = (int)h[j];
      if (n_parts > 0) {
        v %= n_parts;
        if (v < 0) v += n_parts;
      }
      res[j] = v;
    }
    if (r0 + kRows <= n_rows &&
        ((uintptr_t)out % sizeof(Vec<int, kRows>)) == 0) {
      Vec<int, kRows> o;
#pragma unroll
      for (int j = 0; j < kRows; ++j) o.x[j] = res[j];
      *(Vec<int, kRows>*)(out + r0) = o;
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < n_rows) out[r0 + j] = res[j];
    }
  }
}

template <int kRows>
void launch(const Cols& cols, int n_cols, int n_rows, uint32_t seed,
            int n_parts, int* out, cudaStream_t s) {
  long long threads = ((long long)n_rows + kRows - 1) / kRows;
  long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  murmur3_kernel<kRows><<<(int)blocks, kThreads, 0, s>>>(
      cols, n_cols, n_rows, seed, n_parts, out);
}

}  // namespace

// descs: n_cols x 5 int64 words laid out as ColDesc. n_parts 0 writes
// the hash, n_parts > 0 pmod(hash, n_parts). Returns cudaGetLastError()
// after the launch.
extern "C" int murmur3_launch(const void* descs, int n_cols, int n_rows,
                              int seed, int n_parts, void* out,
                              void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || n_parts < 0)
    return (int)cudaErrorInvalidValue;
  Cols cols;
  const ColDesc* d = (const ColDesc*)descs;
  for (int i = 0; i < n_cols; ++i) cols.c[i] = d[i];
  if (n_rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // rows a thread: as many as keep the card full of threads
  if (n_rows >= kFourRowsFrom)
    launch<4>(cols, n_cols, n_rows, (uint32_t)seed, n_parts, (int*)out, s);
  else if (n_rows >= kTwoRowsFrom)
    launch<2>(cols, n_cols, n_rows, (uint32_t)seed, n_parts, (int*)out, s);
  else
    launch<1>(cols, n_cols, n_rows, (uint32_t)seed, n_parts, (int*)out, s);
  return (int)cudaGetLastError();
}
