// Partial group-by in one open-addressed hash-table pass.
//
// Replaces spark_rapids_tpu/kernels/groupby_hash.py _build_kernel and
// _build_kernel_tiled (the whole-array and the tiled Pallas kernels of
// the same function). Per batch: every valid row finds its group's slot
// by linear probing from h & (T - 1); a slot's owner is the smallest
// row of its group (the group's first row); add lanes sum with int64
// wraparound, min/max lanes keep the extreme; a row still unplaced after
// 64 probes sets the overflow flag, and the caller re-runs the batch on
// the sort-based partial aggregate.
//
// Bound on the H100: bytes. The inputs (key words, hash, validity and
// the lane matrices) are read once and the T-slot tables are tiny, so
// the floor is the input bytes over 3.35 TB/s. The design is the simple
// correct one, with no spin-wait: one thread per row; an empty slot is
// claimed with atomicCAS on an int32 owner word (-1 -> row); key
// equality reads the owner's key words from the immutable input kw, so
// no thread ever reads key storage another thread is still writing;
// atomicMin then keeps the smallest row as owner; lanes combine with
// 64-bit atomics (unsigned add wraps exactly like the JAX int64 lanes).
// With few groups (TPC-H q1 has 6) every row's atomics land on a few
// addresses and serialise in L2: per-block shared-memory tables and
// warp-aggregated atomics are the known next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxProbes = 64;

__global__ void init_tables(int T, int n_add, int n_min, int n_max,
                            int* owner, long long* add_out,
                            long long* min_out, long long* max_out,
                            int* overflow) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int stride = gridDim.x * blockDim.x;
  for (int s = i; s < T; s += stride) owner[s] = -1;
  for (int s = i; s < T * n_add; s += stride) add_out[s] = 0;
  for (int s = i; s < T * n_min; s += stride)
    min_out[s] = 0x7FFFFFFFFFFFFFFFLL;
  for (int s = i; s < T * n_max; s += stride)
    max_out[s] = (long long)0x8000000000000000ULL;
  if (i == 0) *overflow = 0;
}

__global__ void groupby_kernel(const long long* __restrict__ kw, int K,
                               const long long* __restrict__ h,
                               const bool* __restrict__ valid, int n_rows,
                               const long long* __restrict__ add, int n_add,
                               const long long* __restrict__ mn, int n_min,
                               const long long* __restrict__ mx, int n_max,
                               int T, int* owner, long long* add_out,
                               long long* min_out, long long* max_out,
                               int* overflow) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_rows;
       r += gridDim.x * blockDim.x) {
    if (!valid[r]) continue;
    const long long* key = kw + (size_t)r * K;
    int slot = (int)(h[r] & (long long)(T - 1));
    int found = -1;
    for (int p = 0; p < kMaxProbes; ++p) {
      int cur = *((volatile int*)&owner[slot]);
      if (cur < 0) {
        int prev = atomicCAS(&owner[slot], -1, r);
        if (prev < 0) {  // claimed: this row is the group's first owner
          found = slot;
          break;
        }
        cur = prev;
      }
      const long long* other = kw + (size_t)cur * K;
      bool same = true;
      for (int w = 0; w < K; ++w) {
        if (other[w] != key[w]) {
          same = false;
          break;
        }
      }
      if (same) {
        atomicMin(&owner[slot], r);
        found = slot;
        break;
      }
      slot = (slot + 1) & (T - 1);
    }
    if (found < 0) {
      atomicExch(overflow, 1);
      continue;
    }
    for (int j = 0; j < n_add; ++j)
      atomicAdd((unsigned long long*)&add_out[(size_t)found * n_add + j],
                (unsigned long long)add[(size_t)r * n_add + j]);
    for (int j = 0; j < n_min; ++j)
      atomicMin(&min_out[(size_t)found * n_min + j],
                mn[(size_t)r * n_min + j]);
    for (int j = 0; j < n_max; ++j)
      atomicMax(&max_out[(size_t)found * n_max + j],
                mx[(size_t)r * n_max + j]);
  }
}

}  // namespace

// kw: (n_rows, K) int64 key words; h: (n_rows,) int64 hash; valid:
// (n_rows,) bool; add/mn/mx: (n_rows, n_*) int64 lanes (may be null when
// n_* is 0). Outputs: owner (T,) int32 (-1 = unused), add_out/min_out/
// max_out (T, n_*) int64, overflow (1,) int32. T is a power of two.
// Returns cudaGetLastError() after the two launches.
extern "C" int groupby_hash_launch(const void* kw, int K, const void* h,
                                   const void* valid, int n_rows,
                                   const void* add, int n_add,
                                   const void* mn, int n_min,
                                   const void* mx, int n_max, int T,
                                   void* owner, void* add_out,
                                   void* min_out, void* max_out,
                                   void* overflow, void* stream) {
  if (T <= 0 || (T & (T - 1)) != 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int init_n = T;
  if (T * n_add > init_n) init_n = T * n_add;
  if (T * n_min > init_n) init_n = T * n_min;
  if (T * n_max > init_n) init_n = T * n_max;
  init_tables<<<(init_n + 255) / 256, 256, 0, s>>>(
      T, n_add, n_min, n_max, (int*)owner, (long long*)add_out,
      (long long*)min_out, (long long*)max_out, (int*)overflow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_rows <= 0) return (int)err;
  int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  groupby_kernel<<<blocks, threads, 0, s>>>(
      (const long long*)kw, K, (const long long*)h, (const bool*)valid,
      n_rows, (const long long*)add, n_add, (const long long*)mn, n_min,
      (const long long*)mx, n_max, T, (int*)owner, (long long*)add_out,
      (long long*)min_out, (long long*)max_out, (int*)overflow);
  return (int)cudaGetLastError();
}
