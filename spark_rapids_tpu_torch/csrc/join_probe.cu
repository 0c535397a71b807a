// Join build + probe through one open-addressed hash table.
//
// Replaces spark_rapids_tpu/kernels/join_probe.py build_probe (the Pallas
// kernel behind the broadcast/FK fast probe and the semi/anti masks of
// ops/join.py). The right (build) side's valid rows go into a table of T
// slots, T a power of two >= max(64, 2 * build capacity); a slot's owner
// is the SMALLEST build row of its key. Then every valid left (stream)
// row walks from its hash slot: an empty slot proves the key absent, an
// owner with equal key words is the match. Outputs per left row:
// matched (bool) and first_row (int32, the owner; 0 where unmatched).
//
// Bound on the H100: bytes. Both key-word matrices, both hash vectors
// and both validity vectors are read once and 5 bytes are written per
// left row, at 3.35 TB/s. The table (at most 16,384 int32 slots at the
// default 8192-row build cap) and the build key words it points at sit
// in L2, so the probe's scattered reads hit the cache.
//
// Design, three launches on one stream and no spin-wait:
//   1. owner[0..T) = -1.
//   2. Build, one thread per build row: claim an empty slot with
//      atomicCAS(owner, -1, r); otherwise compare the K key words of
//      kw_r[owner] with kw_r[r], read from the immutable input (never from
//      table storage another thread may be writing); on equality
//      atomicMin(owner, r) keeps the smallest row whatever order the
//      threads land in, else step to the next slot. A slot's key never
//      changes once claimed, so rows of one key all stop at one slot.
//   3. Probe, one thread per stream row, after the build (stream order).
// Because T >= 2 * build rows the table is never full: every walk meets
// an empty slot within T steps, so there is no overflow path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void init_owner(int T, int* owner) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < T;
       s += gridDim.x * blockDim.x)
    owner[s] = -1;
}

__device__ __forceinline__ bool same_key(const long long* __restrict__ a,
                                         const long long* __restrict__ b,
                                         int K) {
  for (int w = 0; w < K; ++w)
    if (a[w] != b[w]) return false;
  return true;
}

__global__ void build_kernel(const long long* __restrict__ kw_r, int K,
                             const long long* __restrict__ h_r,
                             const bool* __restrict__ valid_r, int n_r,
                             int T, int* owner) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n_r;
       r += gridDim.x * blockDim.x) {
    if (!valid_r[r]) continue;
    const long long* key = kw_r + (size_t)r * K;
    int slot = (int)(h_r[r] & (long long)(T - 1));
    for (int p = 0; p < T; ++p) {
      int cur = *((volatile int*)&owner[slot]);
      if (cur < 0) {
        int prev = atomicCAS(&owner[slot], -1, r);
        if (prev < 0) break;  // claimed: first owner of this key
        cur = prev;
      }
      if (same_key(kw_r + (size_t)cur * K, key, K)) {
        atomicMin(&owner[slot], r);
        break;
      }
      slot = (slot + 1) & (T - 1);
    }
  }
}

__global__ void probe_kernel(const long long* __restrict__ kw_r,
                             const long long* __restrict__ kw_l, int K,
                             const long long* __restrict__ h_l,
                             const bool* __restrict__ valid_l, int n_l,
                             int T, const int* __restrict__ owner,
                             bool* __restrict__ matched,
                             int* __restrict__ first_row) {
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < n_l;
       l += gridDim.x * blockDim.x) {
    bool m = false;
    int fr = 0;
    if (valid_l[l]) {
      const long long* key = kw_l + (size_t)l * K;
      int slot = (int)(h_l[l] & (long long)(T - 1));
      for (int p = 0; p < T; ++p) {
        int cur = owner[slot];
        if (cur < 0) break;  // empty slot: the key is absent
        if (same_key(kw_r + (size_t)cur * K, key, K)) {
          m = true;
          fr = cur;
          break;
        }
        slot = (slot + 1) & (T - 1);
      }
    }
    matched[l] = m;
    first_row[l] = fr;
  }
}

int grid_for(int n) {
  int blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// kw_r: (n_r, K) int64 build key words; h_r: (n_r,) int64 hash; valid_r:
// (n_r,) bool; kw_l/h_l/valid_l: the same for the n_l stream rows, with
// the same K. owner: (T,) int32 scratch, T a power of two >= 2 * n_r.
// Outputs: matched (n_l,) bool, first_row (n_l,) int32. Returns
// cudaGetLastError() after the three launches.
extern "C" int join_probe_launch(const void* kw_r, const void* h_r,
                                 const void* valid_r, int n_r,
                                 const void* kw_l, const void* h_l,
                                 const void* valid_l, int n_l, int K,
                                 int T, void* owner, void* matched,
                                 void* first_row, void* stream) {
  if (T <= 0 || (T & (T - 1)) != 0 || K <= 0 || T < 2 * n_r)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  init_owner<<<grid_for(T), 256, 0, s>>>(T, (int*)owner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_r > 0) {
    build_kernel<<<grid_for(n_r), 256, 0, s>>>(
        (const long long*)kw_r, K, (const long long*)h_r,
        (const bool*)valid_r, n_r, T, (int*)owner);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_l > 0) {
    probe_kernel<<<grid_for(n_l), 256, 0, s>>>(
        (const long long*)kw_r, (const long long*)kw_l, K,
        (const long long*)h_l, (const bool*)valid_l, n_l, T,
        (const int*)owner, (bool*)matched, (int*)first_row);
  }
  return (int)cudaGetLastError();
}
