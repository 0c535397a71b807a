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
// the floor is the input bytes over 3.35 TB/s. With few groups (TPC-H q1
// has 6) the first design, one thread per row with an atomicMin on the
// owner word and one 64-bit global atomic per lane, serialised some
// 16 million atomics on 126 addresses in L2: 1.862 ms at q1's shape
// (786,432 rows, 21 add lanes, 1,024 slots), 35x its 0.0529 ms bound
// (NVIDIA H100 80GB HBM3, 700.00 W).
//
// This design keeps the global slot protocol and takes the atomics off
// the global table:
// - a row's slot: an empty slot is claimed with atomicCAS on the int32
//   owner word (-1 -> row); key equality reads the owner's key words
//   from the immutable input kw, so no thread reads key storage another
//   thread is still writing; each block caches the owner words it has
//   read in shared memory (T <= 4096), since with a few groups every
//   row's read of its owner word landed on the same few L2 lines;
// - within a warp, rows of one slot find each other with
//   __match_any_sync and fold their lanes by shuffles in a tree of at
//   most 5 steps; the lowest lane (the smallest row) leads;
// - the leader adds into its block's shared-memory table of L entries
//   (open-addressed by slot; lane-major), one block of 1024 threads a
//   SM with a table of up to ~200 KB, so q1 and a 700-group batch get an
//   entry for every slot (L = T) and no row touches the global table; a
//   group that finds no free entry within 8 probes (L < T) updates the
//   global table directly, with its own atomicMin on the owner word;
// - each used entry flushes once per block: one atomicMin on the owner
//   word with the block's smallest row of that group, one atomic per
//   lane;
// - a block whose first 1,024 rows hold fewer than 32 live rows (a
//   sparse batch) keeps no table and no owner cache, and its rows
//   update the global table directly: setting up and flushing a table
//   for a handful of rows was most of the kernel's time there.
// Lanes arrive lane-major, (n_lanes, n_rows), so a warp's loads of one
// lane are contiguous; they load 8 lanes at a time, the first 8 while
// the row probes. Every accumulator lane is an int64 combined by
// wrapping add, min or max, so the order in which atomics land changes
// no bit. Measured (NVIDIA H100 80GB HBM3, 700.00 W): 0.1342 ms at q1's
// shape (2.8x its 0.0487 ms valid-row bound; the first design 1.877 ms
// in the same run), 0.2109 ms at 700 groups (was 0.4958). At a batch of
// 10 valid rows in 262,144 it is still slower, 0.00835 ms against
// 0.00600: its launch of 1,024-thread blocks, the validity count and the
// row loop cost more than the whole first kernel there.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kMaxProbes = 64;
constexpr int kLocalProbes = 8;
constexpr int kThreads = 1024;
constexpr int kBatch = 8;  // lanes loaded together
constexpr int kOwnerCache = 4096;  // largest T whose owner words a block caches
constexpr unsigned kFull = 0xffffffffu;
constexpr i64 kI64Max = 0x7FFFFFFFFFFFFFFFLL;
constexpr i64 kI64Min = (i64)0x8000000000000000ULL;

__global__ void init_tables(int T, int n_add, int n_min, int n_max,
                            int* owner, i64* add_out, i64* min_out,
                            i64* max_out, int* overflow) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int stride = gridDim.x * blockDim.x;
  for (int s = i; s < T; s += stride) owner[s] = -1;
  for (int s = i; s < T * n_add; s += stride) add_out[s] = 0;
  for (int s = i; s < T * n_min; s += stride) min_out[s] = kI64Max;
  for (int s = i; s < T * n_max; s += stride) max_out[s] = kI64Min;
  if (i == 0) *overflow = 0;
}

// the global slot of row r's group, or -1 after kMaxProbes probes. A
// slot's owner word only ever holds rows of the group that claimed it,
// so a block caches the owner it read in sown (when T <= kOwnerCache)
// and reads each used slot's word from L2 about once instead of once a
// row: with a few groups every row would read the same few L2 lines.
__device__ __forceinline__ int find_slot(const i64* __restrict__ kw, int K,
                                         i64 hr, int r, int T, int* owner,
                                         int* sown) {
  const i64* key = kw + (size_t)r * K;
  int slot = (int)(hr & (i64)(T - 1));
  for (int p = 0; p < kMaxProbes; ++p) {
    int cur = sown ? *((volatile int*)&sown[slot]) : -1;
    if (cur < 0) {
      cur = *((volatile int*)&owner[slot]);
      if (cur < 0) {
        int prev = atomicCAS(&owner[slot], -1, r);
        if (prev < 0) {  // claimed
          if (sown) sown[slot] = r;
          return slot;
        }
        cur = prev;
      }
      if (sown) sown[slot] = cur;
    }
    const i64* other = kw + (size_t)cur * K;
    bool same = true;
    for (int w = 0; w < K; ++w) {
      if (__ldg(other + w) != __ldg(key + w)) {
        same = false;
        break;
      }
    }
    if (same) return slot;
    slot = (slot + 1) & (T - 1);
  }
  return -1;
}

// the block's table entry of global slot s, or -1 when kLocalProbes
// entries from s's home are held by other slots (or L is 0); with L == T
// every slot has its own entry
__device__ __forceinline__ int local_entry(int* skey, int L, int s) {
  if (L == 0) return -1;
  int e = s & (L - 1);
  int probes = L < kLocalProbes ? L : kLocalProbes;
  for (int p = 0; p < probes; ++p) {
    int cur = *((volatile int*)&skey[e]);
    if (cur == s) return e;
    if (cur < 0) {
      int prev = atomicCAS(&skey[e], -1, s);
      if (prev < 0 || prev == s) return e;
    }
    e = (e + 1) & (L - 1);
  }
  return -1;
}

enum Op { OP_ADD, OP_MIN, OP_MAX };

template <int OP>
__device__ __forceinline__ u64 combine(u64 a, u64 b) {
  if (OP == OP_ADD) return a + b;
  if (OP == OP_MIN) return (i64)a < (i64)b ? a : b;
  return (i64)a > (i64)b ? a : b;
}

// fold lanes [0, nl) of one lane matrix over the warp's peer groups (the
// tree of src steps), kBatch lanes at a time so their loads are in flight
// together (with PRE, the first batch was loaded before the slot was
// found); the leader combines each group's value into the block's entry
// e or, without one, into the global table row gout
template <int OP, bool PRE>
__device__ __forceinline__ void fold_lanes(const i64* __restrict__ lanes,
                                           int nl, int n, int r, bool has,
                                           u64 identity,
                                           const u64 (&pre)[kBatch],
                                           const int (&src)[5], int nsteps,
                                           bool lead, int e, u64* sacc,
                                           int L, i64* gout) {
  for (int j0 = 0; j0 < nl; j0 += kBatch) {
    u64 x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (PRE && j0 == 0) {
        x[k] = has ? pre[k] : identity;
      } else {
        x[k] = has && j0 + k < nl
                   ? (u64)__ldcs(lanes + (size_t)(j0 + k) * n + r)
                   : identity;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (j0 + k >= nl) break;
#pragma unroll
      for (int it = 0; it < 5; ++it) {
        if (it < nsteps) {
          const u64 t = __shfl_sync(kFull, x[k], (src[it] - 1) & 31);
          if (src[it]) x[k] = combine<OP>(x[k], t);
        }
      }
      if (!lead) continue;
      u64* dst = e >= 0 ? sacc + (size_t)(j0 + k) * L + e
                        : (u64*)(gout + j0 + k);
      if (OP == OP_ADD) atomicAdd(dst, x[k]);
      else if (OP == OP_MIN) atomicMin((i64*)dst, (i64)x[k]);
      else atomicMax((i64*)dst, (i64)x[k]);
    }
  }
}

// the first kBatch lanes of row r (identity past nl or for a dead row)
__device__ __forceinline__ void prefetch(const i64* __restrict__ lanes,
                                         int nl, int n, int r, bool live,
                                         u64 identity, u64 (&pre)[kBatch]) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k)
    pre[k] = live && k < nl ? (u64)__ldcs(lanes + (size_t)k * n + r)
                            : identity;
}

__global__ void __launch_bounds__(kThreads, 1)
groupby_kernel(const i64* __restrict__ kw, int K, const i64* __restrict__ h,
               const bool* __restrict__ valid, int n,
               const i64* __restrict__ add, int n_add,
               const i64* __restrict__ mn, int n_min,
               const i64* __restrict__ mx, int n_max, int T, int L,
               int* owner, i64* add_out, i64* min_out, i64* max_out,
               int* overflow) {
  // shared: sacc[nl][L] accumulators (lane-major), skey[L] global slot
  // of each entry (-1 free), srow[L] the block's smallest row per entry,
  // sown[T] the owner words read so far (-1 unknown) when T is small
  const int lane = threadIdx.x & 31;
  const i64 warp0 = ((i64)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const i64 nwarps = ((i64)gridDim.x * blockDim.x) >> 5;
  extern __shared__ u64 smem[];
  const int nl = n_add + n_min + n_max;
  // each row's validity is loaded one iteration ahead
  bool next_live = warp0 * 32 + lane < n && valid[warp0 * 32 + lane];
  // a block whose first rows hold under one live row in 32 (a sparse
  // batch, such as a selective join's output) keeps no table and no
  // owner cache: it would set up and flush them for a handful of rows,
  // so its rows update the global table directly (local_entry answers -1
  // when L is 0)
  const bool sparse = __syncthreads_count(next_live) * 32 < (int)blockDim.x;
  if (sparse) L = 0;
  u64* sacc = smem;
  int* skey = reinterpret_cast<int*>(smem + (size_t)nl * L);
  int* srow = skey + L;
  int* sown = !sparse && T <= kOwnerCache ? srow + L : nullptr;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    skey[i] = -1;
    srow[i] = INT_MAX;
  }
  if (sown)
    for (int i = threadIdx.x; i < T; i += blockDim.x) sown[i] = -1;
  for (int j = 0; j < nl; ++j) {
    const u64 identity =
        j < n_add ? 0ULL : (u64)(j < n_add + n_min ? kI64Max : kI64Min);
    for (int e = threadIdx.x; e < L; e += blockDim.x)
      sacc[(size_t)j * L + e] = identity;
  }
  __syncthreads();

  for (i64 base = warp0 * 32; base < n; base += nwarps * 32) {
    const int r = (int)(base + lane);
    const bool live = next_live;
    const i64 rn = base + nwarps * 32 + lane;
    next_live = rn < n && valid[rn];
    if (!__any_sync(kFull, live)) continue;
    // the first add lanes load while the row finds its slot
    u64 pre[kBatch];
    prefetch(add, n_add, n, r, live, 0ULL, pre);
    int slot = -1;
    if (live) {
      slot = find_slot(kw, K, h[r], r, T, owner, sown);
      if (slot < 0) atomicExch(overflow, 1);
    }
    const bool has = slot >= 0;
    // peers: the lanes of this warp whose rows share the slot
    const unsigned peers = __match_any_sync(kFull, slot);
    const bool lead = has && lane == __ffs(peers) - 1;
    // the reduction tree over each peer group: at step it a lane adds
    // the value of its next remaining higher peer (src, 1-based, 0 for
    // none); lanes at odd rank drop out after each step
    int src[5];
    int nsteps = 0;
    unsigned rest = peers & (0xfffffffeu << lane);
    int rank = __popc(peers & ((1u << lane) - 1));
#pragma unroll
    for (int it = 0; it < 5; ++it) {
      src[it] = __ffs(rest);
      if (__ballot_sync(kFull, src[it] != 0)) nsteps = it + 1;
      rest &= ~__ballot_sync(kFull, rank & 1);
      rank >>= 1;
    }
    int e = -1;
    if (lead) {
      e = local_entry(skey, L, slot);
      if (e >= 0) atomicMin(&srow[e], r);
      else atomicMin(&owner[slot], r);
    }
    const size_t gs = (size_t)(slot < 0 ? 0 : slot);
    fold_lanes<OP_ADD, true>(add, n_add, n, r, has, 0ULL, pre, src, nsteps,
                             lead, e, sacc, L, add_out + gs * n_add);
    fold_lanes<OP_MIN, false>(mn, n_min, n, r, has, (u64)kI64Max, pre, src,
                              nsteps, lead, e, sacc + (size_t)n_add * L, L,
                              min_out + gs * n_min);
    fold_lanes<OP_MAX, false>(mx, n_max, n, r, has, (u64)kI64Min, pre, src,
                              nsteps, lead, e,
                              sacc + (size_t)(n_add + n_min) * L, L,
                              max_out + gs * n_max);
  }
  __syncthreads();

  // flush: one atomic per used entry and lane
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    if (skey[i] >= 0) atomicMin(&owner[skey[i]], srow[i]);
  for (int j = 0; j < nl; ++j) {
    for (int e = threadIdx.x; e < L; e += blockDim.x) {
      const int s = skey[e];
      if (s < 0) continue;
      const u64 v = sacc[(size_t)j * L + e];  // identities change nothing
      if (j < n_add) {
        if (v) atomicAdd((u64*)&add_out[(size_t)s * n_add + j], v);
      } else if (j < n_add + n_min) {
        if ((i64)v != kI64Max)
          atomicMin(&min_out[(size_t)s * n_min + (j - n_add)], (i64)v);
      } else if ((i64)v != kI64Min) {
        atomicMax(&max_out[(size_t)s * n_max + (j - n_add - n_min)], (i64)v);
      }
    }
  }
}

}  // namespace

// kw: (n_rows, K) int64 key words; h: (n_rows,) int64 hash; valid:
// (n_rows,) bool; add/mn/mx: (n_*, n_rows) int64 lanes, lane-major (may
// be null when n_* is 0). L: entries of each block's shared-memory table
// (a power of two <= T, or 0), L * (8 * lanes + 8) bytes of dynamic
// shared memory. block_rows: the rows each block walks, which sets the
// grid to ceil(n_rows / block_rows) blocks, capped at the blocks that fit
// on the SMs at once (0 = kThreads, one row a thread); the autotuner's
// blockRows. Outputs: owner (T,) int32 (-1 = unused), add_out/
// min_out/max_out (T, n_*) int64, overflow (1,) int32. T is a power of
// two. Returns cudaGetLastError() after the two launches, or the error
// that refused the shared-memory size or the launch.
extern "C" int groupby_hash_launch(const void* kw, int K, const void* h,
                                   const void* valid, int n_rows,
                                   const void* add, int n_add,
                                   const void* mn, int n_min,
                                   const void* mx, int n_max, int T, int L,
                                   int block_rows, void* owner,
                                   void* add_out, void* min_out,
                                   void* max_out, void* overflow,
                                   void* stream) {
  if (T <= 0 || (T & (T - 1)) != 0 || K <= 0 || L < 0 || L > T ||
      (L & (L - 1)) != 0 || block_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (block_rows == 0) block_rows = kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  int init_n = T;
  if (T * n_add > init_n) init_n = T * n_add;
  if (T * n_min > init_n) init_n = T * n_min;
  if (T * n_max > init_n) init_n = T * n_max;
  init_tables<<<(init_n + 255) / 256, 256, 0, s>>>(
      T, n_add, n_min, n_max, (int*)owner, (i64*)add_out, (i64*)min_out,
      (i64*)max_out, (int*)overflow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_rows <= 0) return (int)err;
  const size_t smem = (size_t)L * (8 * (size_t)(n_add + n_min + n_max) + 8) +
                     (T <= kOwnerCache ? 4 * (size_t)T : 0);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(groupby_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, groupby_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  i64 blocks = ((i64)n_rows + block_rows - 1) / block_rows;
  if (blocks > (i64)per_sm * sms) blocks = (i64)per_sm * sms;
  groupby_kernel<<<(int)blocks, kThreads, smem, s>>>(
      (const i64*)kw, K, (const i64*)h, (const bool*)valid, n_rows,
      (const i64*)add, n_add, (const i64*)mn, n_min, (const i64*)mx, n_max,
      T, L, (int*)owner, (i64*)add_out, (i64*)min_out, (i64*)max_out,
      (int*)overflow);
  return (int)cudaGetLastError();
}
