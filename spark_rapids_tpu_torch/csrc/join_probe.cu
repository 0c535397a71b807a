// Join build + probe through one open-addressed hash table, in one
// launch.
//
// Replaces spark_rapids_tpu/kernels/join_probe.py build_probe (the Pallas
// kernel behind the broadcast/FK fast probe and the semi/anti masks of
// ops/join.py). The right (build) side's valid rows go into a table of T
// slots, T a power of two >= max(64, 2 * build rows); a slot's owner is
// the SMALLEST build row of its key. Then every valid left (stream) row
// walks from its hash slot: an empty slot proves the key absent, an owner
// with equal key words is the match. Outputs per left row: matched (bool)
// and first_row (int32, the owner; 0 where unmatched). The slot hash is
// computed here from the key words (a 64-bit multiply-xorshift fold); the
// result does not depend on it.
//
// Bound on the H100: bytes. Both key-word matrices and both validity
// vectors are read once and 5 bytes are written per left row, at
// 3.35 TB/s. At the main path's shapes (build <= 8,192 rows, stream
// 262,144 rows) that is about 1.7 us, less than the latency of one
// launch, so the design spends no second launch and no device-memory
// round trip:
//
//   One launch. Every block builds its own private table in shared
//   memory, then probes its share of the stream rows against it. The
//   table holds the build validity, the build key words where they fit
//   (8*K bytes a row) and T int32 owners; the kernel takes up to 4 slots
//   a build row where shared memory allows (fewer collisions: the build
//   and the probe walk less), at most 32,768 slots. The build is repeated
//   by every block: n_r*(8K+1) bytes of L2 reads and n_r shared-memory
//   inserts a block; 1,024-thread blocks of 2,048 stream rows keep that to
//   128 builds at 262,144 stream rows. Measured alternatives: 512- and
//   256-thread blocks built slower (fewer threads insert the same rows);
//   a cluster of 2, 4 or 8 blocks sharing one table cut by hash through
//   distributed shared memory inserted fewer rows a block but was slower
//   at every shape (remote latency on every probe step and insert).
//   Before its build, each thread issues the loads of its first stream
//   rows, so their device-memory latency overlaps the build. The build
//   rows are staged with 16-byte loads, eight a thread in flight.
//
//   Build: one thread per build row claims an empty slot with
//   atomicCAS(owner, -1, r); otherwise it compares the K key words of the
//   slot's owner row with its own, read from the immutable key copy
//   (never from storage another thread may be writing); on equality
//   atomicMin(owner, r) keeps the smallest row whatever order the threads
//   land in, else it steps to the next slot. A slot's key never changes
//   once claimed, so the rows of one key all stop at one slot.
//
//   Probe: each thread takes 2 consecutive stream rows with independent
//   walks; for K = 1 and K = 2 their key words arrive in 16-byte loads
//   and validity and outputs in one access each. Other K take one row a
//   thread. Key words too wide for shared memory beside the owners (K >= 3
//   at the 8,192-row cap) are read from device memory.
//
// Because T >= 2 * build rows the table is never full: every walk meets
// an empty slot within T steps, so there is no overflow path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kRowsPerThread = 2;
constexpr int kTile = kThreads * kRowsPerThread;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kMaxSlots = 32768;  // 128 KB of owners

template <int KC>
__device__ __forceinline__ uint64_t slot_hash(const long long* key, int K) {
  const int n = KC > 0 ? KC : K;
  uint64_t h = 0x9E3779B97F4A7C15ull;
#pragma unroll
  for (int w = 0; w < n; ++w) {
    h = (h ^ (uint64_t)key[w]) * 0xBF58476D1CE4E5B9ull;
    h ^= h >> 31;
  }
  h *= 0x94D049BB133111EBull;
  return h ^ (h >> 32);
}

template <int KC>
__device__ __forceinline__ bool same_key(const long long* a,
                                         const long long* b, int K) {
  const int n = KC > 0 ? KC : K;
#pragma unroll
  for (int w = 0; w < n; ++w)
    if (a[w] != b[w]) return false;
  return true;
}

// The owner of the key's slot, or -1 when the key is absent.
template <int KC>
__device__ __forceinline__ int probe_one(const int* owner,
                                         const long long* keys,
                                         const long long* key, int K,
                                         int T) {
  const int n = KC > 0 ? KC : K;
  int slot = (int)(slot_hash<KC>(key, K) & (uint64_t)(T - 1));
  for (int p = 0; p < T; ++p) {
    int cur = owner[slot];
    if (cur < 0) return -1;  // empty slot: the key is absent
    if (same_key<KC>(keys + (size_t)cur * n, key, K)) return cur;
    slot = (slot + 1) & (T - 1);
  }
  return -1;
}

// kRowsPerThread consecutive values, loaded or stored in one access.
template <typename T>
struct alignas(kRowsPerThread * sizeof(T)) Rows {
  T x[kRowsPerThread];
};

// kRowsPerThread consecutive stream rows a thread: their key words
// (K = KC words each) and validity, loaded as wide as alignment allows.
template <int KC>
struct Quad {
  long long k[kRowsPerThread][KC];
  bool v[kRowsPerThread];

  __device__ __forceinline__ void load(const long long* __restrict__ kw,
                                       const bool* __restrict__ valid,
                                       int r0, int n, bool wide) {
    if (wide && r0 + kRowsPerThread <= n) {
      const longlong2* src = (const longlong2*)(kw + (size_t)r0 * KC);
#pragma unroll
      for (int i = 0; i < kRowsPerThread * KC / 2; ++i) {
        longlong2 q = __ldg(src + i);
        k[(2 * i) / KC][(2 * i) % KC] = q.x;
        k[(2 * i + 1) / KC][(2 * i + 1) % KC] = q.y;
      }
      Rows<unsigned char> vv = *(const Rows<unsigned char>*)(valid + r0);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) v[j] = vv.x[j];
      return;
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      int r = r0 + j;
      v[j] = r < n && valid[r];
#pragma unroll
      for (int w = 0; w < KC; ++w)
        k[j][w] = r < n ? kw[(size_t)r * KC + w] : 0;
    }
  }
};

// Copies ``bytes`` bytes from device memory into shared memory (``dst``
// 16-byte aligned): 16-byte loads, up to 8 a thread in flight at once,
// when ``src`` is 16-byte aligned, else byte by byte.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* __restrict__ src,
                                      size_t bytes) {
  if (((uintptr_t)src & 15) != 0) {
    for (size_t i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
    return;
  }
  constexpr int U = 8;
  const size_t n16 = bytes / 16;
  const int4* s4 = (const int4*)src;
  int4* d4 = (int4*)dst;
  for (size_t base = 0; base < n16; base += (size_t)U * blockDim.x) {
    int4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      size_t i = base + (size_t)u * blockDim.x + threadIdx.x;
      if (i < n16) r[u] = __ldg(s4 + i);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      size_t i = base + (size_t)u * blockDim.x + threadIdx.x;
      if (i < n16) d4[i] = r[u];
    }
  }
  for (size_t i = n16 * 16 + threadIdx.x; i < bytes; i += blockDim.x)
    dst[i] = src[i];
}

// Shared memory a block needs: T owners, the build key words where
// ``keys_smem``, and the build validity.
__host__ __device__ __forceinline__ size_t round16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t table_bytes(int T, int n_r,
                                                      int K,
                                                      bool keys_smem) {
  return 4 * (size_t)T + (keys_smem ? round16(8 * (size_t)K * n_r) : 0) +
         round16((size_t)n_r);
}

// Fills the block's table: stages the build validity (and, with
// KEYS_SMEM, the build key words) in shared memory and sets every owner
// to -1; then inserts every valid build row. Returns the key words the
// table's owners index (shared or device memory).
template <int KC, bool KEYS_SMEM>
__device__ __forceinline__ const long long* build_table(
    unsigned char* smem, const long long* __restrict__ kw_r,
    const bool* __restrict__ valid_r, int n_r, int K, int T) {
  const int n = KC > 0 ? KC : K;
  int* owner = (int*)smem;
  long long* ks = (long long*)(smem + 4 * (size_t)T);
  unsigned char* vs =
      (unsigned char*)ks + (KEYS_SMEM ? round16(8 * (size_t)n * n_r) : 0);
  if (KEYS_SMEM)
    stage((unsigned char*)ks, (const unsigned char*)kw_r,
          8 * (size_t)n * n_r);
  stage(vs, (const unsigned char*)valid_r, (size_t)n_r);
  int4* o4 = (int4*)owner;  // T is a multiple of 64
  for (int i = threadIdx.x; i < T / 4; i += blockDim.x)
    o4[i] = make_int4(-1, -1, -1, -1);
  const long long* keys = KEYS_SMEM ? ks : kw_r;
  __syncthreads();
  for (int r = threadIdx.x; r < n_r; r += blockDim.x) {
    if (!vs[r]) continue;
    const long long* key = keys + (size_t)r * n;
    int slot = (int)(slot_hash<KC>(key, K) & (uint64_t)(T - 1));
    for (int p = 0; p < T; ++p) {
      int cur = ((volatile int*)owner)[slot];
      if (cur < 0) {
        int prev = atomicCAS(&owner[slot], -1, r);
        if (prev < 0) break;  // claimed: first owner of this key
        cur = prev;
      }
      if (same_key<KC>(keys + (size_t)cur * n, key, K)) {
        atomicMin(&owner[slot], r);
        break;
      }
      slot = (slot + 1) & (T - 1);
    }
  }
  __syncthreads();
  return keys;
}

// K = 1 or 2: kRowsPerThread stream rows a thread in tiles of kTile rows.
template <int KC, bool KEYS_SMEM>
__global__ void __launch_bounds__(kThreads) join_probe_wide(
    const long long* __restrict__ kw_r, const bool* __restrict__ valid_r,
    int n_r, const long long* __restrict__ kw_l,
    const bool* __restrict__ valid_l, int n_l, int T, bool wide,
    bool* __restrict__ matched, int* __restrict__ first_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = gridDim.x * kTile;
  int r0 = blockIdx.x * kTile + threadIdx.x * kRowsPerThread;
  Quad<KC> q;
  if (r0 < n_l) q.load(kw_l, valid_l, r0, n_l, wide);  // in flight
  const long long* keys =
      build_table<KC, KEYS_SMEM>(smem, kw_r, valid_r, n_r, KC, T);
  const int* owner = (const int*)smem;
  for (; r0 < n_l; r0 += stride) {
    int fr[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      fr[j] = q.v[j] ? probe_one<KC>(owner, keys, q.k[j], KC, T) : -1;
    if (wide && r0 + kRowsPerThread <= n_l) {
      Rows<unsigned char> m;
      Rows<int> f;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        m.x[j] = fr[j] >= 0;
        f.x[j] = fr[j] < 0 ? 0 : fr[j];
      }
      *(Rows<unsigned char>*)(matched + r0) = m;
      *(Rows<int>*)(first_row + r0) = f;
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        if (r0 + j < n_l) {
          matched[r0 + j] = fr[j] >= 0;
          first_row[r0 + j] = fr[j] < 0 ? 0 : fr[j];
        }
      }
    }
    if (r0 + stride < n_l) q.load(kw_l, valid_l, r0 + stride, n_l, wide);
  }
}

// Any K: one stream row a thread.
template <bool KEYS_SMEM>
__global__ void __launch_bounds__(kThreads) join_probe_any(
    const long long* __restrict__ kw_r, const bool* __restrict__ valid_r,
    int n_r, const long long* __restrict__ kw_l,
    const bool* __restrict__ valid_l, int n_l, int K, int T,
    bool* __restrict__ matched, int* __restrict__ first_row) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long* keys =
      build_table<0, KEYS_SMEM>(smem, kw_r, valid_r, n_r, K, T);
  const int* owner = (const int*)smem;
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < n_l;
       l += gridDim.x * blockDim.x) {
    int fr = valid_l[l]
                 ? probe_one<0>(owner, keys, kw_l + (size_t)l * K, K, T)
                 : -1;
    matched[l] = fr >= 0;
    first_row[l] = fr < 0 ? 0 : fr;
  }
}

int g_sms = 0;

// Launches ``kernel`` with ``smem`` bytes of dynamic shared memory on at
// most as many blocks as fit on the card at once, each with at least
// kTile stream rows (every block repeats the build).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int n_l, cudaStream_t s,
           Args... args) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  int blocks = (n_l + kTile - 1) / kTile;
  if (blocks > g_sms * per_sm) blocks = g_sms * per_sm;
  if (blocks < 1) blocks = 1;
  kernel<<<blocks, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// kw_r: (n_r, K) int64 build key words; valid_r: (n_r,) bool; kw_l /
// valid_l: the same for the n_l stream rows, with the same K. T: table
// slots, a power of two, 64 <= T <= 32768, T >= 2 * n_r. Outputs:
// matched (n_l,) bool, first_row (n_l,) int32. One launch; returns
// cudaGetLastError() after it.
extern "C" int join_probe_launch(const void* kw_r, const void* valid_r,
                                 int n_r, const void* kw_l,
                                 const void* valid_l, int n_l, int K, int T,
                                 void* matched, void* first_row,
                                 void* stream) {
  if (T < 64 || T > kMaxSlots || (T & (T - 1)) != 0 || K <= 0 ||
      T < 2 * n_r || n_r < 0 || n_l < 0)
    return (int)cudaErrorInvalidValue;
  if (n_l == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long* kr = (const long long*)kw_r;
  const bool* vr = (const bool*)valid_r;
  const long long* kl = (const long long*)kw_l;
  const bool* vl = (const bool*)valid_l;
  bool* m = (bool*)matched;
  int* f = (int*)first_row;
  // a block's private table: up to 4 slots a build row where it fits
  // beside the key words (fewer collisions in the build and the probe)
  while (T < 4 * n_r && T < kMaxSlots &&
         table_bytes(2 * T, n_r, K, true) <= (size_t)kMaxSmem)
    T <<= 1;
  bool keys_smem = table_bytes(T, n_r, K, true) <= (size_t)kMaxSmem;
  size_t smem = table_bytes(T, n_r, K, keys_smem);
  // wide loads and stores need the key words and first rows 16-byte
  // aligned and the validity and flags 4-byte aligned (at least what
  // kRowsPerThread rows a thread need)
  bool wide = ((uintptr_t)kl & 15) == 0 && ((uintptr_t)f & 15) == 0 &&
              ((uintptr_t)vl & 3) == 0 && ((uintptr_t)m & 3) == 0;
  if (K == 1)
    return keys_smem
               ? launch(join_probe_wide<1, true>, smem, n_l, s, kr,
                        vr, n_r, kl, vl, n_l, T, wide, m, f)
               : launch(join_probe_wide<1, false>, smem, n_l, s, kr,
                        vr, n_r, kl, vl, n_l, T, wide, m, f);
  if (K == 2)
    return keys_smem
               ? launch(join_probe_wide<2, true>, smem, n_l, s, kr,
                        vr, n_r, kl, vl, n_l, T, wide, m, f)
               : launch(join_probe_wide<2, false>, smem, n_l, s, kr,
                        vr, n_r, kl, vl, n_l, T, wide, m, f);
  return keys_smem
             ? launch(join_probe_any<true>, smem, n_l, s, kr, vr,
                      n_r, kl, vl, n_l, K, T, m, f)
             : launch(join_probe_any<false>, smem, n_l, s, kr, vr,
                      n_r, kl, vl, n_l, K, T, m, f);
}
