// Parquet page decode of every device-decoded column of a row group.
//
// Replaces spark_rapids_tpu/kernels/decode_fused.py build_fused_decode
// (the Pallas kernel that runs columnar/transfer.py _encoded_decode_body
// in one program). Input: the row group's still-encoded page bytes as one
// int32 word buffer, and per column the host-parsed plan tables (page
// table, RLE/bit-packed run tables for definition levels, dictionary
// indices and DELTA miniblocks, string lengths, decoded dictionaries).
// Output per column at capacity cap: data (bool, int8..int64, float32,
// float64, DECIMAL64 int64; DECIMAL128 hi/lo int64 limbs; strings as a
// (cap, char_cap) uint8 matrix plus int32 lengths) and validity, plus the
// batch's active mask. Every page class decodes: RLE/bit-packed hybrid
// (dictionary indices, booleans), PLAIN fixed width, FIXED_LEN_BYTE_ARRAY
// decimals, DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, PLAIN and
// DELTA_LENGTH byte arrays, mixed freely inside one column chunk.
//
// Bound on the H100: bytes. The page words and tables are read once and
// every output written once, at 3.35 TB/s. The first design, one thread
// per row and column, spent its time on dependent global loads: per value
// a binary search in the page table, about 11 steps of binary search in
// a run table of ~1,500 runs, five clamped byte loads for a bit-packed
// read and seven for a FLBA decimal, and some ten descriptor fields read
// again from global memory: 0.218 ms at a q1 row group (750,152 rows,
// 7 columns, 59.8 MB), 12.2x its 0.01786 ms bound (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// This design decodes tiles and keeps many rows in flight. A block of 256
// threads takes a tile of up to four chunks of consecutive rows of one
// column (fewer when the batch is small, so every block has one; a grid
// of as many blocks as fit, four a SM, walks the (tile, column) pairs),
// reads the column's descriptor into shared memory once, and works in
// sub-tiles:
// - a row's dense value index j never decreases as the row does, so a
//   sub-tile's values span one window [j_lo, j_hi]; six warps find, in
//   parallel and 32 probes a step, the run windows of the definition
//   levels (row coordinates) and of the value runs and the page window
//   (dense coordinates), or take a whole table that fits; the block
//   stages those runs' start, packed flag, value, bit start and width
//   and those pages' table entries in shared memory (work runs column
//   by column, so a block keeps whole tables staged across its tiles);
// - a sub-tile whose windows exceed the buffers is halved, down to one
//   row per thread, where an oversized window is read from global
//   memory (the same answers);
// - a tile of one chunk (a small batch, such as a 4,000-row row group
//   with nulls) stages nothing: each thread decodes one row, so the
//   windows would save it no search, and their staging round trip and
//   barriers made it slower than the first design; its searches run in
//   global memory (L1);
// - each thread finds the run and page of its first row there once and
//   moves those cursors forward, never back, over its later rows;
// - rows decode in chunks of two rows a thread (one a thread on a batch
//   of under 2^21 values, where the tiles' setup weighs more than the
//   rows), in phases that issue a thread's global loads before using
//   any: the level and value-run words, then the dictionary entries;
// - a bit-packed value (width <= 32) is one funnel shift of two aligned
//   32-bit words instead of five byte loads.
// What bounds it is latency: the time fell as warps in flight rose
// (smaller chunks, four blocks a SM), and staging a chunk's PLAIN and
// FLBA bytes in shared memory cost more in barriers than it saved, so
// values are read from the buffer (L1). Measured (NVIDIA H100 80GB
// HBM3, 700.00 W; the first design in the same run): 0.1418 ms at the
// q1 row group (7.9x its bound; was 0.2185), 0.0294 ms at a 250,000-row
// store_sales row group (was 0.0308), 0.0248 ms at a 4,000-row batch
// with nulls and strings on the 3-launch scan path (was 0.0250). A
// lookup outside the staged windows (garbage lanes, string and DELTA
// offsets) takes the global search, so every lane computes what the JAX
// body computes. Every byte
// index is clamped into the buffer as jnp clamps it; a bit-packed read
// clamps its word index instead, which leaves every in-range value
// unchanged (invalid rows write 0 either way); all 64-bit arithmetic
// wraps (unsigned).
//
// Three values are prefix sums, taken by a hand-written scan in the same
// source: the row's rank among valid rows (definition levels), the string
// offsets (a per-page segmented sum over byte footprints) and the DELTA
// reconstruction (a per-page segmented sum of deltas). The scan is a
// block-local scan of 1024 lanes (scan_blocks) plus one scan of the block
// sums (scan_sums); the decode adds the block prefix as it reads. A
// column without definition levels needs no rank scan: its rank is
// min(row, n - 1). Launches per batch: 1 when no column needs a scan
// (q1's and q3's row groups), else 3. All on the caller's stream;
// nothing synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// column descriptor: NF int64 fields per device-decoded column, built by
// spark_rapids_tpu_torch/kernels/decode_fused.py (same order there)
enum Field {
  F_KIND, F_OUT_BYTES, F_SEXT32, F_ELEM_BYTES, F_CHAR_CAP, F_NPG,
  F_DENSE_START, F_PLAIN_BYTE, F_PG_ENC, F_PG_FIRST,
  F_NDL, F_DL_OS, F_DL_PK, F_DL_VA, F_DL_BS, F_DL_WD,
  F_NVR, F_VR_OS, F_VR_PK, F_VR_VA, F_VR_BS, F_VR_WD,
  F_NDR, F_DR_OS, F_DR_PK, F_DR_VA, F_DR_BS, F_DR_WD,
  F_SLEN, F_DICT0, F_DICT1, F_DICT_ROWS,
  F_HAS_PLAIN, F_HAS_DELTA, F_HAS_BSS, F_RANK_SLOT, F_DENSE_SLOT,
  F_OUT0, F_OUT1, F_OUT2, NF
};

enum Kind { K_BOOL, K_INT, K_F32, K_F64, K_DEC64, K_DEC128, K_STR };

// page value-section classes (io/device_decode.py PGE_*)
enum { PGE_DICT = 0, PGE_PLAIN = 1, PGE_DELTA = 2, PGE_BSS = 3,
       PGE_PLAIN_STR = 4, PGE_DL_STR = 5 };

constexpr int SCAN_BLOCK = 1024;
constexpr int kThreads = 256;    // decode block: 8 warps
constexpr int kRunBuf = 256;     // staged runs per run table
constexpr int kPageBuf = 64;     // staged pages
constexpr unsigned kFull = 0xffffffffu;

typedef long long i64;
typedef unsigned long long u64;

// the query range of a window that holds its whole table
constexpr i64 kAll0 = (i64)0x8000000000000000ULL;
constexpr i64 kAll1 = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ i64 clampi(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Bytes {
  const uint8_t* p;
  const uint32_t* w;  // the same buffer as 32-bit words
  i64 nb;             // bytes, 4 * words
  __device__ __forceinline__ i64 at(i64 i) const {
    return (i64)p[clampi(i, 0, nb - 1)];
  }
};

// a window of a sorted table for one sub-tile: for every query x in
// [xlo, xhi] the answer lies in [lo, hi]; a[lo..hi] (and a run's other
// fields) are in shared memory when staged
struct Win {
  i64 xlo, xhi, lo, hi;
  int staged;
};

// number of entries <= x in the non-decreasing a[0..len)
// (searchsorted side="right")
__device__ __forceinline__ i64 upper_bound(const i64* a, i64 len, i64 x) {
  i64 lo = 0, hi = len;
  while (lo < hi) {
    i64 mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// clamp(upper_bound(a, len, x) - 1, 0, maxi): the index of the last
// entry <= x, searched in the window when x lies in it
__device__ __forceinline__ i64 find(const i64* a, i64 len, i64 maxi,
                                    const Win* w, const i64* s, i64 x) {
  if (w == nullptr || x < w->xlo || x > w->xhi)
    return clampi(upper_bound(a, len, x) - 1, 0, maxi);
  // entries (lo, hi] that are <= x: a prefix of the window
  const i64* t = w->staged ? s : a + w->lo;
  i64 l = 1, h = w->hi - w->lo + 1;
  while (l < h) {
    i64 mid = (l + h) >> 1;
    if (t[mid] <= x) l = mid + 1; else h = mid;
  }
  return w->lo + l - 1;
}

// find() over global memory by one warp, 32 probes a step (every lane
// passes the same arguments)
__device__ i64 warp_find(const i64* a, i64 len, i64 maxi, i64 x) {
  const int lane = threadIdx.x & 31;
  i64 lo = 0, hi = len;  // the count of entries <= x lies in [lo, hi]
  while (lo < hi) {
    const i64 step = (hi - lo + 31) / 32;
    const i64 idx = lo + (i64)lane * step;
    const int c = __popc(__ballot_sync(kFull, idx < hi && a[idx] <= x));
    if (c == 0) break;
    const i64 nhi = lo + (i64)c * step;
    lo = lo + (i64)(c - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  return clampi(lo - 1, 0, maxi);
}

// the staged copy of a run table's window
struct RunStage {
  i64 os[kRunBuf], va[kRunBuf], bs[kRunBuf];
  int wd[kRunBuf];
  bool pk[kRunBuf];
};

struct Runs {
  i64 n;
  const i64* os;
  const bool* pk;
  const i64* va;
  const i64* bs;
  const i64* wd;
  const Win* w;         // null: no window (the scan kernels)
  const RunStage* s;
};

template <typename T>
__device__ __forceinline__ const T* ptr(const i64* d, int f) {
  return reinterpret_cast<const T*>(d[f]);
}

__device__ __forceinline__ Runs runs_at(const i64* d, int f_n,
                                        const Win* w = nullptr,
                                        const RunStage* s = nullptr) {
  return Runs{d[f_n],           ptr<i64>(d, f_n + 1), ptr<bool>(d, f_n + 2),
              ptr<i64>(d, f_n + 3), ptr<i64>(d, f_n + 4),
              ptr<i64>(d, f_n + 5), w, s};
}

// a run lookup split in two, so that a thread issues the word loads of
// all its rows before it uses any: a packed run's bit offset and width,
// or an RLE run's value (width -1)
struct Probe {
  i64 a;
  int w;
};

__device__ __forceinline__ void probe_words(const Bytes& b, const Probe& p,
                                            uint32_t& lo, uint32_t& hi) {
  lo = hi = 0;
  if (p.w < 0) return;
  const i64 nw = b.nb >> 2, wi = p.a >> 5;
  lo = __ldg(b.w + clampi(wi, 0, nw - 1));
  hi = __ldg(b.w + clampi(wi + 1, 0, nw - 1));
}

__device__ __forceinline__ i64 probe_value(const Probe& p, uint32_t lo,
                                           uint32_t hi) {
  if (p.w < 0) return p.a;
  const uint32_t v = __funnelshift_r(lo, hi, (uint32_t)(p.a & 31));
  const u64 mask = p.w >= 32 ? 0xFFFFFFFFULL : ((1ULL << p.w) - 1ULL);
  return (i64)(v & mask);
}

// ops/rle.py read_packed: width <= 32 bits at bit_off, as one funnel
// shift of the two 32-bit words that hold them
__device__ __forceinline__ i64 read_packed(const Bytes& b, i64 bit_off,
                                           i64 width) {
  const Probe p{bit_off, (int)width};
  uint32_t lo, hi;
  probe_words(b, p, lo, hi);
  return probe_value(p, lo, hi);
}

// ops/rle.py read_packed64: widths up to 64 as two <= 32-bit reads
__device__ __forceinline__ i64 read_packed64(const Bytes& b, i64 bit_off,
                                             i64 width) {
  i64 lo = read_packed(b, bit_off, width < 32 ? width : 32);
  i64 hi = read_packed(b, bit_off + 32, width > 32 ? width - 32 : 0);
  return (i64)((u64)lo | ((u64)hi << 32));
}

// a run: start, value, bit start, width, packed flag
struct Run {
  i64 os, va, bs, wd;
  bool pk;
};

// run rid's fields, from the staged window when it holds rid
__device__ __forceinline__ Run run_at(const Runs& r, i64 rid) {
  if (r.w && r.w->staged && rid >= r.w->lo && rid <= r.w->hi) {
    const int k = (int)(rid - r.w->lo);
    return Run{r.s->os[k], r.s->va[k], r.s->bs[k], (i64)r.s->wd[k],
               r.s->pk[k]};
  }
  return Run{r.os[rid], r.va[rid], r.bs[rid], r.wd[rid], r.pk[rid]};
}

// the run holding pos
__device__ __forceinline__ i64 run_index(const Runs& r, i64 pos) {
  return find(r.os, r.n, r.n - 1, r.w, r.s ? r.s->os : nullptr, pos);
}

// the probe of run rid for position pos
__device__ __forceinline__ Probe probe_at(const Runs& r, i64 rid, i64 pos) {
  const Run u = run_at(r, rid);
  if (!u.pk) return Probe{u.va, -1};
  return Probe{u.bs + (pos - u.os) * u.wd, (int)u.wd};
}

// the index of the last entry <= x of a[0..maxi] (0 if none), moved
// forward from i, a cursor's earlier answer for an x no larger: what
// find() answers, without a search, for the non-decreasing queries of
// one thread; a[lo..top] are staged in s
__device__ __forceinline__ i64 advance(const i64* a, const Win& w,
                                       const i64* s, i64 top, i64 i,
                                       i64 maxi, i64 x) {
  while (i < maxi) {
    const i64 nxt = w.staged && i + 1 >= w.lo && i + 1 <= top
                        ? s[i + 1 - w.lo] : a[i + 1];
    if (nxt > x) break;
    ++i;
  }
  return i;
}

// ops/rle.py hybrid_lookup
__device__ __forceinline__ i64 hybrid_lookup(const Bytes& b, const Runs& r,
                                             i64 pos) {
  const Probe p = probe_at(r, run_index(r, pos), pos);
  uint32_t lo, hi;
  probe_words(b, p, lo, hi);
  return probe_value(p, lo, hi);
}

// ops/rle.py delta_lookup
__device__ __forceinline__ i64 delta_lookup(const Bytes& b, const Runs& r,
                                            i64 pos) {
  const Run u = run_at(r, run_index(r, pos));
  const i64 raw = read_packed64(b, u.bs + (pos - u.os) * u.wd, u.wd);
  return (i64)((u64)u.va + (u64)raw);
}

__device__ __forceinline__ i64 read_le(const Bytes& b, i64 off, int nbytes) {
  u64 v = 0;
  for (int k = 0; k < nbytes; ++k) v |= (u64)b.at(off + k) << (8 * k);
  return (i64)v;
}

__device__ __forceinline__ i64 read_be_signed(const Bytes& b, i64 off,
                                              int nbytes) {
  u64 v = 0;
  for (int k = 0; k < nbytes; ++k)
    v |= (u64)b.at(off + k) << (8 * (nbytes - 1 - k));
  i64 s = (i64)v;
  if (nbytes >= 8) return s;
  int bits = 8 * nbytes;
  return s - ((s >> (bits - 1)) << bits);
}

__device__ __forceinline__ i64 read_bss(const Bytes& b, i64 base,
                                        i64 stride, i64 local, int nbytes) {
  u64 v = 0;
  for (int k = 0; k < nbytes; ++k)
    v |= (u64)b.at(base + k * stride + local) << (8 * k);
  return (i64)v;
}

// the staged copy of the page table's window
struct PageStage {
  i64 ds[kPageBuf + 1], pb[kPageBuf], first[kPageBuf];
  int enc[kPageBuf];
};

// a column's page table, with an optional staged window
struct Pages {
  i64 npg;
  const i64* ds;
  const i64* pb;
  const int32_t* enc;
  const i64* first;
  const Win* w;
  const PageStage* s;
  __device__ __forceinline__ i64 of(i64 x) const {
    return find(ds, npg + 1, npg - 1, w, s ? s->ds : nullptr, x);
  }
  __device__ __forceinline__ bool staged(i64 pg) const {
    return w && w->staged && pg >= w->lo && pg <= w->hi;
  }
  // ds[pg]; the window stages ds[lo..hi + 1]
  __device__ __forceinline__ i64 start(i64 pg) const {
    return w && w->staged && pg >= w->lo && pg <= w->hi + 1
               ? s->ds[pg - w->lo] : ds[pg];
  }
  __device__ __forceinline__ i64 plain(i64 pg) const {
    return staged(pg) ? s->pb[pg - w->lo] : pb[pg];
  }
  __device__ __forceinline__ int encoding(i64 pg) const {
    return staged(pg) ? s->enc[pg - w->lo] : enc[pg];
  }
  __device__ __forceinline__ i64 first_value(i64 pg) const {
    return staged(pg) ? s->first[pg - w->lo] : first[pg];
  }
};

__device__ __forceinline__ Pages pages_at(const i64* d,
                                          const Win* w = nullptr,
                                          const PageStage* s = nullptr) {
  return Pages{d[F_NPG], ptr<i64>(d, F_DENSE_START), ptr<i64>(d, F_PLAIN_BYTE),
               ptr<int32_t>(d, F_PG_ENC), ptr<i64>(d, F_PG_FIRST), w, s};
}

__device__ __forceinline__ bool row_valid(const Bytes& b, const i64* d,
                                          const Runs& dl, i64 r, i64 n) {
  if (r >= n) return false;
  if (d[F_NDL] == 0) return true;
  return hybrid_lookup(b, dl, r) == 1;
}

// the value a lane adds to its column's dense-coordinate scan at p: a
// string value's byte footprint (PLAIN values carry a 4-byte length
// prefix), or a DELTA page's delta (0 at each page's first value)
__device__ __forceinline__ i64 dense_contrib(const Bytes& b, const i64* d,
                                             const Pages& pages, i64 p) {
  const i64 pgd = pages.of(p);
  const int encd = pages.encoding(pgd);
  if (d[F_KIND] == K_STR) {
    if (encd != PGE_PLAIN_STR && encd != PGE_DL_STR) return 0;
    return (i64)ptr<int32_t>(d, F_SLEN)[p] + (encd == PGE_PLAIN_STR ? 4 : 0);
  }
  if (encd != PGE_DELTA || p <= pages.start(pgd)) return 0;
  return delta_lookup(b, runs_at(d, F_NDR), p);
}

// block-local inclusive scan of SCAN_BLOCK int64 lanes (wrapping);
// returns the lane's inclusive value, *total the block's sum
__device__ i64 block_scan(i64 v, i64* total) {
  __shared__ i64 warp_sums[SCAN_BLOCK / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    i64 u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = (i64)((u64)v + (u64)u);
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    i64 s = lane < SCAN_BLOCK / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      i64 u = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s = (i64)((u64)s + (u64)u);
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v = (i64)((u64)v + (u64)warp_sums[warp - 1]);
  *total = warp_sums[SCAN_BLOCK / 32 - 1];
  __syncthreads();
  return v;
}

// pass 1: each block scans SCAN_BLOCK lanes of a column's rank and/or
// dense scan into part[slot][i]; the block's total goes to
// bsum[slot][block]
__global__ void scan_blocks(const int32_t* __restrict__ words, i64 nb,
                            const i64* __restrict__ desc, i64 n, i64 cap,
                            i64 nblk, i64* __restrict__ part,
                            i64* __restrict__ bsum) {
  const i64* d = desc + (i64)blockIdx.y * NF;
  Bytes b{reinterpret_cast<const uint8_t*>(words),
          reinterpret_cast<const uint32_t*>(words), nb};
  i64 i = (i64)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  i64 total;
  if (d[F_RANK_SLOT] >= 0) {
    i64 v = (i < cap && row_valid(b, d, runs_at(d, F_NDL), i, n)) ? 1 : 0;
    i64 s = block_scan(v, &total);
    i64 slot = d[F_RANK_SLOT];
    if (i < cap) part[slot * cap + i] = s;
    if (threadIdx.x == 0) bsum[slot * nblk + blockIdx.x] = total;
  }
  if (d[F_DENSE_SLOT] >= 0) {
    i64 v = i < cap ? dense_contrib(b, d, pages_at(d), i) : 0;
    i64 s = block_scan(v, &total);
    i64 slot = d[F_DENSE_SLOT];
    if (i < cap) part[slot * cap + i] = s;
    if (threadIdx.x == 0) bsum[slot * nblk + blockIdx.x] = total;
  }
}

__device__ void scan_sums_one(i64* s, i64 nblk) {
  i64 carry = 0;
  for (i64 base = 0; base < nblk; base += SCAN_BLOCK) {
    i64 i = base + threadIdx.x;
    i64 v = i < nblk ? s[i] : 0;
    i64 total;
    i64 incl = block_scan(v, &total);
    if (i < nblk) s[i] = (i64)((u64)carry + (u64)incl - (u64)v);
    carry = (i64)((u64)carry + (u64)total);
  }
}

// pass 2: block sums -> exclusive block prefixes, in place, per column
__global__ void scan_sums(const i64* __restrict__ desc, i64 nblk,
                          i64* __restrict__ bsum) {
  const i64* d = desc + (i64)blockIdx.x * NF;
  if (d[F_RANK_SLOT] >= 0) scan_sums_one(bsum + d[F_RANK_SLOT] * nblk, nblk);
  if (d[F_DENSE_SLOT] >= 0)
    scan_sums_one(bsum + d[F_DENSE_SLOT] * nblk, nblk);
}

struct Scans {
  const i64* part;
  const i64* bsum;
  i64 cap, nblk;
  // inclusive prefix sum of slot at lane i
  __device__ __forceinline__ i64 incl(i64 slot, i64 i) const {
    return (i64)((u64)part[slot * cap + i] +
                 (u64)bsum[slot * nblk + i / SCAN_BLOCK]);
  }
};

// row r's dense value index: its rank among valid rows, or min(r, n - 1)
// without definition levels
__device__ __forceinline__ i64 dense_index(const i64* d, const Scans& sc,
                                           i64 r, i64 n, i64 cap) {
  i64 j = d[F_RANK_SLOT] >= 0 ? sc.incl(d[F_RANK_SLOT], r) - 1
                              : (r < n ? r : n - 1);
  return clampi(j, 0, cap - 1);
}

__device__ __forceinline__ void store_row_bytes(uint8_t* out_row,
                                                const uint8_t* src_row,
                                                i64 char_cap) {
  u64* o = reinterpret_cast<u64*>(out_row);
  const u64* s = reinterpret_cast<const u64*>(src_row);
  for (i64 w = 0; w < char_cap / 8; ++w) o[w] = s ? s[w] : 0ULL;
}

__device__ void decode_string(const Bytes& b, const i64* d,
                              const Pages& pages, const Scans& sc, i64 r,
                              i64 j, i64 pg, bool valid, i64 cap, i64 didx,
                              bool is_dict_pg) {
  i64 char_cap = d[F_CHAR_CAP];
  uint8_t* chars = reinterpret_cast<uint8_t*>(d[F_OUT0]) + r * char_cap;
  int32_t* lengths = reinterpret_cast<int32_t*>(d[F_OUT1]);
  if (!valid) {
    store_row_bytes(chars, nullptr, char_cap);
    lengths[r] = 0;
    return;
  }
  if (didx >= 0 && is_dict_pg) {
    store_row_bytes(chars, ptr<uint8_t>(d, F_DICT0) + didx * char_cap,
                    char_cap);
    lengths[r] = ptr<int32_t>(d, F_DICT1)[didx];
    return;
  }
  if (d[F_SLEN] == 0) {  // no PLAIN/DELTA_LENGTH pages in this chunk
    store_row_bytes(chars, nullptr, char_cap);
    lengths[r] = 0;
    return;
  }
  // start of dense value j: the page's byte start plus the footprints
  // of the page's values before j (exclusive segmented prefix sum)
  i64 slot = d[F_DENSE_SLOT];
  i64 based = clampi(pages.start(pg), 0, cap - 1);
  i64 excl_j = sc.incl(slot, j) - dense_contrib(b, d, pages, j);
  i64 excl_b = sc.incl(slot, based) - dense_contrib(b, d, pages, based);
  i64 lp = pages.encoding(pg) == PGE_PLAIN_STR ? 4 : 0;
  i64 start = pages.plain(pg) + (excl_j - excl_b) + lp;
  int32_t len = ptr<int32_t>(d, F_SLEN)[j];
  u64* o = reinterpret_cast<u64*>(chars);
  for (i64 w = 0; w < char_cap / 8; ++w) {
    u64 word = 0;
    for (int k = 0; k < 8; ++k) {
      i64 c = w * 8 + k;
      if (c < len) word |= (u64)b.at(start + c) << (8 * k);
    }
    o[w] = word;
  }
  lengths[r] = len;
}

// the rest of one row once its validity, dense index j, value-run value
// v, page pg and (dg) dictionary entry g0/g1 are known: what the JAX body
// selects for the row, written to every output of the column
__device__ __forceinline__ void finish_row(const Bytes& b, const i64* d,
                           const Pages& pages, const Scans& sc, i64 r,
                           i64 n, i64 cap, bool first_col, bool* active,
                           bool valid, i64 j, i64 v, i64 pg, int enc_pg,
                           i64 off, bool dg, u64 g0, u64 g1) {
  const int kind = (int)d[F_KIND];
  if (first_col) active[r] = r < n;
  bool* validity = reinterpret_cast<bool*>(
      d[(kind == K_STR || kind == K_DEC128) ? F_OUT2 : F_OUT1]);
  validity[r] = valid;
  if (kind == K_BOOL) {
    reinterpret_cast<bool*>(d[F_OUT0])[r] = valid && v != 0;
    return;
  }
  if (kind == K_STR) {
    const i64 char_cap = d[F_CHAR_CAP];
    uint8_t* chars = reinterpret_cast<uint8_t*>(d[F_OUT0]) + r * char_cap;
    int32_t* lengths = reinterpret_cast<int32_t*>(d[F_OUT1]);
    if (!valid) {
      store_row_bytes(chars, nullptr, char_cap);
      lengths[r] = 0;
    } else if (dg) {
      if (char_cap == 8) {
        *reinterpret_cast<u64*>(chars) = g0;
      } else {
        const i64 didx = clampi(v, 0, d[F_DICT_ROWS] - 1);
        store_row_bytes(chars, ptr<uint8_t>(d, F_DICT0) + didx * char_cap,
                        char_cap);
      }
      lengths[r] = (int32_t)g1;
    } else {
      decode_string(b, d, pages, sc, r, j, pg, true, cap, -1, false);
    }
    return;
  }
  const int eb = (int)d[F_ELEM_BYTES];
  if (kind == K_DEC128) {
    i64 hi = 0, lo = 0;
    if (valid && dg) {
      hi = (i64)g0;
      lo = (i64)g1;
    } else if (valid && d[F_HAS_PLAIN]) {
      hi = read_be_signed(b, off, eb - 8);
      u64 l = 0;
      for (int k = 0; k < 8; ++k)
        l |= (u64)b.at(off + (eb - 8) + k) << (8 * (7 - k));
      lo = (i64)l;
    }
    reinterpret_cast<i64*>(d[F_OUT0])[r] = hi;
    reinterpret_cast<i64*>(d[F_OUT1])[r] = lo;
    return;
  }
  // fixed-width scalar kinds, selected in the int64 bit domain
  i64 x = 0;
  if (valid && dg) {
    x = (i64)g0;
  } else if (valid) {
    if (d[F_HAS_PLAIN])
      x = kind == K_DEC64 ? read_be_signed(b, off, eb) : read_le(b, off, eb);
    if (d[F_HAS_BSS] && enc_pg == PGE_BSS) {
      const i64 pg_start = pages.start(pg);
      const i64 stride = clampi(pages.start(pg + 1) - pg_start, 0, cap);
      x = read_bss(b, pages.plain(pg), stride, j - pg_start, eb);
    }
    if (d[F_HAS_DELTA] && enc_pg == PGE_DELTA) {
      const i64 slot = d[F_DENSE_SLOT];
      const i64 based = clampi(pages.start(pg), 0, cap - 1);
      x = (i64)((u64)pages.first_value(pg) +
                ((u64)sc.incl(slot, j) - (u64)sc.incl(slot, based)));
    }
  }
  void* out = reinterpret_cast<void*>(d[F_OUT0]);
  if (kind == K_F32) {
    reinterpret_cast<float*>(out)[r] =
        valid ? __int_as_float((int32_t)x) : 0.0f;
  } else if (kind == K_F64) {
    reinterpret_cast<double*>(out)[r] = valid ? __longlong_as_double(x) : 0.0;
  } else {
    if (d[F_SEXT32]) x = (i64)(int32_t)x;
    if (!valid) x = 0;
    switch (d[F_OUT_BYTES]) {
      case 1: reinterpret_cast<int8_t*>(out)[r] = (int8_t)x; break;
      case 2: reinterpret_cast<int16_t*>(out)[r] = (int16_t)x; break;
      case 4: reinterpret_cast<int32_t*>(out)[r] = (int32_t)x; break;
      default: reinterpret_cast<i64*>(out)[r] = x; break;
    }
  }
}

// a block's shared state for one tile
struct Tile {
  i64 d[NF];
  Win dl, vr, pg;
  int fits;
  int whole, next_whole;  // the staged windows hold whole tables
  RunStage dl_s, vr_s;
  PageStage pg_s;
};

template <typename T>
__device__ __forceinline__ void stage_copy(T* dst, const T* src, i64 count) {
  for (i64 i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__device__ void stage_runs(RunStage& s, const Win& w, const i64* d,
                           int f_n) {
  if (!w.staged) return;
  const i64 k = w.hi - w.lo + 1;
  stage_copy(s.os, ptr<i64>(d, f_n + 1) + w.lo, k);
  stage_copy(s.pk, ptr<bool>(d, f_n + 2) + w.lo, k);
  stage_copy(s.va, ptr<i64>(d, f_n + 3) + w.lo, k);
  stage_copy(s.bs, ptr<i64>(d, f_n + 4) + w.lo, k);
  const i64* wd = ptr<i64>(d, f_n + 5) + w.lo;
  for (i64 i = threadIdx.x; i < k; i += blockDim.x) s.wd[i] = (int)wd[i];
}

// the decode proper: tiles of tile_rows rows of one column per block,
// decoded in chunks of kRows rows a thread
template <int kRows>
__global__ void __launch_bounds__(kThreads, 4)
decode_tiles(const int32_t* __restrict__ words, i64 nb,
             const i64* __restrict__ desc, int ncols, i64 n, i64 cap,
             i64 tile_rows, const i64* __restrict__ part,
             const i64* __restrict__ bsum, i64 nblk,
             bool* __restrict__ active) {
  constexpr int kChunk = kRows * kThreads;
  __shared__ Tile t;
  const Bytes b{reinterpret_cast<const uint8_t*>(words),
                reinterpret_cast<const uint32_t*>(words), nb};
  const Scans sc{part, bsum, cap, nblk};
  const i64* d = t.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const i64 ntiles = (cap + tile_rows - 1) / tile_rows;
  // work items run column by column, so a block that stays on a column
  // keeps its descriptor and, when every table fits whole, its staging
  int loaded = -1;
  for (i64 work = blockIdx.x; work < ntiles * ncols; work += gridDim.x) {
    const int col = (int)(work / ntiles);
    const i64 r0 = (work % ntiles) * tile_rows;
    const i64 r1 = r0 + tile_rows < cap ? r0 + tile_rows : cap;
    __syncthreads();  // the previous tile is done with t
    if (col != loaded) {
      if (threadIdx.x < NF)
        t.d[threadIdx.x] = desc[(i64)col * NF + threadIdx.x];
      if (threadIdx.x == 0) {
        // a tile of one chunk (a small batch) gives each thread one row:
        // windows would save it no search, only add a staging round trip
        // and barriers, so its lookups search the tables in global memory
        t.whole = tile_rows <= kChunk;
        if (t.whole) t.dl = t.vr = t.pg = Win{1, 0, 0, 0, 0};
      }
      loaded = col;
      __syncthreads();
    }
    const int kind = (int)d[F_KIND];
    const bool has_dl = d[F_NDL] > 0, has_vr = d[F_NVR] > 0;
    const bool has_dict = has_vr && d[F_DICT_ROWS] > 0;
    const bool dl_whole = d[F_NDL] <= kRunBuf;
    for (i64 s0 = r0; s0 < r1;) {
      i64 len = r1 - s0;
      for (; !t.whole;) {
        // -- the sub-tile's windows, one search per warp ---------------
        const i64 s1 = s0 + len;
        // (a table that fits its buffer whole is staged whole, for every
        // query, without a search)
        if (warp < 2 && has_dl && (dl_whole || s0 < n)) {
          const i64 x = warp == 0 ? s0 : (s1 < n ? s1 : n) - 1;
          const bool whole = dl_whole;
          const i64 v = whole ? (warp == 0 ? 0 : d[F_NDL] - 1)
                              : warp_find(ptr<i64>(d, F_DL_OS), d[F_NDL],
                                          d[F_NDL] - 1, x);
          if (lane == 0) {
            (warp == 0 ? t.dl.lo : t.dl.hi) = v;
            (warp == 0 ? t.dl.xlo : t.dl.xhi) =
                whole ? (warp == 0 ? kAll0 : kAll1) : x;
          }
        } else if (warp >= 2 && warp < 6) {
          const bool hi_end = warp & 1;
          if (warp < 4 && has_vr) {
            const bool whole = d[F_NVR] <= kRunBuf;
            const i64 x = whole ? 0 : dense_index(d, sc, hi_end ? s1 - 1 : s0,
                                                  n, cap);
            const i64 v = whole ? (hi_end ? d[F_NVR] - 1 : 0)
                                : warp_find(ptr<i64>(d, F_VR_OS), d[F_NVR],
                                            d[F_NVR] - 1, x);
            if (lane == 0) {
              (hi_end ? t.vr.hi : t.vr.lo) = v;
              (hi_end ? t.vr.xhi : t.vr.xlo) =
                  whole ? (hi_end ? kAll1 : kAll0) : x;
            }
          } else if (warp >= 4) {
            const bool whole = d[F_NPG] <= kPageBuf;
            const i64 x = whole ? 0 : dense_index(d, sc, hi_end ? s1 - 1 : s0,
                                                  n, cap);
            const i64 pg = whole ? (hi_end ? d[F_NPG] - 1 : 0)
                                 : warp_find(ptr<i64>(d, F_DENSE_START),
                                             d[F_NPG] + 1, d[F_NPG] - 1, x);
            if (lane == 0) {
              (hi_end ? t.pg.hi : t.pg.lo) = pg;
              (hi_end ? t.pg.xhi : t.pg.xlo) =
                  whole ? (hi_end ? kAll1 : kAll0) : x;
            }
          }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          const bool dl_here = has_dl && (dl_whole || s0 < n);
          if (!dl_here) {  // an empty window: no row looks levels up
            t.dl.xlo = 1;
            t.dl.xhi = 0;
          }
          if (!has_vr) {
            t.vr.xlo = 1;
            t.vr.xhi = 0;
          }
          const bool dl_fit = !dl_here || t.dl.hi - t.dl.lo < kRunBuf;
          const bool vr_fit = !has_vr || t.vr.hi - t.vr.lo < kRunBuf;
          const bool pg_fit = t.pg.hi - t.pg.lo < kPageBuf;
          t.fits = dl_fit && vr_fit && pg_fit;
          t.dl.staged = dl_here && dl_fit;
          t.vr.staged = has_vr && vr_fit;
          t.pg.staged = pg_fit;
          // every table whole: this staging serves the rest of the column
          t.next_whole = (!has_dl || dl_whole) &&
                         (!has_vr || d[F_NVR] <= kRunBuf) &&
                         d[F_NPG] <= kPageBuf;
        }
        __syncthreads();
        if (t.fits || len <= kThreads) break;
        len = (len + 1) / 2;
        __syncthreads();  // every thread has read t.fits
      }
      // -- stage the windows ---------------------------------------------
      if (!t.whole) {
        stage_runs(t.dl_s, t.dl, d, F_NDL);
        stage_runs(t.vr_s, t.vr, d, F_NVR);
        if (t.pg.staged) {
          const i64 k = t.pg.hi - t.pg.lo + 1;
          stage_copy(t.pg_s.ds, ptr<i64>(d, F_DENSE_START) + t.pg.lo, k + 1);
          stage_copy(t.pg_s.pb, ptr<i64>(d, F_PLAIN_BYTE) + t.pg.lo, k);
          stage_copy(t.pg_s.enc, ptr<int32_t>(d, F_PG_ENC) + t.pg.lo, k);
          if (d[F_HAS_DELTA])
            stage_copy(t.pg_s.first, ptr<i64>(d, F_PG_FIRST) + t.pg.lo, k);
        }
        __syncthreads();
        if (threadIdx.x == 0) t.whole = t.next_whole;
      }
      __syncthreads();
      const Runs dl = runs_at(d, F_NDL, &t.dl, &t.dl_s);
      const Runs vr = runs_at(d, F_NVR, &t.vr, &t.vr_s);
      const Pages pages = pages_at(d, &t.pg, &t.pg_s);
      const i64 s1 = s0 + len;
      // each thread's cursors into the level runs, value runs and pages,
      // found once for its first row and moved forward from there
      i64 dl_i = 0, vr_i = 0, pg_i = 0;
      {
        const i64 r = s0 + threadIdx.x < s1 ? s0 + threadIdx.x : s0;
        if (has_dl && r < n) dl_i = run_index(dl, r);
        const i64 j0 = dense_index(d, sc, r, n, cap);
        if (has_vr) vr_i = run_index(vr, j0);
        pg_i = pages.of(j0);
      }
      for (i64 c0 = s0; c0 < s1; c0 += kChunk) {
        const i64 c1 = c0 + kChunk < s1 ? c0 + kChunk : s1;
        // -- phase A: validity, dense index, value-run value -------------
        bool valid[kRows];
        i64 j[kRows], v[kRows];
        {
          Probe p[kRows];
          uint32_t lo[kRows], hi[kRows];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const i64 r = c0 + threadIdx.x + k * kThreads;
            p[k] = Probe{1, -1};
            if (has_dl && r < c1 && r < n) {
              dl_i = advance(dl.os, t.dl, t.dl_s.os, t.dl.hi, dl_i,
                             dl.n - 1, r);
              p[k] = probe_at(dl, dl_i, r);
            }
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) probe_words(b, p[k], lo[k], hi[k]);
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const i64 r = c0 + threadIdx.x + k * kThreads;
            valid[k] = r < c1 && r < n && probe_value(p[k], lo[k], hi[k]) == 1;
            j[k] = dense_index(d, sc, r < c1 ? r : c0, n, cap);
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const i64 r = c0 + threadIdx.x + k * kThreads;
            p[k] = Probe{0, -1};
            if (has_vr && r < c1) {
              vr_i = advance(vr.os, t.vr, t.vr_s.os, t.vr.hi, vr_i,
                             vr.n - 1, j[k]);
              p[k] = probe_at(vr, vr_i, j[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < kRows; ++k) probe_words(b, p[k], lo[k], hi[k]);
#pragma unroll
          for (int k = 0; k < kRows; ++k) v[k] = probe_value(p[k], lo[k], hi[k]);
        }
        // -- phase B: pages and dictionary entries, then the outputs -----
        i64 pg[kRows], off[kRows];
        int enc[kRows];
        u64 g0[kRows], g1[kRows];
        bool dg[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const i64 r = c0 + threadIdx.x + k * kThreads;
          pg[k] = off[k] = 0;
          enc[k] = -1;
          if (kind != K_BOOL && r < c1) {
            pg_i = advance(pages.ds, t.pg, t.pg_s.ds, t.pg.hi + 1, pg_i,
                           pages.npg - 1, j[k]);
            pg[k] = pg_i;
            enc[k] = pages.encoding(pg[k]);
            if (d[F_HAS_PLAIN])
              off[k] = pages.plain(pg[k]) +
                       (j[k] - pages.start(pg[k])) * d[F_ELEM_BYTES];
          }
          dg[k] = has_dict && kind != K_BOOL && valid[k] &&
                  enc[k] == PGE_DICT;
          g0[k] = g1[k] = 0;
          if (dg[k]) {
            const i64 didx = clampi(v[k], 0, d[F_DICT_ROWS] - 1);
            if (kind == K_STR) {
              if (d[F_CHAR_CAP] == 8) g0[k] = __ldg(ptr<u64>(d, F_DICT0) + didx);
              g1[k] = (u64)__ldg(ptr<int32_t>(d, F_DICT1) + didx);
            } else {
              g0[k] = (u64)__ldg(ptr<i64>(d, F_DICT0) + didx);
              if (kind == K_DEC128) g1[k] = (u64)__ldg(ptr<i64>(d, F_DICT1) + didx);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const i64 r = c0 + threadIdx.x + k * kThreads;
          if (r < c1)
            finish_row(b, d, pages, sc, r, n, cap, col == 0, active,
                       valid[k], j[k], v[k], pg[k], enc[k], off[k], dg[k],
                       g0[k], g1[k]);
        }
      }
      s0 = s1;
      __syncthreads();  // the next sub-tile restages t
    }
  }
}

// a batch of fewer values than this decodes one row a thread (more
// blocks in flight where the tiles' setup dominates), else two; the
// autotuner's rowsPerThread overrides the choice (1, 2 or 4), which
// trades live registers for parallelism without changing a byte
constexpr i64 kSmallBatch = 1 << 21;

// decode_tiles<kRows> on as many blocks as fit on the SMs, at most one a
// work item; rows a tile: the largest of 4, 2 or 1 chunks that still
// gives every block a work item
template <int kRows>
cudaError_t launch_tiles(const int32_t* words, i64 nb, const i64* desc,
                         int ncols, i64 n, i64 cap, const i64* part,
                         const i64* bsum, i64 nblk, bool* active,
                         cudaStream_t s) {
  const i64 chunk = (i64)kRows * kThreads;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, decode_tiles<kRows>, kThreads, 0)) != cudaSuccess)
    return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const i64 blocks = (i64)per_sm * sms;
  i64 rows = 4 * chunk;
  while (rows > chunk && ((cap + rows - 1) / rows) * ncols < blocks)
    rows /= 2;
  const i64 work = ((cap + rows - 1) / rows) * ncols;
  decode_tiles<kRows><<<(int)(work < blocks ? work : blocks), kThreads, 0,
                        s>>>(words, nb, desc, ncols, n, cap, rows, part,
                             bsum, nblk, active);
  return cudaGetLastError();
}

}  // namespace

// words: the page bytes as int32 words (nb = 4 * word count); desc:
// (ncols, NF) int64 column descriptors on the device; n rows of capacity
// cap. part: (n_slots, cap) int64 and bsum: (n_slots, nblk) int64 scan
// scratch, nblk = ceil(cap / 1024), unused (null) when n_slots is 0.
// active: (cap,) bool. rows_per_thread: 1, 2 or 4 rows a thread decodes
// in each chunk, or 0 for the choice by batch size. Returns
// cudaGetLastError() after the launches, or the error that refused one.
extern "C" int decode_fused_launch(const void* words, long long nb,
                                   const void* desc, int ncols, long long n,
                                   long long cap, int n_slots, void* part,
                                   void* bsum, void* active,
                                   int rows_per_thread, void* stream) {
  if (ncols <= 0 || ncols > 65535 || cap <= 0 || n < 0 || n > cap ||
      nb <= 0 || (nb & 3) != 0 ||
      (rows_per_thread != 0 && rows_per_thread != 1 &&
       rows_per_thread != 2 && rows_per_thread != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  i64 nblk = (cap + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (n_slots > 0) {
    if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
    dim3 g1((unsigned)nblk, (unsigned)ncols);
    scan_blocks<<<g1, SCAN_BLOCK, 0, s>>>(
        (const int32_t*)words, nb, (const i64*)desc, n, cap, nblk,
        (i64*)part, (i64*)bsum);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_sums<<<ncols, SCAN_BLOCK, 0, s>>>((const i64*)desc, nblk,
                                           (i64*)bsum);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (rows_per_thread == 0) rows_per_thread = cap * ncols < kSmallBatch ? 1 : 2;
  auto launch = rows_per_thread == 1   ? launch_tiles<1>
                : rows_per_thread == 2 ? launch_tiles<2>
                                       : launch_tiles<4>;
  return (int)launch((const int32_t*)words, nb, (const i64*)desc, ncols, n,
                     cap, (const i64*)part, (const i64*)bsum, nblk,
                     (bool*)active, s);
}
