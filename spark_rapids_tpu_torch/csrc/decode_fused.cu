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
// every output written once, at 3.35 TB/s; the work per value is a few
// binary-search steps and shifts.
//
// Design: one thread per row and column (blockIdx.y = column), each doing
// what the JAX body does for its lane: the page by binary search (upper
// bound) in the page table, the run by binary search in the run table,
// the bit-packed read through a 5-byte window (two for widths up to 64),
// the PLAIN little-endian or FLBA big-endian read (sign extension, limbs)
// or the BYTE_STREAM_SPLIT gather, the dictionary gather, the mask by
// validity. Every byte index is clamped into the buffer as jnp clamps
// it, so out-of-range lanes read the same garbage as the reference before
// the validity mask clears them; all 64-bit arithmetic wraps (unsigned).
// Three values are prefix sums, taken by a hand-written scan in the same
// source: the row's rank among valid rows (definition levels), the string
// offsets (a per-page segmented sum over byte footprints) and the DELTA
// reconstruction (a per-page segmented sum of deltas). The scan is a
// block-local scan of 1024 lanes (scan_blocks) plus one scan of the block
// sums (scan_sums); the decode kernel adds the block prefix as it reads,
// so there is no third pass. A column without definition levels needs no
// rank scan: its rank is min(row, n - 1). Launches per batch: 1 when no
// column needs a scan (q1's row groups), else 3. All on the caller's
// stream; nothing synchronises.
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

typedef long long i64;
typedef unsigned long long u64;

struct Bytes {
  const uint8_t* p;
  i64 nb;
  __device__ __forceinline__ i64 at(i64 i) const {
    i = i < 0 ? 0 : (i >= nb ? nb - 1 : i);
    return (i64)p[i];
  }
};

struct Runs {
  i64 n;
  const i64* os;
  const bool* pk;
  const i64* va;
  const i64* bs;
  const i64* wd;
};

template <typename T>
__device__ __forceinline__ const T* ptr(const i64* d, int f) {
  return reinterpret_cast<const T*>(d[f]);
}

__device__ __forceinline__ Runs runs_at(const i64* d, int f_n) {
  Runs r;
  r.n = d[f_n];
  r.os = ptr<i64>(d, f_n + 1);
  r.pk = ptr<bool>(d, f_n + 2);
  r.va = ptr<i64>(d, f_n + 3);
  r.bs = ptr<i64>(d, f_n + 4);
  r.wd = ptr<i64>(d, f_n + 5);
  return r;
}

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

__device__ __forceinline__ i64 clampi(i64 v, i64 lo, i64 hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ops/rle.py read_packed: width <= 32 bits at bit_off, 5-byte window
__device__ __forceinline__ i64 read_packed(const Bytes& b, i64 bit_off,
                                           i64 width) {
  i64 byte0 = bit_off >> 3;
  i64 shift = bit_off & 7;
  u64 word = 0;
  for (int k = 0; k < 5; ++k) word |= (u64)b.at(byte0 + k) << (8 * k);
  u64 mask = width >= 64 ? ~0ULL : ((1ULL << width) - 1ULL);
  return (i64)((word >> shift) & mask);
}

// ops/rle.py read_packed64: widths up to 64 as two <= 32-bit reads
__device__ __forceinline__ i64 read_packed64(const Bytes& b, i64 bit_off,
                                             i64 width) {
  i64 lo = read_packed(b, bit_off, width < 32 ? width : 32);
  i64 hi = read_packed(b, bit_off + 32, width > 32 ? width - 32 : 0);
  return (i64)((u64)lo | ((u64)hi << 32));
}

__device__ __forceinline__ i64 run_of(const Runs& r, i64 pos) {
  return clampi(upper_bound(r.os, r.n, pos) - 1, 0, r.n - 1);
}

// ops/rle.py hybrid_lookup
__device__ __forceinline__ i64 hybrid_lookup(const Bytes& b, const Runs& r,
                                             i64 pos) {
  i64 rid = run_of(r, pos);
  i64 w = r.wd[rid];
  i64 v = read_packed(b, r.bs[rid] + (pos - r.os[rid]) * w, w);
  return r.pk[rid] ? v : r.va[rid];
}

// ops/rle.py delta_lookup
__device__ __forceinline__ i64 delta_lookup(const Bytes& b, const Runs& r,
                                            i64 pos) {
  i64 rid = run_of(r, pos);
  i64 w = r.wd[rid];
  i64 raw = read_packed64(b, r.bs[rid] + (pos - r.os[rid]) * w, w);
  return (i64)((u64)r.va[rid] + (u64)raw);
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

__device__ __forceinline__ i64 page_of(const i64* d, i64 x) {
  i64 npg = d[F_NPG];
  return clampi(upper_bound(ptr<i64>(d, F_DENSE_START), npg + 1, x) - 1, 0,
                npg - 1);
}

__device__ __forceinline__ bool row_valid(const Bytes& b, const i64* d,
                                          i64 r, i64 n) {
  if (r >= n) return false;
  if (d[F_NDL] == 0) return true;
  return hybrid_lookup(b, runs_at(d, F_NDL), r) == 1;
}

// the value a lane adds to its column's dense-coordinate scan at p: a
// string value's byte footprint (PLAIN values carry a 4-byte length
// prefix), or a DELTA page's delta (0 at each page's first value)
__device__ __forceinline__ i64 dense_contrib(const Bytes& b, const i64* d,
                                             i64 p) {
  i64 pgd = page_of(d, p);
  int encd = ptr<int32_t>(d, F_PG_ENC)[pgd];
  if (d[F_KIND] == K_STR) {
    if (encd != PGE_PLAIN_STR && encd != PGE_DL_STR) return 0;
    return (i64)ptr<int32_t>(d, F_SLEN)[p] + (encd == PGE_PLAIN_STR ? 4 : 0);
  }
  if (encd != PGE_DELTA || p <= ptr<i64>(d, F_DENSE_START)[pgd]) return 0;
  return delta_lookup(b, runs_at(d, F_NDR), p);
}

// block-local inclusive scan of SCAN_BLOCK int64 lanes (wrapping);
// returns the lane's inclusive value, *total the block's sum
__device__ i64 block_scan(i64 v, i64* total) {
  __shared__ i64 warp_sums[SCAN_BLOCK / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    i64 u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = (i64)((u64)v + (u64)u);
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    i64 s = lane < SCAN_BLOCK / 32 ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      i64 u = __shfl_up_sync(0xffffffffu, s, o);
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
  Bytes b{reinterpret_cast<const uint8_t*>(words), nb};
  i64 i = (i64)blockIdx.x * SCAN_BLOCK + threadIdx.x;
  i64 total;
  if (d[F_RANK_SLOT] >= 0) {
    i64 v = (i < cap && row_valid(b, d, i, n)) ? 1 : 0;
    i64 s = block_scan(v, &total);
    i64 slot = d[F_RANK_SLOT];
    if (i < cap) part[slot * cap + i] = s;
    if (threadIdx.x == 0) bsum[slot * nblk + blockIdx.x] = total;
  }
  if (d[F_DENSE_SLOT] >= 0) {
    i64 v = i < cap ? dense_contrib(b, d, i) : 0;
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

__device__ __forceinline__ void store_row_bytes(uint8_t* out_row,
                                                const uint8_t* src_row,
                                                i64 char_cap) {
  u64* o = reinterpret_cast<u64*>(out_row);
  const u64* s = reinterpret_cast<const u64*>(src_row);
  for (i64 w = 0; w < char_cap / 8; ++w) o[w] = s ? s[w] : 0ULL;
}

__device__ void decode_string(const Bytes& b, const i64* d, const Scans& sc,
                              i64 r, i64 j, bool valid, i64 cap, i64 didx,
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
  const i64* ds = ptr<i64>(d, F_DENSE_START);
  const int32_t* pg_enc = ptr<int32_t>(d, F_PG_ENC);
  i64 slot = d[F_DENSE_SLOT];
  i64 pgd = page_of(d, j);
  i64 based = clampi(ds[pgd], 0, cap - 1);
  i64 excl_j = sc.incl(slot, j) - dense_contrib(b, d, j);
  i64 excl_b = sc.incl(slot, based) - dense_contrib(b, d, based);
  i64 lp = pg_enc[pgd] == PGE_PLAIN_STR ? 4 : 0;
  i64 start = ptr<i64>(d, F_PLAIN_BYTE)[pgd] + (excl_j - excl_b) + lp;
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

// the decode proper: one thread per (row, column)
__global__ void decode_rows(const int32_t* __restrict__ words, i64 nb,
                            const i64* __restrict__ desc, i64 n, i64 cap,
                            const i64* __restrict__ part,
                            const i64* __restrict__ bsum, i64 nblk,
                            bool* __restrict__ active) {
  const i64* d = desc + (i64)blockIdx.y * NF;
  Bytes b{reinterpret_cast<const uint8_t*>(words), nb};
  Scans sc{part, bsum, cap, nblk};
  const int kind = (int)d[F_KIND];
  for (i64 r = (i64)blockIdx.x * blockDim.x + threadIdx.x; r < cap;
       r += (i64)gridDim.x * blockDim.x) {
    if (blockIdx.y == 0) active[r] = r < n;
    const bool valid = row_valid(b, d, r, n);
    // rank of the row among valid rows: its dense value index
    i64 j = d[F_RANK_SLOT] >= 0 ? sc.incl(d[F_RANK_SLOT], r) - 1
                                : (r < n ? r : n - 1);
    j = clampi(j, 0, cap - 1);
    bool* validity = reinterpret_cast<bool*>(
        d[(kind == K_STR || kind == K_DEC128) ? F_OUT2 : F_OUT1]);
    validity[r] = valid;
    if (kind == K_BOOL) {
      i64 v = hybrid_lookup(b, runs_at(d, F_NVR), j);
      reinterpret_cast<bool*>(d[F_OUT0])[r] = valid && v != 0;
      continue;
    }
    const i64* ds = ptr<i64>(d, F_DENSE_START);
    const i64 pg = page_of(d, j);
    const i64 local = j - ds[pg];
    const int enc_pg = ptr<int32_t>(d, F_PG_ENC)[pg];
    const bool is_dict_pg = enc_pg == PGE_DICT;
    i64 didx = -1;
    if (d[F_NVR] > 0 && d[F_DICT_ROWS] > 0)
      didx = clampi(hybrid_lookup(b, runs_at(d, F_NVR), j), 0,
                    d[F_DICT_ROWS] - 1);
    if (kind == K_STR) {
      decode_string(b, d, sc, r, j, valid, cap, didx, is_dict_pg);
      continue;
    }
    const int eb = (int)d[F_ELEM_BYTES];
    const i64 off = ptr<i64>(d, F_PLAIN_BYTE)[pg] + local * eb;
    if (kind == K_DEC128) {
      i64 hi = 0, lo = 0;
      if (d[F_HAS_PLAIN]) {
        hi = read_be_signed(b, off, eb - 8);
        u64 l = 0;
        for (int k = 0; k < 8; ++k)
          l |= (u64)b.at(off + (eb - 8) + k) << (8 * (7 - k));
        lo = (i64)l;
      }
      if (didx >= 0 && is_dict_pg) {
        hi = ptr<i64>(d, F_DICT0)[didx];
        lo = ptr<i64>(d, F_DICT1)[didx];
      }
      reinterpret_cast<i64*>(d[F_OUT0])[r] = valid ? hi : 0;
      reinterpret_cast<i64*>(d[F_OUT1])[r] = valid ? lo : 0;
      continue;
    }
    // fixed-width scalar kinds, selected in the int64 bit domain
    i64 v = 0;
    if (d[F_HAS_PLAIN])
      v = kind == K_DEC64 ? read_be_signed(b, off, eb) : read_le(b, off, eb);
    if (d[F_HAS_BSS] && enc_pg == PGE_BSS) {
      i64 stride = clampi(ds[pg + 1] - ds[pg], 0, cap);
      v = read_bss(b, ptr<i64>(d, F_PLAIN_BYTE)[pg], stride, local, eb);
    }
    if (d[F_HAS_DELTA] && enc_pg == PGE_DELTA) {
      i64 slot = d[F_DENSE_SLOT];
      i64 pgd = page_of(d, j);
      i64 based = clampi(ds[pgd], 0, cap - 1);
      v = (i64)((u64)ptr<i64>(d, F_PG_FIRST)[pgd] +
                ((u64)sc.incl(slot, j) - (u64)sc.incl(slot, based)));
    }
    if (didx >= 0 && is_dict_pg) v = ptr<i64>(d, F_DICT0)[didx];
    void* out = reinterpret_cast<void*>(d[F_OUT0]);
    if (kind == K_F32) {
      reinterpret_cast<float*>(out)[r] =
          valid ? __int_as_float((int32_t)v) : 0.0f;
    } else if (kind == K_F64) {
      reinterpret_cast<double*>(out)[r] =
          valid ? __longlong_as_double(v) : 0.0;
    } else {
      if (d[F_SEXT32]) v = (i64)(int32_t)v;
      if (!valid) v = 0;
      switch (d[F_OUT_BYTES]) {
        case 1: reinterpret_cast<int8_t*>(out)[r] = (int8_t)v; break;
        case 2: reinterpret_cast<int16_t*>(out)[r] = (int16_t)v; break;
        case 4: reinterpret_cast<int32_t*>(out)[r] = (int32_t)v; break;
        default: reinterpret_cast<i64*>(out)[r] = v; break;
      }
    }
  }
}

int grid_for(i64 n) {
  i64 blocks = (n + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// words: the page bytes as int32 words (nb = 4 * word count); desc:
// (ncols, NF) int64 column descriptors on the device; n rows of capacity
// cap. part: (n_slots, cap) int64 and bsum: (n_slots, nblk) int64 scan
// scratch, nblk = ceil(cap / 1024), unused (null) when n_slots is 0.
// active: (cap,) bool. Returns cudaGetLastError() after the launches.
extern "C" int decode_fused_launch(const void* words, long long nb,
                                   const void* desc, int ncols, long long n,
                                   long long cap, int n_slots, void* part,
                                   void* bsum, void* active, void* stream) {
  if (ncols <= 0 || ncols > 65535 || cap <= 0 || n < 0 || n > cap ||
      nb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  i64 nblk = (cap + SCAN_BLOCK - 1) / SCAN_BLOCK;
  if (n_slots > 0) {
    if (nblk > 2147483647LL) return (int)cudaErrorInvalidValue;
    dim3 g1((unsigned)nblk, (unsigned)ncols);
    scan_blocks<<<g1, SCAN_BLOCK, 0, s>>>(
        (const int32_t*)words, nb, (const i64*)desc, n, cap, nblk,
        (i64*)part, (i64*)bsum);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scan_sums<<<ncols, SCAN_BLOCK, 0, s>>>((const i64*)desc, nblk,
                                           (i64*)bsum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 g((unsigned)grid_for(cap), (unsigned)ncols);
  decode_rows<<<g, 256, 0, s>>>((const int32_t*)words, nb,
                                (const i64*)desc, n, cap,
                                (const i64*)part, (const i64*)bsum, nblk,
                                (bool*)active);
  return (int)cudaGetLastError();
}
