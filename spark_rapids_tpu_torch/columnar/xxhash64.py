"""Spark-compatible XXH64 hashing, vectorized in numpy.

Spark's XxHash64 expression (catalyst XXH64, seed 42L) — the second hash
family the reference accelerates (GpuXxHash64, HashFunctions.scala). The
host implementation here is the oracle; the device twin lives in
ops/hashing.py (xx_* functions) and must match bit-for-bit.

Per-type dispatch mirrors Spark's HashExpression: bool/byte/short/int/
date hash as 4-byte ints, long/timestamp/decimal(<=18) as 8-byte longs,
float/double as their IEEE bits (-0.0 folded to +0.0), strings/binary as
UTF-8 bytes via the full XXH64 byte algorithm (32-byte stripes + tail).
All arithmetic is uint64 with wraparound.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = np.int64(42)

P1 = np.uint64(0x9E3779B185EBCA87)
P2 = np.uint64(0xC2B2AE3D27D4EB4F)
P3 = np.uint64(0x165667B19E3779F9)
P4 = np.uint64(0x85EBCA77C2B2AE63)
P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    x = x.astype(np.uint64)
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * P2
    h = h ^ (h >> np.uint64(29))
    h = h * P3
    h = h ^ (h >> np.uint64(32))
    return h


def hash_int(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """XXH64.hashInt: value zero-extended to a 4-byte block."""
    v = values.astype(np.int32).view(np.uint32).astype(np.uint64)
    h = seed.astype(np.int64).view(np.uint64) + P5 + np.uint64(4)
    h = h ^ (v * P1)
    h = _rotl(h, 23) * P2 + P3
    return _fmix(h).view(np.int64)


def hash_long(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    v = values.astype(np.int64).view(np.uint64)
    h = seed.astype(np.int64).view(np.uint64) + P5 + np.uint64(8)
    h = h ^ (_rotl(v * P2, 31) * P1)
    h = _rotl(h, 27) * P1 + P4
    return _fmix(h).view(np.int64)


def hash_float(values: np.ndarray, seed) -> np.ndarray:
    v = values.astype(np.float32).copy()
    v[v == np.float32(0.0)] = np.float32(0.0)  # fold -0.0
    return hash_int(v.view(np.int32), seed)


def hash_double(values: np.ndarray, seed) -> np.ndarray:
    v = values.astype(np.float64).copy()
    v[v == 0.0] = 0.0
    return hash_long(v.view(np.int64), seed)


def hash_bytes_one(data: bytes, seed: int) -> int:
    """Scalar XXH64 over a byte string (per-row host loop). 1-element
    arrays throughout: wraparound is intended, and numpy only warns on
    scalar overflow."""
    def u(x) -> np.ndarray:
        return np.array([x], dtype=np.uint64)

    n = len(data)
    seed_u = np.array([seed], dtype=np.int64).view(np.uint64)
    i = 0
    if n >= 32:
        acc = [seed_u + P1 + P2, seed_u + P2, seed_u.copy(), seed_u - P1]
        while i + 32 <= n:
            for k in range(4):
                lane = np.frombuffer(
                    data[i + 8 * k:i + 8 * k + 8], dtype="<u8").copy()
                acc[k] = _rotl(acc[k] + lane * P2, 31) * P1
            i += 32
        h = (_rotl(acc[0], 1) + _rotl(acc[1], 7) + _rotl(acc[2], 12)
             + _rotl(acc[3], 18))
        for v in acc:
            h = (h ^ (_rotl(v * P2, 31) * P1)) * P1 + P4
    else:
        h = seed_u + P5
    h = h + u(n)
    while i + 8 <= n:
        lane = np.frombuffer(data[i:i + 8], dtype="<u8").copy()
        h = _rotl(h ^ (_rotl(lane * P2, 31) * P1), 27) * P1 + P4
        i += 8
    if i + 4 <= n:
        lane = np.frombuffer(data[i:i + 4], dtype="<u4").astype(np.uint64)
        h = _rotl(h ^ (lane * P1), 23) * P2 + P3
        i += 4
    while i < n:
        h = _rotl(h ^ (u(data[i]) * P5), 11) * P1
        i += 1
    return int(_fmix(h).view(np.int64)[0])
