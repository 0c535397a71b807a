"""Spark-compatible Murmur3 (x86_32) hashing, vectorized in numpy.

The reference relies on cuDF's spark-murmur3 mode so that GPU hash
partitioning places rows in the same shuffle partitions CPU Spark would
(GpuHashPartitioning.scala; SURVEY.md 2.5 'murmur3-compatible GPU hash').
This module is the host/reference implementation; the device twin (jnp) is
columnar/kernels/hashing.py and must match bit-for-bit.

Algorithm: Spark's Murmur3_x86_32 (hashInt/hashLong/hashUnsafeBytes with
trailing bytes processed one-at-a-time as signed ints), seed 42, columns
folded left-to-right with the running hash as seed; null slots leave the
running hash unchanged.
"""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = np.int32(42)

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)
_M5 = np.uint32(0xE6546B64)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    x = x.astype(np.uint32)
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def _mix_k1(k1: np.ndarray) -> np.ndarray:
    k1 = (k1.astype(np.uint32) * _C1).astype(np.uint32)
    k1 = _rotl(k1, 15)
    return (k1 * _C2).astype(np.uint32)


def _mix_h1(h1: np.ndarray, k1: np.ndarray) -> np.ndarray:
    h1 = (h1.astype(np.uint32) ^ k1).astype(np.uint32)
    h1 = _rotl(h1, 13)
    return (h1 * np.uint32(5) + _M5).astype(np.uint32)


def _fmix(h1: np.ndarray, length: np.ndarray) -> np.ndarray:
    h1 = (h1.astype(np.uint32) ^ np.asarray(length).astype(np.uint32))
    h1 = h1 ^ (h1 >> np.uint32(16))
    h1 = (h1 * np.uint32(0x85EBCA6B)).astype(np.uint32)
    h1 = h1 ^ (h1 >> np.uint32(13))
    h1 = (h1 * np.uint32(0xC2B2AE35)).astype(np.uint32)
    h1 = h1 ^ (h1 >> np.uint32(16))
    return h1


def hash_int(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """hashInt: one 4-byte round + fmix(4). values int32, seed int32/uint32
    array or scalar; returns int32."""
    k1 = _mix_k1(values.astype(np.int32).view(np.uint32))
    h1 = _mix_h1(np.asarray(seed, dtype=np.int32).view(np.uint32)
                 * np.ones(len(values), dtype=np.uint32), k1)
    return _fmix(h1, np.uint32(4)).view(np.int32)


def hash_long(values: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """hashLong: low int32 word then high, + fmix(8)."""
    v = values.astype(np.int64).view(np.uint64)
    low = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    high = (v >> np.uint64(32)).astype(np.uint32)
    h1 = np.asarray(seed, dtype=np.int32).view(np.uint32) \
        * np.ones(len(values), dtype=np.uint32)
    h1 = _mix_h1(h1, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, np.uint32(8)).view(np.int32)


def hash_bytes_one(data: bytes, seed: int) -> int:
    """Scalar hashUnsafeBytes for strings/binary (per-row host loop).
    1-element arrays throughout: integer wraparound is intended and
    numpy only warns on scalar overflow."""
    h1 = np.array([seed], dtype=np.int32).view(np.uint32)
    n = len(data)
    aligned = n - n % 4
    for i in range(0, aligned, 4):
        word = np.frombuffer(data[i:i + 4], dtype="<u4").copy()
        h1 = _mix_h1(h1, _mix_k1(word))
    for i in range(aligned, n):
        b = (np.array([data[i]], dtype=np.uint8).astype(np.int8)
             .astype(np.int32).view(np.uint32))
        h1 = _mix_h1(h1, _mix_k1(b))
    res = _fmix(h1, np.uint32(n))
    return int(res.view(np.int32)[0])


def hash_float(values: np.ndarray, seed) -> np.ndarray:
    """Float: -0.0 normalized to 0.0, then bits hashed as int32
    (Spark Murmur3Hash HashExpression for FloatType)."""
    v = values.astype(np.float32).copy()
    v[v == np.float32(0.0)] = np.float32(0.0)  # folds -0.0 into +0.0
    return hash_int(v.view(np.int32), seed)


def hash_double(values: np.ndarray, seed) -> np.ndarray:
    v = values.astype(np.float64).copy()
    v[v == 0.0] = 0.0
    return hash_long(v.view(np.int64), seed)
