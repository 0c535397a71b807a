"""Spark Murmur3_x86_32 (seed 42) on torch tensors: the plain version of
the murmur3 kernel, bit-compatible with ``columnar/murmur3.py`` and with
the JAX package's ``ops/hashing.py``.

torch has no usable uint32 arithmetic, so every 32-bit word lives in an
int64 tensor in [0, 2^32): products wrap in int64 and are masked back to
32 bits (the low 32 bits of a wrapped product are exact), and right
shifts of non-negative values are logical. Strings hash their UTF-8
bytes from the padded byte matrix: whole little-endian 4-byte words
first, then the tail bytes one at a time, sign-extended from int8.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.sql import types as T

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 0xE6546B64


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def _mix_k1(k1: torch.Tensor) -> torch.Tensor:
    k1 = (k1 * _C1) & M32
    k1 = _rotl(k1, 15)
    return (k1 * _C2) & M32


def _mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = _rotl(h1 ^ k1, 13)
    return (h1 * 5 + _M5) & M32


def _fmix(h1: torch.Tensor, length) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & M32
    return h1 ^ (h1 >> 16)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 (or a narrower int) -> its uint32 bit pattern in int64."""
    return x.to(torch.int64) & M32


def to_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 -> the int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def hash_int(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashInt: one 4-byte round + fmix(4); seed/result as uint32-in-int64."""
    return _fmix(_mix_h1(seed, _mix_k1(_u32(values.to(torch.int32)))), 4)


def hash_long(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """hashLong: low 32-bit word then high, + fmix(8)."""
    v = values.to(torch.int64)
    h1 = _mix_h1(seed, _mix_k1(v & M32))
    h1 = _mix_h1(h1, _mix_k1((v >> 32) & M32))
    return _fmix(h1, 8)


def hash_float(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.float32)
    v = torch.where(v == 0.0, torch.zeros_like(v), v)  # fold -0.0
    return hash_int(v.view(torch.int32), seed)


def hash_double(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.float64)
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    return hash_long(v.view(torch.int64), seed)


def hash_bytes(chars: torch.Tensor, lengths: torch.Tensor,
               seed: torch.Tensor) -> torch.Tensor:
    """hashUnsafeBytes over a padded uint8[n, char_cap] matrix."""
    n, char_cap = chars.shape
    lengths = lengths.to(torch.int64)
    aligned = lengths - (lengths % 4)
    c = chars.to(torch.int64)
    h1 = seed
    for w in range(char_cap // 4):
        off = 4 * w
        word = (c[:, off] | (c[:, off + 1] << 8) | (c[:, off + 2] << 16)
                | (c[:, off + 3] << 24))
        h1 = torch.where(off + 4 <= aligned, _mix_h1(h1, _mix_k1(word)), h1)
    for k in range(3):
        off = torch.clamp(aligned + k, max=char_cap - 1)
        b = torch.gather(chars, 1, off[:, None])[:, 0]
        sb = _u32(b.view(torch.int8))
        h1 = torch.where(aligned + k < lengths,
                         _mix_h1(h1, _mix_k1(sb)), h1)
    return _fmix(h1, lengths & M32)


def hash_device_column(col, seed: torch.Tensor) -> torch.Tensor:
    """Fold one device column into the running hash; null slots leave it
    unchanged (Spark HashExpression)."""
    from spark_rapids_tpu_torch.columnar.device import DeviceStringColumn
    dt = col.dtype
    if isinstance(col, DeviceStringColumn):
        h = hash_bytes(col.chars, col.lengths, seed)
    elif isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                         T.IntegerType, T.DateType)):
        h = hash_int(col.data.to(torch.int32), seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = hash_long(col.data, seed)
    elif isinstance(dt, T.FloatType):
        h = hash_float(col.data, seed)
    elif isinstance(dt, T.DoubleType):
        h = hash_double(col.data, seed)
    elif isinstance(dt, T.DecimalType) and dt.precision <= 18:
        h = hash_long(col.data, seed)
    else:
        raise TypeError(f"cannot hash {dt} on device")
    return torch.where(col.validity, h, seed)


def murmur3_columns(cols: Sequence, capacity: int, seed: int = 42
                    ) -> torch.Tensor:
    """Spark Murmur3Hash(cols, seed): fold columns left to right; int32
    out. The plain version of ``kernels.murmur3``."""
    device = cols[0].validity.device
    h = torch.full((capacity,), seed & M32, dtype=torch.int64,
                   device=device)
    for c in cols:
        h = hash_device_column(c, h)
    return to_i32(h)


def partition_ids(key_cols: Sequence, capacity: int, n_parts: int
                  ) -> torch.Tensor:
    """pmod(murmur3(keys, 42), n) per row — Spark HashPartitioning
    placement; on the card one murmur3 launch hashes and takes the pmod."""
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    return KM.murmur3_columns(key_cols, capacity, 42, n_parts=n_parts)
