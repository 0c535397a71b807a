"""Spark Murmur3_x86_32 (seed 42) on torch tensors: the plain version of
the murmur3 kernel, bit-compatible with ``columnar/murmur3.py`` and with
the JAX package's ``ops/hashing.py``; and Spark XxHash64 (seed 42L),
bit-compatible with ``columnar/xxhash64.py``.

torch has no usable uint32 arithmetic, so every 32-bit word lives in an
int64 tensor in [0, 2^32): products wrap in int64 and are masked back to
32 bits (the low 32 bits of a wrapped product are exact), and right
shifts of non-negative values are logical. Strings hash their UTF-8
bytes from the padded byte matrix: whole little-endian 4-byte words
first, then the tail bytes one at a time, sign-extended from int8. A
struct folds its fields with the running hash as seed; the murmur3
kernel takes a struct key as its fields (``struct_key_fields``).

XXH64 works on uint64 words held in int64 tensors: additions and
products wrap exactly as uint64 arithmetic does, and right shifts are
logical (``int128._srl``), since torch's ``>>`` is arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence

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
    elif isinstance(dt, T.StructType):
        # fold the fields left to right with the running hash as seed;
        # a null struct keeps the incoming seed
        h = seed
        for f in col.fields:
            h = hash_device_column(f, h)
    else:
        raise TypeError(f"cannot hash {dt} on device")
    return torch.where(col.validity, h, seed)


def struct_key_fields(cols: Sequence) -> List:
    """Key columns with each struct replaced by its fields, each field's
    validity ANDed with the struct's: the same murmur3 fold (a null
    struct leaves every field null, so the seed passes through), as flat
    columns the murmur3 kernel reads."""
    from spark_rapids_tpu_torch.columnar.device import (DeviceStructColumn,
                                                        mask_col)
    out: List = []
    for c in cols:
        if isinstance(c, DeviceStructColumn):
            out.extend(struct_key_fields(
                [mask_col(f, c.validity) for f in c.fields]))
        else:
            out.append(c)
    return out


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
    return KM.murmur3_columns(struct_key_fields(key_cols), capacity, 42,
                              n_parts=n_parts)


# ---------------------------------------------------------------------------
# XXH64 (Spark XxHash64, seed 42L): device twin of columnar/xxhash64.py
# ---------------------------------------------------------------------------

def _s64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


_XP1 = _s64(0x9E3779B185EBCA87)
_XP2 = _s64(0xC2B2AE3D27D4EB4F)
_XP3 = _s64(0x165667B19E3779F9)
_XP4 = _s64(0x85EBCA77C2B2AE63)
_XP5 = _s64(0x27D4EB2F165667C5)


def _xrotl(x: torch.Tensor, r: int) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops.int128 import _srl
    return (x << r) | _srl(x, 64 - r)


def _xfmix(h: torch.Tensor) -> torch.Tensor:
    from spark_rapids_tpu_torch.ops.int128 import _srl
    h = h ^ _srl(h, 33)
    h = h * _XP2
    h = h ^ _srl(h, 29)
    h = h * _XP3
    return h ^ _srl(h, 32)


def xx_hash_int(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.int32).to(torch.int64) & M32
    h = seed + _XP5 + 4
    h = h ^ (v * _XP1)
    h = _xrotl(h, 23) * _XP2 + _XP3
    return _xfmix(h)


def xx_hash_long(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.int64)
    h = seed + _XP5 + 8
    h = h ^ (_xrotl(v * _XP2, 31) * _XP1)
    h = _xrotl(h, 27) * _XP1 + _XP4
    return _xfmix(h)


def xx_hash_float(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.float32)
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    return xx_hash_int(v.view(torch.int32), seed)


def xx_hash_double(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    v = values.to(torch.float64)
    v = torch.where(v == 0.0, torch.zeros_like(v), v)
    return xx_hash_long(v.view(torch.int64), seed)


def xx_hash_bytes(chars: torch.Tensor, lengths: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """Full XXH64 over a padded uint8[n, char_cap] matrix: 32-byte
    stripes, then 8-, 4- and 1-byte tail rounds, unrolled to the char
    capacity and masked per row by the byte length."""
    n, char_cap = chars.shape
    pad_cap = max(32, ((char_cap + 31) // 32) * 32)
    if pad_cap != char_cap:
        chars = torch.nn.functional.pad(chars, (0, pad_cap - char_cap))
    L = lengths.to(torch.int64)
    c64 = chars.to(torch.int64)
    lanes = []  # little-endian 8-byte lanes
    for j in range(pad_cap // 8):
        lane = torch.zeros(n, dtype=torch.int64, device=chars.device)
        for k in range(8):
            lane = lane | (c64[:, 8 * j + k] << (8 * k))
        lanes.append(lane)
    acc = [seed + _XP1 + _XP2, seed + _XP2, seed.clone(), seed - _XP1]
    for s in range(pad_cap // 32):
        live = L >= 32 * (s + 1)
        for k in range(4):
            new_v = _xrotl(acc[k] + lanes[4 * s + k] * _XP2, 31) * _XP1
            acc[k] = torch.where(live, new_v, acc[k])
    hbig = (_xrotl(acc[0], 1) + _xrotl(acc[1], 7) + _xrotl(acc[2], 12)
            + _xrotl(acc[3], 18))
    for v in acc:
        hbig = (hbig ^ (_xrotl(v * _XP2, 31) * _XP1)) * _XP1 + _XP4
    h = torch.where(L >= 32, hbig, seed + _XP5)
    h = h + L
    lane_stack = torch.stack(lanes, dim=1)
    tail = (L // 32) * 32
    for t in range(3):
        pos = tail + 8 * t
        idx = torch.clamp(pos // 8, 0, len(lanes) - 1)
        lane = torch.gather(lane_stack, 1, idx[:, None])[:, 0]
        new_h = _xrotl(h ^ (_xrotl(lane * _XP2, 31) * _XP1), 27) \
            * _XP1 + _XP4
        h = torch.where(pos + 8 <= L, new_h, h)
    i8 = (L // 8) * 8
    has4 = i8 + 4 <= L
    w = torch.zeros(n, dtype=torch.int64, device=chars.device)
    for k in range(4):
        b = torch.gather(c64, 1, torch.clamp(i8 + k, 0, pad_cap - 1)
                         [:, None])[:, 0]
        w = w | (b << (8 * k))
    h = torch.where(has4, _xrotl(h ^ (w * _XP1), 23) * _XP2 + _XP3, h)
    i4 = i8 + torch.where(has4, 4, 0)
    for b in range(3):
        pos = i4 + b
        byte = torch.gather(c64, 1, torch.clamp(pos, 0, pad_cap - 1)
                            [:, None])[:, 0]
        h = torch.where(pos < L, _xrotl(h ^ (byte * _XP5), 11) * _XP1, h)
    return _xfmix(h)


def xx_hash_device_column(col, seed: torch.Tensor) -> torch.Tensor:
    from spark_rapids_tpu_torch.columnar.device import DeviceStringColumn
    dt = col.dtype
    if isinstance(col, DeviceStringColumn):
        h = xx_hash_bytes(col.chars, col.lengths, seed)
    elif isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                         T.IntegerType, T.DateType)):
        h = xx_hash_int(col.data.to(torch.int32), seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = xx_hash_long(col.data, seed)
    elif isinstance(dt, T.FloatType):
        h = xx_hash_float(col.data, seed)
    elif isinstance(dt, T.DoubleType):
        h = xx_hash_double(col.data, seed)
    elif isinstance(dt, T.DecimalType) and dt.precision <= 18:
        h = xx_hash_long(col.data, seed)
    else:
        raise TypeError(f"cannot xxhash {dt} on device")
    return torch.where(col.validity, h, seed)


def xxhash64_columns(cols: Sequence, capacity: int, seed: int = 42,
                     device=None) -> torch.Tensor:
    """Spark XxHash64(cols, seed): fold columns left to right; int64."""
    if device is None:
        device = cols[0].validity.device
    h = torch.full((capacity,), seed, dtype=torch.int64, device=device)
    for c in cols:
        h = xx_hash_device_column(c, h)
    return h
