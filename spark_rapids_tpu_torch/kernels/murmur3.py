"""Murmur3 partition-hashing kernel (CUDA, ``csrc/murmur3.cu``).

Replaces ``spark_rapids_tpu/kernels/murmur3.py`` ``murmur3_columns_kernel``.
Each thread folds every key column over 4 consecutive rows with native
uint32 arithmetic, reading each column in its own width (1-byte bool and
byte, 2-byte short, 4- and 8-byte values, string rows 16 or 8 bytes at
a time); the column descriptors (kind, data pointer, validity pointer,
byte-matrix width, lengths pointer) ride the launch as a by-value kernel
argument. With ``n_parts`` > 0 the same launch writes Spark
HashPartitioning's ``pmod(hash, n_parts)`` instead of the hash. Bound on
the H100: bytes — the key columns read once plus 4 bytes written per
row, at 3.35 TB/s.

On a CPU tensor the wrapper runs the plain version,
``ops.hashing.murmur3_columns`` (then ``remainder`` for ``n_parts``); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.sql import types as T

MAX_COLS = 16
_KIND = {"int": 0, "long": 1, "float": 2, "double": 3, "bytes": 4,
         "int8": 5, "int16": 6}
_NATIVE = {torch.bool: "int8", torch.int8: "int8", torch.int16: "int16",
           torch.int32: "int"}


def _col_desc(col) -> Tuple[str, Tuple[torch.Tensor, ...], int]:
    """(kind, tensors the kernel reads, char_cap) for one device column."""
    from spark_rapids_tpu_torch.columnar.device import DeviceStringColumn
    dt = col.dtype
    if isinstance(col, DeviceStringColumn):
        return "bytes", (col.chars.contiguous(), col.validity,
                         col.lengths), col.char_cap
    if isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                       T.IntegerType, T.DateType)):
        kind = _NATIVE.get(col.data.dtype)
        if kind is None:
            raise KR.KernelError(f"murmur3 kernel cannot hash {dt} stored "
                                 f"as {col.data.dtype}")
        return kind, (col.data, col.validity), 0
    if isinstance(dt, (T.LongType, T.TimestampType)):
        return "long", (col.data, col.validity), 0
    if isinstance(dt, T.FloatType):
        return "float", (col.data, col.validity), 0
    if isinstance(dt, T.DoubleType):
        return "double", (col.data, col.validity), 0
    if isinstance(dt, T.DecimalType) and dt.precision <= 18:
        return "long", (col.data, col.validity), 0
    raise KR.KernelError(f"murmur3 kernel cannot hash {dt}")


def murmur3_columns(cols: Sequence, capacity: int, seed: int = 42,
                    n_parts: int = 0) -> torch.Tensor:
    """Spark Murmur3Hash(cols, seed) per row, int32[capacity]; with
    ``n_parts`` > 0, ``pmod(hash, n_parts)`` (the partition id) instead."""
    if not cols:
        raise KR.KernelError("murmur3 needs at least one key column")
    if n_parts < 0:
        raise KR.KernelError(f"murmur3: n_parts {n_parts} < 0")
    if not cols[0].validity.is_cuda:
        from spark_rapids_tpu_torch.ops.hashing import murmur3_columns as plain
        # the plain version's call takes the kernel's span on the CPU
        t0 = KR.dispatch_start()
        h = plain(cols, capacity, seed)
        if t0 is not None:
            KR.dispatch_end(t0, "murmur3")
        if n_parts:
            return torch.remainder(h.to(torch.int64),
                                   n_parts).to(torch.int32)
        return h
    if len(cols) > MAX_COLS:
        raise KR.KernelError(f"murmur3 kernel takes at most {MAX_COLS} "
                             f"key columns, got {len(cols)}")
    descs: List[Tuple[str, Tuple[torch.Tensor, ...], int]] = \
        [_col_desc(c) for c in cols]
    tensors = [t for _k, ts, _w in descs for t in ts]
    KR.require_cuda(tensors, "murmur3")
    for _k, ts, _w in descs:
        if ts[0].shape[0] != capacity:
            raise KR.KernelError("murmur3: column capacity mismatch")
    words = np.zeros((len(descs), 5), dtype=np.int64)
    for i, (kind, ts, width) in enumerate(descs):
        words[i, 0] = _KIND[kind]
        words[i, 1] = width
        words[i, 2] = ts[0].data_ptr()
        words[i, 3] = ts[1].data_ptr()
        words[i, 4] = ts[2].data_ptr() if kind == "bytes" else 0
    fn = KR.library("murmur3").murmur3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    device = tensors[0].device
    out = torch.empty(capacity, dtype=torch.int32, device=device)
    t0 = KR.dispatch_start()
    KR.count_launch("murmur3")
    # the launch goes to the calling thread's current device: make
    # it the tensors' (a card other than 0 on a mesh)
    with KR.on_device(device):
        KR.check(fn(words.ctypes.data, len(descs), capacity, seed,
                    n_parts, out.data_ptr(), KR.stream_handle(device)),
                 "murmur3 launch")
    if t0 is not None:
        KR.dispatch_end(t0, "murmur3", chip=device.index)
    return out
