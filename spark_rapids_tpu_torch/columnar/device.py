"""Device-resident columnar batches on torch tensors (the counterpart of
``spark_rapids_tpu.columnar.device``).

- Every column is a pair of tensors on one ``torch.device``: fixed-width
  ``data`` plus a ``validity`` bool mask.
- Strings are padded byte matrices ``uint8[capacity, char_cap]`` with an
  int32 ``lengths`` vector; decimals beyond 18 digits are two int64 limbs
  (``hi`` signed, ``lo`` the uint64 bit pattern), as in ``ops/int128``.
- A batch has a ``capacity`` bucketed like the JAX package's, and an
  ``active`` row mask: filters flip mask bits, compaction is explicit.
  Padding rows carry validity False and normalized zeros in every column.
- An array column is per-row ``starts``/``lengths`` into an element pool
  (a flat device column of its own capacity bucket); a struct column is
  a column of field columns at the batch's capacity. Row gathers move an
  array's starts and lengths, never its pool (``row_arrays``); a
  concatenation appends the pools and re-bases the starts.

The batch model is kept as it is in the JAX package so the operators port
one to one; the static shapes it was built for cost nothing extra here.

Residency on a mesh (``parallel/``): a batch carries the id of the mesh
chip it belongs to (``chip``, None off the mesh). Emulated chips share
one device, so ``tensor.device`` cannot tell them apart: the per-chip
upload sets ``chip``, every per-batch operator and fused stage keeps it
(``with_columns``, ``on_chip``), and the mesh exchange reads it
(``batch_device``). ``batch_to_device`` moves a batch to another chip:
a copy between cards, the same tensors between emulated chips.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T

MIN_CAPACITY = 64


def bucket_capacity(n: int) -> int:
    """Smallest {1, 1.25, 1.5, 1.75} x 2^k capacity >= n, floored at
    MIN_CAPACITY."""
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    base = 1 << (n.bit_length() - 1)
    if base == n:
        return n
    for num in (5, 6, 7):
        cap = (base >> 2) * num
        if cap >= n:
            return cap
    return base << 1


def bucket_char_cap(max_len: int) -> int:
    """Byte-matrix width bucket: multiple-of-8 padding, floor 8."""
    if max_len <= 8:
        return 8
    return 8 * math.ceil(max_len / 8)


def is_string_like(dt: T.DataType) -> bool:
    return isinstance(dt, (T.StringType, T.BinaryType))


_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64, np.dtype(np.uint8): torch.uint8,
}


def torch_dtype(dt: T.DataType) -> torch.dtype:
    """Device storage dtype for fixed-width types."""
    return _NP_TO_TORCH[np.dtype(T.numpy_dtype(dt))]


@dataclass
class DeviceColumn:
    """Fixed-width device column: data[capacity] + validity[capacity]."""

    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        return (self.data, self.validity)


@dataclass
class DeviceDecimal128Column:
    """DECIMAL128 device column: two int64 limbs (``hi`` signed high,
    ``lo`` the uint64 low bit pattern)."""

    dtype: T.DataType
    hi: torch.Tensor
    lo: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        return (self.hi, self.lo, self.validity)


@dataclass
class DeviceStringColumn:
    """String/binary device column: padded byte matrix + lengths. Zero
    padding past ``lengths[i]`` keeps word-wise comparison equal to
    UTF-8 binary order (with the length as tiebreak)."""

    dtype: T.DataType
    chars: torch.Tensor    # uint8[capacity, char_cap]
    lengths: torch.Tensor  # int32[capacity]
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.chars.shape[0]

    @property
    def char_cap(self) -> int:
        return self.chars.shape[1]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        return (self.chars, self.lengths, self.validity)


@dataclass
class DeviceArrayColumn:
    """Array column: per-row ``(start, length)`` views into a shared
    element pool ``child`` (a device column of its own capacity, whose
    validity marks null elements); ``validity`` marks null arrays. After
    a row gather the starts may point anywhere in the pool: no
    contiguity is assumed. A null array has start and length 0."""

    dtype: T.ArrayType
    starts: torch.Tensor   # int32[capacity]
    lengths: torch.Tensor  # int32[capacity]
    child: "AnyDeviceColumn"
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        return (self.starts, self.lengths) + tuple(self.child.arrays()) \
            + (self.validity,)


@dataclass
class DeviceStructColumn:
    """Struct column as a column of columns: each field a device column
    at the batch's capacity; ``validity`` marks null structs, whose
    field slots are null and zeroed too."""

    dtype: T.StructType
    fields: List["AnyDeviceColumn"]
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    def arrays(self) -> Tuple[torch.Tensor, ...]:
        out: List[torch.Tensor] = []
        for f in self.fields:
            out.extend(f.arrays())
        return tuple(out) + (self.validity,)


AnyDeviceColumn = Union[DeviceColumn, DeviceStringColumn,
                        DeviceDecimal128Column, DeviceArrayColumn,
                        DeviceStructColumn]


def column_arity(dtype: T.DataType) -> int:
    """Number of flat tensors a device column of `dtype` carries."""
    if isinstance(dtype, T.MapType):
        raise NotImplementedError(
            f"map device columns ({dtype.simple_string}) are not "
            "supported on TPU")
    if isinstance(dtype, T.ArrayType):
        return 3 + column_arity(dtype.element_type)
    if isinstance(dtype, T.StructType):
        return 1 + sum(column_arity(f.data_type) for f in dtype.fields)
    if is_string_like(dtype) or T.is_limb_decimal(dtype):
        return 3
    return 2


def make_column(dtype: T.DataType, arrs: Sequence[torch.Tensor]
                ) -> AnyDeviceColumn:
    if isinstance(dtype, T.ArrayType):
        child = make_column(dtype.element_type, arrs[2:-1])
        return DeviceArrayColumn(dtype, arrs[0], arrs[1], child, arrs[-1])
    if isinstance(dtype, T.StructType):
        fields, off = [], 0
        for f in dtype.fields:
            k = column_arity(f.data_type)
            fields.append(make_column(f.data_type, arrs[off:off + k]))
            off += k
        return DeviceStructColumn(dtype, fields, arrs[off])
    column_arity(dtype)
    if is_string_like(dtype):
        return DeviceStringColumn(dtype, *arrs)
    if T.is_limb_decimal(dtype):
        return DeviceDecimal128Column(dtype, *arrs)
    return DeviceColumn(dtype, *arrs)


def row_arrays(c: AnyDeviceColumn) -> List[torch.Tensor]:
    """The column's tensors indexed by row: everything but an array's
    element pool (its starts, lengths and validity stand for it)."""
    if isinstance(c, DeviceArrayColumn):
        return [c.starts, c.lengths, c.validity]
    if isinstance(c, DeviceStructColumn):
        out: List[torch.Tensor] = []
        for f in c.fields:
            out.extend(row_arrays(f))
        return out + [c.validity]
    return list(c.arrays())


def _with_rows(c: AnyDeviceColumn, arrs: Sequence[torch.Tensor],
               i: int) -> Tuple[AnyDeviceColumn, int]:
    if isinstance(c, DeviceArrayColumn):
        return DeviceArrayColumn(c.dtype, arrs[i], arrs[i + 1], c.child,
                                 arrs[i + 2]), i + 3
    if isinstance(c, DeviceStructColumn):
        fields = []
        for f in c.fields:
            nf, i = _with_rows(f, arrs, i)
            fields.append(nf)
        return DeviceStructColumn(c.dtype, fields, arrs[i]), i + 1
    k = len(c.arrays())
    return make_column(c.dtype, arrs[i:i + k]), i + k


def with_row_arrays(columns: Sequence[AnyDeviceColumn],
                    arrs: Sequence[torch.Tensor]) -> List[AnyDeviceColumn]:
    """Inverse of ``row_arrays`` over ``columns``: the same columns over
    new row tensors (gathered, sliced or compacted), each array keeping
    its element pool."""
    out, i = [], 0
    for c in columns:
        nc, i = _with_rows(c, arrs, i)
        out.append(nc)
    return out


def flatten_rows(columns: Sequence[AnyDeviceColumn]) -> List[torch.Tensor]:
    flat: List[torch.Tensor] = []
    for c in columns:
        flat.extend(row_arrays(c))
    return flat


def flatten_columns(columns: Sequence[AnyDeviceColumn]
                    ) -> Tuple[List[torch.Tensor],
                               List[Tuple[T.DataType, int]]]:
    """Flatten column tensors + per-column (dtype, arity) spec; inverse
    is rebuild_columns."""
    flat: List[torch.Tensor] = []
    spec: List[Tuple[T.DataType, int]] = []
    for c in columns:
        arrs = c.arrays()
        spec.append((c.dtype, len(arrs)))
        flat.extend(arrs)
    return flat, spec


def rebuild_columns(spec: Sequence[Tuple[T.DataType, int]],
                    outs: Sequence[torch.Tensor]) -> List[AnyDeviceColumn]:
    cols: List[AnyDeviceColumn] = []
    i = 0
    for dt, n_arr in spec:
        cols.append(make_column(dt, outs[i:i + n_arr]))
        i += n_arr
    return cols


@dataclass
class DeviceBatch:
    """A columnar batch resident on one torch device. ``active`` marks
    real rows; ``_num_rows`` caches the host row count. ``_num_rows_dev``
    is the count as a 0-d device tensor, attached by producers that
    compute it anyway (a stage program's filter, a compaction), so
    neither they nor a consumer that only counts has to read it on the
    host."""

    schema: T.StructType
    columns: List[AnyDeviceColumn]
    active: torch.Tensor
    _num_rows: Optional[int] = None
    _num_rows_dev: Optional[torch.Tensor] = None
    # the mesh chip this batch belongs to (None off the mesh)
    chip: Optional[int] = None

    @property
    def capacity(self) -> int:
        return int(self.active.shape[0])

    @property
    def device(self) -> torch.device:
        return self.active.device

    def row_count(self) -> int:
        if self._num_rows is None:
            n = self._num_rows_dev
            self._num_rows = int(self.active.sum() if n is None else n)
        return self._num_rows

    def row_count_lazy(self):
        """The row count as the host knows it, else as a device scalar
        (read back by whoever needs the number)."""
        if self._num_rows is not None:
            return self._num_rows
        if self._num_rows_dev is not None:
            return self._num_rows_dev
        return self.active.sum()

    def with_columns(self, schema: T.StructType,
                     columns: List[AnyDeviceColumn]) -> "DeviceBatch":
        return DeviceBatch(schema, columns, self.active, self._num_rows,
                           self._num_rows_dev, self.chip)

    def sizeof(self) -> int:
        """Device bytes this batch's tensors hold, reckoned from shapes and
        dtypes only (no synchronise): the active mask at one byte a row
        plus every column tensor. The spill store accounts with it and the
        out-of-core planner sizes its partitions from it. The layouts of
        the two packages agree (int64 limbs for a decimal above 18 digits,
        one byte a bool, a ``uint8[capacity, char_cap]`` string matrix),
        so for the same tensors this is what the JAX package's
        ``DeviceBatch.sizeof`` counts. A string column's ``char_cap`` is
        chosen by whichever path built the batch (the upload codec, a
        concatenation padding to the widest), so the same rows can count
        different bytes after different paths in either package."""
        total = self.active.numel()
        for c in self.columns:
            for a in c.arrays():
                total += a.numel() * a.element_size()
        return total

    @staticmethod
    def empty(schema: T.StructType, device: torch.device) -> "DeviceBatch":
        return DeviceBatch.from_host(HostBatch.empty(schema), device,
                                     MIN_CAPACITY)

    @staticmethod
    def from_host(batch: HostBatch, device: torch.device,
                  capacity: Optional[int] = None) -> "DeviceBatch":
        from spark_rapids_tpu_torch.columnar.transfer import upload_batch
        cap = capacity or bucket_capacity(max(1, batch.num_rows))
        return upload_batch(batch, cap, device)

    def to_host(self) -> HostBatch:
        """Gather active rows back to a HostBatch (device -> host), one
        blocking copy per array (the columnar-to-row transition uses
        ``start_to_host`` / ``finish_to_host`` instead)."""
        active = self.active.cpu().numpy()
        idx = np.nonzero(active)[0]
        cols = [_col_to_host(c, idx) for c in self.columns]
        return HostBatch(self.schema, cols, len(idx))


def start_to_host(batch: DeviceBatch, stream=None):
    """Non-blocking half of a device -> host fetch: on a CUDA device the
    active rows are compacted to the front (cut to the row count where it
    is known) and every array is copied into a pinned host buffer on
    ``stream``, after the current stream's work, ending in an event.
    Returns a token for ``finish_to_host``. On the CPU the arrays are
    already host memory."""
    if batch.device.type != "cuda":
        flat, spec = flatten_columns(batch.columns)
        return (batch.schema, spec, [batch.active] + flat, None, None)
    active, outs = compact_arrays(batch.active, flatten_rows(batch.columns))
    if batch._num_rows is not None:
        active = active[:batch._num_rows]
        outs = [a[:batch._num_rows] for a in outs]
    flat, spec = flatten_columns(with_row_arrays(batch.columns, outs))
    arrays = [active] + flat
    stream.wait_stream(torch.cuda.current_stream(batch.device))
    hosts = []
    with torch.cuda.stream(stream):
        for a in arrays:
            h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            h.copy_(a, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(stream)
    # the device arrays stay referenced by the token until the event has
    # completed, so the allocator cannot reuse them under the copies
    return (batch.schema, spec, hosts, event, arrays)


def finish_to_host(token) -> HostBatch:
    """Blocking half of ``start_to_host``: wait for the copies' event,
    then read the host arrays."""
    schema, spec, hosts, event, _arrays = token
    if event is not None:
        event.synchronize()
    idx = np.nonzero(hosts[0].numpy())[0]
    cols = [_col_to_host(c, idx)
            for c in rebuild_columns(spec, hosts[1:])]
    return HostBatch(schema, cols, len(idx))


def _col_to_host(c: AnyDeviceColumn, idx: np.ndarray) -> HostColumn:
    validity = c.validity.cpu().numpy()[idx]
    if isinstance(c, DeviceStructColumn):
        from spark_rapids_tpu_torch.columnar.host import struct_storage_rows
        fields = [_col_to_host(f, idx) for f in c.fields]
        return HostColumn(c.dtype, struct_storage_rows(fields, validity),
                          validity)
    if isinstance(c, DeviceArrayColumn):
        return _array_to_host(c, idx, validity)
    if isinstance(c, DeviceStringColumn):
        chars = c.chars.cpu().numpy()[idx]
        lengths = c.lengths.cpu().numpy()[idx]
        is_binary = isinstance(c.dtype, T.BinaryType)
        data = None if is_binary else _strings_by_arrow(chars, lengths)
        if data is None:
            data = np.empty(len(idx), dtype=object)
            for i in range(len(idx)):
                raw = chars[i, :lengths[i]].tobytes()
                data[i] = raw if is_binary else raw.decode(
                    "utf-8", errors="replace")
        data[~validity] = b"" if is_binary else ""
        return HostColumn(c.dtype, data, validity)
    if isinstance(c, DeviceDecimal128Column):
        data = np.stack([c.hi.cpu().numpy()[idx], c.lo.cpu().numpy()[idx]],
                        axis=1)
        return HostColumn(c.dtype, data, validity).normalized()
    return HostColumn(c.dtype, c.data.cpu().numpy()[idx],
                      validity).normalized()


def _strings_by_arrow(chars: np.ndarray, lengths: np.ndarray):
    """The rows of a char matrix as an object array of str, converted by
    pyarrow from the rows' bytes and offsets instead of a Python loop
    over rows; None where pyarrow is absent or the bytes are not valid
    UTF-8 (the caller's row loop then replaces what does not decode)."""
    try:
        import pyarrow as pa
    except ImportError:
        return None
    n = len(lengths)
    if n == 0:
        return np.empty(0, dtype=object)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    keep = np.arange(chars.shape[1])[None, :] < lengths[:, None]
    arr = pa.LargeStringArray.from_buffers(
        n, pa.py_buffer(offsets), pa.py_buffer(
            np.ascontiguousarray(chars[keep])))
    try:
        arr.validate(full=True)
    except pa.ArrowInvalid:
        return None
    return arr.to_numpy(zero_copy_only=False)


def _array_to_host(c: DeviceArrayColumn, idx: np.ndarray,
                   validity: np.ndarray) -> HostColumn:
    """An array column's rows ``idx`` as a host column in its compact
    form (``HostColumn.elements``: the rows' lengths and their elements
    in order, gathered from the pool)."""
    pool = _col_to_host(c.child, np.arange(c.child.capacity))
    starts = c.starts.cpu().numpy()[idx].astype(np.int64)
    lengths = np.where(validity, c.lengths.cpu().numpy()[idx], 0) \
        .astype(np.int64)
    before = np.cumsum(lengths) - lengths
    take = np.repeat(starts - before, lengths) + np.arange(lengths.sum())
    return HostColumn(c.dtype, None, validity,
                      elements=(lengths.astype(np.int32), pool.take(take)))


def mask_col(c: AnyDeviceColumn, keep: torch.Tensor) -> AnyDeviceColumn:
    """Null out rows outside `keep` (normalized zeros underneath)."""
    v = c.validity & keep
    if isinstance(c, DeviceStructColumn):
        return DeviceStructColumn(c.dtype,
                                  [mask_col(f, v) for f in c.fields], v)
    if isinstance(c, DeviceArrayColumn):
        return DeviceArrayColumn(c.dtype, torch.where(v, c.starts, 0),
                                 torch.where(v, c.lengths, 0), c.child, v)
    if isinstance(c, DeviceStringColumn):
        return DeviceStringColumn(
            c.dtype, c.chars * v[:, None].to(c.chars.dtype),
            torch.where(v, c.lengths, 0), v)
    if isinstance(c, DeviceDecimal128Column):
        return DeviceDecimal128Column(c.dtype, torch.where(v, c.hi, 0),
                                      torch.where(v, c.lo, 0), v)
    return DeviceColumn(c.dtype, torch.where(
        v, c.data, torch.zeros((), dtype=c.data.dtype, device=v.device)), v)


def sort_key_i64(k: torch.Tensor) -> torch.Tensor:
    """A sort word as a tensor whose SIGNED order is the word's intended
    order: bools and small ints widen, and int64 words carry uint64 bit
    patterns (the JAX package's uint64 words), so their sign bit flips.
    Float words sort as themselves."""
    if k.dtype == torch.bool:
        return k.to(torch.int64)
    if k.dtype == torch.int64:
        return k ^ (-(1 << 63))
    if k.is_floating_point():
        return k
    return k.to(torch.int64)


def sort_with_payload(keys: Sequence[torch.Tensor],
                      payload: Sequence[torch.Tensor]):
    """Stable lexicographic sort by `keys` (most significant first, each
    in the word convention of :func:`sort_key_i64`); `payload` tensors
    follow. A least-significant-first chain of stable single-key sorts
    plus gathers: torch has no multi-operand sort. Returns (sorted_keys,
    order, sorted_payload)."""
    cap = keys[0].shape[0]
    order = torch.arange(cap, dtype=torch.int64, device=keys[0].device)
    for k in reversed(list(keys)):
        kp = sort_key_i64(k)[order]
        _s, o2 = torch.sort(kp, stable=True)
        order = order[o2]
    from spark_rapids_tpu_torch.ops.lanes import fused_take
    gathered = fused_take(list(keys) + list(payload), order)
    return (tuple(gathered[:len(keys)]), order,
            gathered[len(keys):])


def take_columns(columns: Sequence[AnyDeviceColumn], idx: torch.Tensor,
                 valid_at: Optional[torch.Tensor] = None
                 ) -> List[AnyDeviceColumn]:
    """Gather rows by index; rows where ``valid_at`` is False become
    null (callers clamp their indices into range first: unlike jnp.take,
    torch raises on out-of-range indices)."""
    from spark_rapids_tpu_torch.ops.lanes import fused_take
    out = with_row_arrays(columns, fused_take(flatten_rows(columns), idx))
    if valid_at is not None:
        out = [mask_col(c, valid_at) for c in out]
    return out


def compact_arrays(active: torch.Tensor, flat: Sequence[torch.Tensor]):
    """Stable compaction (active rows to the front): one stable sort for
    the permutation + one gather per tensor; the padding tail is zeroed.
    Returns (new_active, outs)."""
    from spark_rapids_tpu_torch.ops.lanes import fused_take
    cap = active.shape[0]
    _k, idx = torch.sort((~active).to(torch.int8), stable=True)
    pos = torch.arange(cap, device=active.device)
    new_active = pos < active.sum()
    outs = []
    for g in fused_take(list(flat), idx):
        keep = new_active[:, None] if g.dim() == 2 else new_active
        outs.append(torch.where(keep, g, torch.zeros(
            (), dtype=g.dtype, device=g.device)))
    return new_active, outs


def slice_compacted_to_bucket(batch: DeviceBatch) -> DeviceBatch:
    """Slice an ALREADY-COMPACTED batch (active rows form a prefix) down
    to its row count's capacity bucket."""
    n = batch.row_count()
    cap = bucket_capacity(max(1, n))
    if cap >= batch.capacity:
        return batch
    rows = [a[:cap] for a in flatten_rows(batch.columns)]
    return DeviceBatch(batch.schema, with_row_arrays(batch.columns, rows),
                       batch.active[:cap], n, chip=batch.chip)


def _concat_flat(parts: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    """Row tensors one after another, byte matrices padded to the widest,
    then zero rows up to ``cap``."""
    parts = list(parts)
    if parts[0].dim() == 2:
        w = max(p.shape[1] for p in parts)
        parts = [torch.nn.functional.pad(p, (0, w - p.shape[1]))
                 if p.shape[1] < w else p for p in parts]
    rows = sum(p.shape[0] for p in parts)
    if cap > rows:
        parts.append(parts[0].new_zeros((cap - rows,)
                                        + tuple(parts[0].shape[1:])))
    return torch.cat(parts)


def concat_columns(parts: Sequence[AnyDeviceColumn], cap: int
                   ) -> AnyDeviceColumn:
    """One column from several (all their rows, in order) at capacity
    ``cap``. Arrays append their element pools whole, at the bucket of
    the pools' total, and each part's starts shift by the pool
    capacities before it."""
    first = parts[0]
    if isinstance(first, DeviceArrayColumn):
        pool_caps = [p.child.capacity for p in parts]
        child = concat_columns([p.child for p in parts],
                               bucket_capacity(max(1, sum(pool_caps))))
        starts, off = [], 0
        for p, pc in zip(parts, pool_caps):
            starts.append(torch.where(p.validity, p.starts + off, 0)
                          .to(torch.int32))
            off += pc
        return DeviceArrayColumn(
            first.dtype, _concat_flat(starts, cap),
            _concat_flat([p.lengths for p in parts], cap), child,
            _concat_flat([p.validity for p in parts], cap))
    if isinstance(first, DeviceStructColumn):
        fields = [concat_columns([p.fields[k] for p in parts], cap)
                  for k in range(len(first.fields))]
        return DeviceStructColumn(
            first.dtype, fields,
            _concat_flat([p.validity for p in parts], cap))
    arrs = [_concat_flat([p.arrays()[k] for p in parts], cap)
            for k in range(len(first.arrays()))]
    return make_column(first.dtype, arrs)


def active_rows(active: torch.Tensor, n: int) -> torch.Tensor:
    """The positions of the ``n`` active rows of ``active`` in order, where
    ``n`` is its active count already known on the host: what
    ``torch.nonzero(active)`` gives, without the host read that sizes
    nonzero's output (a stable sort puts the active rows first, as
    ``compact_arrays`` does)."""
    return torch.sort((~active).to(torch.int8), stable=True)[1][:n]


def concat_device(batches: Sequence[DeviceBatch]) -> DeviceBatch:
    """Device Table.concatenate: compact all actives into one batch at
    the bucket of the total row count. String char matrices of differing
    widths pad to the widest; array pools are appended and their starts
    re-based (``concat_columns``)."""
    assert batches
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    counts = [b.row_count() for b in batches]
    total = sum(counts)
    cap = bucket_capacity(max(1, total))
    dev = batches[0].device
    compacted = [take_columns(b.columns, active_rows(b.active, n))
                 for b, n in zip(batches, counts)]
    cols = [concat_columns([cb[i] for cb in compacted], cap)
            for i in range(len(schema.fields))]
    active = torch.arange(cap, device=dev) < total
    chips = {b.chip for b in batches}
    return DeviceBatch(schema, cols, active, total,
                       chip=chips.pop() if len(chips) == 1 else None)


def on_chip(out: DeviceBatch, src: DeviceBatch) -> DeviceBatch:
    """``out``, a batch an operator made from ``src``, on ``src``'s
    chip."""
    if src.chip is not None:
        out.chip = src.chip
    return out


def batch_device(batch: DeviceBatch) -> Optional[int]:
    """The id of the mesh chip a batch belongs to, or None off the
    mesh."""
    return batch.chip


def batch_to_device(batch: DeviceBatch, chip) -> DeviceBatch:
    """``batch`` on mesh chip ``chip`` (a ``parallel.mesh.Chip``): its
    tensors copied to the chip's device when they lie elsewhere (a copy
    between cards, ordered after the source stream's work), the same
    tensors when they lie there already (emulated chips)."""
    if batch.device == chip.device:
        return DeviceBatch(batch.schema, batch.columns, batch.active,
                           batch._num_rows, batch._num_rows_dev, chip.id)
    flat, spec = flatten_columns(batch.columns)
    moved = copy_to_device(flat + [batch.active], batch.device,
                           chip.device)
    n_dev = batch._num_rows_dev
    return DeviceBatch(batch.schema, rebuild_columns(spec, moved[:-1]),
                       moved[-1], batch._num_rows,
                       None if n_dev is None else n_dev.to(chip.device),
                       chip.id)


def copy_to_device(tensors: Sequence[torch.Tensor], src: torch.device,
                   dst: torch.device) -> List[torch.Tensor]:
    """Tensors on ``src`` copied to ``dst``. Between two cards the copy is
    a peer copy issued on the destination's current stream after an
    event recorded on the source's, so it reads what the source's queued
    work wrote without a host synchronise. On one device they are the
    same tensors."""
    if src == dst:
        return list(tensors)
    if src.type != "cuda" or dst.type != "cuda":
        return [t.to(dst) for t in tensors]
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(src))
    stream = torch.cuda.current_stream(dst)
    stream.wait_event(ev)
    with torch.cuda.stream(stream):
        out = [t.to(dst, non_blocking=True) for t in tensors]
    for t in tensors:
        # the source's caching allocator must not reuse these blocks
        # before the copy on the destination's stream has read them
        t.record_stream(stream)
    return out
