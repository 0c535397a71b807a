"""Host-side columnar batches.

The CPU twin of the device format: each column is a numpy data array plus a
boolean validity array (True = valid), Arrow-style. Strings/binary use numpy
object arrays on the host (the device side uses padded byte matrices, see
device.py). This is what the CPU physical operators evaluate over, what file
readers produce, and what `collect()` materializes — playing the role of
Spark's UnsafeRow/ColumnarBatch world plus RapidsHostColumnVector
(GpuColumnVector.java) in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.sql import types as T


@dataclass(init=False)
class HostColumn:
    """One column: `data` (numpy array) + `validity` (bool array).

    Invalid slots hold an arbitrary-but-deterministic value (0 / "" / None)
    so vectorized ops never see garbage.

    An array column holds its rows in one form or both: ``data``, an
    object array of storage tuples, and ``elements``, the compact form.
    One built from the compact form alone (an Arrow list column, a numpy
    generator, a download) stores ``_data`` as None, and reading ``data``
    then makes the tuples, one row at a time, and keeps them; the upload
    stages from the compact form and never reads them.
    """

    dtype: T.DataType
    _data: Optional[np.ndarray]
    validity: np.ndarray  # bool, True = valid
    # Optional compact representation for string/binary columns decoded
    # from Arrow: (utf8_bytes uint8[total], lengths int32[n]) where row
    # i's bytes are the next lengths[i] bytes after sum(lengths[:i]).
    # The upload codec ships these raw bytes and rebuilds the padded
    # char matrix ON DEVICE (the reference's copy-compact-bytes pattern,
    # GpuParquetScanBase.scala:82) instead of re-encoding the object
    # array; pure optimization — every consumer falls back to ``data``.
    varbytes: Optional[Tuple[np.ndarray, np.ndarray]] = None
    # Optional compact representation of an array column:
    # (lengths int32[n], element column) where row i's elements are the
    # next lengths[i] entries of the element column and a null row has
    # length 0. ``array_elements`` derives and keeps it from ``data``
    # when the column was built without it.
    elements: Optional[Tuple[np.ndarray, "HostColumn"]] = None

    def __init__(self, dtype: T.DataType, data: Optional[np.ndarray],
                 validity: np.ndarray,
                 varbytes: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 elements: Optional[Tuple[np.ndarray, "HostColumn"]] = None):
        self.dtype = dtype
        self._data = data
        self.validity = validity
        self.varbytes = varbytes
        self.elements = elements
        assert len(self) == len(self.validity), (
            f"{len(self)} != {len(self.validity)}")

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = _tuples_from_elements(self.elements, self.validity)
        return self._data

    def __len__(self) -> int:
        if self._data is None:
            return len(self.elements[0])
        return len(self._data)

    @property
    def null_count(self) -> int:
        return int((~self.validity).sum())

    def to_pylist(self) -> List[Any]:
        import datetime
        import decimal
        out: List[Any] = []
        is_bool = isinstance(self.dtype, T.BooleanType)
        is_date = isinstance(self.dtype, T.DateType)
        is_ts = isinstance(self.dtype, T.TimestampType)
        dec_scale = (self.dtype.scale
                     if isinstance(self.dtype, T.DecimalType) else None)
        is_array = isinstance(self.dtype, T.ArrayType)
        is_struct = isinstance(self.dtype, T.StructType)
        epoch = datetime.date(1970, 1, 1)
        ts_epoch = datetime.datetime(1970, 1, 1)
        if T.is_limb_decimal(self.dtype):
            from spark_rapids_tpu_torch.ops import int128 as I
            ints = I.to_pyints(self.data[:, 0], self.data[:, 1])
            return [decimal.Decimal(int(u)).scaleb(-dec_scale)
                    if ok else None
                    for u, ok in zip(ints, self.validity)]
        if self.data.dtype != object and not (
                is_array or is_struct or is_bool or is_date or is_ts
                or dec_scale is not None):
            # plain numbers: one bulk conversion to Python scalars
            return [v if ok else None for v, ok in
                    zip(self.data.tolist(), self.validity.tolist())]
        if is_date and self.data.dtype != object:
            # one date object per distinct day (days outside datetime's
            # year range stay raw ints, as below)
            memo: dict = {}

            def day(v):
                d = memo.get(v)
                if d is None:
                    try:
                        d = epoch + datetime.timedelta(days=v)
                    except OverflowError:
                        d = v
                    memo[v] = d
                return d
            return [day(v) if ok else None for v, ok in
                    zip(self.data.tolist(), self.validity.tolist())]
        for i in range(len(self.data)):
            if not self.validity[i]:
                out.append(None)
            else:
                v = self.data[i]
                if isinstance(v, np.generic):
                    v = v.item()
                if is_array:
                    out.append([_from_storage(x, self.dtype.element_type)
                                for x in v])
                    continue
                if is_struct:
                    out.append(_from_storage(tuple(v), self.dtype))
                    continue
                if is_bool:
                    v = bool(v)
                elif is_date:
                    # pyspark returns datetime.date for DateType; days
                    # outside datetime's year range stay raw ints
                    try:
                        v = epoch + datetime.timedelta(days=v)
                    except OverflowError:
                        pass
                elif is_ts:
                    try:
                        v = ts_epoch + datetime.timedelta(microseconds=v)
                    except OverflowError:
                        pass
                elif dec_scale is not None:
                    v = decimal.Decimal(v).scaleb(-dec_scale)
                out.append(v)
        return out

    def copy(self) -> "HostColumn":
        return HostColumn(self.dtype, self.data.copy(), self.validity.copy())

    def take(self, indices: np.ndarray) -> "HostColumn":
        return HostColumn(self.dtype, self.data[indices],
                          self.validity[indices])

    def slice(self, start: int, end: int) -> "HostColumn":
        """Rows [start, end), the compact forms (``varbytes``,
        ``elements``) sliced with them (an array column built from its
        compact form stays so)."""
        varbytes = elements = None
        if self.varbytes is not None:
            bts, raw = self.varbytes
            lo = int(raw[:start].sum())
            hi = lo + int(raw[start:end].sum())
            varbytes = (bts[lo:hi], raw[start:end])
        if self.elements is not None:
            lengths, child = self.elements
            lo = int(lengths[:start].sum())
            hi = lo + int(lengths[start:end].sum())
            elements = (lengths[start:end], child.slice(lo, hi))
        data = None if self._data is None else self._data[start:end]
        return HostColumn(self.dtype, data, self.validity[start:end],
                          varbytes, elements)

    @staticmethod
    def from_pylist(values: Sequence[Any], dtype: T.DataType) -> "HostColumn":
        n = len(values)
        validity = np.array([v is not None for v in values], dtype=bool)
        if T.is_limb_decimal(dtype):
            from spark_rapids_tpu_torch.ops import int128 as I
            ints = [0 if v is None else _to_storage(v, dtype)
                    for v in values]
            hi, lo = I.from_pyints(ints)
            return HostColumn(dtype, np.stack([hi, lo], axis=1), validity)
        np_dt = T.numpy_dtype(dtype)
        if isinstance(dtype, T.StructType):
            data = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                data[i] = () if v is None else _to_storage(v, dtype)
            return HostColumn(dtype, data, validity)
        if isinstance(dtype, T.ArrayType):
            # canonical element representation is STORAGE form (date ->
            # days, timestamp -> micros, decimal -> unscaled int), like
            # every other column; to_pylist converts back
            et = dtype.element_type
            data = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                data[i] = () if v is None else tuple(
                    None if x is None else _to_storage(x, et) for x in v)
        elif np_dt == np.dtype(object):
            data = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                data[i] = v if v is not None else ""
        else:
            fill = _zero_for(dtype)
            data = np.array(
                [fill if v is None else _to_storage(v, dtype)
                 for v in values], dtype=np_dt)
        return HostColumn(dtype, data, validity)

    @staticmethod
    def all_valid(data: np.ndarray, dtype: T.DataType) -> "HostColumn":
        return HostColumn(dtype, data, np.ones(len(data), dtype=bool))

    @staticmethod
    def nulls(n: int, dtype: T.DataType) -> "HostColumn":
        if T.is_limb_decimal(dtype):
            return HostColumn(dtype, np.zeros((n, 2), dtype=np.int64),
                              np.zeros(n, dtype=bool))
        np_dt = T.numpy_dtype(dtype)
        if np_dt == np.dtype(object):
            data = np.full(n, "", dtype=object)
        else:
            data = np.zeros(n, dtype=np_dt)
        return HostColumn(dtype, data, np.zeros(n, dtype=bool))

    def normalized(self) -> "HostColumn":
        """Zero out invalid slots for deterministic comparison/hashing."""
        out = self.copy()
        inv = ~out.validity
        if isinstance(self.dtype, (T.ArrayType, T.StructType)):
            for i in np.nonzero(inv)[0]:
                out.data[i] = ()
        elif T.is_limb_decimal(self.dtype):
            out.data[inv] = 0  # broadcasts over both limbs
        elif out.data.dtype == np.dtype(object):
            out.data[inv] = ""
        else:
            out.data[inv] = _zero_for(self.dtype)
        return out


def _tuples_from_elements(elements, validity: np.ndarray) -> np.ndarray:
    """The storage-form tuples of an array column from its compact
    form."""
    lengths, child = elements
    values = _storage_values(child)
    out = np.empty(len(lengths), dtype=object)
    off = 0
    for i, (ln, ok) in enumerate(zip(lengths.tolist(),
                                     validity.tolist())):
        out[i] = tuple(values[off:off + ln]) if ok else ()
        off += ln
    return out


def _storage_values(c: "HostColumn") -> List[Any]:
    """A flat column's storage values as Python objects, None where
    null (unscaled ints for limb decimals)."""
    if T.is_limb_decimal(c.dtype):
        from spark_rapids_tpu_torch.ops import int128 as I
        ints = I.to_pyints(np.ascontiguousarray(c.data[:, 0]),
                           np.ascontiguousarray(c.data[:, 1]))
        vals = [int(v) for v in ints]
    else:
        vals = c.data.tolist()
    return [v if ok else None for v, ok in zip(vals, c.validity.tolist())]


def array_elements(c: "HostColumn") -> Tuple[np.ndarray, "HostColumn"]:
    """An array column's compact form ``(lengths, element column)`` (see
    ``HostColumn.elements``), derived from its tuples once and kept on
    the column."""
    if c.elements is None:
        from spark_rapids_tpu_torch.columnar.transfer import \
            _col_from_storage_values
        import itertools
        rows = c.data[np.flatnonzero(c.validity)]
        lengths = np.zeros(len(c.data), dtype=np.int32)
        lengths[c.validity] = np.fromiter(map(len, rows), dtype=np.int32,
                                          count=len(rows))
        elems = list(itertools.chain.from_iterable(rows))
        c.elements = (lengths, _col_from_storage_values(
            elems, c.dtype.element_type))
    return c.elements


def struct_field_values(c: "HostColumn", fi: int) -> List[Any]:
    """Field ``fi``'s storage values out of a struct HostColumn (None
    for null fields/structs/short tuples) — the single copy of the
    subtle guard shared by serde, transfer staging, and hashing."""
    return [c.data[r][fi]
            if c.validity[r] and len(c.data[r]) > fi else None
            for r in range(len(c.data))]


def struct_storage_rows(field_cols: List["HostColumn"],
                        validity: np.ndarray) -> np.ndarray:
    """Field HostColumns -> object array of struct STORAGE tuples
    (unscaled ints for limb decimals, None for null fields, () for null
    structs). The one implementation shared by the device download,
    CreateNamedStruct, and the arrow conversion."""
    n = len(validity)
    field_vals = []
    for fc in field_cols:
        if T.is_limb_decimal(fc.dtype):
            from spark_rapids_tpu_torch.ops import int128 as I
            ints = I.to_pyints(fc.data[:, 0], fc.data[:, 1])
            field_vals.append([
                int(ints[i]) if fc.validity[i] else None
                for i in range(n)])
        else:
            field_vals.append([
                (fc.data[i].item() if isinstance(fc.data[i], np.generic)
                 else fc.data[i]) if fc.validity[i] else None
                for i in range(n)])
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = (tuple(fv[i] for fv in field_vals)
                  if validity[i] else ())
    return out


def _zero_for(dtype: T.DataType) -> Any:
    if isinstance(dtype, T.BooleanType):
        return False
    if isinstance(dtype, (T.FloatType, T.DoubleType)):
        return 0.0
    if isinstance(dtype, (T.ArrayType, T.StructType)):
        return ()
    return 0


def _to_storage(v: Any, dtype: T.DataType) -> Any:
    import datetime
    import decimal
    if isinstance(dtype, T.StructType):
        # storage form: tuple of field storage values (None = null field)
        if isinstance(v, dict):
            vals = [v.get(f.name) for f in dtype.fields]
        else:
            vals = list(v)
        return tuple(None if x is None else _to_storage(x, f.data_type)
                     for x, f in zip(vals, dtype.fields))
    if isinstance(dtype, T.DateType) and isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if isinstance(dtype, T.TimestampType) and isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
        if v.tzinfo is None:
            v = v.replace(tzinfo=datetime.timezone.utc)
        return int((v - epoch).total_seconds() * 1_000_000)
    if isinstance(dtype, T.DecimalType):
        # unscaled int storage: value * 10^scale. A widened local
        # context: the default 28-digit precision rejects 38-digit
        # DECIMAL128 values (InvalidOperation on quantize).
        d = v if isinstance(v, decimal.Decimal) else decimal.Decimal(str(v))
        with decimal.localcontext() as ctx:
            ctx.prec = 80
            q = d.quantize(decimal.Decimal(1).scaleb(-dtype.scale),
                           rounding=decimal.ROUND_HALF_UP)
            return int(q.scaleb(dtype.scale))
    return v


def _from_storage(v: Any, dtype: T.DataType) -> Any:
    """Inverse of _to_storage for collect(): storage ints back to
    python date/datetime/Decimal/bool values (None passes through)."""
    import datetime
    import decimal
    if v is None:
        return None
    if isinstance(dtype, T.StructType):
        return tuple(_from_storage(x, f.data_type)
                     for x, f in zip(v, dtype.fields))
    if isinstance(dtype, T.ArrayType):
        return [_from_storage(x, dtype.element_type) for x in v]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(dtype, T.BooleanType):
        return bool(v)
    if isinstance(dtype, T.DateType):
        try:
            return (datetime.date(1970, 1, 1)
                    + datetime.timedelta(days=v))
        except OverflowError:
            return v
    if isinstance(dtype, T.TimestampType):
        try:
            return (datetime.datetime(1970, 1, 1)
                    + datetime.timedelta(microseconds=v))
        except OverflowError:
            return v
    if isinstance(dtype, T.DecimalType):
        return decimal.Decimal(v).scaleb(-dtype.scale)
    return v


@dataclass
class HostBatch:
    """A batch of rows as host columns; the CPU ColumnarBatch."""

    schema: T.StructType
    columns: List[HostColumn]
    num_rows: int

    def __post_init__(self):
        for c in self.columns:
            assert len(c) == self.num_rows

    @property
    def num_cols(self) -> int:
        return len(self.columns)

    def column(self, i: int) -> HostColumn:
        return self.columns[i]

    def to_pydict(self) -> dict:
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}

    def rows(self) -> Iterator[Tuple]:
        cols = [c.to_pylist() for c in self.columns]
        if not cols:
            return iter([()] * self.num_rows)
        return zip(*(col[:self.num_rows] for col in cols))

    def take(self, indices: np.ndarray) -> "HostBatch":
        return HostBatch(self.schema, [c.take(indices) for c in self.columns],
                         len(indices))

    def slice(self, start: int, end: int) -> "HostBatch":
        end = min(end, self.num_rows)
        return HostBatch(self.schema,
                         [c.slice(start, end) for c in self.columns],
                         max(0, end - start))

    @staticmethod
    def empty(schema: T.StructType) -> "HostBatch":
        return HostBatch(schema,
                         [HostColumn.nulls(0, f.data_type) for f in schema],
                         0)

    @staticmethod
    def from_pydict(data: dict, schema: T.StructType) -> "HostBatch":
        cols = [HostColumn.from_pylist(data[f.name], f.data_type)
                for f in schema.fields]
        n = cols[0].__len__() if cols else 0
        return HostBatch(schema, cols, n)

    @staticmethod
    def concat(batches: Sequence["HostBatch"]) -> "HostBatch":
        """Host-side Table.concatenate."""
        assert batches
        schema = batches[0].schema
        cols = []
        for i, f in enumerate(schema.fields):
            parts = [b.columns[i] for b in batches]
            if all(c._data is None for c in parts):  # compact arrays
                cols.append(HostColumn(
                    f.data_type, None,
                    np.concatenate([c.validity for c in parts]),
                    elements=(np.concatenate([c.elements[0]
                                              for c in parts]),
                              _concat_children([c.elements[1]
                                                for c in parts]))))
                continue
            data = np.concatenate([b.columns[i].data for b in batches])
            val = np.concatenate([b.columns[i].validity for b in batches])
            vbs = [b.columns[i].varbytes for b in batches]
            vb = None
            if all(v is not None for v in vbs):
                vb = (np.concatenate([v[0] for v in vbs]),
                      np.concatenate([v[1] for v in vbs]))
            cols.append(HostColumn(f.data_type, data, val, vb))
        return HostBatch(schema, cols, sum(b.num_rows for b in batches))


def _concat_children(cols: Sequence[HostColumn]) -> HostColumn:
    """Element columns one after another."""
    schema = T.StructType([T.StructField("e", cols[0].dtype)])
    return HostBatch.concat([HostBatch(schema, [c], len(c))
                             for c in cols]).columns[0]
