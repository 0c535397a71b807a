"""Arrow <-> HostBatch conversion and type mapping (the port's copy of
``spark_rapids_tpu.io.arrow_convert``).

Arrow is the host interchange of the file formats: Parquet schema
inference, the host decode of columns the device decode cannot take, and
the writer's HostBatch -> Arrow conversion all go through this module.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T


def arrow_type_to_sql(at: pa.DataType) -> T.DataType:
    if pa.types.is_boolean(at):
        return T.BooleanT
    if pa.types.is_int8(at):
        return T.ByteT
    if pa.types.is_int16(at):
        return T.ShortT
    if pa.types.is_int32(at):
        return T.IntegerT
    if pa.types.is_int64(at):
        return T.LongT
    if pa.types.is_float32(at):
        return T.FloatT
    if pa.types.is_float64(at):
        return T.DoubleT
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return T.StringT
    if pa.types.is_binary(at) or pa.types.is_large_binary(at):
        return T.BinaryT
    if pa.types.is_date32(at):
        return T.DateT
    if pa.types.is_timestamp(at):
        return T.TimestampT
    if pa.types.is_decimal(at):
        return T.DecimalType(at.precision, at.scale)
    # unsigned ints land in the next-wider signed type (Spark has none)
    if pa.types.is_uint8(at):
        return T.ShortT
    if pa.types.is_uint16(at):
        return T.IntegerT
    if pa.types.is_uint32(at) or pa.types.is_uint64(at):
        return T.LongT
    if pa.types.is_list(at) or pa.types.is_large_list(at):
        return T.ArrayType(arrow_type_to_sql(at.value_type))
    if pa.types.is_struct(at):
        return T.StructType([
            T.StructField(at.field(i).name,
                          arrow_type_to_sql(at.field(i).type),
                          at.field(i).nullable)
            for i in range(at.num_fields)])
    raise TypeError(f"unsupported arrow type {at}")


def sql_type_to_arrow(dt: T.DataType) -> pa.DataType:
    if isinstance(dt, T.BooleanType):
        return pa.bool_()
    if isinstance(dt, T.ByteType):
        return pa.int8()
    if isinstance(dt, T.ShortType):
        return pa.int16()
    if isinstance(dt, T.IntegerType):
        return pa.int32()
    if isinstance(dt, T.LongType):
        return pa.int64()
    if isinstance(dt, T.FloatType):
        return pa.float32()
    if isinstance(dt, T.DoubleType):
        return pa.float64()
    if isinstance(dt, T.StringType):
        return pa.string()
    if isinstance(dt, T.BinaryType):
        return pa.binary()
    if isinstance(dt, T.DateType):
        return pa.date32()
    if isinstance(dt, T.TimestampType):
        return pa.timestamp("us", tz="UTC")
    if isinstance(dt, T.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    if isinstance(dt, T.ArrayType):
        return pa.list_(sql_type_to_arrow(dt.element_type))
    if isinstance(dt, T.StructType):
        return pa.struct([
            pa.field(f.name, sql_type_to_arrow(f.data_type), f.nullable)
            for f in dt.fields])
    raise TypeError(f"unsupported sql type {dt}")


def arrow_schema_to_sql(schema: pa.Schema) -> T.StructType:
    return T.StructType([
        T.StructField(f.name, arrow_type_to_sql(f.type), f.nullable)
        for f in schema])


def sql_schema_to_arrow(schema: T.StructType) -> pa.Schema:
    return pa.schema([
        pa.field(f.name, sql_type_to_arrow(f.data_type), f.nullable)
        for f in schema.fields])


def _fill_for(dt: T.DataType):
    if isinstance(dt, T.BooleanType):
        return False
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        return 0.0
    return 0


def _string_varbytes(arr: pa.Array):
    """The compact ``(utf8_bytes, raw_lengths)`` of an Arrow string or
    binary array, for the upload codec (``HostColumn.varbytes``), or
    None where the array has no data buffer. ``raw_lengths`` are the
    unmasked offset deltas: their cumsum gives the byte starts exactly
    (a null slot may own bytes; the decode masks the output lengths
    with validity, not the starts)."""
    if not (pa.types.is_string(arr.type) or pa.types.is_binary(arr.type)
            or pa.types.is_large_string(arr.type)
            or pa.types.is_large_binary(arr.type)):
        return None
    n = len(arr)
    dbuf = arr.buffers()[2]
    if n == 0 or dbuf is None:
        return None
    wide = (pa.types.is_large_string(arr.type)
            or pa.types.is_large_binary(arr.type))
    offs = np.frombuffer(arr.buffers()[1],
                         dtype=np.int64 if wide else np.int32,
                         count=arr.offset + n + 1)[arr.offset:]
    lengths = np.diff(offs).astype(np.int32)
    raw = np.frombuffer(dbuf, dtype=np.uint8, count=int(offs[-1]))
    return np.ascontiguousarray(raw[int(offs[0]):]), lengths


def arrow_column_to_host(arr: pa.ChunkedArray | pa.Array,
                         dt: T.DataType) -> HostColumn:
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    if arr.null_count:
        validity = np.asarray(arr.is_valid())
    else:
        validity = np.ones(n, dtype=bool)
    if isinstance(dt, T.DecimalType):
        # vectorized: decimal128 buffers ARE 16-byte little-endian
        # two's-complement ints — view them as (lo, hi) int64 limb
        # pairs (the engine's unscaled storage) with no per-row loop
        a = arr
        want = pa.decimal128(dt.precision, dt.scale)
        if a.type != want:
            a = a.cast(want)
        buf = a.buffers()[1]
        raw = np.frombuffer(buf, dtype=np.int64,
                            count=2 * (a.offset + n))[2 * a.offset:]
        lo = raw[0::2].copy()
        hi = raw[1::2].copy()
        if arr.null_count:
            lo[~validity] = 0
            hi[~validity] = 0
        if T.is_limb_decimal(dt):
            return HostColumn(dt, np.stack([hi, lo], axis=1), validity)
        return HostColumn(dt, lo, validity)
    np_dt = T.numpy_dtype(dt)
    if isinstance(dt, T.StructType):
        # recurse per field, then zip into storage tuples
        from spark_rapids_tpu_torch.columnar.host import struct_storage_rows
        fields = [arrow_column_to_host(arr.field(i), f.data_type)
                  for i, f in enumerate(dt.fields)]
        return HostColumn(dt, struct_storage_rows(fields, validity),
                          validity)
    if isinstance(dt, T.ArrayType):
        la = arr
        if pa.types.is_large_list(la.type):
            la = la.cast(pa.list_(la.type.value_type))
        offsets = np.asarray(la.offsets, dtype=np.int64)
        child = arrow_column_to_host(la.values, dt.element_type)
        # the compact form: the valid rows' elements in order (a null
        # row's slot, if Arrow gave it any elements, is skipped); the
        # rows' tuples are made from it when first read
        lengths = np.where(validity, np.diff(offsets), 0)
        keep = np.repeat(validity, np.diff(offsets))
        pool = (child.slice(int(offsets[0]), int(offsets[-1]))
                if keep.all() else
                child.take(np.flatnonzero(keep) + offsets[0]))
        return HostColumn(dt, None, validity,
                          elements=(lengths.astype(np.int32), pool))
    if np_dt == np.dtype(object):
        # to_numpy is ~70x faster than a to_pylist loop at SF1 scale
        data = arr.to_numpy(zero_copy_only=False)
        if arr.null_count:
            data = data.copy()
            data[~validity] = ""
        return HostColumn(dt, data, validity, _string_varbytes(arr))
    if isinstance(dt, T.TimestampType):
        arr = arr.cast(pa.timestamp("us"))
        data = np.asarray(arr.cast(pa.int64()).fill_null(0),
                          dtype=np.int64)
        return HostColumn(dt, data, validity)
    if isinstance(dt, T.DateType):
        data = np.asarray(arr.cast(pa.int32()).fill_null(0), dtype=np.int32)
        return HostColumn(dt, data, validity)
    arr = arr.cast(sql_type_to_arrow(dt))
    if arr.null_count:
        arr = arr.fill_null(_fill_for(dt))
    data = np.ascontiguousarray(np.asarray(arr), dtype=np_dt)
    return HostColumn(dt, data, validity)


def arrow_to_host_batch(table: pa.Table,
                        schema: Optional[T.StructType] = None) -> HostBatch:
    if schema is None:
        schema = arrow_schema_to_sql(table.schema)
    cols: List[HostColumn] = []
    for i, f in enumerate(schema.fields):
        cols.append(arrow_column_to_host(table.column(i), f.data_type))
    return HostBatch(schema, cols, table.num_rows)


def host_column_to_arrow(c: HostColumn) -> pa.Array:
    dt = c.dtype
    at = sql_type_to_arrow(dt)
    mask = None if c.validity.all() else ~c.validity
    if isinstance(dt, (T.StringType, T.BinaryType)):
        # pyarrow reads the object array itself; the mask nulls the rows
        return pa.array(c.data, type=at, mask=mask)
    if isinstance(dt, T.ArrayType):
        # the compact form's element column through the scalar path,
        # assembled into a ListArray from the offsets of its lengths
        from spark_rapids_tpu_torch.columnar.host import array_elements
        lengths, elems = array_elements(c)
        offsets = np.zeros(len(lengths) + 1, dtype=np.int32)
        np.cumsum(lengths, out=offsets[1:])
        return pa.ListArray.from_arrays(
            pa.array(offsets, type=pa.int32()), host_column_to_arrow(elems),
            mask=pa.array(mask) if mask is not None else None)
    if isinstance(dt, T.DecimalType):
        # limbs/int64 -> raw 16-byte decimal128 buffer, no per-row loop
        if T.is_limb_decimal(dt):
            hi = np.ascontiguousarray(c.data[:, 0])
            lo = np.ascontiguousarray(c.data[:, 1])
        else:
            lo = c.data.astype(np.int64)
            hi = lo >> np.int64(63)  # sign extension
        pairs = np.empty((len(lo), 2), dtype=np.int64)
        pairs[:, 0] = lo
        pairs[:, 1] = hi
        buf = pa.py_buffer(np.ascontiguousarray(pairs).tobytes())
        if mask is not None:
            vbits = pa.array(~np.asarray(mask), type=pa.bool_()) \
                .buffers()[1]
            return pa.Array.from_buffers(at, len(lo), [vbits, buf],
                                         null_count=int(mask.sum()))
        return pa.Array.from_buffers(at, len(lo), [None, buf])
    if isinstance(dt, T.StructType):
        from spark_rapids_tpu_torch.columnar.host import struct_field_values
        from spark_rapids_tpu_torch.columnar.transfer import \
            _col_from_storage_values
        fields = [host_column_to_arrow(_col_from_storage_values(
            struct_field_values(c, fi), f.data_type))
            for fi, f in enumerate(dt.fields)]
        if mask is not None:
            return pa.StructArray.from_arrays(
                fields, names=[f.name for f in dt.fields],
                mask=pa.array(mask))
        return pa.StructArray.from_arrays(
            fields, names=[f.name for f in dt.fields])
    if isinstance(dt, T.TimestampType):
        a = pa.array(c.data.astype(np.int64), type=pa.int64(), mask=mask)
        return a.cast(at)
    if isinstance(dt, T.DateType):
        a = pa.array(c.data.astype(np.int32), type=pa.int32(), mask=mask)
        return a.cast(at)
    return pa.array(c.data, type=at, mask=mask)


def host_batch_to_arrow(b: HostBatch) -> pa.Table:
    arrays = [host_column_to_arrow(c) for c in b.columns]
    return pa.Table.from_arrays(
        arrays, schema=sql_schema_to_arrow(b.schema))
