"""Serialized columnar batch format of the disk spill tier (the
counterpart of ``spark_rapids_tpu.columnar.serde``, the
GpuColumnarBatchSerializer / MetaUtils TableMeta role): a self-describing
binary encoding of a HostBatch. For the same batch and codec it writes
the same bytes as the JAX package's ``serialize_batch``, so a spill file
of either package reads back in the other. numpy only; pickle carries
code-execution risk and no cross-version contract, so batches on disk
use this format instead.

Layout (little-endian):
  magic 'SRTB' | u16 version | u8 codec | u32 n_rows | u32 n_cols
  u32 schema_len | schema bytes (recursive tag encoding, below)
  u64 payload_len | payload (concatenated column blocks, possibly
  compressed)

Each column block: u8 kind | validity bitmap (ceil(n/8) bytes) | data:
  kind 0 fixed-width: u8 dtype-code, raw array bytes
  kind 1 string/binary: u32 total_bytes, offsets (u32[n+1]), utf-8 bytes
  kind 2 decimal128 limbs: two raw int64 arrays (hi, lo)
  kind 3 array<T>: u32 pool_len, lengths u32[n], elem validity bitmap,
         recursively-encoded element pool column
  kind 4 struct: the validity bitmap, then each field's block

Codec: 0 none, 1 zlib, 2 zstd (spark.rapids.shuffle.compression.codec).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T

MAGIC = b"SRTB"
VERSION = 1

_CODECS = {"none": 0, "zlib": 1, "zstd": 2}
_CODEC_NAMES = {v: k for k, v in _CODECS.items()}

_FIXED_DTYPES = [np.dtype(x) for x in
                 ("bool", "int8", "int16", "int32", "int64",
                  "float32", "float64", "uint8")]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_FIXED_DTYPES)}


def _compress(data: bytes, codec: str) -> bytes:
    if codec == "zlib":
        import zlib
        return zlib.compress(data, 1)
    if codec == "zstd":
        try:
            import zstandard
        except ImportError:
            # gate the optional dep: pyarrow ships a zstd codec; its
            # frames don't embed the content size, so prefix it (both
            # ends of a shuffle/spill run the same build, so the
            # fallback is symmetric)
            import struct

            import pyarrow as pa
            comp = pa.Codec("zstd").compress(data, asbytes=True)
            return struct.pack("<Q", len(data)) + comp
        return zstandard.ZstdCompressor(level=1).compress(data)
    return data


def _decompress(data: bytes, codec_id: int) -> bytes:
    codec = _CODEC_NAMES[codec_id]
    if codec == "zlib":
        import zlib
        return zlib.decompress(data)
    if codec == "zstd":
        try:
            import zstandard
        except ImportError:
            import struct

            import pyarrow as pa
            (n,) = struct.unpack("<Q", data[:8])
            buf = pa.Codec("zstd").decompress(data[8:],
                                              decompressed_size=n)
            return buf.to_pybytes() if hasattr(buf, "to_pybytes") \
                else bytes(buf)
        return zstandard.ZstdDecompressor().decompress(data)
    return data


# -- recursive type encoding ------------------------------------------------

_ATOM_TAGS = [T.BooleanT, T.ByteT, T.ShortT, T.IntegerT, T.LongT,
              T.FloatT, T.DoubleT, T.StringT, T.BinaryT, T.DateT,
              T.TimestampT, T.NullT]


def _enc_type(dt: T.DataType, out: bytearray) -> None:
    if isinstance(dt, T.DecimalType):
        out.append(100)
        out.append(dt.precision)
        out.append(dt.scale)
        return
    if isinstance(dt, T.ArrayType):
        out.append(101)
        _enc_type(dt.element_type, out)
        return
    if isinstance(dt, T.StructType):
        out.append(102)
        out += struct.pack("<H", len(dt.fields))
        for f in dt.fields:
            nb = f.name.encode("utf-8")
            out += struct.pack("<H", len(nb))
            out += nb
            _enc_type(f.data_type, out)
        return
    for i, atom in enumerate(_ATOM_TAGS):
        if dt == atom:
            out.append(i)
            return
    raise TypeError(f"unserializable type {dt}")


def _dec_type(buf: bytes, i: int) -> Tuple[T.DataType, int]:
    tag = buf[i]
    if tag == 100:
        return T.DecimalType(buf[i + 1], buf[i + 2]), i + 3
    if tag == 101:
        et, j = _dec_type(buf, i + 1)
        return T.ArrayType(et), j
    if tag == 102:
        (nf,) = struct.unpack_from("<H", buf, i + 1)
        j = i + 3
        fields = []
        for _ in range(nf):
            (ln,) = struct.unpack_from("<H", buf, j)
            j += 2
            name = bytes(buf[j:j + ln]).decode("utf-8")
            j += ln
            ft, j = _dec_type(buf, j)
            fields.append(T.StructField(name, ft))
        return T.StructType(fields), j
    return _ATOM_TAGS[tag], i + 1


def _enc_schema(schema: T.StructType) -> bytes:
    out = bytearray()
    out += struct.pack("<H", len(schema.fields))
    for f in schema.fields:
        nb = f.name.encode("utf-8")
        out += struct.pack("<H", len(nb))
        out += nb
        _enc_type(f.data_type, out)
    return bytes(out)


def _dec_schema(buf: bytes) -> T.StructType:
    (n,) = struct.unpack_from("<H", buf, 0)
    i = 2
    fields = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<H", buf, i)
        i += 2
        name = buf[i:i + ln].decode("utf-8")
        i += ln
        dt, i = _dec_type(buf, i)
        fields.append(T.StructField(name, dt))
    return T.StructType(fields)


# -- column blocks ----------------------------------------------------------

def _enc_column(c: HostColumn, dt: T.DataType, out: List[bytes]) -> None:
    n = len(c)
    vbits = np.packbits(np.asarray(c.validity, dtype=bool),
                        bitorder="little").tobytes()
    if isinstance(dt, T.ArrayType):
        lengths = np.fromiter((len(v) for v in c.data), dtype=np.uint32,
                              count=n)
        pool: List = []
        for v in c.data:
            pool.extend(v)
        elem_valid = [x is not None for x in pool]
        elem_vals = [0 if x is None else x for x in pool]
        child = HostColumn.from_pylist(
            [None if not ok else v
             for ok, v in zip(elem_valid, elem_vals)], dt.element_type) \
            if pool else HostColumn.nulls(0, dt.element_type)
        out.append(struct.pack("<BI", 3, len(pool)))
        out.append(vbits)
        out.append(lengths.tobytes())
        _enc_column(child, dt.element_type, out)
        return
    if isinstance(dt, T.StructType):
        from spark_rapids_tpu_torch.columnar.host import struct_field_values
        from spark_rapids_tpu_torch.columnar.transfer import \
            _col_from_storage_values
        out.append(struct.pack("<B", 4))
        out.append(vbits)
        for fi, f in enumerate(dt.fields):
            _enc_column(_col_from_storage_values(
                struct_field_values(c, fi), f.data_type),
                f.data_type, out)
        return
    if isinstance(dt, (T.StringType, T.BinaryType)):
        is_bin = isinstance(dt, T.BinaryType)
        encoded = [(v if is_bin else v.encode("utf-8")) if ok else b""
                   for v, ok in zip(c.data, np.asarray(c.validity))]
        offsets = np.zeros(n + 1, dtype=np.uint32)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        out.append(struct.pack("<BI", 1, len(blob)))
        out.append(vbits)
        out.append(offsets.tobytes())
        out.append(blob)
        return
    if T.is_limb_decimal(dt):
        out.append(struct.pack("<B", 2))
        out.append(vbits)
        out.append(np.ascontiguousarray(c.data[:, 0]).tobytes())
        out.append(np.ascontiguousarray(c.data[:, 1]).tobytes())
        return
    data = np.ascontiguousarray(c.data)
    code = _DTYPE_CODE.get(data.dtype)
    if code is None:
        raise TypeError(f"unserializable column dtype {data.dtype}")
    out.append(struct.pack("<BB", 0, code))
    out.append(vbits)
    out.append(data.tobytes())


def _dec_column(buf: memoryview, i: int, n: int, dt: T.DataType
                ) -> Tuple[HostColumn, int]:
    kind = buf[i]
    nvb = (n + 7) // 8
    if kind == 3:
        (pool_len,) = struct.unpack_from("<I", buf, i + 1)
        i += 5
        validity = np.unpackbits(
            np.frombuffer(buf, np.uint8, nvb, i),
            bitorder="little")[:n].astype(bool)
        i += nvb
        lengths = np.frombuffer(buf, np.uint32, n, i)
        i += 4 * n
        child, i = _dec_column(buf, i, pool_len, dt.element_type)
        child_py = child.to_pylist()
        # to_pylist converts to LOGICAL values; re-store them
        from spark_rapids_tpu_torch.columnar.host import _to_storage
        data = np.empty(n, dtype=object)
        off = 0
        for r in range(n):
            ln = int(lengths[r])
            data[r] = tuple(
                None if v is None else _to_storage(v, dt.element_type)
                for v in child_py[off:off + ln]) if validity[r] else ()
            off += ln
        return HostColumn(dt, data, validity), i
    if kind == 4:
        i += 1
        validity = np.unpackbits(
            np.frombuffer(buf, np.uint8, nvb, i),
            bitorder="little")[:n].astype(bool)
        i += nvb
        # decoded field columns are ALREADY storage-form: zip directly
        from spark_rapids_tpu_torch.columnar.host import struct_storage_rows
        fcols = []
        for f in dt.fields:
            fc, i = _dec_column(buf, i, n, f.data_type)
            fcols.append(fc)
        return HostColumn(dt, struct_storage_rows(fcols, validity),
                          validity), i
    if kind == 1:
        (blob_len,) = struct.unpack_from("<I", buf, i + 1)
        i += 5
        validity = np.unpackbits(
            np.frombuffer(buf, np.uint8, nvb, i),
            bitorder="little")[:n].astype(bool)
        i += nvb
        offsets = np.frombuffer(buf, np.uint32, n + 1, i)
        i += 4 * (n + 1)
        blob = bytes(buf[i:i + blob_len])
        i += blob_len
        is_bin = isinstance(dt, T.BinaryType)
        data = np.empty(n, dtype=object)
        for r in range(n):
            raw = blob[offsets[r]:offsets[r + 1]]
            data[r] = (raw if is_bin else raw.decode("utf-8")) \
                if validity[r] else ("" if not is_bin else b"")
        return HostColumn(dt, data, validity), i
    if kind == 2:
        i += 1
        validity = np.unpackbits(
            np.frombuffer(buf, np.uint8, nvb, i),
            bitorder="little")[:n].astype(bool)
        i += nvb
        hi = np.frombuffer(buf, np.int64, n, i).copy()
        i += 8 * n
        lo = np.frombuffer(buf, np.int64, n, i).copy()
        i += 8 * n
        return HostColumn(dt, np.stack([hi, lo], axis=1), validity), i
    # fixed width
    code = buf[i + 1]
    i += 2
    validity = np.unpackbits(
        np.frombuffer(buf, np.uint8, nvb, i),
        bitorder="little")[:n].astype(bool)
    i += nvb
    np_dt = _FIXED_DTYPES[code]
    data = np.frombuffer(buf, np_dt, n, i).copy()
    i += np_dt.itemsize * n
    return HostColumn(dt, data, validity), i


def serialize_batch(b: HostBatch, codec: str = "none") -> bytes:
    if codec not in _CODECS:
        raise ValueError(f"unknown codec {codec!r}: {sorted(_CODECS)}")
    blocks: List[bytes] = []
    for f, c in zip(b.schema.fields, b.columns):
        _enc_column(c, f.data_type, blocks)
    payload = _compress(b"".join(blocks), codec)
    schema = _enc_schema(b.schema)
    head = MAGIC + struct.pack("<HBII", VERSION, _CODECS[codec],
                               b.num_rows, b.num_cols)
    return head + struct.pack("<I", len(schema)) + schema \
        + struct.pack("<Q", len(payload)) + payload


def deserialize_batch(data: bytes) -> HostBatch:
    if data[:4] != MAGIC:
        raise ValueError("not a serialized batch")
    version, codec_id, n_rows, n_cols = struct.unpack_from("<HBII", data, 4)
    if version != VERSION:
        raise ValueError(f"serialized batch version {version}, "
                         f"expected {VERSION}")
    i = 4 + 11
    (slen,) = struct.unpack_from("<I", data, i)
    i += 4
    schema = _dec_schema(data[i:i + slen])
    i += slen
    (plen,) = struct.unpack_from("<Q", data, i)
    i += 8
    payload = memoryview(_decompress(data[i:i + plen], codec_id))
    cols = []
    j = 0
    for f in schema.fields:
        c, j = _dec_column(payload, j, n_rows, f.data_type)
        cols.append(c)
    return HostBatch(schema, cols, n_rows)
