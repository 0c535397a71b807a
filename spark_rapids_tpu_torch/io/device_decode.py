"""Device-side Parquet decode, host half: the host plans, the card
decodes (the port's copy of ``spark_rapids_tpu.io.device_decode``).

The host does only the cheap, sequential work:

1. read the raw column-chunk bytes (one contiguous read per chunk),
2. decompress page bodies (snappy/zstd/gzip through pyarrow's codecs;
   the wire then carries the uncompressed but still encoded pages),
3. parse page headers (Thrift compact protocol) and RLE/bit-packed run
   headers (a varint per run),

and builds a ``ColumnDevicePlan`` per column: run tables, page tables and
decoded dictionaries. Every per-value operation (bit-unpacking, the
dictionary gather, PLAIN and FLBA reinterpretation, DELTA and
BYTE_STREAM_SPLIT reconstruction, string offsets and bytes, definition
levels into validity) happens on the card in the ``decodeFused`` kernel
(``kernels/decode_fused.py``), or in its plain PyTorch version on a CPU
tensor (``columnar/transfer.py``).

Columns whose shape the device decode does not take (nested, INT96,
DELTA_BYTE_ARRAY, ...) raise ``UnsupportedColumn`` and host-decode one by
one through pyarrow; any other error propagates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.sql import types as T

# Parquet enums (format/parquet.thrift)
PAGE_DATA = 0
PAGE_INDEX = 1
PAGE_DICTIONARY = 2
PAGE_DATA_V2 = 3

ENC_PLAIN = 0
ENC_PLAIN_DICTIONARY = 2
ENC_RLE = 3
ENC_BIT_PACKED = 4
ENC_DELTA_BINARY_PACKED = 5
ENC_DELTA_LENGTH_BYTE_ARRAY = 6
ENC_DELTA_BYTE_ARRAY = 7
ENC_RLE_DICTIONARY = 8
ENC_BYTE_STREAM_SPLIT = 9

_ENC_NAMES = {ENC_PLAIN: "PLAIN", ENC_PLAIN_DICTIONARY: "PLAIN_DICTIONARY",
              ENC_RLE: "RLE", ENC_RLE_DICTIONARY: "RLE_DICTIONARY",
              ENC_DELTA_BINARY_PACKED: "DELTA_BINARY_PACKED",
              ENC_DELTA_LENGTH_BYTE_ARRAY: "DELTA_LENGTH_BYTE_ARRAY",
              ENC_DELTA_BYTE_ARRAY: "DELTA_BYTE_ARRAY",
              ENC_BYTE_STREAM_SPLIT: "BYTE_STREAM_SPLIT"}

# per-page value-section encoding classes shipped to the device
# (columnar/transfer.py selects the decode lane per page by these)
PGE_DICT = 0     # RLE/bit-packed hybrid stream (dict indices, bool bits)
PGE_PLAIN = 1    # PLAIN fixed-width at pg_plain_byte
PGE_DELTA = 2    # DELTA_BINARY_PACKED (miniblock runs + seg-cumsum)
PGE_BSS = 3      # BYTE_STREAM_SPLIT at pg_plain_byte
PGE_PLAIN_STR = 4  # PLAIN byte array (4-byte length prefixes)
PGE_DL_STR = 5   # DELTA_LENGTH byte array (concatenated bytes)

# searchsorted sentinel for padded run/page tables
_SENTINEL = 1 << 62


_HOST_CODECS = {"UNCOMPRESSED": None, "SNAPPY": "snappy", "ZSTD": "zstd",
                "GZIP": "gzip", "BROTLI": "brotli"}


class UnsupportedColumn(Exception):
    """Per-column fallback trigger; the message is the reason string."""


# ---------------------------------------------------------------------------
# Thrift compact protocol (just enough for PageHeader)
# ---------------------------------------------------------------------------

_CT_TRUE, _CT_FALSE, _CT_BYTE = 1, 2, 3
_CT_I16, _CT_I32, _CT_I64, _CT_DOUBLE = 4, 5, 6, 7
_CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = 8, 9, 10, 11, 12


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(buf: bytes, pos: int) -> Tuple[int, int]:
    v, pos = _varint(buf, pos)
    return (v >> 1) ^ -(v & 1), pos


def _skip(buf: bytes, pos: int, ftype: int) -> int:
    if ftype in (_CT_TRUE, _CT_FALSE):
        return pos
    if ftype == _CT_BYTE:
        return pos + 1
    if ftype in (_CT_I16, _CT_I32, _CT_I64):
        _, pos = _varint(buf, pos)
        return pos
    if ftype == _CT_DOUBLE:
        return pos + 8
    if ftype == _CT_BINARY:
        n, pos = _varint(buf, pos)
        return pos + n
    if ftype == _CT_STRUCT:
        _, pos = _thrift_struct(buf, pos)
        return pos
    if ftype in (_CT_LIST, _CT_SET):
        h = buf[pos]
        pos += 1
        n, et = h >> 4, h & 0x0F
        if n == 15:
            n, pos = _varint(buf, pos)
        for _ in range(n):
            pos = _skip(buf, pos, et)
        return pos
    if ftype == _CT_MAP:
        n, pos = _varint(buf, pos)
        if n:
            h = buf[pos]
            pos += 1
            for _ in range(n):
                pos = _skip(buf, pos, h >> 4)
                pos = _skip(buf, pos, h & 0x0F)
        return pos
    raise UnsupportedColumn(f"thrift type {ftype} in page header")


def _thrift_struct(buf: bytes, pos: int) -> Tuple[Dict[int, Any], int]:
    """Generic compact-protocol struct -> {field_id: value}; nested
    structs recurse, unknown field types are skipped."""
    out: Dict[int, Any] = {}
    fid = 0
    while True:
        b = buf[pos]
        pos += 1
        if b == 0:
            return out, pos
        delta, ftype = b >> 4, b & 0x0F
        if delta:
            fid += delta
        else:
            fid, pos = _zigzag(buf, pos)
        if ftype in (_CT_TRUE, _CT_FALSE):
            out[fid] = ftype == _CT_TRUE
        elif ftype == _CT_BYTE:
            out[fid] = buf[pos]
            pos += 1
        elif ftype in (_CT_I16, _CT_I32, _CT_I64):
            out[fid], pos = _zigzag(buf, pos)
        elif ftype == _CT_STRUCT:
            out[fid], pos = _thrift_struct(buf, pos)
        else:
            pos = _skip(buf, pos, ftype)


def parse_page_header(buf: bytes, pos: int) -> Tuple[Dict[int, Any], int]:
    """PageHeader at ``pos`` -> (fields, body_offset). Field ids follow
    parquet.thrift: 1 type, 2 uncompressed_page_size,
    3 compressed_page_size, 5 data_page_header {1 num_values,
    2 encoding, 3 definition_level_encoding}, 7 dictionary_page_header
    {1 num_values, 2 encoding}, 8 data_page_header_v2 {1 num_values,
    2 num_nulls, 3 num_rows, 4 encoding, 5 definition_levels_byte_length,
    6 repetition_levels_byte_length, 7 is_compressed}."""
    return _thrift_struct(buf, pos)


# ---------------------------------------------------------------------------
# Plan structures
# ---------------------------------------------------------------------------

@dataclass
class RunTable:
    """RLE/bit-packed hybrid runs, host-parsed headers only: where each
    run's output starts, whether it is bit-packed, the RLE value,
    the absolute payload bit offset into the packed buffer, and the
    per-run bit width (dictionary index width varies across pages)."""

    out_start: List[int] = field(default_factory=list)
    packed: List[bool] = field(default_factory=list)
    value: List[int] = field(default_factory=list)
    bit_start: List[int] = field(default_factory=list)
    width: List[int] = field(default_factory=list)

    def add(self, out_start: int, packed: bool, value: int,
            bit_start: int, width: int) -> None:
        self.out_start.append(out_start)
        self.packed.append(packed)
        self.value.append(value)
        self.bit_start.append(bit_start)
        self.width.append(width)

    def __len__(self) -> int:
        return len(self.out_start)

    def arrays(self, pad_to: int) -> List[np.ndarray]:
        nr = len(self.out_start)
        os = np.full(pad_to, _SENTINEL, dtype=np.int64)
        os[:nr] = self.out_start
        pk = np.zeros(pad_to, dtype=bool)
        pk[:nr] = self.packed
        va = np.zeros(pad_to, dtype=np.int64)
        va[:nr] = self.value
        bs = np.zeros(pad_to, dtype=np.int64)
        bs[:nr] = self.bit_start
        wd = np.ones(pad_to, dtype=np.int64)
        wd[:nr] = self.width
        return [os, pk, va, bs, wd]


@dataclass
class ColumnDevicePlan:
    """One column chunk's device-decode plan (see module docstring)."""

    kind: str             # int | f32 | f64 | dec64 | dec128 | bool | str
    np_dtype: str         # output numpy dtype name for 'int' kinds
    elem_bytes: int       # PLAIN element width (FLBA length for decimals)
    dl: Optional[RunTable]         # definition levels (None = no nulls)
    pg_dense_start: List[int] = field(default_factory=list)
    pg_plain_byte: List[int] = field(default_factory=list)  # -1 = dict page
    pg_enc: List[int] = field(default_factory=list)         # PGE_* class
    pg_first: List[int] = field(default_factory=list)  # delta first_value
    vr: Optional[RunTable] = None  # dict-index / bool-bit runs
    dr: Optional[RunTable] = None  # delta miniblock runs (value=min_delta)
    str_lens: Optional[np.ndarray] = None  # dense byte lengths (plain/DL)
    dict_arrays: List[np.ndarray] = field(default_factory=list)
    char_cap: int = 0
    has_plain: bool = False
    has_delta: bool = False
    has_bss: bool = False
    encoding_values: Dict[str, int] = field(default_factory=dict)


@dataclass
class EncodedBatch:
    """A scan unit staged for device decode: the packed page buffer plus
    per-column plans; columns that fell back carry a HostColumn
    instead. Consumed by ``transfer.prepare_encoded_upload``."""

    schema: T.StructType
    num_rows: int
    words: np.ndarray                      # int32 staging words
    plans: Dict[int, ColumnDevicePlan]     # field index -> device plan
    host_cols: Dict[int, Any]              # field index -> HostColumn
    fallbacks: List[Tuple[str, str]]       # (column, reason)
    # host-decoded value counts per Parquet data encoding for the
    # fallback columns (the scan's hostDecodedValues.* counters)
    fallback_encodings: Dict[str, int] = field(default_factory=dict)
    # the unit's pyarrow host decode (a list of HostBatches), attached by
    # the scan: the upload's OOM fallback for this batch only
    host_fallback: Optional[Callable[[], list]] = None


# ---------------------------------------------------------------------------
# Host-side planner
# ---------------------------------------------------------------------------

def _check_supported(dt: T.DataType, leaf) -> None:
    """Raise UnsupportedColumn unless the file's physical/logical type
    decodes losslessly into ``dt``'s device storage on this backend."""
    if leaf.max_repetition_level > 0:
        raise UnsupportedColumn("nested (repeated) column")
    if leaf.max_definition_level > 1:
        raise UnsupportedColumn("nested optional column")
    phys = leaf.physical_type
    lt = str(leaf.logical_type)
    if isinstance(dt, T.BooleanType):
        if phys != "BOOLEAN":
            raise UnsupportedColumn(f"physical {phys} for boolean")
        return
    if isinstance(dt, T.ByteType):
        if phys != "INT32" or "bitWidth=8" not in lt:
            raise UnsupportedColumn(f"physical {phys}/{lt} for tinyint")
        return
    if isinstance(dt, T.ShortType):
        if phys != "INT32" or "bitWidth=16" not in lt:
            raise UnsupportedColumn(f"physical {phys}/{lt} for smallint")
        return
    if isinstance(dt, T.IntegerType):
        if phys != "INT32" or not (lt == "None" or "bitWidth=32" in lt):
            raise UnsupportedColumn(f"physical {phys}/{lt} for int")
        return
    if isinstance(dt, T.LongType):
        if phys != "INT64" or not (lt == "None" or "bitWidth=64" in lt):
            raise UnsupportedColumn(f"physical {phys}/{lt} for bigint")
        return
    if isinstance(dt, T.FloatType):
        if phys != "FLOAT":
            raise UnsupportedColumn(f"physical {phys} for float")
        return
    if isinstance(dt, T.DoubleType):
        if phys != "DOUBLE":
            raise UnsupportedColumn(f"physical {phys} for double")
        from spark_rapids_tpu_torch.device_caps import F64_BITCAST_EXACT
        if not F64_BITCAST_EXACT:
            raise UnsupportedColumn(
                "f64 bitcast unsupported on this backend")
        return
    if isinstance(dt, T.DateType):
        if phys != "INT32" or lt != "Date":
            raise UnsupportedColumn(f"physical {phys}/{lt} for date")
        return
    if isinstance(dt, T.TimestampType):
        if phys != "INT64" or not lt.startswith("Timestamp") \
                or "micro" not in lt:
            raise UnsupportedColumn(f"physical {phys}/{lt} for timestamp")
        return
    if isinstance(dt, T.DecimalType):
        if f"precision={dt.precision}, scale={dt.scale}" not in lt:
            raise UnsupportedColumn(f"logical {lt} != {dt.simple_string}")
        if phys == "FIXED_LEN_BYTE_ARRAY":
            w = leaf.length
            if T.is_limb_decimal(dt):
                if not 8 < w <= 16:
                    raise UnsupportedColumn(f"FLBA width {w} for dec128")
            elif not 0 < w <= 8:
                raise UnsupportedColumn(f"FLBA width {w} for dec64")
            return
        if phys == "INT64" and not T.is_limb_decimal(dt):
            return
        if phys == "INT32" and not T.is_limb_decimal(dt):
            return
        raise UnsupportedColumn(f"physical {phys} for {dt.simple_string}")
    if isinstance(dt, (T.StringType, T.BinaryType)):
        if phys != "BYTE_ARRAY":
            raise UnsupportedColumn(f"physical {phys} for string/binary")
        return  # per-page dictionary-only check happens during the walk
    raise UnsupportedColumn(f"type {dt.simple_string} not device-decodable")


def _kind_for(dt: T.DataType, leaf) -> Tuple[str, str, int]:
    """(kind, np_dtype_name, plain_elem_bytes) for a supported column."""
    if isinstance(dt, T.BooleanType):
        return "bool", "bool", 0
    if isinstance(dt, T.ByteType):
        return "int", "int8", 4
    if isinstance(dt, T.ShortType):
        return "int", "int16", 4
    if isinstance(dt, (T.IntegerType, T.DateType)):
        return "int", "int32", 4
    if isinstance(dt, (T.LongType, T.TimestampType)):
        return "int", "int64", 8
    if isinstance(dt, T.FloatType):
        return "f32", "float32", 4
    if isinstance(dt, T.DoubleType):
        return "f64", "float64", 8
    if isinstance(dt, T.DecimalType):
        phys = leaf.physical_type
        if phys == "INT32":
            return "int", "int64", 4
        if phys == "INT64":
            return "int", "int64", 8
        if T.is_limb_decimal(dt):
            return "dec128", "int64", leaf.length
        return "dec64", "int64", leaf.length
    return "str", "uint8", 0


def _parse_hybrid_runs(page: bytes, pos: int, end: int, width: int,
                       n_values: int, out_base: int, page_buf_off: int,
                       runs: RunTable) -> Tuple[int, List[Tuple[int, int]]]:
    """Parse run HEADERS of an RLE/bit-packed hybrid stream (payload
    stays in the page bytes for the device). Returns (stream_end_pos,
    packed_regions) where packed_regions are (page_pos, n_vals) of
    bit-packed payloads (the host popcounts these for validity
    bookkeeping when parsing definition levels)."""
    if width == 0:
        # zero-width stream: every value is 0, no bytes consumed
        runs.add(out_base, False, 0, 0, 1)
        return pos, []
    count = 0
    vbytes = (width + 7) // 8
    packed_regions: List[Tuple[int, int]] = []
    while count < n_values:
        if pos >= end:
            raise UnsupportedColumn("truncated RLE/bit-packed stream")
        header, pos = _varint(page, pos)
        if header & 1:  # bit-packed: groups of 8 values
            groups = header >> 1
            nv = min(groups * 8, n_values - count)
            runs.add(out_base + count, True, 0,
                     (page_buf_off + pos) * 8, width)
            packed_regions.append((pos, nv))
            pos += groups * width
            count += nv
        else:  # RLE run
            run_len = header >> 1
            if run_len == 0:
                raise UnsupportedColumn("zero-length RLE run")
            v = int.from_bytes(page[pos:pos + vbytes], "little")
            pos += vbytes
            runs.add(out_base + count, False, v, 0, width)
            count += min(run_len, n_values - count)
    return pos, packed_regions


def _popcount_regions(page: bytes, regions: List[Tuple[int, int]]) -> int:
    """Non-null count contribution of bit-packed def-level regions
    (width-1 streams): vectorized popcount over the payload bytes."""
    total = 0
    for pos, nv in regions:
        nbytes = (nv + 7) // 8
        bits = np.unpackbits(
            np.frombuffer(page, dtype=np.uint8, offset=pos, count=nbytes),
            bitorder="little")[:nv]
        total += int(bits.sum())
    return total


def _plain_str_lengths(body: bytes, pos: int, end: int,
                       nn: int) -> np.ndarray:
    """Per-value byte lengths of a PLAIN byte-array page (4-byte LE
    length prefixes interleaved with the bytes). The value starts form
    a sequential chain (start[i+1] = start[i] + 4 + len[i]); resolved
    with vectorized pointer doubling over a byte-position jump table —
    O(page_bytes * log n) numpy work, no per-value Python loop."""
    if nn <= 0:
        return np.zeros(0, dtype=np.int64)
    if (end - pos) * max(1, nn.bit_length()) > 100 * nn:
        # long values: one step a value costs less than the doubling's
        # log(n) passes over every byte
        return _plain_str_lengths_walk(body, pos, end, nn)
    buf = np.frombuffer(body, dtype=np.uint8, offset=pos,
                        count=end - pos).astype(np.int64)
    B = buf.shape[0]
    if B < 4:
        raise UnsupportedColumn("truncated PLAIN byte-array page")
    le = (buf[:-3] | (buf[1:-2] << 8) | (buf[2:-1] << 16)
          | (buf[3:] << 24))        # u32 length at every byte position
    limit = B - 3
    nxt = np.arange(limit, dtype=np.int64) + 4 + le
    np.clip(nxt, 0, limit - 1, out=nxt)   # keep the table in-domain
    starts = np.empty(nn, dtype=np.int64)
    starts[0] = 0
    filled = 1
    jump = nxt                            # jumps exactly `filled` values
    while filled < nn:
        take = min(filled, nn - filled)
        starts[filled:filled + take] = jump[starts[:take]]
        filled += take
        if filled < nn:
            jump = jump[jump]
    lengths = le[starts]
    if nn >= 2 and not (np.diff(starts) > 0).all():
        raise UnsupportedColumn("corrupt PLAIN byte-array chain")
    if int(starts[-1]) + 4 + int(lengths[-1]) > B:
        raise UnsupportedColumn("PLAIN byte-array page overruns body")
    return lengths


def _plain_str_lengths_walk(body: bytes, pos: int, end: int,
                            nn: int) -> np.ndarray:
    """``_plain_str_lengths`` by following the chain one value at a
    time."""
    view = memoryview(body)
    frm = int.from_bytes
    out = []
    for _ in range(nn):
        if pos + 4 > end:
            raise UnsupportedColumn("PLAIN byte-array page overruns body")
        ln = frm(view[pos:pos + 4], "little")
        out.append(ln)
        pos += 4 + ln
    if pos > end:
        raise UnsupportedColumn("PLAIN byte-array page overruns body")
    return np.array(out, dtype=np.int64)


def _parse_delta_header(page: bytes, pos: int) -> Tuple[int, int, int,
                                                        int, int]:
    """DELTA_BINARY_PACKED stream header ->
    (values_per_miniblock, miniblocks_per_block, total_count,
    first_value, pos_after_header)."""
    block_size, pos = _varint(page, pos)
    mbpb, pos = _varint(page, pos)
    total, pos = _varint(page, pos)
    first, pos = _zigzag(page, pos)
    if mbpb <= 0 or block_size <= 0 or block_size % mbpb:
        raise UnsupportedColumn("malformed delta header")
    vpm = block_size // mbpb
    if vpm % 8:
        raise UnsupportedColumn(f"delta miniblock size {vpm}")
    return vpm, mbpb, total, first, pos


def _parse_delta_runs(page: bytes, pos: int, end: int, out_base: int,
                      page_buf_off: int, runs: RunTable
                      ) -> Tuple[int, int, int]:
    """Parse DELTA_BINARY_PACKED block/miniblock HEADERS (the payload
    stays in the page bytes for the device): appends one run per
    miniblock with out_start in dense-lane coordinates (the lane of the
    miniblock's FIRST delta = out_base + 1 + delta_index), value =
    the block's min_delta, and the payload's absolute bit offset.
    Returns (first_value, total_count, stream_end_pos)."""
    vpm, mbpb, total, first, pos = _parse_delta_header(page, pos)
    remaining = total - 1
    di = 0
    while remaining > 0:
        if pos >= end:
            raise UnsupportedColumn("truncated delta stream")
        md, pos = _zigzag(page, pos)
        widths = page[pos:pos + mbpb]
        pos += mbpb
        for w in widths:
            if remaining <= 0:
                break
            if w > 64:
                raise UnsupportedColumn(f"delta bit width {w}")
            nv = min(vpm, remaining)
            runs.add(out_base + 1 + di, True, md,
                     (page_buf_off + pos) * 8, w)
            pos += vpm * w // 8
            di += nv
            remaining -= nv
    if pos > end:
        # a truncated last miniblock would otherwise point the device
        # kernel past this page into neighbor bytes — fall back instead
        raise UnsupportedColumn("delta stream overruns page")
    return first, total, pos


def _delta_decode_host(page: bytes, pos: int, end: int
                       ) -> Tuple[np.ndarray, int]:
    """Full host decode of one DELTA_BINARY_PACKED stream (used for
    DELTA_LENGTH_BYTE_ARRAY *lengths*, which the host needs anyway to
    size the static char matrix): vectorized per miniblock via
    unpackbits, wrap-around arithmetic in uint64. Returns
    (int64 values, stream_end_pos)."""
    vpm, mbpb, total, first, pos = _parse_delta_header(page, pos)
    first_u = np.uint64(first & 0xFFFFFFFFFFFFFFFF)
    if total <= 0:
        return np.zeros(0, dtype=np.int64), pos
    deltas = np.zeros(max(0, total - 1), dtype=np.uint64)
    remaining = total - 1
    di = 0
    shifts = {}
    while remaining > 0:
        if pos >= end:
            raise UnsupportedColumn("truncated delta stream")
        md, pos = _zigzag(page, pos)
        md_u = np.uint64(md & 0xFFFFFFFFFFFFFFFF)
        widths = page[pos:pos + mbpb]
        pos += mbpb
        for w in widths:
            if remaining <= 0:
                break
            if w > 64:
                raise UnsupportedColumn(f"delta bit width {w}")
            nv = min(vpm, remaining)
            nb = vpm * w // 8
            if w:
                bits = np.unpackbits(
                    np.frombuffer(page, dtype=np.uint8, offset=pos,
                                  count=nb), bitorder="little")
                if w not in shifts:
                    shifts[w] = np.arange(w, dtype=np.uint64)
                vals = (bits.reshape(vpm, w).astype(np.uint64)
                        << shifts[w]).sum(axis=1, dtype=np.uint64)
                deltas[di:di + nv] = vals[:nv] + md_u
            else:
                deltas[di:di + nv] = md_u
            pos += nb
            di += nv
            remaining -= nv
    out = np.empty(total, dtype=np.uint64)
    out[0] = first_u
    if total > 1:
        np.cumsum(deltas, out=out[1:])
        out[1:] += first_u
    return out.view(np.int64), pos


def _decode_dict_page(body: bytes, nvals: int, dt: T.DataType,
                      kind: str, leaf) -> Tuple[List[np.ndarray], int]:
    """PLAIN dictionary page -> host-decoded lookup arrays (dictionaries
    are bounded by the writer's dict-page limit, ~1MB, so host decode
    here is footer-scale work, not row-scale)."""
    if kind == "int":
        phys = leaf.physical_type
        np_in = np.int32 if phys == "INT32" else np.int64
        vals = np.frombuffer(body, dtype=np_in, count=nvals)
        return [vals.astype(np.int64)], 0
    if kind == "f32":
        raw = np.frombuffer(body, dtype=np.int32, count=nvals)
        return [raw.astype(np.int64)], 0
    if kind == "f64":
        return [np.frombuffer(body, dtype=np.int64, count=nvals).copy()], 0
    if kind in ("dec64", "dec128"):
        w = leaf.length
        b = np.frombuffer(body, dtype=np.uint8,
                          count=nvals * w).reshape(nvals, w)
        if kind == "dec64":
            acc = np.zeros(nvals, dtype=np.int64)
            for k in range(w):
                acc = (acc << 8) | b[:, k].astype(np.int64)
            if w < 8:
                acc -= (acc >> (8 * w - 1)) << (8 * w)
            return [acc], 0
        hi_w = w - 8
        hi = np.zeros(nvals, dtype=np.int64)
        for k in range(hi_w):
            hi = (hi << 8) | b[:, k].astype(np.int64)
        if hi_w < 8:
            hi -= (hi >> (8 * hi_w - 1)) << (8 * hi_w)
        lo = np.zeros(nvals, dtype=np.uint64)
        for k in range(hi_w, w):
            lo = (lo << np.uint64(8)) | b[:, k].astype(np.uint64)
        return [hi, lo.view(np.int64)], 0
    if kind == "str":
        from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
        lens = _plain_str_lengths(body, 0, len(body), nvals)
        char_cap = bucket_char_cap(max(1, int(lens.max(initial=0))))
        chars = np.zeros((max(nvals, 1), char_cap), dtype=np.uint8)
        lengths = np.zeros(max(nvals, 1), dtype=np.int32)
        if nvals:
            # value i's bytes follow its 4-byte prefix: gather them all
            # at once into the rows of the char matrix
            ends = np.cumsum(lens + 4)
            firsts = ends - lens
            inner = np.arange(int(lens.sum())) - np.repeat(
                np.cumsum(lens) - lens, lens)
            raw = np.frombuffer(body, dtype=np.uint8)
            keep = np.arange(char_cap)[None, :] < lens[:, None]
            chars[:nvals][keep] = raw[np.repeat(firsts, lens) + inner]
            lengths[:nvals] = lens
        return [chars, lengths], char_cap
    raise UnsupportedColumn(f"dictionary for kind {kind}")


def _plan_column(raw: bytes, chunk, leaf, dt: T.DataType, n_rows: int,
                 packer) -> ColumnDevicePlan:
    """Walk one column chunk's pages, appending decompressed page bytes
    to ``packer`` and building the device plan."""
    _check_supported(dt, leaf)
    codec_name = _HOST_CODECS.get(chunk.compression, "?")
    if codec_name == "?":
        raise UnsupportedColumn(f"codec {chunk.compression}")
    kind, np_dt, elem_bytes = _kind_for(dt, leaf)
    max_def = leaf.max_definition_level

    start, end = 0, len(raw)  # raw is exactly the chunk's byte range

    plan = ColumnDevicePlan(kind, np_dt, elem_bytes,
                            dl=RunTable(), vr=RunTable(), dr=RunTable())
    import pyarrow as pa
    codec = pa.Codec(codec_name) if codec_name else None

    rows = 0       # rows consumed (levels)
    dense = 0      # non-null values consumed
    n_dict = 0
    all_valid_runs = True
    str_parts: List[Tuple[int, np.ndarray]] = []  # (dense_off, lengths)
    pos = start
    while pos < end:
        hdr, body_off = parse_page_header(raw, pos)
        ptype = hdr.get(1)
        usize, csize = hdr.get(2, 0), hdr.get(3, 0)
        body = raw[body_off:body_off + csize]
        pos = body_off + csize
        if ptype == PAGE_INDEX:
            continue
        if ptype == PAGE_DICTIONARY:
            dph = hdr.get(7, {})
            if dph.get(2, ENC_PLAIN) not in (ENC_PLAIN,
                                             ENC_PLAIN_DICTIONARY):
                raise UnsupportedColumn("non-PLAIN dictionary page")
            if codec is not None:
                body = codec.decompress(body, usize).to_pybytes()
            n_dict = dph.get(1, 0)
            plan.dict_arrays, plan.char_cap = _decode_dict_page(
                body, n_dict, dt, kind, leaf)
            continue
        if ptype == PAGE_DATA:
            dph = hdr.get(5)
            if dph is None:
                raise UnsupportedColumn("data page without header")
            nv = dph.get(1, 0)
            enc = dph.get(2, ENC_PLAIN)
            if max_def and dph.get(3, ENC_RLE) != ENC_RLE:
                raise UnsupportedColumn("non-RLE definition levels")
            if codec is not None:
                body = codec.decompress(body, usize).to_pybytes()
            val_off = 0
            def_section = None
            if max_def:
                dl_len = int.from_bytes(body[0:4], "little")
                def_section = (4, 4 + dl_len)
                val_off = 4 + dl_len
        elif ptype == PAGE_DATA_V2:
            dph = hdr.get(8)
            if dph is None:
                raise UnsupportedColumn("v2 page without header")
            nv = dph.get(1, 0)
            enc = dph.get(4, ENC_PLAIN)
            rep_len = dph.get(6, 0)
            dl_len = dph.get(5, 0)
            if rep_len:
                raise UnsupportedColumn("v2 repetition levels")
            levels = body[:dl_len]
            values = body[dl_len:]
            if dph.get(7, True) and codec is not None:
                values = codec.decompress(
                    values, usize - dl_len).to_pybytes()
            body = levels + values
            def_section = (0, dl_len) if max_def else None
            val_off = dl_len
        else:
            raise UnsupportedColumn(f"page type {ptype}")

        if nv == 0:
            continue
        page_off = packer.add(np.frombuffer(body, dtype=np.uint8))

        # definition levels -> validity runs (+ per-page non-null count)
        nn = nv
        if def_section is not None:
            width = max_def.bit_length()
            dl_runs = RunTable()
            _, regions = _parse_hybrid_runs(
                body, def_section[0], def_section[1], width, nv,
                rows, page_off, dl_runs)
            nn = _popcount_regions(body, regions)
            for i in range(len(dl_runs)):
                plan.dl.add(dl_runs.out_start[i], dl_runs.packed[i],
                            dl_runs.value[i], dl_runs.bit_start[i],
                            dl_runs.width[i])
                if dl_runs.packed[i]:
                    all_valid_runs = False
                elif dl_runs.value[i] != max_def:
                    all_valid_runs = False
                else:
                    nxt = (dl_runs.out_start[i + 1]
                           if i + 1 < len(dl_runs) else rows + nv)
                    nn += nxt - dl_runs.out_start[i]

        # value section
        plan.pg_dense_start.append(dense)
        ename = _ENC_NAMES.get(enc, str(enc))
        plan.encoding_values[ename] = \
            plan.encoding_values.get(ename, 0) + nn
        plan.pg_first.append(0)
        if enc in (ENC_PLAIN_DICTIONARY, ENC_RLE_DICTIONARY):
            if not plan.dict_arrays:
                raise UnsupportedColumn("dictionary page missing")
            vw = body[val_off]
            if vw > 32:
                raise UnsupportedColumn(f"dict index width {vw}")
            _parse_hybrid_runs(body, val_off + 1, len(body), vw, nn,
                               dense, page_off, plan.vr)
            plan.pg_enc.append(PGE_DICT)
            plan.pg_plain_byte.append(-1)
        elif enc == ENC_PLAIN and kind == "str":
            lens = _plain_str_lengths(body, val_off, len(body), nn)
            str_parts.append((dense, lens))
            plan.pg_enc.append(PGE_PLAIN_STR)
            plan.pg_plain_byte.append(page_off + val_off)
        elif enc == ENC_PLAIN and kind == "bool":
            # raw bit-packed values == one packed run of width 1
            plan.vr.add(dense, True, 0, (page_off + val_off) * 8, 1)
            plan.pg_enc.append(PGE_DICT)  # value comes from vr
            plan.pg_plain_byte.append(-1)
        elif enc == ENC_PLAIN:
            plan.has_plain = True
            plan.pg_enc.append(PGE_PLAIN)
            plan.pg_plain_byte.append(page_off + val_off)
        elif enc == ENC_RLE and kind == "bool":
            # v2 boolean pages: 4-byte length prefix then a hybrid
            # stream of width 1 — same device lane as PLAIN booleans
            _parse_hybrid_runs(body, val_off + 4, len(body), 1, nn,
                               dense, page_off, plan.vr)
            plan.pg_enc.append(PGE_DICT)
            plan.pg_plain_byte.append(-1)
        elif enc == ENC_DELTA_BINARY_PACKED and kind in ("int", "dec64") \
                and leaf.physical_type in ("INT32", "INT64"):
            first, total, _ = _parse_delta_runs(
                body, val_off, len(body), dense, page_off, plan.dr)
            if total != nn:
                raise UnsupportedColumn(
                    f"delta count {total} != page values {nn}")
            plan.pg_first[-1] = first
            plan.has_delta = True
            plan.pg_enc.append(PGE_DELTA)
            plan.pg_plain_byte.append(-1)
        elif enc == ENC_DELTA_LENGTH_BYTE_ARRAY and kind == "str":
            lens, bytes_pos = _delta_decode_host(body, val_off,
                                                 len(body))
            if lens.shape[0] != nn:
                raise UnsupportedColumn(
                    f"delta-length count {lens.shape[0]} != {nn}")
            if lens.shape[0] and (int(lens.min()) < 0 or
                                  bytes_pos + int(lens.sum())
                                  > len(body)):
                raise UnsupportedColumn("delta-length bytes overrun")
            str_parts.append((dense, lens))
            plan.pg_enc.append(PGE_DL_STR)
            plan.pg_plain_byte.append(page_off + bytes_pos)
        elif enc == ENC_BYTE_STREAM_SPLIT and (
                kind in ("f32", "f64")
                or (kind == "int" and leaf.physical_type
                    in ("INT32", "INT64"))):
            if val_off + nn * elem_bytes > len(body):
                raise UnsupportedColumn("BYTE_STREAM_SPLIT page overrun")
            plan.has_bss = True
            plan.pg_enc.append(PGE_BSS)
            plan.pg_plain_byte.append(page_off + val_off)
        else:
            raise UnsupportedColumn(
                f"encoding {_ENC_NAMES.get(enc, enc)} for {kind}")
        rows += nv
        dense += nn

    if rows != n_rows:
        raise UnsupportedColumn(
            f"page rows {rows} != row-group rows {n_rows}")
    plan.pg_dense_start.append(dense)
    if all_valid_runs or max_def == 0:
        plan.dl = None  # no nulls: validity is just the active mask
    if len(plan.vr) == 0:
        plan.vr = None
    if len(plan.dr) == 0:
        plan.dr = None
    if str_parts:
        # dense-lane byte lengths for the non-dict string pages; the
        # device builds offsets from these with a per-page (segmented)
        # prefix-sum and gathers the bytes column
        lens = np.zeros(max(1, dense), dtype=np.int32)
        max_len = 1
        for off, part in str_parts:
            lens[off:off + part.shape[0]] = part
            if part.shape[0]:
                max_len = max(max_len, int(part.max()))
        plan.str_lens = lens
        from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
        plain_cap = bucket_char_cap(max_len)
        if plan.dict_arrays:
            if plain_cap > plan.char_cap:
                # unify the char matrix width across dict + plain pages
                ch = plan.dict_arrays[0]
                wide = np.zeros((ch.shape[0], plain_cap), dtype=ch.dtype)
                wide[:, :ch.shape[1]] = ch
                plan.dict_arrays[0] = wide
                plan.char_cap = plain_cap
        else:
            plan.char_cap = plain_cap
    if kind == "str" and plan.vr is None and plan.str_lens is None:
        raise UnsupportedColumn("string column with no value pages")
    return plan


def plan_unit_encoded(unit, data_schema: T.StructType
                      ) -> Optional[EncodedBatch]:
    """Build the device-decode staging for one parquet ScanUnit (one
    row group). Columns whose chunk cannot be device-decoded fall back
    to the pyarrow host decode individually; returns None when nothing
    can be device-decoded (caller uses the plain host path)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.transfer import _Packer
    from spark_rapids_tpu_torch.io.arrow_convert import \
        arrow_column_to_host

    if not unit.row_groups or len(unit.row_groups) != 1:
        return None
    pf = pq.ParquetFile(unit.path)
    meta = pf.metadata
    rg = unit.row_groups[0]
    rgm = meta.row_group(rg)
    n_rows = rgm.num_rows
    if n_rows == 0:
        return None
    sch = pf.schema
    leaf_by_name = {}
    for i in range(len(sch)):
        c = sch.column(i)
        leaf_by_name.setdefault(c.path.split(".")[0], c)
    chunk_by_leaf = {}
    for ci in range(rgm.num_columns):
        col = rgm.column(ci)
        chunk_by_leaf[col.path_in_schema.split(".")[0]] = col

    with open(unit.path, "rb") as f:

        def chunk_bytes(chunk) -> bytes:
            start = chunk.data_page_offset
            if chunk.dictionary_page_offset is not None:
                start = min(start, chunk.dictionary_page_offset)
            f.seek(start)
            return f.read(chunk.total_compressed_size)

        packer = _Packer()
        plans: Dict[int, ColumnDevicePlan] = {}
        host_cols: Dict[int, Any] = {}
        fallbacks: List[Tuple[str, str]] = []
        for fi, fld in enumerate(data_schema.fields):
            leaf = leaf_by_name.get(fld.name)
            chunk = chunk_by_leaf.get(fld.name)
            if leaf is None or chunk is None:
                fallbacks.append((fld.name, "column missing in file"))
                continue
            try:
                raw = chunk_bytes(chunk)
                # per-column staging: a mid-chunk UnsupportedColumn
                # (e.g. dictionary overflow into PLAIN byte arrays)
                # must not leave this column's already-appended pages
                # as dead bytes in every uploaded batch
                sub = _Packer()
                plan = _plan_column(raw, chunk, leaf,
                                    fld.data_type, n_rows, sub)
                _rebase_plan(plan, packer.off)
                packer.parts.extend(sub.parts)
                packer.off += sub.off
                plans[fi] = plan
            except UnsupportedColumn as e:
                fallbacks.append((fld.name, str(e)))

    if not plans:
        return None
    # host-decoded value counts per data encoding for the fallback
    # columns (a new fallback shows up in the hostDecodedValues split,
    # not just a unit count)
    fallback_encodings: Dict[str, int] = {}
    for name, _reason in fallbacks:
        chunk = chunk_by_leaf.get(name)
        if chunk is None:
            continue
        # count each column's rows ONCE, under its dominant DATA
        # encoding: chunk.encodings also lists level encodings and the
        # dictionary page's own PLAIN, which would multi-count
        data_encs = [e for e in chunk.encodings
                     if e not in ("RLE", "BIT_PACKED")]
        dict_encs = [e for e in data_encs if "DICTIONARY" in e]
        ename = (dict_encs or data_encs or ["UNKNOWN"])[0]
        fallback_encodings[ename] = \
            fallback_encodings.get(ename, 0) + n_rows
    if fallbacks:
        names = [n for n, _r in fallbacks]
        present = [n for n in names if n in leaf_by_name]
        tbl = pf.read_row_groups([rg], columns=present) if present \
            else None
        for fi, fld in enumerate(data_schema.fields):
            if fi in plans:
                continue
            if tbl is not None and fld.name in tbl.column_names:
                host_cols[fi] = arrow_column_to_host(
                    tbl.column(fld.name), fld.data_type)
            else:
                host_cols[fi] = _null_host_column(fld.data_type, n_rows)
    return EncodedBatch(data_schema, n_rows, packer.words(), plans,
                        host_cols, fallbacks,
                        fallback_encodings=fallback_encodings)


def _rebase_plan(plan: ColumnDevicePlan, base: int) -> None:
    """Shift a plan built against a column-local buffer to its final
    byte offset in the shared packed buffer (base is 4-byte aligned:
    _Packer pads every add)."""
    for rt in (plan.dl, plan.vr, plan.dr):
        if rt is None:
            continue
        for i in range(len(rt)):
            if rt.packed[i]:
                rt.bit_start[i] += base * 8
    plan.pg_plain_byte = [b + base if b >= 0 else b
                          for b in plan.pg_plain_byte]


def _null_host_column(dt: T.DataType, n: int):
    from spark_rapids_tpu_torch.columnar.host import HostColumn
    validity = np.zeros(n, dtype=bool)
    if T.is_limb_decimal(dt):
        return HostColumn(dt, np.zeros((n, 2), dtype=np.int64), validity)
    np_dt = T.numpy_dtype(dt)
    if np_dt == np.dtype(object):
        data = np.empty(n, dtype=object)
        data[:] = ""
        return HostColumn(dt, data, validity)
    return HostColumn(dt, np.zeros(n, dtype=np_dt), validity)
