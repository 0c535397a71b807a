"""File scans: DataFrameReader + CpuFileScanExec (the port's counterpart
of ``spark_rapids_tpu.io.readers``).

The host lists files (with Hive ``k=v`` partition-directory discovery),
plans scan units (one per row group of a Parquet file, one per stripe of a
multi-stripe ORC file, else one per file), prunes Parquet units whose
footer statistics rule out a pushed-down predicate, and bin-packs the
units into partitions as Spark's FilePartition does. Each partition then
reads its units with the reader strategy of
``spark.rapids.sql.format.parquet.reader.type``, for every format:

- PERFILE       the task thread reads the units one by one;
- MULTITHREADED a shared thread pool reads and converts a sliding window
                of units ahead of the task thread;
- COALESCING    the partition's units are stitched into one table,
                decoded on the host and emitted in batch-size slices.

Parquet, ORC, CSV, JSON and text decode through pyarrow on the host. When
``TorchRowToColumnarExec`` consumes the scan directly, a Parquet row group
(PERFILE or MULTITHREADED) is staged instead as an ``EncodedBatch``
(still-encoded pages plus plan tables) for the ``decodeFused`` kernel;
otherwise, and for units the device decode cannot take, pyarrow decodes
on the host; that host decode is also the upload's fallback for one batch
after an out-of-memory error. The file reads of every path run under the
IO retry protocol (``io_with_retry``: bounded backoff, the original error
after ``spark.rapids.sql.reader.maxRetries``).

The mesh scan (``spark.rapids.sql.multichip.scan.enabled`` while a mesh of
two or more healthy chips is active): ``TorchRowToColumnarExec`` hands the
scan the mesh's chips (``set_scan_mesh``), and ``partitions()`` returns
one reader stream per chip, the units dealt round-robin-by-bytes
(``shard_units_by_bytes``, counted in ``meshScanUnits.chip<N>``); each
chip's share still bin-packs into sub-partitions read in turn under the
configured reader. ``partition_devices`` names each stream's chip, and the
upload lands the stream's batches there; a Parquet row group still
stages as an EncodedBatch for ``decodeFused`` on its chip.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from itertools import islice
from typing import Any, Dict, Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import (MAX_READER_BATCH_SIZE_ROWS,
                                         MULTITHREADED_READ_NUM_THREADS,
                                         PARQUET_READER_TYPE,
                                         TASK_PARALLELISM, TorchConf)
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T

DEFAULT_MAX_PARTITION_BYTES = 128 << 20

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def list_files(paths: Sequence[str]) -> List[tuple]:
    """Directory/glob expansion with Hive partition-directory discovery:
    ``(file, part_values)`` pairs, part_values mapping partition column
    -> raw string value parsed from ``k=v`` path components."""
    out: List[tuple] = []
    for p in paths:
        if os.path.isdir(p):
            base = os.path.abspath(p)
            for root, dirs, names in os.walk(base):
                dirs.sort()
                dirs[:] = [d for d in dirs if not d.startswith((".", "_"))]
                pv: Dict[str, str] = {}
                rel = os.path.relpath(root, base)
                if rel != ".":
                    from urllib.parse import unquote
                    for comp in rel.split(os.sep):
                        if "=" in comp:
                            k, v = comp.split("=", 1)
                            pv[k] = (v if v == HIVE_DEFAULT_PARTITION
                                     else unquote(v))
                for n in sorted(names):
                    if n.startswith(("_", ".")):
                        continue
                    out.append((os.path.join(root, n), pv))
        elif any(ch in p for ch in "*?["):
            out.extend((f, {}) for f in sorted(glob.glob(p)))
        elif os.path.exists(p):
            out.append((p, {}))
        else:
            raise FileNotFoundError(p)
    if not out:
        raise FileNotFoundError(f"no input files in {list(paths)}")
    return out


def file_fingerprints(files: Sequence[str]):
    """``(path, size, mtime_ns)`` of each input file, or None when a file
    cannot be statted (it vanished between listing and here): an input
    set without fingerprints is uncacheable, never stale."""
    try:
        return tuple((f, st.st_size, st.st_mtime_ns)
                     for f, st in ((f, os.stat(f)) for f in files))
    except OSError:
        return None


def discovered_partition_fields(files: List[tuple]) -> List[T.StructField]:
    """Partition columns + value-inferred types (Spark's
    PartitioningUtils.inferPartitionColumnValue: int -> long -> double ->
    string)."""
    names: List[str] = []
    values: Dict[str, List[str]] = {}
    for _f, pv in files:
        for k, v in pv.items():
            if k not in values:
                names.append(k)
                values[k] = []
            values[k].append(v)
    return [T.StructField(n, _infer_part_type(values[n])) for n in names]


_INT_RE = re.compile(r"-?\d+\Z")
_FLOAT_RE = re.compile(r"-?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?\Z")


def _infer_part_type(raw: List[str]) -> T.DataType:
    """Strict numeric parse: values Python's int()/float() accept but
    Arrow's cast rejects ('1_0', '+5', ' 7') stay strings."""
    vals = [v for v in raw if v != HIVE_DEFAULT_PARTITION]
    if not vals:
        return T.StringT
    if all(_INT_RE.match(v) for v in vals):
        ints = [int(v) for v in vals]
        if all(-(1 << 31) <= i < (1 << 31) for i in ints):
            return T.IntegerT
        if all(-(1 << 63) <= i < (1 << 63) for i in ints):
            return T.LongT
        return T.DoubleT
    if all(_FLOAT_RE.match(v) for v in vals):
        return T.DoubleT
    return T.StringT


@dataclass
class ScanUnit:
    """One decode unit: a row group of a Parquet file, a stripe of an ORC
    file, or a whole file (``row_groups`` None; also a Parquet file whose
    footer cannot be read). ``stats`` maps column -> (min, max,
    null_count, num_rows) from a Parquet footer, None where absent."""

    path: str
    size_bytes: int
    row_groups: Optional[List[int]] = None  # row groups, or ORC stripes
    part_values: Optional[Dict[str, str]] = None
    stats: Optional[Dict[str, tuple]] = None


# Footer parses memoized per (format, file set) and checked against each
# file's size and mtime, so planning the same DataFrame again (every
# collect) reads no footer twice, and a rewritten file is planned anew. A
# bounded LRU: a session reading many datasets keeps the newest.
# tpu-lint: disable=jit-module-cache(a footer memo of scan units bounded at _UNITS_CACHE_MAX; it holds no built program)
_UNITS_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
_UNITS_CACHE_MAX = 64
_UNITS_LOCK = threading.Lock()


def plan_scan_units(fmt: str, files: List[tuple]) -> List[ScanUnit]:
    key = (fmt, tuple(f for f, _ in files))
    stats = [os.stat(f) for f, _ in files]
    sig = tuple((tuple(sorted(pv.items())), st.st_mtime_ns, st.st_size)
                for (_f, pv), st in zip(files, stats))
    with _UNITS_LOCK:
        cached = _UNITS_CACHE.get(key)
        if cached is not None and cached[0] == sig:
            _UNITS_CACHE.move_to_end(key)
            return cached[1]
    if fmt == "parquet":
        units = _parquet_units(files)
    elif fmt == "orc":
        units = _orc_units(files)
    else:
        units = [ScanUnit(f, os.path.getsize(f), part_values=pv)
                 for f, pv in files]
    with _UNITS_LOCK:
        _UNITS_CACHE[key] = (sig, units)
        _UNITS_CACHE.move_to_end(key)
        if len(_UNITS_CACHE) > _UNITS_CACHE_MAX:
            _UNITS_CACHE.popitem(last=False)
    return units


def _parquet_units(files: List[tuple]) -> List[ScanUnit]:
    import pyarrow.parquet as pq
    units: List[ScanUnit] = []
    for f, pv in files:
        try:
            meta = pq.ParquetFile(f).metadata
        except Exception:
            # an unreadable footer: the whole-file host read decides
            units.append(ScanUnit(f, os.path.getsize(f), part_values=pv))
            continue
        for rg in range(meta.num_row_groups):
            rgm = meta.row_group(rg)
            stats: Dict[str, tuple] = {}
            for ci in range(rgm.num_columns):
                col = rgm.column(ci)
                name = col.path_in_schema.split(".")[0]
                try:
                    st = col.statistics
                    if st is None:
                        stats[name] = (None, None, None, rgm.num_rows)
                    else:
                        stats[name] = (
                            st.min if st.has_min_max else None,
                            st.max if st.has_min_max else None,
                            st.null_count if st.has_null_count else None,
                            rgm.num_rows)
                except Exception:
                    # some physical/logical combinations (a decimal
                    # stored as an integer) cannot extract statistics:
                    # pruning is optional, the scan is not
                    stats[name] = (None, None, None, rgm.num_rows)
            units.append(ScanUnit(f, rgm.total_byte_size, [rg], pv, stats))
        if meta.num_row_groups == 0:
            units.append(ScanUnit(f, 0, [], pv))
    return units


def _orc_units(files: List[tuple]) -> List[ScanUnit]:
    """One unit per stripe of a multi-stripe ORC file (each stripe decodes
    on its own, so a large file spreads over partitions and the pool),
    one per file otherwise."""
    import pyarrow.orc as po
    units: List[ScanUnit] = []
    for f, pv in files:
        size = os.path.getsize(f)
        try:
            ns = po.ORCFile(f).nstripes
        except Exception:
            ns = 0
        if ns <= 1:
            units.append(ScanUnit(f, size, part_values=pv))
            continue
        per = max(1, size // ns)
        units.extend(ScanUnit(f, per, [st], pv) for st in range(ns))
    return units


def shard_units_by_bytes(units: List[ScanUnit], n: int
                         ) -> List[List[ScanUnit]]:
    """The mesh scan's unit scheduler: each unit goes to the stream with
    the fewest bytes so far (ties to the lowest stream, so equal units
    deal round-robin), which balances skewed row groups across chips.
    Streams may come back empty (fewer units than chips); they are kept,
    so the per-chip structure is stable."""
    streams: List[List[ScanUnit]] = [[] for _ in range(n)]
    loads = [0] * n
    for u in units:
        i = min(range(n), key=lambda d: (loads[d], d))
        streams[i].append(u)
        # +1 so zero-byte units (empty row groups) still spread
        loads[i] += u.size_bytes + 1
    return streams


def pack_partitions(units: List[ScanUnit], max_bytes: int,
                    open_cost: int = 0) -> List[List[ScanUnit]]:
    """Bin-pack units into partitions (FilePartition.getFilePartitions;
    each unit weighs its bytes plus openCostInBytes, like Spark)."""
    parts: List[List[ScanUnit]] = []
    cur: List[ScanUnit] = []
    cur_bytes = 0
    for u in units:
        w = u.size_bytes + open_cost
        if cur and cur_bytes + w > max_bytes:
            parts.append(cur)
            cur, cur_bytes = [], 0
        cur.append(u)
        cur_bytes += w
    if cur:
        parts.append(cur)
    return parts


def _read_unit(fmt: str, unit: ScanUnit, schema: T.StructType,
               options: Dict[str, Any]):
    """Decode one unit to a pyarrow Table with ``schema``'s columns."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import sql_type_to_arrow
    names = [f.name for f in schema.fields]
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pf = pq.ParquetFile(unit.path)
        if unit.row_groups is not None:
            if not unit.row_groups:
                return pa.table(
                    {n: pa.array([], type=sql_type_to_arrow(f.data_type))
                     for n, f in zip(names, schema.fields)})
            return _conform(pf.read_row_groups(
                unit.row_groups, columns=_present(pf.schema_arrow, names)),
                schema)
        return _conform(pf.read(columns=_present(pf.schema_arrow, names)),
                        schema)
    if fmt == "orc":
        import pyarrow.orc as po
        of = po.ORCFile(unit.path)
        cols = _present(of.schema, names)
        if unit.row_groups:  # stripe indices
            return _conform(pa.Table.from_batches(
                [of.read_stripe(st, columns=cols)
                 for st in unit.row_groups]), schema)
        return _conform(of.read(columns=cols), schema)
    if fmt == "csv":
        return _read_csv(unit.path, schema, options)
    if fmt == "json":
        import pyarrow.json as pj
        return _conform(pj.read_json(unit.path), schema)
    if fmt == "text":
        import pyarrow.csv as pc
        return pc.read_csv(unit.path, parse_options=pc.ParseOptions(
            delimiter="\x01", quote_char=False, escape_char=False),
            read_options=pc.ReadOptions(column_names=[names[0]]))
    raise ValueError(f"unknown file format {fmt!r}")


def _present(file_schema, names: List[str]) -> List[str]:
    """The names a file holds: a column the file lacks is read as nulls
    (``_conform``)."""
    have = set(file_schema.names)
    return [n for n in names if n in have]


def _read_csv(path: str, schema: T.StructType, options: Dict[str, Any]):
    """A CSV file with the schema's types; a file whose column count
    differs from the schema is read again by position (Spark's
    PERMISSIVE mode): extra columns are dropped, missing ones are null."""
    import pyarrow as pa
    import pyarrow.csv as pc

    from spark_rapids_tpu_torch.io.arrow_convert import sql_type_to_arrow
    header = str(options.get("header", "false")).lower() == "true"
    sep = options.get("sep", options.get("delimiter", ","))
    null_value = options.get("nullValue", "")
    names = [f.name for f in schema.fields]
    null_values = [null_value] if null_value else [""]
    parse_opts = pc.ParseOptions(delimiter=sep)
    timestamp_parsers = [pc.ISO8601, "%Y-%m-%d %H:%M:%S"]
    try:
        tbl = pc.read_csv(
            path,
            read_options=pc.ReadOptions(
                column_names=None if header else names),
            parse_options=parse_opts,
            convert_options=pc.ConvertOptions(
                column_types={f.name: sql_type_to_arrow(f.data_type)
                              for f in schema.fields},
                null_values=null_values, strings_can_be_null=True,
                timestamp_parsers=timestamp_parsers))
    except pa.lib.ArrowInvalid:
        # the same null semantics; the types are cast by _conform below
        tbl = pc.read_csv(
            path,
            read_options=pc.ReadOptions(autogenerate_column_names=True,
                                        skip_rows=1 if header else 0),
            parse_options=parse_opts,
            convert_options=pc.ConvertOptions(
                null_values=null_values, strings_can_be_null=True,
                timestamp_parsers=timestamp_parsers))
    # by position: a header's names may differ from the schema's
    n = min(len(names), tbl.num_columns)
    tbl = tbl.select(list(range(n))).rename_columns(names[:n])
    return _conform(tbl, schema)


def _conform(tbl, schema: T.StructType):
    """The table's columns in the schema's order and types; a column the
    table lacks is all null, one the schema lacks is dropped."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import sql_type_to_arrow
    cols = []
    for f in schema.fields:
        at = sql_type_to_arrow(f.data_type)
        if f.name in tbl.column_names:
            cols.append(tbl.column(f.name).cast(at))
        else:
            cols.append(pa.nulls(tbl.num_rows, type=at))
    return pa.Table.from_arrays(cols, names=[f.name for f in schema.fields])


def _partition_value_array(f: T.StructField, raw: Optional[str], n: int):
    """One partition field's constant column: parse the raw directory
    value once, then broadcast the scalar."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import sql_type_to_arrow
    at = sql_type_to_arrow(f.data_type)
    if raw is None or raw == HIVE_DEFAULT_PARTITION:
        return pa.nulls(n, type=at)
    return pa.repeat(pa.scalar(raw, type=pa.string()).cast(at), n)


def _append_partition_columns(tbl, part_fields: List[T.StructField],
                              part_values: Dict[str, str]):
    for f in part_fields:
        tbl = tbl.append_column(f.name, _partition_value_array(
            f, part_values.get(f.name), tbl.num_rows))
    return tbl


def _extend_with_partition_cols(enc, schema: T.StructType,
                                part_fields: List[T.StructField],
                                part_values: Dict[str, str]):
    """Remap an EncodedBatch built against the data schema onto the full
    scan schema, adding directory-derived partition values as constant
    host columns."""
    from spark_rapids_tpu_torch.io.arrow_convert import arrow_column_to_host
    data_idx = {f.name: i for i, f in enumerate(enc.schema.fields)}
    plans = {}
    host_cols = {}
    n = enc.num_rows
    for fi, f in enumerate(schema.fields):
        di = data_idx.get(f.name)
        if di is not None:
            if di in enc.plans:
                plans[fi] = enc.plans[di]
            else:
                host_cols[fi] = enc.host_cols[di]
            continue
        host_cols[fi] = arrow_column_to_host(
            _partition_value_array(f, part_values.get(f.name), n),
            f.data_type)
    enc.schema = schema
    enc.plans = plans
    enc.host_cols = host_cols
    return enc


def _stat_storage(v, dt: T.DataType):
    """Footer stat value -> the engine's storage form (days/micros/
    unscaled int); None when not convertible (disables pruning)."""
    from spark_rapids_tpu_torch.columnar.host import _to_storage
    try:
        out = _to_storage(v, dt)
    except Exception:
        return None
    return out if isinstance(out, (int, float, str)) else None


def unit_can_match(u: ScanUnit, preds: List[tuple],
                   fields: Dict[str, T.DataType]) -> bool:
    """False when this row group's footer stats PRECLUDE any row matching
    every pushed conjunct. Conservative: missing stats or unconvertible
    values keep the unit."""
    if u.stats is None:
        return True
    for name, op, val in preds:
        st = u.stats.get(name)
        if st is None:
            continue
        mn, mx, nulls, n_rows = st
        dt = fields.get(name)
        if op == "notnull":
            if nulls is not None and n_rows and nulls == n_rows:
                return False
            continue
        if op == "isnull":
            if nulls is not None and nulls == 0 and n_rows:
                return False
            continue
        if mn is None or mx is None or dt is None:
            continue
        lo, hi = _stat_storage(mn, dt), _stat_storage(mx, dt)
        if lo is None or hi is None:
            continue
        try:
            if op == "eq" and (val < lo or val > hi):
                return False
            if op == "lt" and lo >= val:
                return False
            if op == "le" and lo > val:
                return False
            if op == "gt" and hi <= val:
                return False
            if op == "ge" and hi < val:
                return False
        except TypeError:
            continue  # cross-type compare: keep the unit
    return True


_READ_POOL: Optional[ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def _shared_pool(n_threads: int) -> ThreadPoolExecutor:
    """The MULTITHREADED reader's pool, shared by every scan of the
    process and made anew only when the thread count changes. Its threads
    do host work only (file reads, decompression, run-header parsing,
    Arrow conversion): they take no device permit and touch no device."""
    global _READ_POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _READ_POOL is None or _POOL_SIZE != n_threads:
            if _READ_POOL is not None:
                _READ_POOL.shutdown(wait=False)
            _READ_POOL = ThreadPoolExecutor(
                max_workers=n_threads, thread_name_prefix="torch-multifile")
            _POOL_SIZE = n_threads
        return _READ_POOL


class ScanMetrics(M.MetricRegistry):
    """Named counters of one scan: ``deviceDecodedBatches``,
    ``deviceFallbackUnits``, ``deviceFallbackColumns``,
    ``deviceDecodedValues.<ENC>`` and ``hostDecodedValues.<ENC>``, the
    IO retry protocol's ``ioRetryCount`` and ``retryBlockTime``, and the
    host walls ``decodeTime`` (a unit's read and pyarrow decode) and
    ``convertTime`` (Arrow to HostBatch), in nanoseconds summed over the
    threads that ran them. A registry, so ``plan_metrics`` sums them with
    the operators'."""

    def add(self, name: str, v: int = 1) -> None:
        self.create(name).add(v)


class CpuFileScanExec(P.PhysicalPlan):
    """File source scan, a host node; the rewrite puts a
    ``TorchRowToColumnarExec`` above it, which turns on ``emit_encoded``
    at execution time."""

    def __init__(self, output, fmt: str, paths: List[str],
                 options: Dict[str, Any], conf: TorchConf):
        self.children = []
        self._output = output
        self.fmt = fmt
        self.paths = paths
        self.options = options or {}
        self.conf = conf
        from spark_rapids_tpu_torch.conf import METRICS_LEVEL
        self.metrics = ScanMetrics(str(conf.get(METRICS_LEVEL)),
                                   owner="FileScan")
        listed = list_files(paths)
        self.files = [f for f, _ in listed]
        # (path, size, mtime_ns) of the inputs at planning time: what a
        # cache of this scan's results is keyed on and checked against
        self.fingerprints = file_fingerprints(self.files)
        part_names = {k for _f, pv in listed for k in pv}
        self._part_fields = [f for f in self.schema.fields
                             if f.name in part_names]
        max_bytes = int(conf.get_key("spark.sql.files.maxPartitionBytes",
                                     DEFAULT_MAX_PARTITION_BYTES))
        open_cost = int(conf.get_key("spark.sql.files.openCostInBytes",
                                     4 << 20))
        self._units = plan_scan_units(fmt, listed)
        # Spark's FilePartition.maxSplitBytes: bytesPerCore floored by
        # openCostInBytes, capped by maxPartitionBytes
        parallelism = max(1, int(conf.get(TASK_PARALLELISM)))
        total = sum(u.size_bytes for u in self._units) \
            + open_cost * len(self._units)
        self._max_bytes = min(max_bytes,
                              max(open_cost, total // parallelism))
        self._open_cost = open_cost
        self._pushed: List[tuple] = []  # (col, op, storage value)
        self.pruned_units = 0
        self._parts = pack_partitions(self._units, self._max_bytes,
                                      open_cost)
        # set by the planner when input_file_name() sits above this scan:
        # every reader then runs as PERFILE
        self.force_perfile = False
        # set at execution time by TorchRowToColumnarExec when IT is the
        # direct consumer: only then may partitions() emit EncodedBatch
        # staging objects instead of HostBatches
        self.emit_encoded = False
        # the mesh scan: set at execution time by TorchRowToColumnarExec
        # to the mesh's chips; partitions() then returns one stream per
        # chip and names each stream's chip in partition_devices
        self._mesh_chips: List = []
        self.partition_devices: List = []

    def set_scan_mesh(self, chips: List) -> None:
        self._mesh_chips = list(chips or [])

    def _mesh_streams(self) -> Optional[List[List[ScanUnit]]]:
        """The units of each chip's stream on the mesh scan, else None."""
        if len(self._mesh_chips) < 2:
            return None
        units = [u for part in self._parts for u in part]
        return shard_units_by_bytes(units, len(self._mesh_chips))

    def set_pushdown(self, preds: List[tuple]) -> None:
        """Install pushed-down predicates (name, op, storage value) and
        prune Parquet row-group units whose footer stats preclude
        matches. The enclosing Filter still runs, so pruning may be
        conservative."""
        self._pushed = preds
        if not preds or self.fmt != "parquet":
            return
        fields = {f.name: f.data_type for f in self.schema.fields}
        kept = [u for u in self._units if unit_can_match(u, preds, fields)]
        self.pruned_units = len(self._units) - len(kept)
        # always at least one (possibly empty) partition so global
        # aggregates still see a partition to produce their one row in
        self._parts = pack_partitions(kept, self._max_bytes,
                                      self._open_cost) if kept else [[]]

    @property
    def output(self):
        return self._output

    def units_per_partition(self) -> List[int]:
        """The units (row groups, stripes or files) of each partition
        (each chip's stream on the mesh scan), from the footers, before
        any read."""
        streams = self._mesh_streams()
        return [len(us) for us in (streams if streams is not None
                                   else self._parts)]

    def reader_type(self) -> str:
        """The reader strategy the partitions run: the conf's, or PERFILE
        where ``input_file_name()`` forced it."""
        if self.force_perfile:
            return "PERFILE"
        return str(self.conf.get(PARQUET_READER_TYPE)).upper()

    def simple_string(self):
        s = (f"FileScan {self.fmt} [{len(self.files)} files, "
             f"{len(self._parts)} partitions")
        if self._pushed:
            s += (f", pushed {len(self._pushed)} filters, "
                  f"pruned {self.pruned_units} units")
        return s + "]"

    def partitions(self):
        reader_type = self.reader_type()
        if reader_type not in ("PERFILE", "MULTITHREADED", "COALESCING"):
            raise ValueError(f"unknown reader type {reader_type!r} "
                             f"({PARQUET_READER_TYPE.key})")
        max_rows = int(self.conf.get(MAX_READER_BATCH_SIZE_ROWS))
        schema = self.schema
        part_fields = self._part_fields
        part_names = {f.name for f in part_fields}
        data_schema = T.StructType(
            [f for f in schema.fields if f.name not in part_names])
        # COALESCING's point is the one-table stitch, which the device
        # decode does not do: its units decode on the host
        device_decode = (self.fmt == "parquet"
                         and reader_type != "COALESCING"
                         and self.emit_encoded)
        metrics = self.metrics

        def decode(u: ScanUnit):
            with metrics.timed("decodeTime"):
                # a transient IO error retries with bounded backoff, on
                # whichever thread reads the unit
                tbl = R.io_with_retry(
                    lambda: _read_unit(self.fmt, u, data_schema,
                                       self.options),
                    self.conf, metrics, path=u.path)
                if part_fields:
                    tbl = _append_partition_columns(tbl, part_fields,
                                                    u.part_values or {})
                    tbl = tbl.select([f.name for f in schema.fields])
            return tbl

        def emit(tbl) -> Iterator[HostBatch]:
            from spark_rapids_tpu_torch.io.arrow_convert import \
                arrow_to_host_batch
            for lo in range(0, max(1, tbl.num_rows), max_rows):
                with metrics.timed("convertTime"):
                    hb = arrow_to_host_batch(tbl.slice(lo, max_rows),
                                             schema)
                yield hb

        def plan_device(u: ScanUnit):
            """ScanUnit -> EncodedBatch (host IO, decompression and
            header parsing only), or None when the unit host-decodes."""
            from spark_rapids_tpu_torch.io import device_decode as DD
            # the planner's file reads ride the same IO retry protocol;
            # timed as the JAX package's host half of the device decode
            with metrics.timed_wall("deviceDecodeTime", path=u.path):
                enc = R.io_with_retry(
                    lambda: DD.plan_unit_encoded(u, data_schema),
                    self.conf, metrics, path=u.path)
            if enc is None or enc.num_rows > max_rows:
                metrics.add("deviceFallbackUnits")
                return None
            if part_fields:
                enc = _extend_with_partition_cols(
                    enc, schema, part_fields, u.part_values or {})
            # the upload's OOM fallback: this unit's host decode
            enc.host_fallback = lambda u=u: list(emit(decode(u)))
            metrics.add("deviceDecodedBatches")
            if enc.fallbacks:
                metrics.add("deviceFallbackColumns", len(enc.fallbacks))
            for ename, nvals in enc.fallback_encodings.items():
                metrics.add(f"hostDecodedValues.{ename}", nvals)
            for plan in enc.plans.values():
                for ename, nvals in plan.encoding_values.items():
                    metrics.add(f"deviceDecodedValues.{ename}", nvals)
            return enc

        def decode_unit(u: ScanUnit) -> List[Any]:
            """One unit's batches, materialised on a pool thread: its
            EncodedBatch, or its HostBatches converted from Arrow there,
            so the consuming thread only packs and uploads."""
            enc = plan_device(u) if device_decode else None
            return [enc] if enc is not None else list(emit(decode(u)))

        def set_file(path: str) -> None:
            # input_file_name()'s context, read by a project over this
            # scan on the thread that pulls the scan's batches
            E._PART_CTX.input_file = path

        def coalescing(units: List[ScanUnit]) -> Iterator[Any]:
            import pyarrow as pa
            tbl = pa.concat_tables([decode(u) for u in units])
            set_file("")  # the stitched batches span files
            yield from emit(tbl)

        def multithreaded(units: List[ScanUnit]) -> Iterator[Any]:
            n_threads = int(self.conf.get(MULTITHREADED_READ_NUM_THREADS))
            pool = _shared_pool(n_threads)
            # a sliding window: converted HostBatches are several times
            # their Arrow size, so only numThreads + 2 units are in flight
            ahead = iter(units)
            futures = deque(pool.submit(decode_unit, u)
                            for u in islice(ahead, n_threads + 2))
            try:
                for u in units:
                    f = futures.popleft()
                    nxt = next(ahead, None)
                    if nxt is not None:
                        futures.append(pool.submit(decode_unit, nxt))
                    batches = f.result()
                    set_file(u.path)
                    yield from batches
            finally:
                # an error or a consumer that stopped early cancels the
                # reads not yet started, so the shared pool drains
                for f in futures:
                    f.cancel()

        def perfile(units: List[ScanUnit]) -> Iterator[Any]:
            for u in units:
                enc = plan_device(u) if device_decode else None
                if enc is not None:
                    set_file(u.path)
                    yield enc
                    continue
                tbl = decode(u)
                set_file(u.path)
                yield from emit(tbl)

        def make(units: List[ScanUnit]):
            def run() -> Iterator[Any]:
                if len(units) > 1 and reader_type == "COALESCING":
                    return coalescing(units)
                if len(units) > 1 and reader_type == "MULTITHREADED":
                    return multithreaded(units)
                return perfile(units)
            return run

        streams = self._mesh_streams()
        if streams is not None:
            # one reader stream per chip; an empty stream is kept, so a
            # chip with no units still yields its (empty) partition
            self.partition_devices = list(self._mesh_chips)

            def chip_stream(st: List[ScanUnit]):
                # a chip's share still bin-packs as the conf says (the
                # COALESCING reader stitches one table per sub-partition)
                subs = pack_partitions(st, self._max_bytes,
                                       self._open_cost) if st else [[]]
                runs = [make(us) for us in subs]

                def run() -> Iterator[Any]:
                    for r in runs:
                        yield from r()
                return run

            for chip, st in zip(self._mesh_chips, streams):
                metrics.add(f"meshScanUnits.chip{chip.id}", len(st))
            return [chip_stream(st) for st in streams]
        self.partition_devices = []
        return [make(us) for us in self._parts]


class DataFrameReader:
    """spark.read facade (pyspark DataFrameReader shape)."""

    def __init__(self, session):
        self._session = session
        self._format = "parquet"
        self._schema: Optional[T.StructType] = None
        self._options: Dict[str, Any] = {}

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = fmt.lower()
        return self

    def schema(self, schema) -> "DataFrameReader":
        if isinstance(schema, str):
            from spark_rapids_tpu_torch.sql.session import _parse_ddl_schema
            schema = _parse_ddl_schema(schema)
        self._schema = schema
        return self

    def option(self, key: str, value: Any) -> "DataFrameReader":
        self._options[key] = value
        return self

    def options(self, **opts) -> "DataFrameReader":
        self._options.update(opts)
        return self

    def load(self, path=None):
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        paths = [path] if isinstance(path, str) else list(path)
        listed = list_files(paths)  # one walk for inference and discovery
        schema = self._schema or self._infer_schema_from(listed)
        # append Hive-style partition columns discovered from k=v dirs
        have = {f.name for f in schema.fields}
        extra = [f for f in discovered_partition_fields(listed)
                 if f.name not in have]
        if extra:
            schema = T.StructType(list(schema.fields) + extra)
        plan = L.FileScan(self._format, paths, schema, dict(self._options))
        return DataFrame(plan, self._session)

    def parquet(self, *paths: str):
        return self.format("parquet").load(list(paths))

    def orc(self, *paths: str):
        return self.format("orc").load(list(paths))

    def csv(self, path, schema=None, header=None, sep=None,
            inferSchema=None, nullValue=None):
        if schema is not None:
            self.schema(schema)
        if header is not None:
            self.option("header", str(header).lower())
        if sep is not None:
            self.option("sep", sep)
        if inferSchema is not None:
            self.option("inferSchema", str(inferSchema).lower())
        if nullValue is not None:
            self.option("nullValue", nullValue)
        return self.format("csv").load(path)

    def json(self, path, schema=None):
        if schema is not None:
            self.schema(schema)
        return self.format("json").load(path)

    def text(self, path):
        self._schema = T.StructType([T.StructField("value", T.StringT)])
        return self.format("text").load(path)

    def table(self, name: str):
        return self._session.table(name)

    # -- schema inference --------------------------------------------------

    def _infer_schema_from(self, listed: List[tuple]) -> T.StructType:
        """The first file's schema: its footer for Parquet and ORC, pyarrow's
        inference for JSON, ``_infer_csv_schema`` for CSV."""
        from spark_rapids_tpu_torch.io.arrow_convert import \
            arrow_schema_to_sql
        first = listed[0][0]
        fmt = self._format
        if fmt == "parquet":
            import pyarrow.parquet as pq
            return arrow_schema_to_sql(pq.ParquetFile(first).schema_arrow)
        if fmt == "orc":
            import pyarrow.orc as po
            return arrow_schema_to_sql(po.ORCFile(first).schema)
        if fmt == "json":
            import pyarrow.json as pj
            return arrow_schema_to_sql(pj.read_json(first).schema)
        if fmt == "csv":
            return self._infer_csv_schema(first)
        raise ValueError(
            f"cannot infer schema for format {fmt}; pass .schema(...)")

    def _infer_csv_schema(self, path: str) -> T.StructType:
        """Column names from the header (else ``_c0``, ``_c1``, ...);
        with ``inferSchema`` the types pyarrow infers, widened as
        ``arrow_type_to_sql_for_csv`` says, else every column a string."""
        import pyarrow.csv as pc
        header = str(self._options.get("header", "false")).lower() == "true"
        sep = self._options.get("sep", self._options.get("delimiter", ","))
        infer = str(self._options.get("inferSchema",
                                      "false")).lower() == "true"
        tbl = pc.read_csv(path, parse_options=pc.ParseOptions(delimiter=sep))
        names = (tbl.column_names if header
                 else [f"_c{i}" for i in range(tbl.num_columns)])
        if not header:
            # the first row was data: read again without taking it as names
            tbl = pc.read_csv(
                path, read_options=pc.ReadOptions(column_names=names),
                parse_options=pc.ParseOptions(delimiter=sep))
        if infer:
            return T.StructType([
                T.StructField(n, arrow_type_to_sql_for_csv(col.type))
                for n, col in zip(names, tbl.columns)])
        return T.StructType([T.StructField(n, T.StringT) for n in names])


def arrow_type_to_sql_for_csv(at) -> T.DataType:
    """CSV inference's types: integers as LONG and floats as DOUBLE
    (Spark's CSVInferSchema), anything unrecognised as a string."""
    import pyarrow as pa
    if pa.types.is_boolean(at):
        return T.BooleanT
    if pa.types.is_integer(at):
        return T.LongT
    if pa.types.is_floating(at):
        return T.DoubleT
    if pa.types.is_timestamp(at):
        return T.TimestampT
    if pa.types.is_date(at):
        return T.DateT
    return T.StringT
