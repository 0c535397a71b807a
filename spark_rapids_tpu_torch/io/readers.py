"""Parquet scan: DataFrameReader + CpuFileScanExec (the port's counterpart
of ``spark_rapids_tpu.io.readers``, Parquet only).

The host lists files (with Hive ``k=v`` partition-directory discovery),
reads footers and plans one scan unit per row group, prunes units whose
footer statistics rule out a pushed-down predicate, and bin-packs the
units into partitions as Spark's FilePartition does. Each partition then
reads its units one by one on the task thread (PERFILE).

When ``TorchRowToColumnarExec`` consumes the scan directly, a row group is
staged as an ``EncodedBatch`` (still-encoded pages plus plan tables) for
the ``decodeFused`` kernel; otherwise, and for units the device decode
cannot take, pyarrow decodes on the host; that host decode is also the
upload's fallback for one batch after an out-of-memory error. The file
reads of both paths run under the IO retry protocol (``io_with_retry``:
bounded backoff, the original error after
``spark.rapids.sql.reader.maxRetries``). The MULTITHREADED and COALESCING
readers, the other formats and the mesh scan are not ported yet.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import (MAX_READER_BATCH_SIZE_ROWS,
                                         PARQUET_READER_TYPE,
                                         TASK_PARALLELISM, TorchConf)
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T

DEFAULT_MAX_PARTITION_BYTES = 128 << 20

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet to spark_rapids_tpu_torch")


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
    """One decode unit: a row group of a Parquet file (or the whole file
    when its footer cannot be read). ``stats`` maps column -> (min, max,
    null_count, num_rows) from the footer, None where absent."""

    path: str
    size_bytes: int
    row_groups: Optional[List[int]] = None
    part_values: Optional[Dict[str, str]] = None
    stats: Optional[Dict[str, tuple]] = None


def plan_scan_units(fmt: str, files: List[tuple]) -> List[ScanUnit]:
    if fmt != "parquet":
        raise _not_ported(f"reading {fmt}")
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


def _read_unit(fmt: str, unit: ScanUnit, schema: T.StructType):
    """Decode one unit to a pyarrow Table with ``schema``'s columns."""
    if fmt != "parquet":
        raise _not_ported(f"reading {fmt}")
    import pyarrow as pa
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.io.arrow_convert import sql_type_to_arrow
    names = [f.name for f in schema.fields]
    pf = pq.ParquetFile(unit.path)
    if unit.row_groups is not None:
        if not unit.row_groups:
            return pa.table(
                {n: pa.array([], type=sql_type_to_arrow(f.data_type))
                 for n, f in zip(names, schema.fields)})
        return pf.read_row_groups(unit.row_groups, columns=names)
    return pf.read(columns=names)


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


class ScanMetrics(M.MetricRegistry):
    """Named counters of one scan: ``deviceDecodedBatches``,
    ``deviceFallbackUnits``, ``deviceFallbackColumns``,
    ``deviceDecodedValues.<ENC>`` and ``hostDecodedValues.<ENC>``, and
    the IO retry protocol's ``ioRetryCount`` and ``retryBlockTime``. A
    registry, so ``plan_metrics`` sums them with the operators'."""

    def add(self, name: str, v: int = 1) -> None:
        self.create(name).add(v)


class CpuFileScanExec(P.PhysicalPlan):
    """File source scan, a host node; the rewrite puts a
    ``TorchRowToColumnarExec`` above it, which turns on ``emit_encoded``
    at execution time."""

    def __init__(self, output, fmt: str, paths: List[str],
                 options: Dict[str, Any], conf: TorchConf):
        if fmt != "parquet":
            raise _not_ported(f"reading {fmt}")
        self.children = []
        self._output = output
        self.fmt = fmt
        self.paths = paths
        self.options = options or {}
        self.conf = conf
        self.metrics = ScanMetrics()
        listed = list_files(paths)
        self.files = [f for f, _ in listed]
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
        # set at execution time by TorchRowToColumnarExec when IT is the
        # direct consumer: only then may partitions() emit EncodedBatch
        # staging objects instead of HostBatches
        self.emit_encoded = False

    def set_pushdown(self, preds: List[tuple]) -> None:
        """Install pushed-down predicates (name, op, storage value) and
        prune row-group units whose footer stats preclude matches. The
        enclosing Filter still runs, so pruning may be conservative."""
        self._pushed = preds
        if not preds:
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
        """The units (row groups) of each partition, from the footers,
        before any read."""
        return [len(us) for us in self._parts]

    def simple_string(self):
        s = (f"FileScan {self.fmt} [{len(self.files)} files, "
             f"{len(self._parts)} partitions")
        if self._pushed:
            s += (f", pushed {len(self._pushed)} filters, "
                  f"pruned {self.pruned_units} units")
        return s + "]"

    def partitions(self):
        reader_type = str(self.conf.get(PARQUET_READER_TYPE)).upper()
        if reader_type != "PERFILE":
            raise _not_ported(f"the {reader_type} Parquet reader")
        max_rows = int(self.conf.get(MAX_READER_BATCH_SIZE_ROWS))
        schema = self.schema
        part_fields = self._part_fields
        part_names = {f.name for f in part_fields}
        data_schema = T.StructType(
            [f for f in schema.fields if f.name not in part_names])
        device_decode = self.emit_encoded
        metrics = self.metrics

        def decode(u: ScanUnit):
            # a transient IO error retries with bounded backoff
            tbl = R.io_with_retry(
                lambda: _read_unit(self.fmt, u, data_schema), self.conf,
                metrics, path=u.path)
            if part_fields:
                tbl = _append_partition_columns(tbl, part_fields,
                                                u.part_values or {})
                tbl = tbl.select([f.name for f in schema.fields])
            return tbl

        def emit(tbl) -> Iterator[HostBatch]:
            from spark_rapids_tpu_torch.io.arrow_convert import \
                arrow_to_host_batch
            for lo in range(0, max(1, tbl.num_rows), max_rows):
                yield arrow_to_host_batch(tbl.slice(lo, max_rows), schema)

        def plan_device(u: ScanUnit):
            """ScanUnit -> EncodedBatch (host IO, decompression and
            header parsing only), or None when the unit host-decodes."""
            from spark_rapids_tpu_torch.io import device_decode as DD
            # the planner's file reads ride the same IO retry protocol
            enc = R.io_with_retry(
                lambda: DD.plan_unit_encoded(u, data_schema), self.conf,
                metrics, path=u.path)
            if enc is None or enc.num_rows > max_rows:
                metrics.add("deviceFallbackUnits")
                return None
            if part_fields:
                enc = _extend_with_partition_cols(
                    enc, schema, part_fields, u.part_values or {})
            # the upload's OOM fallback: this unit's host decode
            enc.host_fallback = lambda u=u: list(emit(decode(u)))
            metrics.add("deviceDecodedBatches")
            metrics.add("deviceFallbackColumns", len(enc.fallbacks))
            for ename, nvals in enc.fallback_encodings.items():
                metrics.add(f"hostDecodedValues.{ename}", nvals)
            for plan in enc.plans.values():
                for ename, nvals in plan.encoding_values.items():
                    metrics.add(f"deviceDecodedValues.{ename}", nvals)
            return enc

        def make(units: List[ScanUnit]):
            def run() -> Iterator[Any]:
                for u in units:
                    enc = plan_device(u) if device_decode else None
                    if enc is not None:
                        yield enc
                    else:
                        yield from emit(decode(u))
            return run

        return [make(us) for us in self._parts]


class DataFrameReader:
    """spark.read facade (pyspark DataFrameReader shape), Parquet only."""

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

    def load(self, path=None):
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame
        if self._format != "parquet":
            raise _not_ported(f"reading {self._format}")
        paths = [path] if isinstance(path, str) else list(path)
        listed = list_files(paths)
        schema = self._schema or self._infer_schema(listed[0][0])
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

    @staticmethod
    def _infer_schema(first: str) -> T.StructType:
        import pyarrow.parquet as pq

        from spark_rapids_tpu_torch.io.arrow_convert import \
            arrow_schema_to_sql
        return arrow_schema_to_sql(pq.ParquetFile(first).schema_arrow)
