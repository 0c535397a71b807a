"""File formats and reader strategies through both packages: the JAX
package (``spark.rapids.sql.enabled`` false and true, its kernels
interpreted on the CPU) and the port (``TorchSparkSession(device="cpu")``)
read the same files and must return identical rows (NaN equal to NaN,
-0.0 distinct from 0.0).

The cases mirror ``tests/test_io.py``: the self-describing round trips
(Parquet, ORC, JSON) and CSV with a schema, with ``inferSchema`` and with
more or fewer columns than the schema, its name collision and its
``nullValue``; text; every format under the PERFILE, MULTITHREADED and
COALESCING readers; the MULTITHREADED fault that cancels the queued
reads, with the pool usable after it; ``batchSizeRows`` splitting; ORC
stripe units; ``input_file_name()`` under COALESCING (plain, with the
upload ring two deep at one permit, and on the host task pool), placed
as the JAX package places it. Also the port's own guarantees: the
scan's counters under each reader (decodeFused only where a Parquet
unit stages for it), the IO retry protocol on pool threads counting as
on the task thread, the footer memo invalidated by a rewritten file,
and the input fingerprints. Everything is written into ``tmp_path`` at
a few hundred rows."""

import datetime
import decimal
import os
import shutil
import signal
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pytest
import torch

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import retry as PR
from spark_rapids_tpu_torch.io import readers as RD
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _sort_key
from tests.support import values_equal
from tests.torch_dual import dual_run

torch.set_num_threads(2)

READER = "spark.rapids.sql.format.parquet.reader.type"
THREADS = "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads"
READERS = ["PERFILE", "MULTITHREADED", "COALESCING"]
MIXED_SCHEMA = ("k bigint, v double, s string, d decimal(15,2), dt date, "
                "ts timestamp")
ONE_PERMIT_RING = {"spark.rapids.sql.concurrentGpuTasks": "1",
                   "spark.rapids.sql.format.parquet.deviceDecode"
                   ".maxInFlight": "2"}
# the JAX package's side of a query its upload ring would hang on
NO_RING = {"spark.rapids.sql.format.parquet.deviceDecode.maxInFlight": "0"}
LIMIT_S = 120


def mixed_data(n: int = 400, seed: int = 7) -> dict:
    """Seeded columns with nulls, NaN and -0.0: the same Python values go
    to both packages."""
    rng = np.random.default_rng(seed)
    k = [int(x) if x % 7 else None for x in rng.integers(0, 50, n)]
    v = [float(x) if i % 5 else None
         for i, x in enumerate(rng.normal(0, 100, n))]
    v[1], v[2] = float("nan"), -0.0
    s = [f"s{x}" if x % 3 else None for x in rng.integers(0, 99, n)]
    d = [decimal.Decimal(int(x)).scaleb(-2) if x % 4 else None
         for x in rng.integers(-10 ** 9, 10 ** 9, n)]
    dt = [datetime.date(1970, 1, 1) + datetime.timedelta(days=int(x))
          if x % 6 else None for x in rng.integers(-3000, 20000, n)]
    us = rng.integers(0, 2_000_000_000_000_000, n)
    us[::3] -= us[::3] % 1_000_000  # whole seconds print no fraction
    ts = [datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=int(x)) if i % 9 else None for i, x in enumerate(us)]
    return {"k": k, "v": v, "s": s, "d": d, "dt": dt, "ts": ts}


def frame_rows(data: dict, schema: str) -> list:
    """The rows of the port's DataFrame of ``data``: what a writer is
    given (a timestamp's microseconds as the session converts them)."""
    s = TorchSparkSession({}, device="cpu")
    return [tuple(r) for r in s.createDataFrame(data, schema).collect()]


def write_jax(path: str, fmt: str, data: dict, schema: str,
              parts: int = 2, **kw) -> None:
    s = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        df = s.createDataFrame(data, schema, num_partitions=parts)
        getattr(df.write.mode("overwrite"), fmt)(path, **kw)
    finally:
        s.stop()


def collect_all(build, conf=None, jax_conf=None,
                jax_device: bool = True) -> dict:
    """``build(session, F)``'s rows in the JAX package with the engine off
    (and on, where ``jax_device``), and in the port on the CPU:
    ``{name: rows}``."""
    conf = dict(conf or {})
    out = {}
    for name, enabled in (("jax_cpu", "false"), ("jax_device", "true")):
        if name == "jax_device" and not jax_device:
            continue
        s = TpuSparkSession(dict(conf, **(jax_conf or {}), **{
            "spark.rapids.sql.enabled": enabled}))
        try:
            out[name] = [tuple(r) for r in build(s, JF).collect()]
        finally:
            s.stop()
    s = TorchSparkSession(conf, device="cpu")
    out["port"] = [tuple(r) for r in build(s, PF).collect()]
    return out


def rows_equal(want, got, ordered: bool = False) -> None:
    if not ordered:
        want, got = sorted(want, key=_sort_key), sorted(got, key=_sort_key)
    assert len(want) == len(got), (len(want), len(got))
    for w, g in zip(want, got):
        assert len(w) == len(g) and all(
            values_equal(a, b) for a, b in zip(w, g)), (w, g)


def same_everywhere(build, conf=None, jax_conf=None, ordered=False,
                    jax_device: bool = True):
    """The port's rows, after holding them against the JAX sessions'."""
    out = collect_all(build, conf, jax_conf, jax_device)
    if jax_device:
        rows_equal(out["jax_cpu"], out["jax_device"], ordered)
    rows_equal(out["jax_cpu"], out["port"], ordered)
    return out["port"]


def port_plan_scan(session):
    return next(n for n in _nodes(session.last_plan)
                if isinstance(n, RD.CpuFileScanExec))


def _nodes(plan):
    out = [plan]
    for c in getattr(plan, "children", []):
        out += _nodes(c)
    return out


class time_limit:
    """Fail a test that hangs, instead of hanging the run."""

    def __enter__(self):
        def fire(*_):
            raise TimeoutError(f"no result within {LIMIT_S} s")
        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(LIMIT_S)

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)


# -- round trips -----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["parquet", "orc", "json"])
def test_roundtrip_self_describing(tmp_path, fmt):
    """Written by the JAX package, read by each package with the schema
    from the files (JSON with the schema given, as its inference loses
    decimals, dates and timestamps in both packages alike)."""
    data = mixed_data()
    path = str(tmp_path / fmt)
    write_jax(path, fmt, data, MIXED_SCHEMA)

    def build(s, F):
        if fmt == "json":
            return s.read.json(path, schema=MIXED_SCHEMA)
        return getattr(s.read, fmt)(path)
    got = same_everywhere(build)
    want = frame_rows(data, MIXED_SCHEMA)
    rows_equal(want, got)


def test_json_inferred_schema_as_the_reference(tmp_path):
    """pyarrow's inference of JSON lines, file by file: decimals and
    whole-second timestamps come back as strings, dates as timestamps, in
    both packages alike."""
    data = mixed_data(60)
    path = str(tmp_path / "json")
    write_jax(path, "json", data, MIXED_SCHEMA, parts=1)
    same_everywhere(lambda s, F: s.read.json(path))
    s = TorchSparkSession({}, device="cpu")
    js = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        jnames = [(f.name, type(f.data_type).__name__)
                  for f in js.read.json(path).plan.schema.fields]
    finally:
        js.stop()
    pnames = [(f.name, type(f.data_type).__name__)
              for f in s.read.json(path).plan.schema.fields]
    assert pnames == jnames


def test_roundtrip_csv_with_schema(tmp_path):
    data = mixed_data()
    path = str(tmp_path / "csv")
    write_jax(path, "csv", data, MIXED_SCHEMA, header=True)
    got = same_everywhere(lambda s, F: s.read.csv(
        path, schema=MIXED_SCHEMA, header=True))
    rows_equal(frame_rows(data, MIXED_SCHEMA), got)


def test_csv_null_value_and_separator(tmp_path):
    """dbgen's shape: ``|`` separated, no header, a ``nullValue``."""
    f = tmp_path / "t.tbl"
    f.write_text("1|2.50|x|1998-09-02\nNULL|3.00|NULL|NULL\n4|NULL|z|"
                 "1992-01-02\n")
    schema = "a bigint, p decimal(15,2), s string, d date"
    got = same_everywhere(lambda s, F: s.read.csv(
        str(f), schema=schema, sep="|", nullValue="NULL"), ordered=True)
    assert got[1] == (None, decimal.Decimal("3.00"), None, None)


def test_csv_infer_schema(tmp_path):
    path = str(tmp_path / "csv")
    write_jax(path, "csv", {"a": [1, 2], "b": [1.5, 2.5], "c": ["x", "y"]},
              "a bigint, b double, c string", parts=1, header=True)
    types = {}
    for pkg, mk in (("jax", lambda: TpuSparkSession(
            {"spark.rapids.sql.enabled": "false"})),
            ("port", lambda: TorchSparkSession({}, device="cpu"))):
        s = mk()
        back = s.read.option("inferSchema", "true").option(
            "header", "true").format("csv").load(path)
        types[pkg] = [(f.name, type(f.data_type).__name__)
                      for f in back.plan.schema.fields]
        assert back.count() == 2
    assert types["port"] == types["jax"] == [
        ("a", "LongType"), ("b", "DoubleType"), ("c", "StringType")]
    same_everywhere(lambda s, F: s.read.csv(path, header=True,
                                            inferSchema=True))
    # no header: _c0, _c1, ... all strings without inferSchema
    same_everywhere(lambda s, F: s.read.csv(path))


@pytest.mark.parametrize("text,options,want", [
    ("a,b,c\n1,2,3\n4,5,6\n", {}, [(1, 2), (4, 5)]),
    ("a\n1\n4\n", {}, [(1, None), (4, None)]),
    ("x,y,a\n1,2,3\n", {}, [(1, 2)]),
    ("a\n1\nXX\n", {"nullValue": "XX"}, [(1, None), (None, None)]),
], ids=["more_columns", "fewer_columns", "name_collision",
        "mismatch_keeps_null_value"])
def test_csv_permissive_column_count(tmp_path, text, options, want):
    """A file whose columns differ from the schema is read by position:
    extra columns dropped, missing ones null, ``nullValue`` kept."""
    f = tmp_path / "t.csv"
    f.write_text(text)

    def build(s, F):
        r = s.read.format("csv").schema("a bigint, b bigint") \
            .option("header", "true")
        for k, v in options.items():
            r = r.option(k, v)
        return r.load(str(f))
    assert same_everywhere(build, ordered=True) == want


def test_text(tmp_path):
    f = tmp_path / "lines.txt"
    f.write_text("first line\nsecond, with a comma\n\"quoted\"\nlast\n")
    got = same_everywhere(lambda s, F: s.read.text(str(f)), ordered=True)
    assert got == [("first line",), ("second, with a comma",),
                   ('"quoted"',), ("last",)]


def test_single_column_csv_drops_a_null_row_as_the_reference(tmp_path):
    """A one-column CSV writes a null as an empty line, which pyarrow's
    reader skips: both packages lose that row alike (ROADMAP C)."""
    path = str(tmp_path / "csv")
    write_jax(path, "csv", {"v": [1.5, None, -0.0, float("nan")]},
              "v double", parts=1)
    got = same_everywhere(lambda s, F: s.read.csv(path, schema="v double"),
                          ordered=True)
    assert len(got) == 3


# -- reader strategies ------------------------------------------------------

def _multi_file_dataset(root: str, fmt: str, files: int = 6,
                        rows: int = 40) -> None:
    """``files`` files of ``rows`` rows each under ``root/sub<i>``."""
    for i in range(files):
        data = mixed_data(rows, seed=100 + i)
        write_jax(os.path.join(root, f"sub{i}"), fmt, data, MIXED_SCHEMA,
                  parts=1)


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv", "json"])
def test_reader_strategies(tmp_path, fmt, reader):
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, fmt)

    def build(s, F):
        if fmt in ("csv", "json"):
            return getattr(s.read, fmt)(root, schema=MIXED_SCHEMA)
        return getattr(s.read, fmt)(root)
    got = same_everywhere(build, {READER: reader, THREADS: "2"})
    want = [r for i in range(6)
            for r in frame_rows(mixed_data(40, seed=100 + i), MIXED_SCHEMA)]
    rows_equal(want, got)


@pytest.mark.parametrize("reader", READERS)
def test_reader_counters_on_the_device_path(tmp_path, reader):
    """A group-by over Parquet: PERFILE and MULTITHREADED stage every row
    group for decodeFused; COALESCING decodes on the host and says so in
    its decodeTime and convertTime; the rows equal the JAX package's."""
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, "parquet")

    def build(s, F):
        return s.read.parquet(root).groupBy("k").agg(
            F.count("v").alias("c"), F.sum("d").alias("sd"))
    conf = {READER: reader, THREADS: "3"}
    same_everywhere(build, conf)
    s = TorchSparkSession(conf, device="cpu")
    build(s, PF).collect()
    scan = port_plan_scan(s)
    snap = scan.metrics.snapshot()
    total = plan_metrics(s.last_plan)
    decoded = total.get("kernelDispatchCount.decodeFused", 0)
    if reader == "COALESCING":
        assert snap.get("deviceDecodedBatches", 0) == 0 and decoded == 0
        assert snap["decodeTime"] > 0 and snap["convertTime"] > 0
    else:
        assert snap["deviceDecodedBatches"] == decoded == 6
        assert snap.get("decodeTime", 0) == 0
    assert scan.reader_type() == reader


def test_multithreaded_fault_cancels_and_pool_stays_usable(tmp_path,
                                                          monkeypatch):
    """A read that raises on a pool thread surfaces on the consumer, the
    reads still queued are cancelled, and the shared pool serves the
    next session (after the first one stopped)."""
    root = str(tmp_path / "multi")
    for i in range(10):
        write_jax(os.path.join(root, f"sub{i}"), "parquet",
                  {"a": list(range(i * 10, i * 10 + 10))}, "a bigint",
                  parts=1)
    calls = []
    real_read = RD._read_unit

    def faulty_read(fmt, unit, schema, options):
        calls.append(unit.path)
        if "sub0" in unit.path:
            raise RuntimeError("injected decode fault")
        time.sleep(0.05)  # keep later reads queued, not running
        return real_read(fmt, unit, schema, options)

    monkeypatch.setattr(RD, "_read_unit", faulty_read)
    # the engine off: every unit host-decodes through _read_unit
    conf = {READER: "MULTITHREADED", THREADS: "2",
            "spark.rapids.sql.enabled": "false"}
    s = TorchSparkSession(conf, device="cpu")
    with pytest.raises(RuntimeError, match="injected decode fault"):
        s.read.parquet(root).collect()
    s.stop()
    assert len(calls) < 10, calls
    monkeypatch.setattr(RD, "_read_unit", real_read)
    pool = RD._shared_pool(2)
    s = TorchSparkSession(conf, device="cpu")
    got = sorted(r.a for r in s.read.parquet(root).collect())
    assert got == list(range(100))
    assert RD._shared_pool(2) is pool
    s.stop()


def test_pool_threads_take_no_permit(tmp_path, monkeypatch):
    """The pool's work is host work: no device permit is taken on a pool
    thread while a MULTITHREADED scan feeds the device path."""
    from spark_rapids_tpu_torch.resource import TorchSemaphore
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, "parquet")
    seen = []
    plain = TorchSemaphore.acquire_if_necessary

    def acquire(self, *a, **kw):
        seen.append(threading.current_thread().name)
        return plain(self, *a, **kw)
    monkeypatch.setattr(TorchSemaphore, "acquire_if_necessary", acquire)
    s = TorchSparkSession(dict(ONE_PERMIT_RING, **{
        READER: "MULTITHREADED", THREADS: "3"}), device="cpu")
    with time_limit():
        rows = s.read.parquet(root).groupBy("k").agg(
            PF.count("v").alias("c")).collect()
    assert rows and seen
    assert not any(n.startswith("torch-multifile") for n in seen), seen


def test_multithreaded_under_the_ring_at_one_permit(tmp_path):
    """MULTITHREADED's consumer is the ring's producer thread, which
    adopts its task's permit: two units deep at one permit, the rows
    equal the JAX package's (its side without the ring)."""
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, "csv")

    def build(s, F):
        return s.read.csv(root, schema=MIXED_SCHEMA).groupBy("k").agg(
            F.count("v").alias("c"), F.max("ts").alias("t"))
    with time_limit():
        same_everywhere(build, dict(ONE_PERMIT_RING, **{
            READER: "MULTITHREADED", THREADS: "2"}), jax_conf=NO_RING)


def test_io_retries_on_pool_threads_count_as_on_the_task_thread(tmp_path):
    """Injected transient IO errors retry on whichever thread reads the
    unit: ioRetryCount is the same under every reader."""
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, "orc", files=5)
    counts = {}
    for reader in READERS:
        PR.reset_fault_injection()
        s = TorchSparkSession({READER: reader, THREADS: "3",
                               "spark.rapids.sql.test.injectIOError": "3",
                               "spark.rapids.sql.reader.retryBackoffMs":
                               "1"}, device="cpu")
        rows = s.read.orc(root).collect()
        assert len(rows) == 200
        counts[reader] = plan_metrics(s.last_plan).get("ioRetryCount", 0)
    PR.reset_fault_injection()
    assert counts["PERFILE"] > 0
    assert counts["MULTITHREADED"] == counts["COALESCING"] == \
        counts["PERFILE"], counts


def test_batch_size_rows_splits_batches(tmp_path):
    path = str(tmp_path / "p")
    write_jax(path, "parquet", mixed_data(100), MIXED_SCHEMA, parts=1)
    for reader in READERS:
        s = TorchSparkSession({READER: reader,
                               "spark.rapids.sql.reader.batchSizeRows":
                               "16"}, device="cpu")
        scan = s._plan_cpu(s.read.parquet(path).plan)
        batches = [b for t in scan.partitions() for b in t()]
        assert all(b.num_rows <= 16 for b in batches)
        assert sum(b.num_rows for b in batches) == 100
        assert len(batches) == 7


def test_orc_stripe_units(tmp_path):
    """A multi-stripe ORC file plans one unit per stripe, with rows equal
    to the JAX package's under every reader."""
    path = str(tmp_path / "t.orc")
    n = 200_000
    po.write_table(pa.table({"k": np.arange(n) % 7, "v": np.arange(n)}),
                   path, stripe_size=64 << 10)
    units = RD.plan_scan_units("orc", RD.list_files([path]))
    assert len(units) == po.ORCFile(path).nstripes > 1
    assert [u.row_groups for u in units] == [[i] for i in range(len(units))]
    for reader in READERS:
        got = same_everywhere(lambda s, F: s.read.orc(path).groupBy(
            "k").agg(F.sum("v").alias("sv")), {READER: reader})
        assert sorted(got) == [(k, int(np.arange(n)[np.arange(n) % 7 == k]
                                       .sum())) for k in range(7)]


def test_unit_memo_sees_a_rewritten_file(tmp_path):
    """The footer memo is keyed on the file set and checked against each
    file's size and mtime: an overwrite, then a read, plans anew."""
    path = str(tmp_path / "p")
    s = TorchSparkSession({}, device="cpu")
    s.createDataFrame({"a": [1, 2, 3]}, "a bigint", num_partitions=1) \
        .write.parquet(path)
    files = RD.list_files([path])
    first = RD.plan_scan_units("parquet", files)
    assert RD.plan_scan_units("parquet", files) is first
    f = files[0][0]
    t = pa.table({"a": pa.array(list(range(10)), pa.int64())})
    import pyarrow.parquet as pq
    pq.write_table(t, f, row_group_size=4)
    st = os.stat(f)
    os.utime(f, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    again = RD.plan_scan_units("parquet", files)
    assert again is not first and len(again) == 3
    assert sorted(r.a for r in s.read.parquet(path).collect()) == \
        list(range(10))


def test_file_fingerprints(tmp_path):
    path = str(tmp_path / "p")
    s = TorchSparkSession({}, device="cpu")
    s.createDataFrame({"a": [1, 2, 3]}, "a bigint", num_partitions=2) \
        .write.parquet(path)
    scan = s._plan_cpu(s.read.parquet(path).plan)
    fps = scan.fingerprints
    assert [f for f, _s, _m in fps] == scan.files
    assert all(sz == os.path.getsize(f) and m == os.stat(f).st_mtime_ns
               for f, sz, m in fps)
    assert RD.file_fingerprints(scan.files + [str(tmp_path / "gone")]) \
        is None


def test_reader_table_and_options(tmp_path):
    path = str(tmp_path / "csv")
    write_jax(path, "csv", {"a": [1, 2]}, "a bigint", parts=1, header=True,
              sep=";")
    s = TorchSparkSession({}, device="cpu")
    df = s.read.options(header="true", sep=";").schema("a bigint") \
        .format("csv").load(path)
    df.createOrReplaceTempView("t")
    assert [r.a for r in s.read.table("t").collect()] == [1, 2]


# -- input_file_name() ------------------------------------------------------

IFF_SQL = ("SELECT f, count(*) AS c FROM (SELECT input_file_name() AS f "
           "FROM t) x GROUP BY f")


def _iff_dataset(root: str) -> dict:
    """Four Parquet files of 10, 20, 30 and 40 rows: {file: rows}."""
    want = {}
    for i in range(4):
        d = os.path.join(root, f"sub{i}")
        write_jax(d, "parquet", {"a": list(range(10 * (i + 1)))}, "a bigint",
                  parts=1)
        f = next(os.path.join(d, n) for n in os.listdir(d)
                 if n.endswith(".parquet"))
        want[f] = 10 * (i + 1)
    return want


def _iff_build(root):
    def build(s, F):
        s.read.parquet(root).createOrReplaceTempView("t")
        return s.sql(IFF_SQL)
    return build


@pytest.mark.parametrize("reader", READERS)
def test_input_file_name_per_file(tmp_path, reader):
    """Each file's row count under every reader: the scan under the
    project reads as PERFILE, as the JAX package's does; placement as in
    the JAX package."""
    root = str(tmp_path / "iff")
    want = _iff_dataset(root)
    build = _iff_build(root)
    got = same_everywhere(build, {READER: reader})
    assert dict(got) == want
    _jax_rec, port_rec = dual_run(lambda s: build(s, JF),
                                  lambda s: build(s, PF), {READER: reader})
    # the project stays on the host with the JAX package's reason
    assert port_rec.reports[-1].fallbacks == [
        ("CpuProjectExec", ["expression InputFileName <InputFileName()> "
                            "is not supported on TPU"])]
    s = TorchSparkSession({READER: reader}, device="cpu")
    build(s, PF).collect()
    assert port_plan_scan(s).reader_type() == "PERFILE"
    # without input_file_name() the reader stays COALESCING
    s.read.parquet(root).groupBy().count().collect()
    assert port_plan_scan(s).reader_type() == reader


def test_input_file_name_under_the_ring_at_one_permit(tmp_path):
    """The ring's producer thread pulls the scan and evaluates the
    project: the file it sets is the one the project reads."""
    root = str(tmp_path / "iff")
    want = _iff_dataset(root)
    with time_limit():
        got = same_everywhere(_iff_build(root), dict(ONE_PERMIT_RING, **{
            READER: "COALESCING"}), jax_conf=NO_RING)
    assert dict(got) == want
    s = TorchSparkSession(dict(ONE_PERMIT_RING, **{READER: "COALESCING"}),
                          device="cpu")
    _iff_build(root)(s, PF).collect()
    assert plan_metrics(s.last_plan).get("uploadAheadBatches", 0) > 0


@pytest.mark.parametrize("reader", READERS)
def test_input_file_name_on_the_host_task_pool(tmp_path, reader):
    """The engine off: the plan's partitions drain on task threads, each
    setting and reading its own file."""
    root = str(tmp_path / "iff")
    want = _iff_dataset(root)
    conf = {READER: reader, "spark.rapids.sql.enabled": "false",
            "spark.rapids.sql.taskParallelism": "4",
            "spark.sql.files.openCostInBytes": "1"}
    s = TorchSparkSession(conf, device="cpu")
    df = s.read.parquet(root).select(PF.input_file_name().alias("f"), "a")
    rows = df.collect()
    counts = {}
    for f, _a in rows:
        counts[f] = counts.get(f, 0) + 1
    assert counts == want
    assert len(s._plan_cpu(s.read.parquet(root).plan)._parts) == 4
    rows_equal(collect_all(lambda s, F: s.read.parquet(root).select(
        F.input_file_name().alias("f"), "a"), conf)["jax_cpu"], rows)


def test_stop_leaves_the_pool_usable(tmp_path):
    root = str(tmp_path / "multi")
    _multi_file_dataset(root, "json", files=3)
    conf = {READER: "MULTITHREADED", THREADS: "2"}
    for _ in range(2):
        s = TorchSparkSession(conf, device="cpu")
        assert s.read.json(root, schema=MIXED_SCHEMA).count() == 120
        s.stop()
    shutil.rmtree(root)


def test_unknown_reader_type_raises(tmp_path):
    path = str(tmp_path / "p")
    write_jax(path, "parquet", {"a": [1]}, "a bigint", parts=1)
    s = TorchSparkSession({READER: "EVERYFILE"}, device="cpu")
    with pytest.raises(ValueError, match="unknown reader type"):
        s.read.parquet(path).collect()


@pytest.mark.parametrize("reader", READERS)
@pytest.mark.parametrize("fmt", ["parquet", "orc"])
def test_a_unit_missing_a_column_reads_it_as_nulls(tmp_path, fmt, reader):
    """Two files of one dataset, the second without ``b`` and with an
    extra ``c``: the scan keeps the schema of the first, ``b`` null where
    a file lacks it, ``c`` dropped, under every reader and on both
    paths. (The JAX package fails here: ROADMAP C.)"""
    import pyarrow.parquet as pq
    write = pq.write_table if fmt == "parquet" else po.write_table
    root = tmp_path / "evolve"
    root.mkdir()
    write(pa.table({"a": pa.array([1, 2], pa.int64()),
                    "b": pa.array(["x", None])}), str(root / f"p1.{fmt}"))
    write(pa.table({"a": pa.array([3], pa.int64()),
                    "c": pa.array([9.5])}), str(root / f"p2.{fmt}"))
    for enabled in ("true", "false"):
        s = TorchSparkSession({READER: reader, THREADS: "2",
                               "spark.rapids.sql.enabled": enabled},
                              device="cpu")
        got = getattr(s.read, fmt)(str(root)).collect()
        assert sorted(tuple(r) for r in got) == [(1, "x"), (2, None),
                                                 (3, None)]
