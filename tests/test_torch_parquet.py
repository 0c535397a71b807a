"""Parquet through both packages: the JAX package's TpuSparkSession
(kernels interpreted on the CPU) and the port's
TorchSparkSession(device="cpu") read the same files and must return
identical rows, with the same scan route: device-decoded batches,
host-decoded columns and units, row groups pruned by footer statistics,
and join routes. Files written by the port's writer read back through
pyarrow to the same table as the JAX package's writer's.

Everything is written into ``tmp_path`` at a small scale."""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import (Q1, Q3_BENCH, check_q1_rows, check_q3_rows,
                        decode_corpus, lineitem_arrays, lineitem_fields,
                        q1_reference, q3_reference, q3_tables)
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

JAX_CONF = {"spark.rapids.sql.enabled": "true"}
SCAN_KEYS = ("deviceDecodedBatches", "deviceFallbackColumns",
             "deviceFallbackUnits")
READER = "spark.rapids.sql.format.parquet.reader.type"
CORPUS = ["plain", "dict", "page_nulls", "int_dict_overflow",
          "str_dict_overflow", "dec128_flba", "delta_nulls", "delta_length",
          "bss", "page_v2", "bool_ts", "plain_strings",
          "narrow_ints_binary", "delta_byte_array_mixed", "q1_row_group"]


def _nodes(plan):
    out = [plan]
    for c in getattr(plan, "children", []):
        out += _nodes(c)
    return out


def _jax_run(views, sql, conf=None, plans_out=None):
    """(rows, metric snapshot, pruned units) of ``sql`` in the JAX
    package over ``views`` {name: path}; the captured plans are appended
    to ``plans_out`` where one is given."""
    s = TpuSparkSession(dict(JAX_CONF, **(conf or {})))
    try:
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        df = s.sql(sql)
        s.start_capture()
        rows = [tuple(r) for r in df.collect()]
        plans = s.get_captured_plans()
        if plans_out is not None:
            plans_out.extend(plans)
        snap = registry_snapshot(plans)["metrics"]
        pruned = sum(getattr(n, "pruned_units", 0)
                     for p in plans for n in _nodes(p))
        return rows, snap, pruned
    finally:
        s.stop()


def _port_run(views, sql, conf=None):
    """(rows, summed scan counters, pruned units, executed plan) of
    ``sql`` in the port over ``views``."""
    s = TorchSparkSession(dict(conf or {}), device="cpu")
    for name, path in views.items():
        s.read.parquet(path).createOrReplaceTempView(name)
    rows = [tuple(r) for r in s.sql(sql).collect()]
    scans = [n for n in _nodes(s.last_plan)
             if isinstance(n, CpuFileScanExec)]
    counts: dict = {}
    for sc in scans:
        for k, v in sc.metrics.snapshot().items():
            counts[k] = counts.get(k, 0) + v
    return rows, counts, sum(sc.pruned_units for sc in scans), s.last_plan


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return decode_corpus(str(tmp_path_factory.mktemp("corpus")),
                         q1_rows=6000)


@pytest.mark.parametrize("case", CORPUS)
def test_select_star_identical_to_jax_package(corpus, case):
    views = {"t": corpus[case]}
    want, snap, _ = _jax_run(views, "SELECT * FROM t")
    got, counts, _, _plan = _port_run(views, "SELECT * FROM t")
    assert got == want
    assert len(got) > 0
    for k in SCAN_KEYS:
        assert counts.get(k, 0) == snap.get(k, 0), (k, counts, snap)
    assert counts.get("deviceDecodedBatches", 0) == 1
    for k, v in snap.items():
        if k.startswith(("deviceDecodedValues.", "hostDecodedValues.")):
            assert counts.get(k) == v, (k, counts)


@pytest.fixture(scope="module")
def q1_files(tmp_path_factory):
    """q1's lineitem, 20,000 rows in 8 files of 2,500 rows in row groups
    of 1,000 (3 units a file, all packed into one partition)."""
    base = str(tmp_path_factory.mktemp("q1"))
    arrays = lineitem_arrays(20_000)
    tbl = host_batch_to_arrow(host_batch_from_numpy(lineitem_fields(),
                                                    arrays))
    for i in range(8):
        pq.write_table(tbl.slice(i * 2500, 2500),
                       os.path.join(base, f"part-{i:05d}.parquet"),
                       row_group_size=1000)
    return base, arrays


@pytest.mark.parametrize("reader", ["PERFILE", "MULTITHREADED"])
def test_q1_identical_to_jax_package(q1_files, reader):
    """The port's PERFILE reader against either of the JAX package's."""
    base, arrays = q1_files
    views = {"lineitem": base}
    want, snap, jpruned = _jax_run(views, Q1, {READER: reader})
    got, counts, pruned, plan = _port_run(views, Q1)
    assert got == want
    check_q1_rows(got, q1_reference(arrays))
    assert counts["deviceDecodedBatches"] == snap["deviceDecodedBatches"]
    assert counts["deviceDecodedBatches"] == 24
    for k in SCAN_KEYS[1:]:
        assert counts.get(k, 0) == snap.get(k, 0) == 0
    assert pruned == jpruned == 0
    names = [type(n).__name__ for n in _nodes(plan)]
    assert names[-2:] == ["TorchRowToColumnarExec", "CpuFileScanExec"]
    assert all(n.startswith("Torch") for n in names[:-1])


@pytest.mark.parametrize("reader", ["MULTITHREADED", "COALESCING"])
def test_unported_reader_types_raise(q1_files, reader):
    """q1 under the port's MULTITHREADED and COALESCING readers: rows
    equal to the JAX package's under the same reader; every row group
    staged for decodeFused under MULTITHREADED, none under COALESCING,
    which decodes on the host."""
    base, arrays = q1_files
    views = {"lineitem": base}
    want, _snap, _pruned = _jax_run(views, Q1, {READER: reader})
    got, counts, _pruned, _plan = _port_run(views, Q1, {READER: reader})
    assert got == want
    check_q1_rows(got, q1_reference(arrays))
    assert counts.get("deviceDecodedBatches", 0) == (
        24 if reader == "MULTITHREADED" else 0)


def test_pushdown_prunes_the_same_row_groups(tmp_path):
    """Sorted ship dates: the footer statistics rule out the early row
    groups of a late-date filter, in both packages alike."""
    arrays = lineitem_arrays(12_000)
    order = np.argsort(arrays[6], kind="stable")
    arrays = [a[order] for a in arrays]
    tbl = host_batch_to_arrow(host_batch_from_numpy(lineitem_fields(),
                                                    arrays))
    path = str(tmp_path / "sorted.parquet")
    pq.write_table(tbl, path, row_group_size=1000)
    sql = ("SELECT l_returnflag, count(*) c, sum(l_quantity) q "
           "FROM t WHERE l_shipdate > date '1998-06-01' "
           "GROUP BY l_returnflag ORDER BY l_returnflag")
    want, snap, jpruned = _jax_run({"t": path}, sql)
    got, counts, pruned, _plan = _port_run({"t": path}, sql)
    assert got == want
    assert pruned == jpruned > 0
    assert counts["deviceDecodedBatches"] == snap["deviceDecodedBatches"] \
        == 12 - pruned


def _q3_types(mod):
    return {"long": mod.LongT, "int": mod.IntegerT, "str": mod.StringT,
            "dec72": mod.DecimalType(7, 2)}


@pytest.fixture(scope="module")
def q3_files(tmp_path_factory):
    """bench.py's q3 tables at 20,000 store_sales rows, written as bench
    writes them (through the port's writer here): store_sales in 8
    files, item and date_dim in one each."""
    base = str(tmp_path_factory.mktemp("q3"))
    tables = q3_tables(20_000)
    s = TorchSparkSession(device="cpu")
    types = _q3_types(PT)
    views = {}
    for name, parts in (("item", 1), ("date_dim", 1), ("store_sales", 8)):
        cols = tables[name]
        batch = host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                                      [a for _c, _k, a in cols])
        views[name] = os.path.join(base, name)
        s.createDataFrame(batch, num_partitions=parts).write \
            .mode("overwrite").parquet(views[name])
    return views, tables


def test_q3_bench_text_identical_to_jax_package(q3_files):
    views, tables = q3_files
    want, snap, _ = _jax_run(views, Q3_BENCH)
    got, counts, _, plan = _port_run(views, Q3_BENCH)
    assert got == want
    check_q3_rows(got, q3_reference(tables), "q3 from parquet")
    assert counts["deviceDecodedBatches"] == snap["deviceDecodedBatches"] \
        == 10
    routes = {"joinProbe": 0, "fkFastPathJoins": 0}
    for n in _nodes(plan):
        for k, v in getattr(n, "route_counts", {}).items():
            routes[k] += v
    assert routes["joinProbe"] == snap.get(
        "kernelDispatchCount.joinProbe", 0)
    assert routes["fkFastPathJoins"] == snap.get("fkFastPathJoins", 0)
    names = [type(n).__name__ for n in _nodes(plan)]
    assert names.count("TorchBroadcastHashJoinExec") == 2


@pytest.mark.parametrize("query", ["q1", "q3"])
def test_plans_and_dispatches_match_jax_package(q1_files, q3_files, query):
    """From Parquet, too: the JAX package's operators and exchange
    partition counts (one partition on one card: no murmur3), and the
    same groupbyHash and decodeFused dispatches."""
    from spark_rapids_tpu_torch.metrics import plan_metrics
    from test_torch_runtime import dispatches, plan_shape
    if query == "q1":
        views, sql = {"lineitem": q1_files[0]}, Q1
    else:
        views, sql = q3_files[0], Q3_BENCH
    jplans: list = []
    want, snap, _ = _jax_run(views, sql, plans_out=jplans)
    got, _counts, _, plan = _port_run(views, sql)
    assert got == want
    (jplan,) = jplans
    kinds, exchanges = plan_shape(plan)
    assert (kinds, exchanges) == plan_shape(jplan)
    assert all(n == 1 for _p, n in exchanges)
    d = dispatches(plan_metrics(plan))
    assert d == dispatches(snap)
    assert d["kernelDispatchCount.murmur3"] == 0
    assert d["kernelDispatchCount.decodeFused"] == (24 if query == "q1"
                                                    else 10)


def test_writer_matches_jax_writer(tmp_path):
    """The same rows written by each package's DataFrameWriter read back
    through pyarrow to equal tables, file for file."""
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
    from spark_rapids_tpu.sql import types as JT
    rng = np.random.default_rng(3)
    n = 3000
    arrays = [rng.integers(-10**12, 10**12, n),
              rng.integers(-10**9, 10**9, n),
              np.array([f"v{i % 13}" for i in range(n)], dtype=object),
              rng.integers(-3000, 30000, n).astype(np.int32)]
    valid = [rng.random(n) > 0.1 for _ in arrays]
    kinds = [("a", "LongT"), ("d", None), ("s", "StringT"),
             ("dt", "DateT")]

    def dtype(mod, name, kind):
        return mod.DecimalType(15, 2) if kind is None else getattr(mod, kind)
    port_batch = host_batch_from_numpy(
        [(c, dtype(PT, c, k)) for c, k in kinds], arrays, valid)
    jfields = JT.StructType([JT.StructField(c, dtype(JT, c, k))
                             for c, k in kinds])
    jbatch = JHostBatch(jfields, [
        JHostColumn(f.data_type, a, v).normalized()
        for f, a, v in zip(jfields.fields, arrays, valid)], n)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    TorchSparkSession(device="cpu").createDataFrame(
        port_batch, num_partitions=3).write.parquet(pdir)
    js = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        js.createDataFrame(jbatch, num_partitions=3).write.parquet(jdir)
    finally:
        js.stop()
    pfiles = sorted(f for f in os.listdir(pdir) if f.endswith(".parquet"))
    jfiles = sorted(f for f in os.listdir(jdir) if f.endswith(".parquet"))
    assert len(pfiles) == len(jfiles) == 3
    assert os.path.exists(os.path.join(pdir, "_SUCCESS"))
    for pf, jf in zip(pfiles, jfiles):
        pt = pq.read_table(os.path.join(pdir, pf))
        jt = pq.read_table(os.path.join(jdir, jf))
        assert pt.equals(jt), pf
        meta = pq.ParquetFile(os.path.join(pdir, pf)).metadata
        assert meta.row_group(0).column(0).compression == "SNAPPY"


def test_write_modes(tmp_path):
    s = TorchSparkSession(device="cpu")
    df = s.createDataFrame(host_batch_from_numpy(
        [("x", PT.LongT)], [np.arange(10)]), num_partitions=2)
    path = str(tmp_path / "out")
    df.write.parquet(path)
    with pytest.raises(FileExistsError):
        df.write.parquet(path)
    df.write.mode("ignore").parquet(path)
    df.write.mode("overwrite").parquet(path)
    assert pq.read_table(path).column("x").to_pylist() == list(range(10))
    orc = str(tmp_path / "orc")
    df.write.format("orc").save(orc)
    assert sorted(r.x for r in s.read.orc(orc).collect()) == list(range(10))
    csv = str(tmp_path / "csv")
    df.write.csv(csv)
    assert sorted(r.x for r in s.read.format("csv").schema("x bigint")
                  .load(csv).collect()) == list(range(10))
