"""Whole-stage fusion held against the JAX package on the CPU: q1, both q3
forms, q1 and q3 from Parquet and the user repartition query run through
the JAX package's TpuSparkSession (kernels interpreted) and the port's
TorchSparkSession(device="cpu"), with ``spark.rapids.sql.stageFusion.
enabled`` on and off in both. The rows must be identical; fused, the
port's plan must hold the JAX plan's fused stages (the same node kinds,
the same grouping of ``fused_ops``, the same sink aggregate) with the
same ``fusedOps``, ``dispatchCount`` and per-operator batch counts.

``test_torch_runtime.fused_shape`` reads a plan of either package
without flattening its fused stages, as ``plan_shape`` does. On the
CPU no CUDA graph is made: each stage program runs eagerly, and the
stage cache counts its hits and misses all the same."""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import (Q1, Q3_BENCH, Q3_PUSHED, lineitem_arrays,
                        lineitem_fields, q3_tables)
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_q1 import (CONF, N_PARTS, _LINEITEM, _jax_batch,
                           _lineitem_arrays, _q1_sql, _torch_batch)
from test_torch_q3 import _jax_batch as _jq3_batch
from test_torch_q3 import _torch_batch as _tq3_batch
from test_torch_runtime import dispatches, fused_shape

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.exec import fused as F
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.jit_cache import JitCache
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

JAX_CONF = {"spark.rapids.sql.enabled": "true"}
FUSION = "spark.rapids.sql.stageFusion.enabled"
WINDOW = "spark.rapids.sql.stageFusion.maxInFlight"
QUERIES = ["q1", "q3_bench", "q3_pushed", "q1_parquet", "q3_parquet",
           "repartition"]
Q3_SALES = 8000
Q3_PARTS = {"store_sales": 4, "item": 2, "date_dim": 2}


def _nodes(plan):
    out = [plan]
    for c in plan.children:
        out += _nodes(c)
    return out


def stage_counts(plan):
    """Per fused stage, from the root down: ``fusedOps`` of the stage,
    ``dispatchCount`` summed over the stage node and its constituents,
    and the ``numOutputBatches`` of each constituent below a sink
    aggregate (the JAX package records none for the sink itself)."""
    out = []
    for p in _nodes(plan):
        ops = getattr(p, "fused_ops", None)
        if not ops:
            continue
        dispatch = sum(o.metrics.snapshot().get("dispatchCount", 0)
                       for o in [p] + list(ops))
        chain = ops if p.sink_agg is None else ops[:-1]
        out.append((p.metrics.snapshot()["fusedOps"], dispatch,
                    tuple(o.metrics.snapshot().get("numOutputBatches", 0)
                          for o in chain)))
    return out


def _sales(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    return [("item", "long", rng.integers(1, 300, n)),
            ("price", "dec72", rng.integers(100, 100_000, n))]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """q1's lineitem (6,000 rows in 3 files of 2 row groups: one scan
    partition of 6 units) and q3's tables (store_sales in 4 files, the
    dimensions in one each), written as Parquet."""
    base = str(tmp_path_factory.mktemp("fused"))
    q1_dir = os.path.join(base, "lineitem")
    os.makedirs(q1_dir)
    tbl = host_batch_to_arrow(host_batch_from_numpy(
        lineitem_fields(), lineitem_arrays(6000)))
    for i in range(3):
        pq.write_table(tbl.slice(i * 2000, 2000),
                       os.path.join(q1_dir, f"part-{i:05d}.parquet"),
                       row_group_size=1000)
    tables = q3_tables(Q3_SALES)
    s = TorchSparkSession(device="cpu")
    q3_views = {}
    for name, parts in (("item", 1), ("date_dim", 1), ("store_sales", 4)):
        q3_views[name] = os.path.join(base, name)
        s.createDataFrame(_tq3_batch(tables[name]), num_partitions=parts) \
            .write.mode("overwrite").parquet(q3_views[name])
    return q1_dir, q3_views, tables


def _frames(session, pkg, files):
    """``{query: DataFrame}`` of every query over one session."""
    q1_dir, q3_views, tables = files
    batch = _jax_batch if pkg == "jax" else _torch_batch
    q3_batch = _jq3_batch if pkg == "jax" else _tq3_batch
    session.createDataFrame(batch(_LINEITEM, _lineitem_arrays()),
                            num_partitions=N_PARTS) \
        .createOrReplaceTempView("t")
    for name, cols in tables.items():
        session.createDataFrame(q3_batch(cols),
                                num_partitions=Q3_PARTS[name]) \
            .createOrReplaceTempView(name)
    session.read.parquet(q1_dir).createOrReplaceTempView("lineitem")
    for name, path in q3_views.items():
        session.read.parquet(path).createOrReplaceTempView(f"pq_{name}")
    q3_pq = Q3_BENCH
    for name in q3_views:
        q3_pq = q3_pq.replace(f" {name}", f" pq_{name}")
    f = JF if pkg == "jax" else PF
    sales = session.createDataFrame(q3_batch(_sales()), num_partitions=3)
    return {"q1": session.sql(_q1_sql()),
            "q3_bench": session.sql(Q3_BENCH),
            "q3_pushed": session.sql(Q3_PUSHED),
            "q1_parquet": session.sql(Q1),
            "q3_parquet": session.sql(q3_pq),
            "repartition": sales.repartition(4, "item").groupBy("item")
            .agg(f.sum("price").alias("s"), f.count("*").alias("c"))}


@pytest.fixture(scope="module")
def runs(files):
    """``{(query, fused): (jax rows, jax plan, port rows, port plan)}``."""
    out = {}
    for fused in (True, False):
        conf = dict(CONF, **{FUSION: str(fused).lower()})
        jax_s = TpuSparkSession(dict(conf, **JAX_CONF))
        port = TorchSparkSession(dict(conf), device="cpu")
        try:
            jdfs = _frames(jax_s, "jax", files)
            pdfs = _frames(port, "torch", files)
            for q in QUERIES:
                jax_s.start_capture()
                want = [tuple(r) for r in jdfs[q].collect()]
                (jplan,) = jax_s.get_captured_plans()
                got = [tuple(r) for r in pdfs[q].collect()]
                out[(q, fused)] = (want, jplan, got, port.last_plan)
        finally:
            jax_s.stop()
    return out


@pytest.mark.parametrize("query", QUERIES)
def test_rows_identical_to_jax_package_with_fusion_on(runs, query):
    want, _jplan, got, _plan = runs[(query, True)]
    assert len(want) >= 1
    if query == "repartition":
        want, got = sorted(want), sorted(got)
    assert got == want


@pytest.mark.parametrize("query", QUERIES)
def test_fused_stages_match_jax_package(runs, query):
    """The same stages, grouped the same way, with the same sink, and the
    same fusedOps, dispatchCount and per-operator batch counts."""
    _want, jplan, _got, plan = runs[(query, True)]
    assert fused_shape(plan) == fused_shape(jplan)
    assert stage_counts(plan) == stage_counts(jplan)
    assert dispatches(plan_metrics(plan)) == \
        dispatches(registry_snapshot([jplan])["metrics"])


@pytest.mark.parametrize("query", QUERIES)
def test_fusion_off_gives_unfused_plans_and_the_same_rows(runs, query):
    want, jplan, got, plan = runs[(query, False)]
    fused_rows = runs[(query, True)][2]
    if query == "repartition":
        want, got, fused_rows = sorted(want), sorted(got), sorted(fused_rows)
    assert got == want == fused_rows
    assert not any(isinstance(k, tuple) for k in fused_shape(plan))
    assert fused_shape(plan) == fused_shape(jplan)


def test_which_queries_fuse(runs):
    """q1 (memory and Parquet) and q3's bench text fuse the filter into
    the partial aggregate; q3 pushed fuses each build side's filter and
    project; the repartition query has no chain to fuse."""
    stage = ("TorchFusedStageExec",
             ("TorchFilterExec", "TorchHashAggregateExec"),
             "TorchHashAggregateExec")
    build = ("TorchFusedStageExec", ("TorchFilterExec", "TorchProjectExec"),
             None)
    for q, want in (("q1", [stage]), ("q1_parquet", [stage]),
                    ("q3_bench", [stage]), ("q3_parquet", [stage]),
                    ("q3_pushed", [build, build]), ("repartition", [])):
        shape = fused_shape(runs[(q, True)][3])
        assert [k for k in shape if isinstance(k, tuple)] == want, q
    # q1's stage sits straight over the row-to-columnar upload
    shape = fused_shape(runs[("q1", True)][3])
    assert shape[shape.index(stage) + 1] == "TorchRowToColumnarExec"
    plan = runs[("q1", True)][3]
    assert "TorchFusedStage [TorchFilter+TorchHashAggregate]" in \
        plan.tree_string()


def test_constituent_row_counts(runs):
    """The filter inside q1's stage counts the rows it keeps (from the
    stage program's own count), the sink aggregate its groups."""
    arrays = _lineitem_arrays()
    cutoff = (np.datetime64("1998-09-02")
              - np.datetime64("1970-01-01")).astype(int)
    plan = runs[("q1", True)][3]
    (stage,) = [p for p in _nodes(plan) if getattr(p, "fused_ops", None)]
    filt, agg = stage.fused_ops
    assert filt.metrics.value("numOutputRows") == int(
        (arrays[6] <= cutoff).sum())
    assert agg.metrics.value("numOutputBatches") == N_PARTS
    assert agg.metrics.value("numOutputRows") == \
        stage.metrics.value("numOutputRows")


def test_q1_parquet_merges_each_partitions_partial_results(runs):
    """Six row groups in one scan partition: six update programs, then
    one merge of their partial results (the JAX package's merge_partial),
    so the partial aggregate yields one batch."""
    plan = runs[("q1_parquet", True)][3]
    (stage,) = [p for p in _nodes(plan) if getattr(p, "fused_ops", None)]
    agg = stage.sink_agg
    assert agg.metrics.value("dispatchCount") == 7
    assert agg.metrics.value("kernelDispatchCount.groupbyHash") == 6
    assert agg.metrics.value("numOutputBatches") == 1


@pytest.mark.parametrize("window", ["1", "2", "4"])
def test_max_in_flight_gives_the_same_rows(files, window):
    port = TorchSparkSession({WINDOW: window}, device="cpu")
    dfs = _frames(port, "torch", files)
    base = TorchSparkSession({FUSION: "false"}, device="cpu")
    want = [tuple(r) for r in _frames(base, "torch", files)["q3_pushed"]
            .collect()]
    assert [tuple(r) for r in dfs["q3_pushed"].collect()] == want


def _string_batch(words, n=200):
    rng = np.random.default_rng(5)
    return host_batch_from_numpy(
        [("s", PT.StringT), ("v", PT.LongT)],
        [np.array(words, dtype=object)[rng.integers(0, len(words), n)],
         rng.integers(0, 100, n)])


def test_stage_cache_keys_on_input_shapes():
    """Two batches that differ only in a string column's char cap (8 and
    24 bytes) run the same stage through two cache entries; another
    batch of the first shape hits."""
    F.STAGE_CACHE.clear()
    port = TorchSparkSession({}, device="cpu")
    seen = []
    for words in (["a", "bb", "ccc"], ["a", "bb", "c" * 20],
                  ["dd", "e", "f"]):
        df = port.createDataFrame(_string_batch(words), num_partitions=1) \
            .filter(PF.col("v") > 10).select(PF.col("s"), PF.col("v"))
        df.collect()
        (stage,) = [p for p in _nodes(port.last_plan)
                    if getattr(p, "fused_ops", None)]
        m = stage.metrics.snapshot()
        seen.append((m.get("compileCacheMisses", 0),
                     m.get("compileCacheHits", 0)))
    assert seen == [(1, 0), (1, 0), (0, 1)]
    assert len(F.STAGE_CACHE) == 2


def test_numeric_literals_are_inputs_string_literals_are_keys():
    """``v > 10`` and ``v > 50`` share one stage program (the literal is
    an input tensor); ``s = 'a'`` and ``s = 'bb'`` key two."""
    F.STAGE_CACHE.clear()
    misses = F.STAGE_CACHE.stats()["misses"]
    port = TorchSparkSession({}, device="cpu")
    batch = _string_batch(["a", "bb", "ccc"])
    rows = {}
    for cond in (PF.col("v") > 10, PF.col("v") > 50,
                 PF.col("s") == "a", PF.col("s") == "bb"):
        df = port.createDataFrame(batch, num_partitions=1).filter(cond) \
            .select(PF.col("s"), PF.col("v"))
        rows[str(cond)] = sorted(tuple(r) for r in df.collect())
    assert F.STAGE_CACHE.stats()["misses"] - misses == 3
    assert len(F.STAGE_CACHE) == 3
    base = TorchSparkSession({FUSION: "false"}, device="cpu")
    for cond in (PF.col("v") > 10, PF.col("v") > 50,
                 PF.col("s") == "a", PF.col("s") == "bb"):
        df = base.createDataFrame(batch).filter(cond) \
            .select(PF.col("s"), PF.col("v"))
        assert sorted(tuple(r) for r in df.collect()) == rows[str(cond)]


def test_programs_of_one_structure_keep_their_own_literals():
    """``sum(v + 1), sum(v + 1)`` and ``sum(v + 1), sum(v + 2)`` have one
    program structure, but the first evaluates its shared source once:
    the second must get its own program, not reuse that one."""
    F.STAGE_CACHE.clear()
    batch = _string_batch(["a", "bb", "ccc"])
    keys, vals = batch.columns[0].data, batch.columns[1].data
    fused = TorchSparkSession({}, device="cpu")
    plain = TorchSparkSession({FUSION: "false"}, device="cpu")
    for a, b in ((1, 1), (1, 2)):
        def rows(s):
            return sorted(tuple(r) for r in s.createDataFrame(
                batch, num_partitions=1).filter(PF.col("v") > 10)
                .groupBy("s").agg(PF.sum(PF.col("v") + a).alias("x"),
                                  PF.sum(PF.col("v") + b).alias("y"))
                .collect())
        got = rows(fused)
        assert got == rows(plain)
        for key, x, y in got:
            n = int(((keys == key) & (vals > 10)).sum())
            assert y - x == (b - a) * n
    assert len(F.STAGE_CACHE) == 2


class _Released:
    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


def test_jit_cache_evicts_oldest_and_releases_it():
    cache = JitCache("test_lru", capacity=2)
    vals = [_Released() for _ in range(3)]
    for i, v in enumerate(vals):
        got, miss = cache.get_or_build(i, lambda v=v: v)
        assert got is v and miss
    assert vals[0].released and not vals[1].released
    got, miss = cache.get_or_build(1, lambda: pytest.fail("rebuilt"))
    assert got is vals[1] and not miss
    assert cache.stats() == {"size": 2, "capacity": 2, "hits": 1,
                             "misses": 3, "evictions": 1, "contention": 0}
    cache.clear()
    assert vals[1].released and vals[2].released and len(cache) == 0


def test_jit_cache_builds_a_key_once_under_concurrency():
    import threading
    import time
    cache = JitCache("test_single_flight")
    builds = []

    def build():
        builds.append(1)
        time.sleep(0.05)
        return object()
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        cache.get_or_build("k", build)[0])) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(results) == 8
    assert all(r is results[0] for r in results)
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] \
        + cache.stats()["contention"] >= 7


def test_launches_recorded_in_a_capture_count_at_each_replay():
    KR.reset_launches()
    with KR.recording_launches() as names:
        KR.count_launch("groupbyHash")
    assert names == ["groupbyHash"] and KR.LAUNCHES["groupbyHash"] == 0
    for _ in range(3):
        KR.count_replay(names)
    KR.count_launch("groupbyHash")
    assert KR.LAUNCHES["groupbyHash"] == 4
    KR.reset_launches()


def test_input_signature_holds_shapes_dtypes_and_aliasing():
    a = torch.zeros(64, dtype=torch.int64)
    b = torch.zeros(64, dtype=torch.int64)
    c = torch.zeros(64, dtype=torch.int32)
    assert F.input_signature([a, b]) != F.input_signature([a, a])
    assert F.input_signature([a, b]) != F.input_signature([a, c])
    assert F.input_signature([a, b]) == F.input_signature([b, a])
    assert F.input_signature([a]) != F.input_signature(
        [torch.zeros(80, dtype=torch.int64)])
