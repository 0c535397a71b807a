"""The runtime around the kernels, held against the JAX package on the
CPU: the plan rewrite (planner-inserted exchanges coalesced to one
partition on one card, a user's ``repartition`` keeping its count, the
batch coalescer over an exchange), the upload ring of the row-to-columnar
transition at every ``maxInFlight`` depth, and the operator metrics.

``plan_shape`` puts a plan of either package in one form: the node kinds
from the root down (a fused stage's operators in place of the stage,
``Tpu`` read as ``Torch``) and each shuffle exchange's partitioning and
count. ``test_torch_q3.py`` and ``test_torch_parquet.py`` import it;
``fused_shape`` keeps each fused stage whole (``test_torch_fused.py``)."""

import os
import sys
import threading

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import Q1, lineitem_arrays, lineitem_fields
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_q1 import (CONF, N_PARTS, _LINEITEM, _jax_batch,
                           _lineitem_arrays, _q1_sql, _torch_batch)

from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (TorchRowToColumnarExec,
                                              device_channel)
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.metrics import Metric, plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

JAX_CONF = {"spark.rapids.sql.enabled": "true"}
DEPTH = "spark.rapids.sql.format.parquet.deviceDecode.maxInFlight"
DISPATCH = ("kernelDispatchCount.murmur3", "kernelDispatchCount.groupbyHash",
            "kernelDispatchCount.decodeFused")


def plan_shape(plan):
    """(node kinds, [(partitioning, partitions)] of the shuffle
    exchanges) of an executed plan of either package."""
    kinds, exchanges = [], []

    def walk(p):
        ops = getattr(p, "fused_ops", None)
        if ops:
            kinds.extend(type(o).__name__ for o in reversed(ops))
        else:
            kinds.append(type(p).__name__)
        if type(p).__name__.endswith("ShuffleExchangeExec"):
            exchanges.append((type(p.partitioning).__name__,
                              p.partitioning.num_partitions))
        for c in p.children:
            walk(c)
    walk(plan)
    return [k.replace("Tpu", "Torch", 1) for k in kinds], exchanges


def fused_shape(plan):
    """The node kinds of a plan of either package from the root down, as
    ``plan_shape`` reads them but with each fused stage kept whole:
    ``(kind, (constituent kinds...), sink kind or None)``."""
    def name(o):
        return type(o).__name__.replace("Tpu", "Torch", 1)
    out = []

    def walk(p):
        ops = getattr(p, "fused_ops", None)
        if ops:
            sink = p.sink_agg
            out.append((name(p), tuple(name(o) for o in ops),
                        None if sink is None else name(sink)))
        else:
            out.append(name(p))
        for c in p.children:
            walk(c)
    walk(plan)
    return out


def dispatches(metrics: dict) -> dict:
    """The kernel dispatch counts of a summed metric snapshot."""
    return {k: metrics.get(k, 0) for k in DISPATCH}


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "torch-upload-prefetch" and t.is_alive()]


# ---------------------------------------------------------------------------
# q1 from memory: the plan, the exchange counts and the dispatches

def test_q1_plan_and_dispatches_match_jax_package():
    arrays = _lineitem_arrays()
    jax_s = TpuSparkSession(dict(CONF, **JAX_CONF))
    try:
        jax_s.createDataFrame(_jax_batch(_LINEITEM, arrays),
                              num_partitions=N_PARTS) \
            .createOrReplaceTempView("t")
        df = jax_s.sql(_q1_sql())
        jax_s.start_capture()
        want = [tuple(r) for r in df.collect()]
        (jplan,) = jax_s.get_captured_plans()
        jsnap = registry_snapshot([jplan])["metrics"]
    finally:
        jax_s.stop()
    port = TorchSparkSession(dict(CONF), device="cpu")
    port.createDataFrame(_torch_batch(_LINEITEM, arrays),
                         num_partitions=N_PARTS).createOrReplaceTempView("t")
    got = [tuple(r) for r in port.sql(_q1_sql()).collect()]
    assert got == want
    kinds, exchanges = plan_shape(port.last_plan)
    assert (kinds, exchanges) == plan_shape(jplan)
    # spark.sql.shuffle.partitions is 4; one card coalesces both exchanges
    assert exchanges == [("RangePartitioning", 1), ("HashPartitioning", 1)]
    got_d = dispatches(plan_metrics(port.last_plan))
    assert got_d == dispatches(jsnap)
    assert got_d["kernelDispatchCount.murmur3"] == 0
    assert got_d["kernelDispatchCount.groupbyHash"] == N_PARTS


def test_device_partitions_key_overrides_auto():
    """``spark.rapids.sql.shuffle.devicePartitions`` = 2 keeps two
    partitions where auto coalesces to one; the rows do not change."""
    arrays = _lineitem_arrays()
    runs = {}
    for key in ("0", "2"):
        port = TorchSparkSession(dict(
            CONF, **{"spark.rapids.sql.shuffle.devicePartitions": key}),
            device="cpu")
        port.createDataFrame(_torch_batch(_LINEITEM, arrays),
                             num_partitions=N_PARTS) \
            .createOrReplaceTempView("t")
        rows = [tuple(r) for r in port.sql(_q1_sql()).collect()]
        runs[key] = (rows, plan_shape(port.last_plan)[1],
                     dispatches(plan_metrics(port.last_plan)))
    assert runs["0"][0] == runs["2"][0]
    assert runs["2"][1] == [("RangePartitioning", 2),
                            ("HashPartitioning", 2)]
    assert runs["2"][2]["kernelDispatchCount.murmur3"] == N_PARTS


# ---------------------------------------------------------------------------
# a user's repartition keeps its count

def _sales(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    return [("item", "long", rng.integers(1, 300, n)),
            ("price", "dec72", rng.integers(100, 100_000, n))]


def _sales_frames(jax_s, port, parts=3):
    from test_torch_q3 import _jax_batch as jq3, _torch_batch as tq3
    cols = _sales()
    return (jax_s.createDataFrame(jq3(cols), num_partitions=parts),
            port.createDataFrame(tq3(cols), num_partitions=parts))


def _partition_rows(plan):
    return [sorted(tuple(r) for b in thunk() for r in b.rows())
            for thunk in plan.partitions()]


def test_repartition_rows_and_partitions_match_jax_package():
    jax_s = TpuSparkSession(dict(JAX_CONF))
    port = TorchSparkSession({}, device="cpu")
    try:
        jdf, pdf = _sales_frames(jax_s, port)
        # the exchange alone: each output partition holds the JAX
        # package's rows
        jparts = _partition_rows(jax_s.plan_physical(
            jdf.repartition(4, "item").plan))
        pparts = _partition_rows(port.plan_physical(
            pdf.repartition(4, "item").plan))
        assert pparts == jparts
        assert len(pparts) == 4 and all(pparts)
        # then the aggregate over it
        jq = jdf.repartition(4, "item").groupBy("item").agg(
            JF.sum("price").alias("s"), JF.count("*").alias("c"))
        jax_s.start_capture()
        want = sorted(tuple(r) for r in jq.collect())
        (jplan,) = jax_s.get_captured_plans()
        jsnap = registry_snapshot([jplan])["metrics"]
    finally:
        jax_s.stop()
    pq_ = pdf.repartition(4, "item").groupBy("item").agg(
        PF.sum("price").alias("s"), PF.count("*").alias("c"))
    got = sorted(tuple(r) for r in pq_.collect())
    assert got == want and len(got) == 299
    kinds, exchanges = plan_shape(port.last_plan)
    assert (kinds, exchanges) == plan_shape(jplan)
    assert exchanges == [("HashPartitioning", 1), ("HashPartitioning", 4)]
    got_d = dispatches(plan_metrics(port.last_plan))
    assert got_d == dispatches(jsnap)
    # one hash of the partition ids per input batch
    assert got_d["kernelDispatchCount.murmur3"] == 3


def test_filter_over_exchange_coalesces_batches():
    """A filter straight over a device exchange reads it through a
    TorchCoalesceBatchesExec, as the JAX package's plan does: the
    exchange's per-input pieces reach the filter as one batch a
    partition."""
    jax_s = TpuSparkSession(dict(JAX_CONF))
    port = TorchSparkSession({}, device="cpu")
    try:
        jdf, pdf = _sales_frames(jax_s, port)
        jq = jdf.repartition(4, "item").filter(JF.col("item") > 100)
        jax_s.start_capture()
        want = sorted(tuple(r) for r in jq.collect())
        (jplan,) = jax_s.get_captured_plans()
    finally:
        jax_s.stop()
    got = sorted(tuple(r) for r in pdf.repartition(4, "item").filter(
        PF.col("item") > 100).collect())
    assert got == want
    kinds, _ex = plan_shape(port.last_plan)
    assert kinds == plan_shape(jplan)[0]
    assert kinds[:3] == ["TorchColumnarToRowExec", "TorchFilterExec",
                         "TorchCoalesceBatchesExec"]
    coalesce = port.last_plan.children[0].children[0]
    assert coalesce.metrics.value("numOutputBatches") == 4
    assert coalesce.metrics.value("numOutputRows") == 6000


def _port_ops(plan, kind):
    """The plan's operators of ``kind``, fused-stage constituents
    included (as the JAX side is read below)."""
    return [o for p in _nodes(plan)
            for o in getattr(p, "fused_ops", None) or [p]
            if type(o).__name__ == kind]


def test_operator_output_counts_match_jax_package():
    """Every operator counts the rows and batches it yields. Where the
    JAX package's operator records the same metric (the R2C's rows and
    batches, the filter's batches, the root's rows) the counts are
    equal; the filter's and the final aggregate's rows equal the rows of
    the JAX package's own answers, and the partial aggregate's the
    groups of each input partition."""
    jax_s = TpuSparkSession(dict(JAX_CONF))
    port = TorchSparkSession({}, device="cpu")
    try:
        jdf, pdf = _sales_frames(jax_s, port)
        n_filtered = len(jdf.filter(JF.col("item") > 100).collect())
        jq = jdf.filter(JF.col("item") > 100).groupBy("item").agg(
            JF.sum("price").alias("s"), JF.count("*").alias("c"))
        jax_s.start_capture()
        want = sorted(tuple(r) for r in jq.collect())
        (jplan,) = jax_s.get_captured_plans()
    finally:
        jax_s.stop()
    got = sorted(tuple(r) for r in pdf.filter(PF.col("item") > 100)
                 .groupBy("item").agg(PF.sum("price").alias("s"),
                                      PF.count("*").alias("c")).collect())
    assert got == want
    jops = {}
    for p in _nodes(jplan):
        for o in getattr(p, "fused_ops", None) or [p]:
            if hasattr(o, "metrics"):
                jops.setdefault(type(o).__name__, []).append(
                    o.metrics.snapshot())
    plan = port.last_plan
    (filt,) = _port_ops(plan, "TorchFilterExec")
    (r2c,) = _port_ops(plan, "TorchRowToColumnarExec")
    final, partial = _port_ops(plan, "TorchHashAggregateExec")
    (exchange,) = _port_ops(plan, "TorchShuffleExchangeExec")
    (jfilt,) = jops["TpuFilterExec"]
    (jr2c,) = jops["TpuRowToColumnarExec"]
    (jc2r,) = jops["TpuColumnarToRowExec"]
    for k in ("numOutputRows", "numOutputBatches"):
        assert r2c.metrics.value(k) == jr2c[k]
    assert filt.metrics.value("numOutputBatches") == \
        jfilt["numOutputBatches"] == 3
    assert filt.metrics.value("numOutputRows") == n_filtered
    assert final.metrics.value("numOutputRows") == \
        jc2r["numOutputRows"] == len(want)
    items = _sales()[0][2]
    per_part = sum(len(np.unique(s[s > 100]))
                   for s in np.split(items, 3))
    assert partial.metrics.value("numOutputRows") == per_part
    assert partial.metrics.value("numOutputBatches") == 3
    assert exchange.metrics.value("numOutputRows") == per_part
    assert plan.metrics.value("numOutputRows") == len(want)


def test_metric_reads_device_counts_back_when_read():
    m = Metric("numOutputRows")
    m.add(3)
    m.add(torch.tensor([True, False, True]).sum())
    m.add(torch.tensor(5))
    assert m.value == 10
    m.add(1)
    assert m.value == 11


def test_repartition_without_columns_is_not_ported():
    """``repartition(n)`` without columns was not ported before; it now
    deals the rows round-robin over its n partitions (user-specified, so
    the count stays) and loses none."""
    port = TorchSparkSession({}, device="cpu")
    df = port.createDataFrame(host_batch_from_numpy(
        [("x", PT.LongT)], [np.arange(10)]), num_partitions=2)
    rows = sorted(r[0] for r in df.repartition(3).collect())
    assert rows == list(range(10))
    (_kinds, exchanges) = plan_shape(port.last_plan)
    assert exchanges == [("RoundRobinPartitioning", 3)]


# ---------------------------------------------------------------------------
# the upload ring at every depth

@pytest.fixture(scope="module")
def q1_parquet(tmp_path_factory):
    """q1's lineitem, 6,000 rows in 3 files of 2 row groups: one scan
    partition of 6 upload units, so the ring runs several units ahead."""
    base = str(tmp_path_factory.mktemp("q1ring"))
    arrays = lineitem_arrays(6000)
    tbl = host_batch_to_arrow(host_batch_from_numpy(lineitem_fields(),
                                                    arrays))
    for i in range(3):
        pq.write_table(tbl.slice(i * 2000, 2000),
                       os.path.join(base, f"part-{i:05d}.parquet"),
                       row_group_size=1000)
    return base


def _r2c_metrics(plan, prefix):
    out = {}
    for p in _nodes(plan):
        if type(p).__name__ == prefix + "RowToColumnarExec":
            for k, v in p.metrics.snapshot().items():
                out[k] = out.get(k, 0) + v
    return out


def _nodes(plan):
    out = [plan]
    for c in plan.children:
        out += _nodes(c)
    return out


@pytest.fixture(scope="module")
def ring_runs(q1_parquet):
    """q1 from Parquet and from memory at maxInFlight 0, 1 and 2 through
    both packages: rows and the row-to-columnar metrics."""
    arrays = _lineitem_arrays()
    out = {}
    for depth in (0, 1, 2):
        conf = dict(CONF, **{DEPTH: str(depth)})
        jax_s = TpuSparkSession(dict(conf, **JAX_CONF))
        port = TorchSparkSession(dict(conf), device="cpu")
        try:
            for s, batch in ((jax_s, _jax_batch(_LINEITEM, arrays)),
                             (port, _torch_batch(_LINEITEM, arrays))):
                s.createDataFrame(batch, num_partitions=N_PARTS) \
                    .createOrReplaceTempView("mem")
                s.read.parquet(q1_parquet).createOrReplaceTempView("pq")
            for src in ("mem", "pq"):
                sql = Q1.replace("FROM lineitem", f"FROM {src}")
                df = jax_s.sql(sql)
                jax_s.start_capture()
                want = [tuple(r) for r in df.collect()]
                (jplan,) = jax_s.get_captured_plans()
                got = [tuple(r) for r in port.sql(sql).collect()]
                out[(src, depth)] = (want, got,
                                     _r2c_metrics(jplan, "Tpu"),
                                     _r2c_metrics(port.last_plan, "Torch"))
        finally:
            jax_s.stop()
    return out


@pytest.mark.parametrize("src", ["mem", "pq"])
@pytest.mark.parametrize("depth", [0, 1, 2])
def test_ring_depth_rows_and_metrics_match_jax_package(ring_runs, src,
                                                       depth):
    want, got, jm, pm = ring_runs[(src, depth)]
    assert got == want
    assert got == ring_runs[(src, 0)][1]
    for k in ("numOutputRows", "numOutputBatches", "uploadAheadBatches"):
        assert pm.get(k, 0) == jm.get(k, 0), (k, pm, jm)
    units = 6 if src == "pq" else N_PARTS
    assert pm["numOutputBatches"] == units
    assert pm.get("uploadAheadBatches", 0) == (0 if depth == 0 else units)
    assert pm["packBatchTime"] > 0 and pm["copyToDeviceTime"] > 0
    assert ("scanPrefetchTime" in pm) == (depth > 0)


def test_ring_with_key_unset_runs_only_over_a_file_scan_of_units(
        ring_runs, q1_parquet):
    """Left unset, the ring runs at its default depth over the Parquet
    scan's partition of 6 units and not over partitions already in host
    memory; the rows do not change."""
    arrays = _lineitem_arrays()
    port = TorchSparkSession(dict(CONF), device="cpu")
    port.createDataFrame(_torch_batch(_LINEITEM, arrays),
                         num_partitions=N_PARTS).createOrReplaceTempView("mem")
    port.read.parquet(q1_parquet).createOrReplaceTempView("pq")
    for src, ahead in (("mem", 0), ("pq", 6)):
        got = [tuple(r) for r in port.sql(
            Q1.replace("FROM lineitem", f"FROM {src}")).collect()]
        assert got == ring_runs[(src, 0)][1]
        pm = _r2c_metrics(port.last_plan, "Torch")
        assert pm.get("uploadAheadBatches", 0) == ahead
        assert ("scanPrefetchTime" in pm) == (ahead > 0)
        assert "pinnedStreamCopies" not in pm  # no pinned memory here


class _Units:
    """A file scan stand-in: its partitions' unit counts."""

    children, output = [], []

    def __init__(self, units):
        self.units = units

    def units_per_partition(self):
        return self.units


@pytest.mark.parametrize("setting, want", [
    (None, [0, 2, 0]), ("2", [2, 2, 2]), ("0", [0, 0, 0]),
    ("1", [1, 1, 1])])
def test_ring_depth_per_partition(setting, want):
    conf = TorchConf({} if setting is None else {DEPTH: setting})
    r2c = TorchRowToColumnarExec(_Units([1, 4, 0]), conf,
                                 torch.device("cpu"))
    assert r2c.ring_depths(3) == want
    mem = TorchRowToColumnarExec(_Source(1), conf, torch.device("cpu"))
    assert mem.ring_depths(2) == ([0, 0] if setting is None
                                  else [int(setting)] * 2)


class _Source:
    """A host plan node whose one partition yields ``n`` small batches,
    or raises after ``fail_after`` of them; ``closed`` records that its
    generator was closed."""

    def __init__(self, n, fail_after=None):
        self.n, self.fail_after = n, fail_after
        self.closed = False
        self.children = []
        self.output = []

    def partitions(self):
        def run():
            try:
                for i in range(self.n):
                    if i == self.fail_after:
                        raise ValueError("scan failed")
                    yield host_batch_from_numpy(
                        [("x", PT.LongT)], [np.arange(i * 10, i * 10 + 10)])
            finally:
                self.closed = True
        return [run]


def _r2c(src, depth):
    conf = TorchConf({DEPTH: str(depth),
                      "spark.rapids.sql.batchSizeRows": "10"})
    return TorchRowToColumnarExec(src, conf, torch.device("cpu"))


@pytest.mark.parametrize("depth", [0, 2])
def test_producer_error_raises_on_consumer(depth):
    src = _Source(20, fail_after=5)
    gen = _r2c(src, depth).device_partitions()[0]()
    got = []
    with pytest.raises(ValueError, match="scan failed"):
        for b in gen:
            got.append(b.to_host().columns[0].data.tolist())
    # the batches before the failure, less those still in flight
    want = [list(range(i * 10, i * 10 + 10)) for i in range(5)]
    assert got == want[:len(got)] and len(got) >= 5 - depth
    assert src.closed
    assert not _prefetch_threads()


def test_closing_consumer_joins_producer():
    src = _Source(1000)
    gen = _r2c(src, 2).device_partitions()[0]()
    first = next(gen)
    assert first.to_host().columns[0].data.tolist() == list(range(10))
    assert _prefetch_threads()
    gen.close()
    assert not _prefetch_threads()
    assert src.closed


@pytest.mark.parametrize("depth", [1, 3])
def test_ring_keeps_every_row_in_order_under_thread_switches(depth):
    """The producer and the task thread share the ring's slots and the
    operator's metrics; with a switch interval of a microsecond and
    more units than slots, every unit still arrives whole and in order,
    and the counters add up."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        src = _Source(200)
        r2c = _r2c(src, depth)
        got = [b.to_host().columns[0].data.tolist()
               for b in device_channel(r2c)[0]()]
    finally:
        sys.setswitchinterval(old)
    assert got == [list(range(i * 10, i * 10 + 10)) for i in range(200)]
    assert r2c.metrics.value("numOutputRows") == 2000
    assert r2c.metrics.value("uploadAheadBatches") == 200
    assert not _prefetch_threads()
