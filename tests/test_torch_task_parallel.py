"""One device plan's partitions on ``spark.rapids.sql.taskParallelism``
task threads, and the exchanges' concurrent drains, in the port, held
against the JAX package at the same settings on the CPU.

The same seeded inputs go through both packages at 1, 2 and 4 tasks,
with the device exchanges at 4 partitions (so reduce tasks race into one
exchange) and the sources in 3 to 5 partitions. The rows must be equal
at every thread count. At 4 tasks the concurrency guards must hold:
each shuffle exchange materializes once, a broadcast builds once
(``broadcastBuilds``, equal to the JAX package's), the FK hint is sized
once (``fkFastPathJoins``), and every permit and store handle is back
after the collect, also after a cancel mid-drain; a plan whose broadcast
and exchange share one permit (``concurrentGpuTasks=1``) finishes. Over
emulated meshes of 4 and 8 chips the port at 4 tasks gives the JAX
8-device mesh's rows, with each chip's ``dispatchCount`` equal to the
1-task run's. A stage's literal tensors are built once for each device a
batch arrives on.

ROADMAP C4 and C5, two faults of the reference, are mirrored by the
port; a test through both packages holds each.
"""

import math
import threading

import numpy as np
import pytest
import torch

from spark_rapids_tpu.parallel import active_mesh as jactive_mesh
from spark_rapids_tpu.parallel import build_mesh as jbuild_mesh
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import lifecycle as LC
from spark_rapids_tpu_torch import memory as PMEM
from spark_rapids_tpu_torch import resource as PRES
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.exec.fused import DeviceLiterals
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from spark_rapids_tpu import retry as JR
from chip_smoke import counting_materializations, distinct_nodes
from tests.harness import _rows, _sort_key

torch.set_num_threads(2)

CPU = torch.device("cpu")
TASKS = (1, 2, 4)
# device exchanges at 4 partitions, kept apart by adaptive coalescing:
# reduce tasks race into one exchange
BASE = {"spark.rapids.sql.shuffle.devicePartitions": "4",
        "spark.sql.shuffle.partitions": "4",
        "spark.rapids.sql.adaptive.targetPartitionBytes": "1"}
NO_BROADCAST = {"spark.sql.autoBroadcastJoinThreshold": "-1"}


@pytest.fixture(autouse=True)
def _fresh_state():
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()


@pytest.fixture
def materializations():
    """Each shuffle exchange's materializations, by node id."""
    with counting_materializations() as counts:
        yield counts


# ---------------------------------------------------------------------------
# the shapes: (source partitions, seeded data, query) through both packages
# ---------------------------------------------------------------------------

def _fact(n: int = 900, seed: int = 21) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": [int(x) for x in rng.integers(0, 40, n)],
            "v": [int(x) for x in rng.integers(-500, 500, n)],
            "s": ["s%02d" % x for x in rng.integers(0, 25, n)]}


def _dim(n: int = 40) -> dict:
    return {"k2": list(range(n)), "name": ["d%d" % i for i in range(n)]}


def _facts(s, parts: int = 5):
    return s.createDataFrame(_fact(), "k long, v long, s string",
                             num_partitions=parts)


def _dims(s, parts: int = 3):
    return s.createDataFrame(_dim(), "k2 long, name string",
                             num_partitions=parts)


def q_grouped(s, f):
    return _facts(s).groupBy("k").agg(
        f.sum("v").alias("sv"), f.count("v").alias("c"),
        f.min("v").alias("mn"), f.max("s").alias("ms"))


def q_shuffled_join(s, f):
    return (_facts(s).join(_dims(s), f.col("k") == f.col("k2"), "inner")
            .groupBy("name").agg(f.sum("v").alias("sv"),
                                 f.count("*").alias("c")))


def q_broadcast_fk(s, f):
    return (_facts(s).join(_dims(s), f.col("k") == f.col("k2"), "inner")
            .select("k", "v", "name"))


def q_window(s, f):
    w = f.Window.partitionBy("k").orderBy("v", "s")
    return _facts(s).select("k", "v", "s", f.rank().over(w).alias("r"))


def q_order_limit(s, f):
    return _facts(s).orderBy(f.col("v").desc(), "k", "s").limit(25)


def q_union(s, f):
    a = _facts(s, 5).select("k", "v")
    b = s.createDataFrame({"k": list(range(30)),
                           "v": [i * 7 for i in range(30)]},
                          "k long, v long", num_partitions=3)
    return a.union(b).groupBy("k").agg(f.sum("v").alias("sv"))


def q_reused_broadcast(s, f):
    fact, dim = _facts(s, 4), _dims(s, 1)
    cond = f.col("k") == f.col("k2")
    return fact.join(dim, cond, "leftsemi").union(
        fact.join(dim, cond, "leftanti")).select("k", "v")


def q_cached_twice(s, f):
    c = _facts(s, 4).cache()
    return c.filter(f.col("v") > 0).union(c.filter(f.col("v") <= 0)) \
        .groupBy("k").agg(f.count("*").alias("c"), f.sum("v").alias("sv"))


# (name, query, extra conf, ordered)
SHAPES = [
    ("grouped_aggregate", q_grouped, {}, False),
    ("shuffled_join", q_shuffled_join, NO_BROADCAST, False),
    ("broadcast_fk_join", q_broadcast_fk, {}, False),
    ("window", q_window, {}, False),
    ("order_by_limit", q_order_limit, {}, True),
    ("union", q_union, {}, False),
    ("reused_broadcast", q_reused_broadcast, {}, False),
    ("cached_twice", q_cached_twice, {}, False),
]


def _conf(tasks: int, extra=None) -> dict:
    return dict(BASE, **(extra or {}),
                **{"spark.rapids.sql.taskParallelism": str(tasks)})


def _builds(plans) -> int:
    return sum(n.metrics.value("broadcastBuilds") for p in plans
               for n in distinct_nodes(p)
               if "BroadcastExchange" in type(n).__name__)


def _distinct_metrics(plan) -> dict:
    """Every metric of an executed plan summed over its distinct nodes."""
    out: dict = {}
    for n in distinct_nodes(plan):
        m = getattr(n, "metrics", None)
        for k, v in (m.snapshot() if m is not None else {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _port(q, conf):
    """``(rows, plans, session conf)`` of ``q`` on a port session on the
    CPU; the permits and store handles are checked back after it."""
    s = TorchSparkSession(dict(conf), device="cpu")
    try:
        s.start_capture()
        rows = _rows(q(s, PF)._execute().to_pydict())
        plans = s.get_captured_plans()
        _assert_released(s)
        return rows, plans
    finally:
        s.stop()


def _assert_released(s) -> None:
    assert PRES.get_semaphore(s.conf_obj).in_use == 0, "a permit leaked"
    assert PMEM.get_device_store(s.conf_obj).stats()["liveHandles"] == 0, \
        "a store handle outlived the collect"


def _jax(q, conf, mesh=None):
    s = TpuSparkSession(dict(conf))
    try:
        s.start_capture()
        if mesh is not None:
            with jactive_mesh(mesh):
                rows = _rows(q(s, JF)._execute().to_pydict())
        else:
            rows = _rows(q(s, JF)._execute().to_pydict())
        return rows, s.get_captured_plans()
    finally:
        s.stop()


def _norm(rows, ordered: bool):
    return rows if ordered else sorted(rows, key=_sort_key)


@pytest.mark.parametrize("name,q,extra,ordered", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_rows_equal_the_jax_package_at_each_task_count(name, q, extra,
                                                       ordered):
    """The port at 1, 2 and 4 tasks against the JAX package at the same
    setting: the rows are equal, and do not depend on the thread count."""
    first = None
    for tasks in TASKS:
        got, _plans = _port(q, _conf(tasks, extra))
        want, _jp = _jax(q, _conf(tasks, extra))
        assert _norm(got, ordered) == _norm(want, ordered), \
            f"{name} at {tasks} tasks"
        if first is None:
            first = got
        assert _norm(got, ordered) == _norm(first, ordered), \
            f"{name}: rows at {tasks} tasks differ from 1 task"


# adaptive execution materializes most exchanges on the collecting thread
# (its statistics are read before the stream partitions run); without it
# every reduce task races into its exchange
ADAPTIVE = {"adaptive": {},
            "adaptive_off": {"spark.sql.adaptive.enabled": "false"}}


@pytest.mark.parametrize("mode", list(ADAPTIVE))
@pytest.mark.parametrize("name,q,extra,ordered", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_guards_hold_at_four_tasks(name, q, extra, ordered, mode,
                                   materializations):
    """At 4 tasks: every shuffle exchange materializes once, a broadcast
    builds once (as many builds as the JAX package), the FK hint is
    counted once, and the plan really ran on task threads."""
    extra = dict(extra, **ADAPTIVE[mode])
    seen_threads = set()
    inner = TorchShuffleExchangeExec._pull_split

    def recording(self, thunks, split_one):
        def wrap(t):
            def run():
                seen_threads.add(threading.current_thread().name)
                return t()
            return run
        return inner(self, [wrap(t) for t in thunks], split_one)

    TorchShuffleExchangeExec._pull_split = recording
    try:
        got, plans = _port(q, _conf(4, extra))
    finally:
        TorchShuffleExchangeExec._pull_split = inner
    want, jplans = _jax(q, _conf(4, extra))
    assert _norm(got, ordered) == _norm(want, ordered)
    exchanges = [n for p in plans for n in distinct_nodes(p)
                 if isinstance(n, TorchShuffleExchangeExec)]
    if name not in ("broadcast_fk_join", "reused_broadcast"):
        assert exchanges, f"{name}: no shuffle exchange ran"
    for e in exchanges:
        if e._cache is not None or id(e) in materializations:
            assert materializations.get(id(e)) == 1, \
                f"{name}: {e.simple_string()} materialized " \
                f"{materializations.get(id(e))} times"
    assert _builds(plans) == _builds(jplans)
    if name in ("broadcast_fk_join", "reused_broadcast"):
        assert _builds(plans) == 1
        # the plan's own metrics walk a reused subtree once
        assert sum(plan_metrics(p).get("broadcastBuilds", 0)
                   for p in plans) == 1
        for p in plans:
            assert plan_metrics(p) == _distinct_metrics(p)
    if name == "broadcast_fk_join":
        joins = [n for p in plans for n in distinct_nodes(p)
                 if hasattr(n, "route_counts")]
        assert sum(j.route_counts["fkFastPathJoins"] for j in joins) == 1
        assert sum(plan_metrics(p).get("fkFastPathJoins", 0)
                   for p in plans) == 1
    if name == "grouped_aggregate":
        # the source's 5 partitions drained on pull threads
        assert any(t.startswith("torch-shuffle") for t in seen_threads), \
            seen_threads


def test_device_plan_runs_on_task_threads():
    """A device plan's partitions run on ``taskParallelism`` task threads
    (the collecting thread drained them alone before)."""
    names = set()
    from spark_rapids_tpu_torch.exec.base import TorchColumnarToRowExec
    orig = TorchColumnarToRowExec.partitions

    def recording(self):
        def wrap(t):
            def run():
                names.add(threading.current_thread().name)
                yield from t()
            return run
        return [wrap(t) for t in orig(self)]

    TorchColumnarToRowExec.partitions = recording
    try:
        got, plans = _port(q_window, _conf(4))
    finally:
        TorchColumnarToRowExec.partitions = orig
    assert any(n.startswith("torch-task") for n in names), names
    want, _ = _jax(q_window, _conf(4))
    assert sorted(got, key=_sort_key) == sorted(want, key=_sort_key)


def test_cancel_mid_drain_at_four_tasks_releases_everything():
    """An injected cancel at a checkpoint inside the drain stops the
    query on its task threads; every permit and store handle is back."""
    conf = _conf(4, dict(NO_BROADCAST, **{
        "spark.rapids.sql.test.injectOOM": "site:cancel:12"}))
    s = TorchSparkSession(conf, device="cpu")
    try:
        inj = R.get_fault_injector(s.conf_obj)
        with LC.token_scope(LC.CancelToken()):
            with pytest.raises(LC.TorchQueryCancelled) as e:
                q_shuffled_join(s, PF).collect()
        assert e.value.reason == LC.REASON_INJECTED
        assert inj.stats()["cancelsInjected"] == 1
        _assert_released(s)
    finally:
        s.stop()


def test_one_permit_four_tasks_finishes():
    """``concurrentGpuTasks=1`` at 4 tasks over a broadcast join and two
    exchanges: the broadcast takes the permit before its build lock and
    an exchange returns its caller's permit before its lock, so the one
    permit is never held by a thread that waits on a lock another permit
    holder needs. A wrong order deadlocks: the collect runs on a thread
    with its own time limit."""
    conf = _conf(4, {"spark.rapids.sql.concurrentGpuTasks": "1"})

    def q(s, f):
        return (q_broadcast_fk(s, f).groupBy("name")
                .agg(f.sum("v").alias("sv")).orderBy("name"))

    out: dict = {}

    def run():
        try:
            out["rows"] = _port(q, conf)[0]
        except BaseException as e:  # reported on the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "deadlock at concurrentGpuTasks=1"
    assert "error" not in out, out.get("error")
    assert out["rows"] == _jax(q, conf)[0]


def _within(seconds: float, fn):
    """``fn()`` on a thread of its own; fails if it has not ended within
    ``seconds`` (a deadlock), else returns its result or raises its
    error."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # reported on the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no end within {seconds} s: a deadlock"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture
def slow_exchange():
    """Each shuffle exchange's materialization starts 0.3 s late, after
    the caller's permit went back: threads that wait for a permit then
    take it before the exchange's pull threads ask for one."""
    import time
    inner = TorchShuffleExchangeExec._materialize_inner

    def slow(self):
        time.sleep(0.3)
        return inner(self)

    TorchShuffleExchangeExec._materialize_inner = slow
    yield
    TorchShuffleExchangeExec._materialize_inner = inner


@pytest.mark.parametrize("permits", [1, 2])
def test_broadcast_consumers_wait_for_its_build_without_a_permit(
        permits, slow_exchange):
    """Four threads ask one broadcast at once at 4 tasks, adaptive
    execution off, its build side a grouped aggregate over a hash
    exchange. The build's exchange returns the builder's permit and its
    pull threads take permits again: a consumer that waited on the build
    lock holding a permit would starve them, a deadlock at
    ``concurrentGpuTasks`` 1 or 2. The build runs once, every thread gets
    its batch, and every permit and store handle is back."""
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchBroadcastExchangeExec
    from spark_rapids_tpu_torch.memory import release_plan_handles
    conf = _conf(4, {"spark.sql.adaptive.enabled": "false",
                     "spark.rapids.sql.concurrentGpuTasks": str(permits)})
    s = TorchSparkSession(conf, device="cpu")
    try:
        df = _dims(s).groupBy("k2").agg(PF.max("name").alias("mx"))
        root = s.plan_physical(df.plan, announce=False)
        assert any(isinstance(n, TorchShuffleExchangeExec)
                   for n in distinct_nodes(root))
        bx = TorchBroadcastExchangeExec(root.children[0], s.conf_obj, CPU)

        def consumer():
            try:
                return bx.materialize_device()
            finally:
                PRES.release_current_thread()

        def ask_at_once():
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(4) as pool:
                futs = [pool.submit(consumer) for _ in range(4)]
                return [f.result() for f in futs]

        built = _within(60, ask_at_once)
        assert all(b is built[0] for b in built)
        assert bx.metrics.value("broadcastBuilds") == 1
        host = built[0].to_host().to_pydict()
        assert sorted(zip(host["k2"], host["mx"])) == \
            [(k, "d%d" % k) for k in range(40)]
        release_plan_handles(root)
        _assert_released(s)
    finally:
        s.stop()


def q_broadcast_over_sort(s, f):
    d = _dims(s).orderBy("name")
    cond = f.col("k") == f.col("k2")
    return (_facts(s).join(d, cond, "inner").groupBy("name")
            .agg(f.sum("v").alias("sv"))
            .union(_facts(s).where(f.col("v") > 0).join(d, cond, "inner")
                   .groupBy("name").agg(f.count("v").alias("sv"))))


def q_broadcast_over_limit(s, f):
    d = _dims(s).limit(30)
    cond = f.col("k") == f.col("k2")
    return (_facts(s).join(d, cond, "leftsemi").groupBy("k")
            .agg(f.sum("v").alias("sv"))
            .union(_facts(s).join(d, cond, "leftanti").groupBy("k")
                   .agg(f.count("v").alias("sv"))))


@pytest.mark.parametrize("permits", [1, 2])
@pytest.mark.parametrize("q", [q_broadcast_over_sort, q_broadcast_over_limit],
                         ids=["sort", "limit"])
def test_broadcast_builds_over_exchanges_on_task_threads(q, permits,
                                                         slow_exchange):
    """Broadcasts whose build sides hold an exchange (a sort's range
    exchange, a limit's single-partition one), built on two task threads
    at once under aggregates at one partition, at 4 tasks with adaptive
    execution off and ``concurrentGpuTasks`` 1 or 2: the query ends, each
    broadcast builds once, and the rows are the JAX package's."""
    one = {"spark.rapids.sql.shuffle.devicePartitions": "1",
           "spark.sql.shuffle.partitions": "1",
           "spark.sql.adaptive.enabled": "false"}
    conf = _conf(4, dict(one, **{
        "spark.rapids.sql.concurrentGpuTasks": str(permits)}))
    got, plans = _within(120, lambda: _port(q, conf))
    bx = [n for p in plans for n in distinct_nodes(p)
          if "BroadcastExchange" in type(n).__name__]
    assert len(bx) == 2 and all(
        n.metrics.value("broadcastBuilds") == 1 for n in bx)
    want, _ = _jax(q, _conf(1, one))
    assert sorted(got, key=_sort_key) == sorted(want, key=_sort_key)


def test_literals_are_keyed_by_the_batch_device():
    """A stage's literal tensors are built once for each device a batch
    arrives on, on that device, also when task threads ask at once."""
    exprs = [PE.Add(PE.BoundReference(0, PT.LongT, True),
                    PE.Literal(7, PT.LongT)),
             PE.Literal("x", PT.StringT)]
    calls = []

    def groups_on(device):
        calls.append(device)
        return [X.literal_values(exprs, device)]

    lits = DeviceLiterals(groups_on, CPU)
    meta = torch.device("meta")
    threads = [threading.Thread(target=lits.on, args=(d,))
               for d in (meta, CPU, meta, meta)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(map(str, calls)) == ["cpu", "meta"]
    assert all(t.device == CPU for t in lits.on(CPU))
    assert all(t.device.type == "meta" for t in lits.on(meta))
    assert [tuple(t.shape) for t in lits.on(CPU)] == \
        [tuple(t.shape) for t in lits.on(meta)]
    assert lits.layout == (tuple(len(ts) for ts in
                                 X.literal_values(exprs, CPU)),)


# ---------------------------------------------------------------------------
# the mesh: the per-chip streams drained on task threads
# ---------------------------------------------------------------------------

@pytest.fixture
def emulated():
    """Chips emulated on the cpu device for the test; the active mesh and
    the emulation it found are restored after it."""
    prev_mesh, prev_em = PM.get_active_mesh(), PM.emulated_chips()
    PM.set_active_mesh(None)

    def emulate(n: int):
        PM.emulate_chips(n, CPU)
    yield emulate
    PM.set_active_mesh(prev_mesh)
    PM.emulate_chips(*prev_em) if prev_em else PM.emulate_chips(None)


@pytest.fixture(scope="module")
def jmesh8():
    return jbuild_mesh(8)


def _chip_dispatches(plans) -> dict:
    out: dict = {}
    for p in plans:
        for k, v in plan_metrics(p).items():
            if k.startswith("dispatchCount.chip"):
                out[k] = out.get(k, 0) + v
    return out


def _mesh_scan_agg(path):
    def q(s, f):
        return (s.read.parquet(path).where(f.col("v") > -400)
                .groupBy("k").agg(f.sum("v").alias("sv"),
                                  f.count("*").alias("c"),
                                  f.max("s").alias("mx")))
    return q


def _mesh_scan_join(path):
    def q(s, f):
        return (s.read.parquet(path)
                .join(_dims(s), f.col("k") == f.col("k2"), "inner")
                .groupBy("name").agg(f.sum("v").alias("sv"),
                                     f.count("*").alias("c")))
    return q


MESH_SHAPES = [("scan_aggregate", _mesh_scan_agg, {}),
               ("scan_shuffled_join", _mesh_scan_join, NO_BROADCAST)]


@pytest.mark.parametrize("chips", [4, 8])
@pytest.mark.parametrize("name,make,extra", MESH_SHAPES,
                         ids=[s[0] for s in MESH_SHAPES])
def test_mesh_drain_on_task_threads(chips, name, make, extra, emulated,
                                    jmesh8, tmp_path):
    """Over ``chips`` emulated chips the mesh scan's per-chip streams
    drain on 4 task threads: the port gives the JAX 8-device mesh's rows,
    and each chip runs as many dispatches as at 1 task."""
    from tests.test_torch_multichip import _scan_table
    q = make(_scan_table(tmp_path, "t16", 16, rows_per_file=200))
    emulated(chips)
    ici = dict(extra, **{"spark.rapids.shuffle.mode": "ici",
                         "spark.rapids.shuffle.ici.devices": str(chips)})
    one, plans1 = _port(q, ici)
    four, plans4 = _port(q, dict(ici, **{
        "spark.rapids.sql.taskParallelism": "4"}))
    want, _ = _jax(q, dict(extra, **{
        "spark.rapids.shuffle.mode": "ici",
        "spark.rapids.sql.taskParallelism": "4"}), mesh=jmesh8)
    canon = lambda rows: sorted(rows, key=_sort_key)  # noqa: E731
    assert canon(four) == canon(one) == canon(want)
    assert sum(plan_metrics(p).get("numIciExchanges", 0)
               for p in plans4) >= 1
    d1, d4 = _chip_dispatches(plans1), _chip_dispatches(plans4)
    assert d4 == d1 and len(d4) == chips, (d1, d4)


# ---------------------------------------------------------------------------
# ROADMAP C4 and C5: faults of the reference, mirrored
# ---------------------------------------------------------------------------

C4_SQL = ("select g, count(*) c from t1 join (select distinct name from "
          "t2) d on concat('g', substring(d.name, 2, 1)) = t1.g "
          "group by g")


def _c4_views(s):
    s.createDataFrame({"g": ["g%d" % (i % 10) for i in range(600)],
                       "v": list(range(600))}, "g string, v long",
                      num_partitions=5).createOrReplaceTempView("t1")
    s.createDataFrame({"name": ["n%d%d" % (i % 10, i % 7)
                                for i in range(90)]}, "name string",
                      num_partitions=3).createOrReplaceTempView("t2")


def test_c4_host_exchange_beside_a_device_exchange_mirrored():
    """C4: a shuffled join with one exchange left on the host (substring
    is not fully compatible) and the other coalesced on the device fails
    on one chip in both packages, with the co-partitioning assertion."""
    port = TorchSparkSession({}, device="cpu")
    try:
        _c4_views(port)
        with pytest.raises(AssertionError, match="co-partitioned"):
            port.sql(C4_SQL).collect()
        _assert_released(port)
    finally:
        port.stop()
    jax = TpuSparkSession({})
    try:
        _c4_views(jax)
        with pytest.raises(AssertionError, match="co-partitioned"):
            jax.sql(C4_SQL).collect()
    finally:
        jax.stop()


C5_SQL = ("select x, count(*) c from t1 where x is null or isnan(x) "
          "or x = 0 group by x")


def _c5_rows(session) -> list:
    session.createDataFrame(
        {"x": [1.5, -0.0, None, 0.0, float("nan"), 2.0, None]},
        "x double", num_partitions=1).createOrReplaceTempView("t1")
    return _rows(session.sql(C5_SQL)._execute().to_pydict())


def test_c5_host_engine_keeps_the_first_zero_mirrored():
    """C5: both host engines return the group's first row, -0.0, as the
    key of the zeros' group (Spark and both device paths give 0.0)."""
    off = {"spark.rapids.sql.enabled": "false"}
    port = TorchSparkSession(off, device="cpu")
    jax = TpuSparkSession(off)
    try:
        got, want = _c5_rows(port), _c5_rows(jax)
    finally:
        port.stop()
        jax.stop()
    for rows in (got, want):
        zeros = [r for r in rows if r[0] is not None and r[0] == 0.0]
        assert len(zeros) == 1 and zeros[0][1] == 2, rows
        assert math.copysign(1.0, zeros[0][0]) == -1.0, rows
    assert sorted(map(repr, got)) == sorted(map(repr, want))
