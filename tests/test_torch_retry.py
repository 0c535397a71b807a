"""The OOM retry and split-and-retry protocol, the fault injector and the
reader IO retry of the port (``spark_rapids_tpu_torch/retry.py``), held
against the JAX package's (``tests/test_retry.py``'s cases, less the mesh
and chip-failure ones) on the CPU.

The same seeded numpy inputs go through ``TpuSparkSession`` (kernels
interpreted) and ``TorchSparkSession(device="cpu")`` under the same conf
and injection schedule. The two packages wrap different sites, so one
schedule can hit different operations in each: the rows must be equal
(exact, the only tolerance), and each package's own counters must show
the protocol ran. Injection schedules and the injector's firing pattern
are compared event for event. Two cases have no JAX counterpart: what
counts as an out-of-memory error on the card, and a stage program whose
build raises leaving no cache entry.
"""

import glob

import numpy as np
import pytest
import torch

from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.device import concat_device as jconcat
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.metrics import MetricRegistry as JMetricRegistry
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import memory as MEM
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import resource
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import DeviceBatch, concat_device
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.metrics import MetricRegistry, plan_metrics
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_injection():
    """Every test starts both packages' injectors afresh."""
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()


def retry_conf(injection=None, **extra):
    conf = {
        # small batches: many wrapped allocation points per query
        "spark.rapids.sql.batchSizeRows": "256",
        "spark.rapids.sql.retry.backoffMs": "1",
        "spark.rapids.sql.retry.maxBackoffMs": "4",
    }
    if injection:
        conf["spark.rapids.sql.test.injectOOM"] = injection
    conf.update(extra)
    return conf


# ---------------------------------------------------------------------------
# Query helpers: the same tables and SQL through both packages
# ---------------------------------------------------------------------------

def q1_shape_tables(n=3000, seed=11):
    """filter -> 2-key group-by over a string and an int key (the q1
    silhouette at test scale)."""
    rng = np.random.default_rng(seed)
    flag = np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)]
    return {"t": ("flag string, status int, qty bigint, price int",
                  {"flag": list(flag),
                   "status": [int(v) for v in rng.integers(0, 4, n)],
                   "qty": [int(v) for v in rng.integers(-10**9, 10**9, n)],
                   "price": [int(v) for v in rng.integers(0, 10**6, n)]},
                  4)}


Q1_SHAPE_SQL = ("SELECT flag, status, sum(qty) AS sq, min(price) AS mn, "
                "max(price) AS mx, count(*) AS c FROM t "
                "WHERE qty > -500000000 GROUP BY flag, status")


def q3_shape_tables(seed=12):
    """fact-dim join -> group-by -> order by / limit (the q3 silhouette)."""
    rng = np.random.default_rng(seed)
    brand = np.array([f"b{i}" for i in range(5)], dtype=object)
    return {
        "fact": ("k int, item int, amt bigint",
                 {"k": [int(v) for v in rng.integers(0, 8, 2500)],
                  "item": [int(v) for v in rng.integers(0, 500, 2500)],
                  "amt": [int(v) for v in rng.integers(-10**6, 10**6,
                                                       2500)]}, 3),
        "dim": ("item2 int, brand string",
                {"item2": [int(v) for v in rng.permutation(600)[:400]],
                 "brand": list(brand[rng.integers(0, 5, 400)])}, 2)}


Q3_SHAPE_SQL = ("SELECT brand, sum(amt) AS sa, count(*) AS c FROM fact "
                "JOIN dim ON item = item2 GROUP BY brand ORDER BY brand "
                "LIMIT 50")


def _register(session, tables):
    for name, (ddl, data, parts) in tables.items():
        session.createDataFrame(data, ddl, num_partitions=parts) \
            .createOrReplaceTempView(name)


def run_both(tables, sql, conf, ordered=False):
    """``(JAX rows, port rows, JAX plan metrics, port plan metrics,
    port plan)`` of one query under one conf, each package's injector
    fresh."""
    JR.reset_fault_injection()
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        _register(jax_s, tables)
        jax_s.start_capture()
        want = [tuple(r) for r in jax_s.sql(sql).collect()]
        jm = registry_snapshot(plans=jax_s.get_captured_plans())["metrics"]
    finally:
        jax_s.stop()
    R.reset_fault_injection()
    port = TorchSparkSession(dict(conf), device="cpu")
    _register(port, tables)
    got = [tuple(r) for r in port.sql(sql).collect()]
    pm = plan_metrics(port.last_plan)
    if not ordered:
        want = sorted(want, key=repr)
        got = sorted(got, key=repr)
    return want, got, jm, pm, port.last_plan


# ---------------------------------------------------------------------------
# Combinator units
# ---------------------------------------------------------------------------

def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 40, n),
            np.array([f"s{i % 7}" for i in range(n)], dtype=object))


def device_batch(n=64, seed=0):
    v, s = _arrays(n, seed)
    schema = T.StructType([T.StructField("v", T.LongT),
                           T.StructField("s", T.StringT)])
    return DeviceBatch.from_host(HostBatch(schema, [
        HostColumn(T.LongT, v, np.ones(n, dtype=bool)),
        HostColumn(T.StringT, s, np.ones(n, dtype=bool))], n), CPU)


def jax_device_batch(n=64, seed=0):
    v, s = _arrays(n, seed)
    schema = JT.StructType([JT.StructField("v", JT.LongT),
                            JT.StructField("s", JT.StringT)])
    return JDeviceBatch.from_host(JHostBatch(schema, [
        JHostColumn(JT.LongT, v, np.ones(n, dtype=bool)),
        JHostColumn(JT.StringT, s, np.ones(n, dtype=bool))], n))


def _rows(batch):
    return batch.to_host().to_pydict()


def test_with_retry_recovers_from_injected_oom():
    settings = {"spark.rapids.sql.test.injectOOM": "2:2",
                "spark.rapids.sql.retry.backoffMs": "1",
                "spark.rapids.sql.retry.maxBackoffMs": "2"}
    for pkg, conf, metrics in ((R, TorchConf(settings), MetricRegistry()),
                               (JR, TpuConf(settings), JMetricRegistry())):
        # allocation 1 passes; allocation 2 starts a 2-failure streak
        assert pkg.with_retry(lambda: "a", conf, metrics) == "a"
        assert metrics.value("retryCount") == 0
        calls = []
        assert pkg.with_retry(lambda: calls.append(1) or 42, conf,
                              metrics) == 42
        assert metrics.value("retryCount") == 2
        assert len(calls) == 1  # the faults pre-empt fn
        assert pkg.get_fault_injector(conf).oom_injected == 2


def test_with_retry_exhausts_and_reraises():
    settings = {"spark.rapids.sql.test.injectOOM": "1:100",
                "spark.rapids.sql.retry.maxRetries": "2",
                "spark.rapids.sql.retry.backoffMs": "1",
                "spark.rapids.sql.retry.maxBackoffMs": "1"}
    metrics = MetricRegistry()
    with pytest.raises(R.TorchRetryOOM):
        R.with_retry(lambda: 1, TorchConf(settings), metrics)
    jmetrics = JMetricRegistry()
    with pytest.raises(JR.TpuRetryOOM):
        JR.with_retry(lambda: 1, TpuConf(settings), jmetrics)
    assert metrics.value(M.RETRY_COUNT) == jmetrics.value("retryCount") == 2


def test_with_split_retry_splits_and_preserves_order():
    """A fn that refuses pieces above 16 rows halves recursively; the
    pieces concatenate to the original rows, as in the JAX package."""
    def run(pkg, batch, metrics, oom):
        def fn(piece):
            if piece.row_count() > 16:
                raise oom("too big")
            return piece
        return pkg.with_split_retry(batch, fn, None, metrics)

    metrics = MetricRegistry()
    outs = run(R, device_batch(64, 3), metrics, R.TorchSplitAndRetryOOM)
    jmetrics = JMetricRegistry()
    jouts = run(JR, jax_device_batch(64, 3), jmetrics,
                JR.TpuSplitAndRetryOOM)
    assert len(outs) == len(jouts) == 4
    # 64 -> 2 x 32 -> 4 x 16
    assert metrics.value(M.SPLIT_RETRY_COUNT) == 3
    assert jmetrics.value("splitRetryCount") == 3
    assert [o.row_count() for o in outs] == [o.row_count() for o in jouts]
    got = _rows(concat_device(outs))
    assert got == _rows(device_batch(64, 3))
    assert got == jconcat(jouts).to_host().to_pydict()


def test_split_device_batch_respects_active_mask():
    """Halves balance the ACTIVE rows and keep their order under a
    scattered mask, and hold the JAX package's halves' rows."""
    b = device_batch(32, seed=4)
    scatter = torch.as_tensor(np.arange(b.capacity) % 3 == 0)
    b = DeviceBatch(b.schema, b.columns, b.active & scatter, None)
    halves = R.split_device_batch(b)
    jb = jax_device_batch(32, seed=4)
    import jax.numpy as jnp
    jb = JDeviceBatch(jb.schema, jb.columns,
                      jb.active & jnp.asarray(np.arange(jb.capacity) % 3
                                              == 0), None)
    jhalves = JR.split_device_batch(jb)
    assert halves is not None and len(halves) == 2
    assert [_rows(h) for h in halves] == \
        [h.to_host().to_pydict() for h in jhalves]
    assert _rows(concat_device(halves)) == _rows(b)


def test_split_single_row_reports_unsplittable():
    assert R.split_device_batch(device_batch(1, seed=5)) is None
    hb = HostBatch.from_pydict({"v": [1]}, T.StructType(
        [T.StructField("v", T.LongT)]))
    assert R.split_host_batch(hb) is None


def _pattern(inj, hook, exc, n=100):
    fired = []
    for _ in range(n):
        try:
            hook(inj)
            fired.append(False)
        except exc:
            fired.append(True)
    return fired


@pytest.mark.parametrize("spec", ["5:2", "seed:42:0.3", "split:4", "3",
                                  "site:upload:2"])
def test_injector_fires_as_the_jax_package_does(spec):
    """The same spec fires at exactly the same events in both packages,
    and twice the same in one (the grammar and its seeded stream)."""
    def hook(inj):
        inj.on_alloc("upload")
    port = [_pattern(R.FaultInjector(oom_spec=spec), hook, R.TorchRetryOOM)
            for _ in range(2)]
    jax = _pattern(JR.FaultInjector(oom_spec=spec), hook, JR.TpuRetryOOM)
    assert port[0] == port[1] == jax
    assert any(jax)


def test_seeded_io_schedule_independent_of_oom():
    """A seeded IO schedule follows its own stream whether or not an OOM
    schedule is set, and the JAX package's stream."""
    def hook(inj):
        inj.on_io("p")
    alone = _pattern(R.FaultInjector(io_spec="seed:7:0.4"), hook, IOError, 50)
    both = _pattern(R.FaultInjector(oom_spec="seed:99:0.4",
                                    io_spec="seed:7:0.4"), hook, IOError, 50)
    jax = _pattern(JR.FaultInjector(io_spec="seed:7:0.4"), hook, IOError, 50)
    assert any(alone)
    assert alone == both == jax


def test_injection_suppressed_in_recovery():
    inj = R.FaultInjector(oom_spec="1")
    with R.suppress_injection():
        inj.on_alloc()  # no raise
    with pytest.raises(R.TorchRetryOOM):
        inj.on_alloc()


def test_site_budget_is_the_planning_leg():
    inj = R.FaultInjector(oom_spec="site:budget:2")
    inj.on_alloc()  # never an allocation fault
    assert [inj.on_budget_query() for _ in range(4)] == \
        [False, True, False, True]
    assert inj.stats()["budgetFaultsInjected"] == 2


# ---------------------------------------------------------------------------
# What counts as an out-of-memory error (no JAX counterpart: the JAX
# package matches error text)
# ---------------------------------------------------------------------------

def test_only_oom_errors_are_retried():
    assert R.is_oom_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert R.is_oom_error(KR.KernelError(
        "launch: CUDA error 2", code=KR.CUDA_ERROR_MEMORY_ALLOCATION))
    assert R.is_oom_error(R.TorchSplitAndRetryOOM("injected"))
    # sticky CUDA errors and text that merely looks like an OOM are not
    for e in (KR.KernelError("launch: CUDA error 700", code=700),
              KR.KernelError("launch: CUDA error 719", code=719),
              KR.KernelError("nvcc failed"),
              RuntimeError("CUDA error: out of memory"),
              RuntimeError("RESOURCE_EXHAUSTED: Failed to allocate"),
              MemoryError("host")):
        assert not R.is_oom_error(e), e


@pytest.mark.parametrize("err", [
    KR.KernelError("groupbyHash: CUDA error 700", code=700),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_non_oom_error_propagates_without_retry_or_split(err):
    """A sticky CUDA error leaves the context unusable: it must reach the
    caller on the first attempt, not be retried or split."""
    metrics = MetricRegistry()
    calls = []

    def fn(piece=None):
        calls.append(1)
        raise err

    with pytest.raises(type(err)):
        R.with_retry(fn, TorchConf(retry_conf()), metrics)
    with pytest.raises(type(err)):
        R.with_split_retry(device_batch(64, 1), fn, TorchConf(retry_conf()),
                           metrics)
    assert len(calls) == 2
    assert metrics.value(M.RETRY_COUNT) == 0
    assert metrics.value(M.SPLIT_RETRY_COUNT) == 0


def test_real_oom_retries_then_splits():
    """``torch.OutOfMemoryError`` from the allocator retries, and after
    the retries the batch splits; the pieces hold the original rows."""
    metrics = MetricRegistry()
    b = device_batch(64, 2)

    def fn(piece):
        if piece.row_count() > 32:
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return piece

    outs = R.with_split_retry(b, fn, TorchConf(retry_conf()), metrics)
    assert metrics.value(M.RETRY_COUNT) == 3  # maxRetries, then split
    assert metrics.value(M.SPLIT_RETRY_COUNT) == 1
    assert _rows(concat_device(outs)) == _rows(b)


# ---------------------------------------------------------------------------
# A stage program whose build raises (the capture-failure path, with a fake
# program on the CPU)
# ---------------------------------------------------------------------------

def test_failed_stage_build_leaves_no_cache_entry():
    FU.STAGE_CACHE.clear()
    metrics = MetricRegistry()
    flat = [torch.arange(64, dtype=torch.int64)]
    key = ("test-failed-build",)
    state = {"fail": True}

    def fn(inputs):
        if state["fail"]:
            raise torch.OutOfMemoryError("CUDA out of memory (capture)")
        return [inputs[0] * 2], None

    with pytest.raises(torch.OutOfMemoryError):
        FU.run_program(key, fn, flat, metrics)
    full_key = (key, FU.input_signature(flat))
    assert full_key not in FU.STAGE_CACHE
    assert len(FU.STAGE_CACHE) == 0
    # under the retry protocol the next attempt builds and runs
    calls = []

    def flaky(inputs):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (capture)")
        return [inputs[0] * 2], None

    outs, _meta = R.with_retry(
        lambda: FU.run_program(key, flaky, flat, metrics),
        TorchConf(retry_conf()), metrics)
    assert torch.equal(outs[0], flat[0] * 2)
    assert full_key in FU.STAGE_CACHE
    assert metrics.value(M.RETRY_COUNT) == 1
    FU.STAGE_CACHE.clear()


def test_recovery_releases_least_recently_used_stage_programs():
    FU.STAGE_CACHE.clear()
    metrics = MetricRegistry()
    progs = []
    for i in range(4):
        flat = [torch.arange(64 * (i + 1), dtype=torch.int64)]
        FU.run_program(("lru", i), lambda x: ([x[0] + 1], None), flat,
                       metrics)
        progs.append(((("lru", i), FU.input_signature(flat))))
    for i, (key, _sig) in enumerate(progs):
        FU.STAGE_CACHE._data[(key, _sig)].pool_bytes = 1000 * (i + 1)
    assert FU.release_stage_programs(everything=False) == 1000 + 2000
    assert [k in FU.STAGE_CACHE for k in progs] == [False, False, True,
                                                    True]
    assert FU.release_stage_programs(everything=False) == 3000
    # a lone program stays on a first attempt; a later attempt frees it
    assert FU.release_stage_programs(everything=False) == 0
    assert FU.release_stage_programs(everything=True) == 4000
    assert len(FU.STAGE_CACHE) == 0
    assert FU.release_stage_programs(everything=True) == 0


def test_exhaustion_escalates_into_split():
    """Failures beyond maxRetries: with_retry runs out and
    with_split_retry halves instead of failing (as in the JAX package)."""
    settings = {"spark.rapids.sql.retry.maxRetries": "2",
                "spark.rapids.sql.retry.backoffMs": "1",
                "spark.rapids.sql.retry.maxBackoffMs": "1"}
    results = []
    for pkg, conf, metrics, b, oom in (
            (R, TorchConf(settings), MetricRegistry(), device_batch(32, 8),
             R.TorchRetryOOM),
            (JR, TpuConf(settings), JMetricRegistry(),
             jax_device_batch(32, 8), JR.TpuRetryOOM)):
        state = {"fails": 4}

        def fn(piece, state=state, oom=oom):
            if state["fails"] > 0:
                state["fails"] -= 1
                raise oom("synthetic alloc failure")
            return piece

        outs = pkg.with_split_retry(b, fn, conf, metrics)
        results.append((metrics.value("splitRetryCount"),
                        metrics.value("retryCount"), len(outs)))
    assert results[0] == results[1] == (1, 3, 2)


def test_split_oom_on_unsplittable_piece_degrades_to_retry():
    conf = TorchConf({"spark.rapids.sql.retry.backoffMs": "1",
                      "spark.rapids.sql.retry.maxBackoffMs": "1"})
    metrics = MetricRegistry()
    b = device_batch(1, seed=9)
    state = {"fails": 2}

    def fn(piece):
        if state["fails"] > 0:
            state["fails"] -= 1
            raise R.TorchSplitAndRetryOOM("split demanded on 1-row piece")
        return piece

    outs = R.with_split_retry(b, fn, conf, metrics)
    assert len(outs) == 1
    assert metrics.value(M.SPLIT_RETRY_COUNT) == 0
    assert metrics.value(M.RETRY_COUNT) == 1
    assert _rows(outs[0]) == _rows(b)
    state["fails"] = 10**6
    with pytest.raises(R.TorchRetryOOM):
        R.with_split_retry(b, fn, conf, metrics)


# ---------------------------------------------------------------------------
# Store hooks
# ---------------------------------------------------------------------------

def test_store_spill_device_down_frees_device_bytes(tmp_path):
    store = MEM.DeviceStore(1 << 30, 1 << 30, str(tmp_path))
    b1, b2 = device_batch(128, 6), device_batch(128, 7)
    want = _rows(b1)
    h1, h2 = store.register(b1), store.register(b2)
    assert store.device_bytes == b1.sizeof() + b2.sizeof()
    freed = store.spill_device_down()
    assert freed == b1.sizeof() + b2.sizeof() and store.device_bytes == 0
    assert _rows(h1.get()) == want
    h1.close()
    h2.close()


def test_disk_files_tracked_and_swept_on_close(tmp_path):
    store = MEM.DeviceStore(device_budget=1, host_budget=1,
                            spill_dir=str(tmp_path))
    handles = [store.register(device_batch(64, s)) for s in range(3)]
    assert store.stats()["diskFilesLive"] >= 1
    assert glob.glob(str(tmp_path / "spill-*.bin"))
    live_before = store.disk_files_live
    assert _rows(handles[0].get()) == _rows(device_batch(64, 0))
    assert store.disk_files_live < live_before + 1
    store.close()
    assert store.stats()["diskFilesLive"] == 0
    assert not glob.glob(str(tmp_path / "spill-*.bin"))
    assert store.device_bytes == 0 and store.host_bytes == 0


# ---------------------------------------------------------------------------
# q1- and q3-shaped queries under injected OOM: rows equal to the JAX
# package's under the same schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", ["3", "4:2", "seed:42:0.2"])
def test_q1_shape_rows_under_oom_schedule(sched):
    want, got, jm, pm, _plan = run_both(q1_shape_tables(), Q1_SHAPE_SQL,
                                        retry_conf(sched))
    assert got == want
    assert jm.get("retryCount", 0) > 0 and pm.get(M.RETRY_COUNT, 0) > 0, \
        (jm.get("retryCount"), pm.get(M.RETRY_COUNT))


def test_q1_shape_split_and_retry():
    """split:3 splits at the split-capable sites (the upload, the partial
    aggregate's stage) and degrades to a retry at the others."""
    want, got, jm, pm, _plan = run_both(q1_shape_tables(), Q1_SHAPE_SQL,
                                        retry_conf("split:3"))
    assert got == want
    assert jm.get("splitRetryCount", 0) > 0
    assert pm.get(M.SPLIT_RETRY_COUNT, 0) > 0
    assert pm.get(M.RETRY_COUNT, 0) > 0


@pytest.mark.parametrize("sched", ["3", "split:4"])
def test_q3_shape_rows_under_oom_schedule(sched):
    want, got, jm, pm, _plan = run_both(q3_shape_tables(), Q3_SHAPE_SQL,
                                        retry_conf(sched), ordered=True)
    assert got == want and len(got) == 5
    assert jm.get("retryCount", 0) > 0 and pm.get(M.RETRY_COUNT, 0) > 0


def test_oom_schedule_with_tiny_pool_spills_on_retry(tmp_path):
    """Injected OOM and a tiny device pool: the recovery spills the
    store down (spillBytesOnRetry > 0) and the rows stay equal."""
    conf = retry_conf("3", **{
        "spark.rapids.memory.tpu.poolSize": str(256 << 10),
        "spark.rapids.memory.spillDirectory": str(tmp_path)})
    want, got, jm, pm, _plan = run_both(q1_shape_tables(), Q1_SHAPE_SQL,
                                        conf)
    assert got == want
    assert pm.get(M.RETRY_COUNT, 0) > 0
    assert pm.get(M.SPILL_BYTES_ON_RETRY, 0) > 0


def test_oom_schedule_with_task_parallelism_returns_permits():
    conf = retry_conf("4", **{"spark.rapids.sql.taskParallelism": "3"})
    want, got, _jm, pm, _plan = run_both(q1_shape_tables(), Q1_SHAPE_SQL,
                                         conf)
    assert got == want
    assert pm.get(M.RETRY_COUNT, 0) > 0
    assert resource._SEMAPHORE is not None
    assert resource._SEMAPHORE.in_use == 0


def test_semaphore_permits_restored_after_failed_query():
    """A query whose every allocation fails, beyond any retry or split,
    raises and returns every device permit and store handle."""
    conf = retry_conf("1:1000000", **{
        "spark.rapids.sql.retry.maxRetries": "1"})
    port = TorchSparkSession(conf, device="cpu")
    _register(port, q1_shape_tables())
    with pytest.raises(R.TorchRetryOOM):
        port.sql(Q1_SHAPE_SQL).collect()
    sem = resource._SEMAPHORE
    assert sem is not None and sem.in_use == 0
    store = MEM._STORE
    assert store is not None
    assert store.release_for_registries(
        MEM.plan_registries(port.last_plan)) == 0


# ---------------------------------------------------------------------------
# Reader IO retry
# ---------------------------------------------------------------------------

def _write_parquet(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(14)
    path = tmp_path / "t"
    path.mkdir()
    for i in range(3):
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 8, 400).astype(np.int32)),
            "v": pa.array(rng.integers(-10**9, 10**9, 400))}),
            str(path / f"part-{i}.parquet"))
    return str(path)


PARQUET_SQL = "SELECT k, sum(v) AS s FROM p GROUP BY k"


def _read_both(path, conf):
    JR.reset_fault_injection()
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        jax_s.read.parquet(path).createOrReplaceTempView("p")
        jax_s.start_capture()
        want = sorted(tuple(r) for r in jax_s.sql(PARQUET_SQL).collect())
        jm = registry_snapshot(plans=jax_s.get_captured_plans())["metrics"]
    finally:
        jax_s.stop()
    R.reset_fault_injection()
    port = TorchSparkSession(dict(conf), device="cpu")
    port.read.parquet(path).createOrReplaceTempView("p")
    got = sorted(tuple(r) for r in port.sql(PARQUET_SQL).collect())
    return want, got, jm, plan_metrics(port.last_plan)


def test_reader_retries_transient_io_errors(tmp_path):
    path = _write_parquet(tmp_path)
    conf = {"spark.rapids.sql.test.injectIOError": "2",
            "spark.rapids.sql.reader.retryBackoffMs": "1"}
    want, got, jm, pm = _read_both(path, conf)
    assert got == want and len(got) == 8
    assert jm.get("ioRetryCount", 0) > 0
    assert pm.get(M.IO_RETRY_COUNT, 0) > 0


def test_reader_reraises_original_after_exhaustion(tmp_path):
    path = _write_parquet(tmp_path)
    conf = {"spark.rapids.sql.test.injectIOError": "1:1000000",
            "spark.rapids.sql.reader.maxRetries": "2",
            "spark.rapids.sql.reader.retryBackoffMs": "1"}
    port = TorchSparkSession(conf, device="cpu")
    port.read.parquet(path).createOrReplaceTempView("p")
    with pytest.raises(IOError, match="injected IO error"):
        port.sql(PARQUET_SQL).collect()


@pytest.mark.parametrize("sched", ["site:upload:2", "site:upload:2:5"])
def test_upload_oom_shrinks_ring_and_falls_back_to_host_decode(tmp_path,
                                                               sched):
    """``site:upload`` fails the upload's copy: the ring shrinks (the
    older in-flight uploads complete first) and the unit takes the
    synchronous protocol; a streak longer than the retries makes that
    row group take its host decode (``deviceDecodeOomFallbacks``), which
    the port does only on the CPU. Rows equal the JAX package's under the
    same schedule."""
    path = _write_parquet(tmp_path)
    conf = retry_conf(sched, **{
        "spark.rapids.sql.format.parquet.deviceDecode.maxInFlight": "2"})
    want, got, _jm, pm = _read_both(path, conf)
    assert got == want and len(got) == 8
    assert pm.get(M.RETRY_COUNT, 0) > 0 or sched == "site:upload:2"
    if sched.endswith(":5"):
        assert pm.get(M.DEVICE_DECODE_OOM_FALLBACKS, 0) > 0
        # the other row groups still decode on the device
        assert pm.get("kernelDispatchCount.decodeFused", 0) > 0


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_encoded_upload_never_takes_host_decode_on_the_card(device):
    """An EncodedBatch whose upload runs out of retries: on a CUDA device
    the OOM propagates and the pyarrow decode is never called (the row
    group's decode stays ``decodeFused``'s); on the CPU it takes the host
    decode for that batch, as the JAX package does. ``_upload_degraded``
    decides by the exec's device before it touches one, so both run
    here."""
    from spark_rapids_tpu_torch.exec.base import TorchRowToColumnarExec
    from spark_rapids_tpu_torch.io.device_decode import EncodedBatch
    schema = T.StructType([T.StructField("a", T.LongT, True)])
    host = HostBatch(schema, [HostColumn(T.LongT, np.arange(4),
                                         np.ones(4, dtype=bool))], 4)
    calls = []

    def decode_on_host():
        calls.append(1)
        return [host]
    enc = EncodedBatch(schema, 4, np.zeros(4, dtype=np.int32), {}, {}, [],
                       host_fallback=decode_on_host)
    r2c = TorchRowToColumnarExec(None, TorchConf({}), torch.device(device))
    if device == "cuda":
        with pytest.raises(R.TorchRetryOOM, match="on the device"):
            r2c._upload_degraded(enc)
        assert calls == []
        assert r2c.metrics.value(M.DEVICE_DECODE_OOM_FALLBACKS) == 0
    else:
        out = r2c._upload_degraded(enc)
        assert calls == [1]
        assert r2c.metrics.value(M.DEVICE_DECODE_OOM_FALLBACKS) == 1
        assert sum(b.row_count() for b in out) == 4
