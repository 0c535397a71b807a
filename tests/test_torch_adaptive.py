"""Adaptive execution in the port (``spark_rapids_tpu_torch/adaptive.py``
and its call sites in the exchange and the shuffled join), held against
the JAX package's on the CPU.

The replan calculus: the JAX package's own helper cases
(``tests/test_adaptive.py``, less the serving layer's ``fusion_key``) run
against the port's module, and seeded inputs through both modules give
equal outputs. The engine: the JAX package's skew sweep, injected-OOM
contrast, broadcast demotion and coalesce cases run through both
packages with adaptive execution on and off; the rows are equal in all
four runs, the ``aqe*`` counters and ``retryCount`` equal the JAX
package's (an injected schedule's retry count depends on how many
allocations each package wraps, so there both must only be above 0),
the adaptive-off runs count no replan, and the executed plans' fused
stages are equal. The exchange statistics never read a row count that
is not known, and a round-robin exchange deals rows as the JAX package
does.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import adaptive as JA_MOD
from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from chip_smoke import plan_nodes_of
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch import adaptive as PA
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

import tests.test_adaptive as JA
from tests.datagen import IntegerGen, LongGen, SmallIntGen, gen_batch
from tests.harness import _rows, _sort_key
from tests.torch_dual import _rebind, assert_all_torch, port_batch

torch.set_num_threads(2)

AQE_KEYS = ("aqeBroadcastFlip", "aqeReplans", "aqeSkewSplits",
            "aqeCoalescedPartitions")
OFF = {"spark.rapids.sql.adaptive.enabled": "false"}


@pytest.fixture(autouse=True)
def _fresh_injection():
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()


# ---------------------------------------------------------------------------
# The replan calculus

HELPER_CASES = ["test_exchange_stats_median_ignores_empty_partitions",
                "test_exchange_stats_all_empty",
                "test_skew_splits_thresholds_and_cap",
                "test_coalesce_groups_adjacent_up_to_target",
                "test_slice_groups_contiguous_and_bounded"]


@pytest.mark.parametrize("name", HELPER_CASES)
def test_jax_helper_case_passes_on_the_port_module(name):
    """The JAX package's test body, its ``A`` rebound to the port's
    adaptive module."""
    _rebind(getattr(JA, name), dict(vars(JA), A=PA))()


def _stats(mod, rng, n):
    sizes = [int(v) if rng.random() > 0.3 else 0
             for v in rng.integers(1, 1000, n)]
    return mod.ExchangeStats(tuple(sizes), tuple(s // 10 for s in sizes))


@pytest.mark.parametrize("seed", range(6))
def test_helpers_equal_jax_package_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 24))
    js = _stats(JA_MOD, np.random.default_rng(seed), n)
    ps = _stats(PA, np.random.default_rng(seed), n)
    for prop in ("num_partitions", "total_bytes", "max_bytes",
                 "median_bytes", "skew_ratio"):
        assert getattr(js, prop) == getattr(ps, prop), prop
    for factor in (0.0, 1.5, 4.0, 10.0):
        assert JA_MOD.skew_splits(js, factor) == PA.skew_splits(ps, factor)
    for target in (1, 500, 2000, 64 << 20):
        assert JA_MOD.coalesce_groups(js.partition_bytes, target) == \
            PA.coalesce_groups(ps.partition_bytes, target)
    for k in (1, 2, 3, 16):
        assert JA_MOD.slice_groups(list(js.partition_bytes), k) == \
            PA.slice_groups(list(ps.partition_bytes), k)


CONF_CASES = [
    {},
    OFF,
    {"spark.sql.adaptive.enabled": "false"},
    {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"},
    {"spark.rapids.sql.adaptive.autoBroadcastBytes": "1m",
     "spark.rapids.sql.adaptive.targetPartitionBytes": "4k",
     "spark.rapids.sql.adaptive.skewFactor": "0"},
    {"spark.sql.adaptive.advisoryPartitionSizeInBytes": "16m",
     "spark.rapids.sql.adaptive.skewFactor": "2.5"},
]


@pytest.mark.parametrize("conf", CONF_CASES)
def test_conf_resolution_equals_jax_package(conf):
    jc, pc = TpuConf(dict(conf)), TorchConf(dict(conf))
    for fn in ("adaptive_enabled", "auto_broadcast_bytes",
               "target_partition_bytes", "skew_factor"):
        assert getattr(JA_MOD, fn)(jc) == getattr(PA, fn)(pc), fn


def test_item_stats_never_reads_an_unknown_row_count():
    """A handle whose rows are unknown counts 0 rows and its whole
    bytes; reading the stats leaves the count unknown (no synchronise)."""
    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.memory import DeviceStore
    from spark_rapids_tpu_torch.sql import types as T
    hb = host_batch_from_numpy([("a", T.LongT)], [np.arange(100)])
    b = DeviceBatch.from_host(hb, torch.device("cpu"))
    unknown = DeviceBatch(b.schema, b.columns, b.active, None)
    store = DeviceStore(1 << 30, 1 << 30, "/nonexistent")
    try:
        h_unknown = store.register(unknown)
        h_known = store.register(b)
        st = PA.capture_stats([[h_unknown], [h_known]])
        assert h_unknown._state.rows is None
        assert st.partition_rows == (0, 100)
        assert st.partition_bytes[0] == unknown.sizeof()
        assert st.partition_bytes[1] == int(b.sizeof() * 100
                                            / b.capacity)
    finally:
        store.close()


def test_round_robin_pids_equal_jax_package():
    import jax.numpy as jnp

    from spark_rapids_tpu.exec.exchange import _round_robin_pids
    from spark_rapids_tpu_torch.exec.exchange import round_robin_pids
    rng = np.random.default_rng(3)
    for n, start in ((3, 0), (4, 5), (16, 1)):
        active = rng.random(1024) > 0.4
        want = np.asarray(_round_robin_pids(jnp.asarray(active),
                                            jnp.int32(start), n))
        got = round_robin_pids(torch.from_numpy(active), start, n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy()[active], want[active])


def test_round_robin_repartition_equals_jax_package():
    def fn(s, F):
        df = s.createDataFrame(
            {"g": [i % 5 for i in range(500)], "v": list(range(500))},
            "g int, v long", num_partitions=3)
        return df.repartition(4).groupBy("g").agg(F.sum("v").alias("sv"),
                                                  F.count("v").alias("c"))
    (jrows, jm, jplan), (prows, pm, plan) = run_both(fn, {})
    assert prows == jrows and len(prows) == 5
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    (exch,) = [p for p in plan_nodes_of(plan)
               if type(p).__name__ == "TorchShuffleExchangeExec"
               and type(p.partitioning).__name__ ==
               "RoundRobinPartitioning"]
    assert exch.partitioning.num_partitions == 4


# ---------------------------------------------------------------------------
# The engine, through both packages

def run_both(df_fn, conf):
    """``((JAX rows, counters, plan), (port rows, counters, plan))`` of
    ``df_fn(session, functions)``, rows sorted as the JAX package's
    tests sort them."""
    conf = {k: str(v) for k, v in conf.items()}
    JR.reset_fault_injection()
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        jax_s.start_capture()
        batch = df_fn(jax_s, JF)._execute()
        jrows = sorted(_rows(batch.to_pydict()), key=_sort_key)
        (jplan,) = jax_s.get_captured_plans()
        jm = registry_snapshot([jplan])["metrics"]
    finally:
        jax_s.stop()
    R.reset_fault_injection()
    port = TorchSparkSession(conf, device="cpu")
    batch = df_fn(port, PF)._execute()
    prows = sorted(_rows(batch.to_pydict()), key=_sort_key)
    pm = plan_metrics(port.last_plan)
    keys = AQE_KEYS + ("retryCount", "splitRetryCount")
    return ((jrows, {k: int(jm.get(k, 0)) for k in keys}, jplan),
            (prows, {k: int(pm.get(k, 0)) for k in keys}, port.last_plan))


def check_on_off(df_fn, conf, fired: str):
    """Adaptive on and off in both packages: rows equal in all four
    runs; counters equal between the packages; ``fired`` above 0 when
    on and every ``aqe*`` counter 0 when off; fused stages equal.
    Returns the two port plans."""
    (jon, jm_on, jplan), (pon, pm_on, plan) = run_both(df_fn, conf)
    (joff, jm_off, _jp), (poff, pm_off, plan_off) = run_both(
        df_fn, dict(conf, **OFF))
    assert pon == jon == joff == poff
    assert pm_on == jm_on, (pm_on, jm_on)
    assert pm_off == jm_off, (pm_off, jm_off)
    assert pm_on[fired] > 0, pm_on
    assert all(pm_off[k] == 0 for k in AQE_KEYS), pm_off
    assert pm_on["retryCount"] == 0
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    return plan, plan_off


def _skew_join(hot_mult, jt, with_nulls):
    def fn(s, F):
        l_, r_ = JA._skew_frames(s, hot_mult, with_nulls)
        return l_.join(r_, l_["k"] == r_["k2"], jt)
    return fn


# the JAX sweep's cases (it skips 100x with nulls)
SWEEP = [(m, jt, nulls) for m in (10, 100) for jt in ("inner", "left")
         for nulls in (False, True) if not (m == 100 and nulls)]


@pytest.mark.parametrize("hot_mult,jt,with_nulls", SWEEP,
                         ids=[f"{m}x-{jt}-{'nullkeys' if n else 'dense'}"
                              for m, jt, n in SWEEP])
def test_skewed_join_sweep_equals_jax_package(hot_mult, jt, with_nulls):
    plan, _off = check_on_off(_skew_join(hot_mult, jt, with_nulls),
                              JA._SKEW_BASE, "aqeSkewSplits")
    (join,) = [p for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]
    assert join.metrics.value("aqeReplans") == 1


def test_skewed_join_injected_oom_contrast():
    fn = _skew_join(10, "inner", False)
    inject = dict(JA._SKEW_BASE, **OFF, **{
        "spark.rapids.sql.test.injectOOM": "2:2",
        "spark.rapids.sql.retry.backoffMs": "5",
        "spark.rapids.sql.retry.maxBackoffMs": "20"})
    (joff, jm_off, _jp), (poff, pm_off, _pp) = run_both(fn, inject)
    (jon, jm_on, jplan), (pon, pm_on, plan) = run_both(fn, JA._SKEW_BASE)
    assert pon == jon == joff == poff
    # under the schedule both retry; each package wraps its own count of
    # allocations, so the counts themselves differ
    assert jm_off["retryCount"] > 0 and pm_off["retryCount"] > 0
    assert all(pm_off[k] == jm_off[k] == 0 for k in AQE_KEYS)
    assert pm_on == jm_on and pm_on["retryCount"] == 0
    assert pm_on["aqeSkewSplits"] > 0
    assert fused_shape(plan) == fused_shape(jplan)


def _demotion(s, F):
    def gb(gens, n, seed):
        b = gen_batch(gens, n, seed)
        return b if isinstance(s, TpuSparkSession) else port_batch(b)
    l_ = s.createDataFrame(gb([("k", SmallIntGen()), ("a", IntegerGen())],
                              400, 11), num_partitions=2)
    r_ = s.createDataFrame(gb([("k2", SmallIntGen()), ("b", LongGen())],
                              60, 12), num_partitions=2)
    return l_.join(r_.repartition(3), l_["k"] == r_["k2"], "inner")


def test_broadcast_demotion_equals_jax_package():
    plan, plan_off = check_on_off(_demotion, {}, "aqeBroadcastFlip")
    (join,) = [p for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]
    # the stream side's co-partitioning exchange is gone from the
    # executed plan; adaptive off keeps it
    assert type(join).__name__ == "TorchShuffledHashJoinExec"
    assert type(join.left).__name__ == "TorchRowToColumnarExec"
    (join_off,) = [p for p in plan_nodes_of(plan_off)
                   if hasattr(p, "route_counts")]
    assert type(join_off.left).__name__ == "TorchShuffleExchangeExec"


def test_coalesce_equals_jax_package():
    def fn(s, F):
        df = s.createDataFrame(
            {"g": [i % 3 for i in range(600)],
             "v": list(range(600))}, "g int, v long", num_partitions=4)
        return df.groupBy("g").agg(F.sum("v").alias("sv"))
    conf = {"spark.rapids.sql.batchSizeRows": "512",
            "spark.rapids.sql.shuffle.devicePartitions": "8"}
    plan, _off = check_on_off(fn, conf, "aqeCoalescedPartitions")
    (exch,) = [p for p in plan_nodes_of(plan)
               if type(p).__name__ == "TorchShuffleExchangeExec"
               and p.partitioning.num_partitions == 8]
    assert exch.allow_aqe_coalesce
    assert exch.metrics.value("exchangeTotalBytes") > 0


def test_replanned_stream_side_handles_released():
    """The demoted join's build exchange keeps its handles until the
    collect ends; then the session releases every handle of the
    executed plan, the rewired stream side's included."""
    from spark_rapids_tpu_torch.memory import get_device_store
    port = TorchSparkSession({}, device="cpu")
    _demotion(port, PF).collect()
    store = get_device_store(port.conf_obj)
    from spark_rapids_tpu_torch.memory import plan_registries
    regs = plan_registries(port.last_plan)
    live = [st for st in store._states.values()
            if not st.closed and st.metrics_ref is not None
            and id(st.metrics_ref()) in regs]
    assert not live
    assert plan_metrics(port.last_plan)["aqeBroadcastFlip"] == 1


def test_demotion_rewires_the_planned_stream_subtree():
    """The demotion hands the join the stream subtree it was planned
    with (not a copy): the dropped exchange's child becomes the join's
    left child, and its metrics record the one run that happened."""
    from spark_rapids_tpu_torch.memory import release_plan_handles
    port = TorchSparkSession({}, device="cpu")
    physical = port.plan_physical(_demotion(port, PF).plan)
    (join,) = [p for p in plan_nodes_of(physical)
               if hasattr(p, "route_counts")]
    exch = join.left
    assert type(exch).__name__ == "TorchShuffleExchangeExec"
    planned = exch.child
    try:
        rows = physical.execute_collect().num_rows
    finally:
        release_plan_handles(physical)
    assert join.left is planned
    assert plan_metrics(physical)["aqeBroadcastFlip"] == 1
    assert plan_metrics(planned)["numOutputRows"] == 400
    assert rows == len(_demotion(port, PF).collect())
