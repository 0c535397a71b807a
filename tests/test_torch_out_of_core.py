"""Planned out-of-core execution of the port (the budget oracle in
``spark_rapids_tpu_torch/memory.py``; the partitioned hash join and the
bucketed final aggregate), held against the JAX package's
(``tests/test_out_of_core.py``'s cases, less the two ``doctor`` ones) on
the CPU.

The same seeded inputs run through both packages under the same tiny
``deviceBudgetBytes``: the rows must be equal (exact), and where the JAX
test requires the planned path, both packages must show it
(``plannedPartitions`` > 0) with no retry (``retryCount`` == 0): the
retry protocol stays the backstop, never the steady state.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.memory import get_budget_oracle
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

NO_BCAST = {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"}
TINY_BUDGET = {"spark.rapids.sql.memory.deviceBudgetBytes": "8192"}

_OOC_KEYS = ("plannedPartitions", "plannedOutOfCoreEscalations",
             "budgetPressurePeak", "retryCount", "splitRetryCount")


@pytest.fixture(autouse=True)
def _fresh_injection():
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()


def run_both(df_fn, conf, ordered=False):
    """``(JAX rows, port rows, JAX counters, port counters, port plan)``
    of ``df_fn(session, functions)`` under ``conf``."""
    JR.reset_fault_injection()
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        jax_s.start_capture()
        want = [tuple(r) for r in df_fn(jax_s, JF).collect()]
        jm = registry_snapshot(plans=jax_s.get_captured_plans())["metrics"]
    finally:
        jax_s.stop()
    R.reset_fault_injection()
    port = TorchSparkSession(dict(conf), device="cpu")
    got = [tuple(r) for r in df_fn(port, PF).collect()]
    pm = plan_metrics(port.last_plan)
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    return (want, got, {k: int(jm.get(k, 0)) for k in _OOC_KEYS},
            {k: int(pm.get(k, 0)) for k in _OOC_KEYS}, port.last_plan)


def _join_data(spark, n=1000, seed=5, nulls=False, strings=False,
               skew=False, parts=3):
    rng = np.random.RandomState(seed)
    lk = rng.randint(0, 300, n)
    rk = rng.randint(0, 300, n)
    if skew:  # one hot key owns most rows: rehashing cannot split it
        lk[: n * 9 // 10] = 7
        rk[: n // 2] = 7

    def col(keys):
        out = []
        for i, v in enumerate(keys):
            if nulls and i % 11 == 0:
                out.append(None)
            elif strings:
                out.append(f"k{int(v):03d}")
            else:
                out.append(int(v))
        return out
    kt = "string" if strings else "bigint"
    l_ = spark.createDataFrame(
        {"k": col(lk), "v": [int(i) for i in range(n)]},
        f"k {kt}, v bigint", num_partitions=parts)
    r_ = spark.createDataFrame(
        {"k2": col(rk), "w": [int(i * 3) for i in range(n)]},
        f"k2 {kt}, w bigint", num_partitions=parts)
    return l_, r_


def _join(jt, **data):
    def fn(s, F):
        l_, r_ = _join_data(s, **data)
        return l_.join(r_, l_["k"] == r_["k2"], jt)
    return fn


def _planned(c):
    return c["plannedPartitions"] > 0 and c["retryCount"] == 0 \
        and c["splitRetryCount"] == 0


def _join_kinds(plan):
    out = []

    def walk(p):
        out.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(plan)
    return out


# ---------------------------------------------------------------------------
# Partitioned join
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jt", ["inner", "left", "leftsemi", "full"])
def test_ooc_join_parity(jt):
    want, got, jc, pc, plan = run_both(_join(jt, nulls=True),
                                       {**NO_BCAST, **TINY_BUDGET})
    assert got == want
    assert "TorchShuffledHashJoinExec" in _join_kinds(plan)
    assert _planned(jc), jc
    assert _planned(pc), pc


def test_ooc_join_parity_string_keys():
    want, got, _jc, pc, _plan = run_both(
        _join("inner", strings=True, nulls=True),
        {**NO_BCAST, **TINY_BUDGET})
    assert got == want
    assert _planned(pc), pc


def test_ooc_join_skewed_keys_recursion_backstop():
    """A hot key owns 90% of the stream rows and half the build: a
    doubled modulus never splits it, so the plan recurses to
    maxRecursion and the backstop takes the bucket."""
    conf = {**NO_BCAST, **TINY_BUDGET,
            "spark.rapids.sql.outOfCore.maxRecursion": "1"}
    want, got, jc, pc, _plan = run_both(_join("inner", skew=True), conf)
    assert got == want
    for c in (jc, pc):
        assert c["plannedPartitions"] > 0, c
        assert c["plannedOutOfCoreEscalations"] > 0, c


def test_ooc_join_recursive_repartition():
    """maxPartitions=2 makes the first plan too coarse: buckets
    re-partition at a doubled modulus until they fit."""
    conf = {**NO_BCAST, **TINY_BUDGET,
            "spark.rapids.sql.outOfCore.maxPartitions": "2"}
    want, got, jc, pc, _plan = run_both(_join("inner"), conf)
    assert got == want
    for c in (jc, pc):
        assert c["plannedOutOfCoreEscalations"] > 0, c
        assert c["retryCount"] == 0, c


def test_ooc_disabled_stays_in_memory():
    conf = {**NO_BCAST, **TINY_BUDGET,
            "spark.rapids.sql.outOfCore.enabled": "false"}
    want, got, jc, pc, _plan = run_both(_join("inner"), conf)
    assert got == want
    assert jc["plannedPartitions"] == pc["plannedPartitions"] == 0


# ---------------------------------------------------------------------------
# Bucketed final aggregate
# ---------------------------------------------------------------------------

def test_ooc_agg_parity():
    def fn(s, F):
        rng = np.random.RandomState(9)
        t = s.createDataFrame(
            {"g": [int(v) for v in rng.randint(0, 200, 1600)],
             "x": [int(v) for v in range(1600)]}, "g bigint, x bigint",
            num_partitions=3)
        return t.groupBy("g").agg(F.sum("x").alias("s"),
                                  F.count("*").alias("c"),
                                  F.min("x").alias("mn"),
                                  F.max("x").alias("mx"))
    want, got, jc, pc, _plan = run_both(fn, TINY_BUDGET)
    assert got == want and len(got) == 200
    assert _planned(jc), jc
    assert _planned(pc), pc


def test_ooc_agg_parity_string_keys_with_nulls():
    def fn(s, F):
        rng = np.random.RandomState(2)
        g = [None if i % 13 == 0 else f"g{int(v):03d}"
             for i, v in enumerate(rng.randint(0, 150, 1200))]
        t = s.createDataFrame({"g": g, "x": [int(v) for v in range(1200)]},
                              "g string, x bigint", num_partitions=3)
        return t.groupBy("g").agg(F.sum("x").alias("s"),
                                  F.count("*").alias("c"))
    want, got, _jc, pc, _plan = run_both(fn, TINY_BUDGET)
    assert got == want
    assert _planned(pc), pc


# ---------------------------------------------------------------------------
# 8x over the budget, end to end: the planned path, zero retries
# ---------------------------------------------------------------------------

def test_ooc_e2e_8x_over_budget_q1_shape():
    """filter + grouped aggregate + sort over a working set more than 8x
    the budget (~96 KB of key and value columns against 8 KB)."""
    n = 4000

    def fn(s, F):
        rng = np.random.RandomState(4)
        t = s.createDataFrame(
            {"flag": [int(v) for v in rng.randint(0, 3, n)],
             "status": [int(v) for v in rng.randint(0, 5, n)],
             "qty": [int(v) for v in rng.randint(0, 50, n)]},
            "flag bigint, status bigint, qty bigint", num_partitions=4)
        return (t.filter(F.col("qty") > 4)
                .groupBy("flag", "status")
                .agg(F.sum("qty").alias("sq"), F.count("*").alias("c"))
                .orderBy("flag", "status"))
    want, got, jc, pc, _plan = run_both(fn, TINY_BUDGET, ordered=True)
    assert got == want and len(got) == 15
    assert _planned(jc), jc
    assert _planned(pc), pc


def test_ooc_e2e_8x_over_budget_q3_shape():
    """join + grouped aggregate + limit over budget: the join and the
    aggregate both take the planned tier, with zero retries."""
    def fn(s, F):
        l_, r_ = _join_data(s, n=1600, parts=4)
        return (l_.join(r_, l_["k"] == r_["k2"], "inner")
                .groupBy("k").agg(F.sum("w").alias("sw"),
                                  F.count("*").alias("c"))
                .orderBy("k").limit(50))
    want, got, jc, pc, _plan = run_both(fn, {**NO_BCAST, **TINY_BUDGET},
                                        ordered=True)
    assert got == want and len(got) == 50
    assert _planned(jc), jc
    assert _planned(pc), pc


# ---------------------------------------------------------------------------
# The budget oracle and the site:budget fault
# ---------------------------------------------------------------------------

def test_budget_oracle_pow2_plan():
    o = get_budget_oracle(TorchConf(
        {"spark.rapids.sql.memory.deviceBudgetBytes": "1024"}))
    share = o.operator_share()
    assert share == 512
    assert o.plan_partitions(100) == 1
    n = o.plan_partitions(10 * share)
    assert n == 16 and (n & (n - 1)) == 0
    assert o.plan_partitions(10 ** 9) == o.max_partitions


def test_budget_oracle_disabled_never_partitions():
    o = get_budget_oracle(TorchConf(
        {"spark.rapids.sql.memory.deviceBudgetBytes": "1024",
         "spark.rapids.sql.outOfCore.enabled": "false"}))
    assert o.plan_partitions(10 ** 9) == 1


def test_site_budget_fault_halves_headroom():
    conf = TorchConf({"spark.rapids.sql.memory.deviceBudgetBytes": "4096",
                      "spark.rapids.sql.test.injectOOM": "site:budget:2"})
    o = get_budget_oracle(conf)
    assert [o.headroom() for _ in range(4)] == [4096, 2048, 4096, 2048]
    assert R.get_fault_injector(conf).stats()["budgetFaultsInjected"] == 2


def test_site_budget_fault_escalates_without_retries():
    """Halved headroom on every oracle query plans more partitions,
    never a retry, and the rows stay equal."""
    clean = {**NO_BCAST, **TINY_BUDGET}
    fault = {**clean, "spark.rapids.sql.test.injectOOM": "site:budget:1"}
    _w, _g, _jc, pclean, _p = run_both(_join("inner"), clean)
    want, got, jc, pc, _plan = run_both(_join("inner"), fault)
    assert got == want
    assert pc["plannedPartitions"] >= pclean["plannedPartitions"] > 0
    for c in (jc, pc):
        assert c["retryCount"] == 0 and c["splitRetryCount"] == 0, c
    assert R.get_fault_injector(TorchConf(fault)).stats()[
        "budgetFaultsInjected"] > 0
