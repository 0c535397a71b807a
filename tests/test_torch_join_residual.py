"""Residual (non-equi) join conditions in the port, held against the JAX
package on the CPU.

The JAX package's own cases (``tests/test_device_join.py``): an inner
join with a residual runs on the device in both packages with equal
rows; a conditional outer join runs on the host in both packages, placed
alike, with equal rows and the JAX package's reason. Inner joins with residuals over string, decimal and
double columns run on every route the port has: the broadcast stream,
the shuffled co-partition, their chunked forms (``batchSizeRows`` 256)
and the out-of-core bucket pairs (a tiny device budget); the rows equal
the JAX package's, exactly. TPC-H q19 (its OR in the join condition) at
60,000 lineitem rows and 2,000 parts, from memory and from Parquet,
gives the rows of the JAX package and of the numpy reference
(``chip_smoke.q19_reference``), with the plan all ``Torch*`` and its
fused stages equal to the JAX package's.
"""

import decimal
import os

import numpy as np
import pytest
import torch

from chip_smoke import Q19, plan_nodes_of, q19_reference, q19_tables
from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_q12 import _jax_batch, _torch_batch
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

import tests.test_device_join as TDJ
from tests.torch_dual import assert_all_torch, run_case

torch.set_num_threads(2)

_KEYS = ("plannedPartitions", "retryCount", "fkFastPathJoins",
         "aqeBroadcastFlip")


@pytest.fixture(autouse=True)
def _fresh_injection():
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()


def test_inner_join_with_condition_matches_jax_package():
    rec = run_case(TDJ, "test_join_inner_with_condition")
    assert rec.results[0][0] == "rows" and rec.results[0][1]


def test_conditional_outer_join_refused_with_jax_reason():
    """The JAX package keeps a conditional outer join on its CPU; the
    port runs it on its host engine at the same place, for the JAX
    package's reason, with the same rows."""
    rec = run_case(TDJ, "test_conditional_outer_join_falls_back")
    (msg,) = rec.messages
    assert ("conditional left join runs on CPU (residual conditions are "
            "device-filtered for inner joins only)") in msg, msg
    assert rec.results[0][1] and [op for op, _up, _down in
                                  rec.results[0][3]] == [
        "CpuBroadcastHashJoinExec"]


def run_both(df_fn, conf):
    """``(JAX rows, port rows, JAX counters, port counters, JAX plan,
    port plan)`` of ``df_fn(session, functions)`` under ``conf``, rows
    sorted."""
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        jax_s.start_capture()
        want = [tuple(r) for r in df_fn(jax_s, JF).collect()]
        (jplan,) = jax_s.get_captured_plans()
        jm = registry_snapshot(plans=[jplan])["metrics"]
    finally:
        jax_s.stop()
    port = TorchSparkSession(dict(conf), device="cpu")
    got = [tuple(r) for r in df_fn(port, PF).collect()]
    pm = plan_metrics(port.last_plan)
    for node in plan_nodes_of(port.last_plan):
        for k, v in getattr(node, "route_counts", {}).items():
            pm[k] = pm.get(k, 0) + v
    return (sorted(want, key=repr), sorted(got, key=repr),
            {k: int(jm.get(k, 0)) for k in _KEYS},
            {k: int(pm.get(k, 0)) for k in _KEYS}, jplan, port.last_plan)



def _frames(spark, n=900, seed=17):
    """A pair of frames over int keys with string, decimal(15,2) and
    double payloads (a tenth of each payload null), the left side in 3
    partitions of 300 rows (over the chunked routes' 256); about 22 and
    11 rows per key, so each key joins ~250 pairs before the residual."""
    rng = np.random.RandomState(seed)

    def side(n, sfx):
        keys = rng.randint(0, 40, n)
        strs = [None if i % 10 == 3 else f"s{v:03d}"
                for i, v in enumerate(rng.randint(0, 500, n))]
        decs = [None if i % 10 == 5 else decimal.Decimal(int(v)).scaleb(-2)
                for i, v in enumerate(rng.randint(-99999, 99999, n))]
        dbls = [None if i % 10 == 7 else float(v)
                for v, i in zip(rng.standard_normal(n) * 100, range(n))]
        return spark.createDataFrame(
            {f"k{sfx}": [int(k) for k in keys], f"s{sfx}": strs,
             f"d{sfx}": decs, f"x{sfx}": dbls},
            f"k{sfx} bigint, s{sfx} string, d{sfx} decimal(15,2), "
            f"x{sfx} double", num_partitions=3)
    return side(n, ""), side(n // 2, "2")


RESIDUALS = {
    "string": lambda l_, r_: l_["s"] < r_["s2"],
    "decimal": lambda l_, r_: (l_["d"] + r_["d2"]) > 0,
    "double": lambda l_, r_: (l_["x"] * 2.0) > r_["x2"],
}

ROUTES = {
    "broadcast": {},
    "broadcast_chunked": {"spark.rapids.sql.batchSizeRows": "256"},
    "shuffled": {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"},
    "shuffled_chunked": {"spark.rapids.sql.autoBroadcastJoinThreshold":
                         "-1", "spark.rapids.sql.batchSizeRows": "256"},
    "out_of_core": {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1",
                    "spark.rapids.sql.memory.deviceBudgetBytes": "8192"},
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", list(RESIDUALS))
def test_residual_on_every_route(kind, route):
    def fn(s, F):
        l_, r_ = _frames(s)
        if route == "broadcast_chunked":
            # a broadcast stream partition chunks by batches: the user
            # exchange leaves 3 batches (one per input) in each
            l_ = l_.repartition(2, "k")
        cond = (l_["k"] == r_["k2"]) & RESIDUALS[kind](l_, r_)
        return l_.join(r_, cond, "inner")

    want, got, jc, pc, _jplan, plan = run_both(fn, ROUTES[route])
    assert got == want and got
    names = [type(p).__name__ for p in plan_nodes_of(plan)]
    assert_all_torch(plan)
    if route.startswith("broadcast"):
        assert "TorchBroadcastHashJoinExec" in names
    else:
        assert "TorchShuffledHashJoinExec" in names
    # a condition never takes the FK fast path, in either package
    assert jc["fkFastPathJoins"] == pc["fkFastPathJoins"] == 0
    (join,) = [p for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]
    if route.endswith("chunked"):
        # each stream partition (2 broadcast, 1 shuffled) joined in
        # chunks of at most 256 rows
        parts = 2 if route.startswith("broadcast") else 1
        assert join.metrics.value("numOutputBatches") > parts
    if route == "out_of_core":
        assert join.metrics.value("plannedPartitions") > 0
        assert jc["plannedPartitions"] > 0
    assert pc["retryCount"] == jc["retryCount"] == 0


# ---------------------------------------------------------------------------
# TPC-H q19 at a small size

N_LINEITEM = 60_000
N_PART = 2_000
N_ORDERS = 15_000
CONF = {"spark.sql.shuffle.partitions": "4"}
PARTS = {"lineitem": 3, "orders": 2, "part": 2}


@pytest.fixture(scope="module")
def q19_data():
    return q19_tables(N_LINEITEM, N_PART, N_ORDERS)


@pytest.fixture(scope="module")
def q19_runs(q19_data, tmp_path_factory):
    """``{source: (jax rows, jax plan, port rows, port plan)}``."""
    base = str(tmp_path_factory.mktemp("q19"))
    tables = {k: v for k, v in q19_data.items() if k != "orders"}
    writer = TorchSparkSession(device="cpu")
    paths = {}
    for name, cols in tables.items():
        paths[name] = os.path.join(base, name)
        writer.createDataFrame(_torch_batch(cols),
                               num_partitions=PARTS[name]) \
            .write.mode("overwrite").parquet(paths[name])
    out = {}
    jax_s = TpuSparkSession(dict(CONF, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        for source in ("memory", "parquet"):
            port = TorchSparkSession(dict(CONF), device="cpu")
            for name, cols in tables.items():
                if source == "memory":
                    jax_s.createDataFrame(_jax_batch(cols),
                                          num_partitions=PARTS[name]) \
                        .createOrReplaceTempView(name)
                    port.createDataFrame(_torch_batch(cols),
                                         num_partitions=PARTS[name]) \
                        .createOrReplaceTempView(name)
                else:
                    jax_s.read.parquet(paths[name]) \
                        .createOrReplaceTempView(name)
                    port.read.parquet(paths[name]) \
                        .createOrReplaceTempView(name)
            jax_s.start_capture()
            want = [tuple(r) for r in jax_s.sql(Q19).collect()]
            (jplan,) = jax_s.get_captured_plans()
            got = [tuple(r) for r in port.sql(Q19).collect()]
            out[source] = (want, jplan, got, port.last_plan)
    finally:
        jax_s.stop()
    return out


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q19_rows_identical_to_jax_package_and_reference(q19_runs, q19_data,
                                                         source):
    want, _jplan, got, _plan = q19_runs[source]
    ref, kept = q19_reference(q19_data)
    assert kept > 0 and ref[0][0] is not None
    assert want == ref
    assert got == want
    assert got[0][0].as_tuple().exponent == -4


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q19_plan_all_torch_with_the_residual_in_the_join(q19_runs, source):
    _want, jplan, _got, plan = q19_runs[source]
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    (join,) = [p for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]
    assert join.condition is not None and join.join_type == "inner"
    assert "Or(" in repr(join.condition) or " OR " in repr(join.condition)
    if source == "parquet":
        assert plan_metrics(plan).get("deviceDecodedBatches", 0) > 0
