"""The port's aggregates against the JAX package's: the JAX package's
own grouped and global aggregate cases (``tests/test_device_exec.py``),
float sums and averages under ``variableFloatAgg``, first/last,
stddev/variance (``tests/torch_dual.py`` runs each case through both
packages), then TPC-H q1 in its double form at a small size against the
JAX package and against a ``math.fsum`` reference, and the segmented
scans of ``ops/groupby`` against numpy. Float sums are held within
rel_tol=1e-12 (their addition order is the port's own log-step scan,
not XLA's), everything else exactly."""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (Q1, check_q1_double_rows, lineitem_arrays,
                        lineitem_double_arrays, lineitem_double_fields,
                        q1_double_reference)
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_exec as JX
from tests.torch_dual import (assert_all_torch, dual_run, rows_close,
                              run_case)

torch.set_num_threads(2)

FLOAT_AGG = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}


@pytest.mark.parametrize("keygen", ["int_keys", "string_keys", "bool_keys",
                                    "date_keys"])
def test_grouped_agg_basic(keygen):
    from tests.datagen import BooleanGen, DateGen, KeyStringGen, SmallIntGen
    run_case(JX, "test_grouped_agg_basic",
             {"int_keys": SmallIntGen(), "string_keys": KeyStringGen(),
              "bool_keys": BooleanGen(), "date_keys": DateGen()}[keygen])


CASES = ["test_grouped_agg_long_extremes", "test_grouped_avg_int",
         "test_grouped_agg_multi_key", "test_grouped_min_max_string",
         "test_global_agg", "test_global_agg_empty_input",
         "test_agg_with_expr_key", "test_float_agg_opt_in",
         "test_float_min_max_on_device", "test_first_last_agg",
         "test_stddev_variance_device", "test_full_pipeline_on_device"]


@pytest.mark.parametrize("name", CASES)
def test_agg_case(name):
    rec = run_case(JX, name)
    if name == "test_float_agg_opt_in":
        # variableFloatAgg off: the JAX package's reason, word for word
        assert "device float sum/average may differ from CPU due to " \
            "addition ordering" in rec.messages[0]


@pytest.mark.parametrize("func,reason", [
    ("stddev", "device stddev/variance may differ from CPU"),
    ("avg", "device float sum/average may differ from CPU")])
def test_float_aggregates_refused_without_variable_float_agg(func, reason):
    """With ``variableFloatAgg`` off both packages keep the float
    aggregate on the host, for the same reason, and give the same rows
    (within rel_tol=1e-12)."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu_torch.sql import functions as PF

    def make(s, F):
        return s.createDataFrame(
            {"k": ["a", "b", "a"], "v": [1.0, 2.0, 3.0]},
            "k string, v double").groupBy("k").agg(
            getattr(F, func)("v").alias("x"))
    jax_rec, port_rec = dual_run(lambda s: make(s, JF),
                                 lambda s: make(s, PF), approx=True)
    assert reason in port_rec.messages[0]
    assert [op for op, _up, _down in jax_rec.results[0][3]] == \
        ["CpuHashAggregateExec"] * 2


@pytest.mark.parametrize("func", ["first", "last"])
@pytest.mark.parametrize("ignorenulls", [True, False])
def test_first_last_by_row_order(func, ignorenulls):
    """First/last per group over the row order of one partition, nulls
    taken or skipped, against a plain Python reference."""
    from spark_rapids_tpu_torch.sql import functions as PF
    rng = np.random.default_rng(5)
    k = rng.integers(0, 7, 400).tolist()
    v = [None if rng.random() < 0.3 else int(x)
         for x in rng.integers(-50, 50, 400)]
    s = TorchSparkSession(device="cpu")
    df = s.createDataFrame({"k": k, "v": v}, "k int, v int",
                           num_partitions=1)
    got = {r[0]: r[1] for r in df.groupBy("k").agg(
        getattr(PF, func)("v", ignorenulls=ignorenulls).alias("x"))
        .collect()}
    want = {}
    for kk, vv in zip(k, v):
        seen = kk in want
        if ignorenulls and vv is None:
            want.setdefault(kk, None)
        elif func == "last" or not seen or (ignorenulls
                                             and want[kk] is None):
            want[kk] = vv
    assert got == want


N_Q1 = 4000


def _jax_double_batch(arrays):
    n = len(arrays[0])
    types = [JT.DoubleT] * 4 + [JT.StringT, JT.StringT, JT.DateT]
    names = [f for f, _t in lineitem_double_fields()]
    schema = JT.StructType([JT.StructField(nm, t)
                            for nm, t in zip(names, types)])
    return JHostBatch(schema, [
        JHostColumn(f.data_type, np.asarray(a), np.ones(n, bool))
        for f, a in zip(schema.fields, arrays)], n)


@pytest.fixture(scope="module")
def q1_double():
    darrays = lineitem_double_arrays(lineitem_arrays(N_Q1))
    sql = Q1.replace("FROM lineitem", "FROM t")
    jax_s = TpuSparkSession(dict(FLOAT_AGG, **{
        "spark.rapids.sql.enabled": "true",
        "spark.sql.shuffle.partitions": "4"}))
    try:
        jax_s.createDataFrame(_jax_double_batch(darrays),
                              num_partitions=3).createOrReplaceTempView("t")
        jax_s.start_capture()
        want = [tuple(r) for r in jax_s.sql(sql).collect()]
        (jplan,) = jax_s.get_captured_plans()
    finally:
        jax_s.stop()
    port = TorchSparkSession(dict(FLOAT_AGG, **{
        "spark.sql.shuffle.partitions": "4"}), device="cpu")
    port.createDataFrame(host_batch_from_numpy(lineitem_double_fields(),
                                               darrays),
                         num_partitions=3).createOrReplaceTempView("t")
    got = [tuple(r) for r in port.sql(sql).collect()]
    return darrays, want, jplan, got, port.last_plan


def test_q1_double_rows_against_jax_package(q1_double):
    _d, want, _jplan, got, _plan = q1_double
    assert len(want) == 6
    rows_close(want, got, approx=True)


def test_q1_double_against_fsum_reference(q1_double):
    darrays, _want, _jplan, got, _plan = q1_double
    assert check_q1_double_rows(got, q1_double_reference(darrays)) <= 1e-12


def test_q1_double_plan_and_stages_equal_jax_package(q1_double):
    _d, _want, jplan, _got, plan = q1_double
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)


def test_seg_running_sum_resets_at_segments():
    """Float sums per segment from the log-step scan, against fsum; the
    lane layout (rows, lanes) gives each lane its own sums."""
    rng = np.random.default_rng(3)
    n = 1000
    starts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
    marker = np.zeros(n, dtype=np.int64)
    for s in starts:
        marker[s:] = s
    x = rng.normal(0, 1e6, (n, 3))
    run = G.seg_running_sum(torch.from_numpy(marker),
                            torch.from_numpy(x)).numpy()
    ends = list(starts - 1) + [n - 1]
    begin = [0] + list(starts)
    for b, e in zip(begin, ends):
        for lane in range(3):
            want = math.fsum(x[b:e + 1, lane])
            assert math.isclose(run[e, lane], want, rel_tol=1e-12,
                                abs_tol=1e-3)


def test_has_nans_false_groups_without_the_nan_word():
    """hasNans=false drops the is-NaN key word; NaN-free float keys group
    the same either way."""
    from spark_rapids_tpu_torch.sql import functions as PF
    rows = {"k": [1.5, -0.0, 0.0, 2.5, 1.5], "v": [1, 2, 3, 4, 5]}
    out = []
    for flag in ("true", "false"):
        s = TorchSparkSession({"spark.rapids.sql.hasNans": flag},
                              device="cpu")
        df = s.createDataFrame(rows, "k double, v long")
        out.append(sorted(tuple(r) for r in df.groupBy("k").agg(
            PF.sum("v").alias("s")).collect()))
    assert out[0] == out[1] == [(0.0, 5), (1.5, 6), (2.5, 4)]
    assert G.kernel_salt() == (False,)
    TorchSparkSession(device="cpu")
    assert G.kernel_salt() == (True,)
