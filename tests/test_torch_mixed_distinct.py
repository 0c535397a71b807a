"""Mixed DISTINCT and plain aggregates in the port
(``Planner._rewrite_mixed_distinct``: a distinct-only and a plain
aggregate over one cached child, joined on null-safe key equality)
against the JAX package's on the same data, and ClickBench Q10 and Q9
(``chip_smoke.Q10``, ``Q9``) over ``chip_smoke.hits_tables`` at 20,000
rows against the JAX package's and against the numpy reference the chip
run uses (``chip_smoke.hits_reference``).

Checked: rows exact (averages within 1e-12 relative against numpy;
equal to the JAX package's as values); the null-key group joined 1:1;
the plan all ``Torch*`` with the shuffled join on ``<=>`` and both
aggregates reading one relation, materialised once; the port's plan
fused as the JAX package's; the JAX cases of
``tests/test_device_exec.py`` through ``tests/torch_dual.py``; the
global form (no GROUP BY), which both packages join on the host in a
nested-loop join, with the same rows."""

import pytest
import torch

import test_device_exec
from chip_smoke import (Q9, Q10, Q10_ALL, check_all_groups, check_ranked,
                        hits_batch, hits_reference, hits_tables)
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape
from test_torch_ysb import jax_batch

from spark_rapids_tpu_torch.exec.join import TorchShuffledHashJoinExec
from spark_rapids_tpu_torch.io.cache import CpuCachedScanExec
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows, _sort_key
from tests.torch_dual import assert_all_torch, compare, dual_run, run_case

torch.set_num_threads(2)

N_HITS = 20_000
CONF = {"spark.sql.shuffle.partitions": "8"}

MD = {"k": ["a", "b", None, "a", "b", None, "c", "a"],
      "a": [1, 2, 2, None, 2, 1, None, 3],
      "v": [10, 20, 30, 40, None, 60, 70, 80]}
MD_DDL = "k string, a int, v bigint"

QUERIES = {
    "several_plain": "SELECT k, count(DISTINCT a) cd, sum(v) sv, "
                     "count(v) cv, avg(v) av, min(v) mn, max(a) mx, "
                     "count(*) c FROM md GROUP BY k",
    "distinct_expression": "SELECT k, sum(DISTINCT a + 1) sd, "
                           "count(*) c FROM md GROUP BY k",
    "plain_first": "SELECT max(v) mv, k, count(DISTINCT a) cd FROM md "
                   "GROUP BY k",
    "two_keys": "SELECT k, a, count(DISTINCT v) cd, sum(v) sv FROM md "
                "GROUP BY k, a",
}


def _walk(p):
    yield p
    for n in getattr(p, "fused_ops", []):
        yield n
    for c in p.children:
        yield from _walk(c)


def _run(s, sql, capture=False):
    s.createDataFrame(MD, MD_DDL, num_partitions=3) \
        .createOrReplaceTempView("md")
    if capture:
        s.start_capture()
    rows = sorted(_rows(s.sql(sql)._execute().to_pydict()), key=_sort_key)
    return rows, (s.get_captured_plans()[0] if capture else s.last_plan)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_grouped_mixed_distinct_equals_jax_package(name):
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        want, jplan = _run(js, QUERIES[name], capture=True)
    finally:
        js.stop()
    ps = TorchSparkSession(device="cpu")
    got, plan = _run(ps, QUERIES[name])
    compare([("rows", want, False)], [("rows", got, False)])
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    (join,) = [p for p in _walk(plan)
               if isinstance(p, TorchShuffledHashJoinExec)]
    assert all(join.null_safe)
    scans = [p for p in _walk(plan) if isinstance(p, CpuCachedScanExec)]
    assert len(scans) == 2 and scans[0].rel is scans[1].rel
    assert scans[0].rel.materializations == 1


def test_null_key_group_joins_one_to_one():
    ps = TorchSparkSession(device="cpu")
    rows, _plan = _run(ps, QUERIES["several_plain"])
    null_rows = [r for r in rows if r[0] is None]
    assert null_rows == [(None, 2, 90, 2, 45.0, 30, 2, 2)]
    assert len(rows) == 4


@pytest.mark.parametrize("case", [
    "test_mixed_distinct_and_plain_aggregates_device",
    "test_mixed_distinct_global",
    "test_count_distinct_device",
])
def test_jax_cases(case):
    run_case(test_device_exec, case)


def test_global_form_raises_with_the_fallback_reason():
    """The global form (no GROUP BY) joins its two one-row sides in a
    cross join, a nested-loop join on the host in both packages: the same
    placement and the same rows."""
    def make(s):
        s.createDataFrame(MD, MD_DDL).createOrReplaceTempView("md")
        return s.sql("SELECT count(DISTINCT a) cd, sum(v) sv FROM md")
    jax_rec, port_rec = dual_run(make, make)
    assert port_rec.results[0][1] == [(3, 310)]
    assert any(op == "CpuBroadcastNestedLoopJoinExec"
               for op, _up, _down in jax_rec.results[0][3])


@pytest.fixture(scope="module")
def hits():
    t = hits_tables(N_HITS)
    return t, hits_batch(t), hits_reference(t)


@pytest.fixture(scope="module")
def clickbench(hits):
    """Both packages' rows of Q10, Q9 and Q10's every group, and the
    port's plan of Q10."""
    _t, pb, _want = hits
    js = TpuSparkSession(dict(CONF, **{"spark.rapids.sql.enabled": "true"}))
    ps = TorchSparkSession(dict(CONF), device="cpu")
    out = {}
    try:
        js.createDataFrame(jax_batch(pb), num_partitions=8) \
            .createOrReplaceTempView("hits")
        ps.createDataFrame(pb, num_partitions=8) \
            .createOrReplaceTempView("hits")
        for name, sql in (("q10", Q10), ("q9", Q9), ("q10_all", Q10_ALL)):
            want = [tuple(r) for r in js.sql(sql).collect()]
            got = [tuple(r) for r in ps.sql(sql).collect()]
            out[name] = (want, got, ps.last_plan)
    finally:
        js.stop()
    return out


def test_clickbench_q10_equals_jax_package_and_reference(hits, clickbench):
    want_ref = hits[2]
    jrows, rows, plan = clickbench["q10"]
    assert len(rows) == 10
    check_ranked(rows, want_ref["q10"], 2, "q10")
    check_ranked(jrows, want_ref["q10"], 2, "q10 (JAX)")
    assert_all_torch(plan)
    names = [type(p).__name__ for p in _walk(plan)]
    assert "TorchShuffledHashJoinExec" in names
    assert names.count("CpuCachedScanExec") == 2


def test_clickbench_q10_every_group(hits, clickbench):
    jrows, rows, _plan = clickbench["q10_all"]
    assert check_all_groups(rows, hits[2]["q10"], "q10 all") <= 1e-12
    compare([("rows", sorted(jrows), False)],
            [("rows", sorted(rows), False)])
    assert len(rows) > 1000
    # a user is mostly in one region: about as many (region, user) pairs
    # as users
    assert sum(r[4] for r in rows) > 0.25 * N_HITS


def test_clickbench_q9_equals_jax_package_and_reference(hits, clickbench):
    jrows, rows, plan = clickbench["q9"]
    check_ranked(rows, hits[2]["q9"], 1, "q9")
    check_ranked(jrows, hits[2]["q9"], 1, "q9 (JAX)")
    assert_all_torch(plan)
    assert "CpuCachedScanExec" not in [type(p).__name__
                                       for p in _walk(plan)]


def test_reference_checks_catch_a_wrong_row(hits, clickbench):
    """The chip run's checks refuse a row that is off by one."""
    _jrows, rows, _plan = clickbench["q10"]
    bad = [rows[0][:1] + (rows[0][1] + 1,) + rows[0][2:]] + rows[1:]
    with pytest.raises(AssertionError):
        check_ranked(bad, hits[2]["q10"], 2, "q10")
    with pytest.raises(AssertionError):
        check_ranked(rows[1:] + rows[:1], hits[2]["q10"], 2, "q10")
