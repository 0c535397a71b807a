"""The per-operator CPU fallback in the port against the JAX package's, on
the CPU: for each query both packages run it (the JAX package's device
path with its kernels interpreted, the port with ``device="cpu"``), and
three things must be equal:

- the rows (exact; ordered where the query orders them);
- the placement: the same operators on the host, with the same
  neighbours above and below them (``tests/torch_dual.placement``),
  and the same plans with their fused stages
  (``test_torch_runtime.fused_shape``), a cached relation's
  materialisation included;
- the explain lines each rewrite prints under
  ``spark.rapids.sql.explain=ALL`` (every device operator and every
  fallback with its reason), after ``Torch``->``Tpu`` and ``GPU``->``TPU``
  and with expression ids blanked; the report's ``coverage`` and
  ``reason_counts`` too.

The queries: TPC-H q13 (``chip_smoke.Q13``, its conditional left outer
join on the host) broadcast and shuffled, and with
``spark.rapids.sql.expression.Like=false``; TPC-DS q28 (``chip_smoke.Q28``,
11 nested-loop joins on the host); conditional left, right and full
outer joins; non-equi inner and cross joins; the global mixed DISTINCT;
TPC-H q1 with each of five ``spark.rapids.sql.exec.<Op>=false``; ANSI
casts in join keys; ``split`` and ``collect_list``; a pandas UDF in a
filter and in a sort key; an ``F.udf`` the compiler does not take. Each
also under ``spark.rapids.sql.test.forceDevice=true``, where both
packages raise ``AssertionError``. The JAX package's own fallback cases
of ``tests/test_device_exec.py`` and its global mixed DISTINCT run
through ``tests/torch_dual.py``. q13, q28 and q1 are also held against
their numpy references. Last, the cost model's island reversal
(``_revert_small_islands``) decides as the JAX package's on the same
islands when both are given the same constants."""

import contextlib
import io
import re
import signal

import numpy as np
import pytest
import torch

from chip_smoke import (Q1, Q13, Q28, check_q1_rows, check_q28_rows,
                        lineitem_arrays, lineitem_fields, q1_reference,
                        q13_batches, q13_reference, q13_tables, q28_batch,
                        q28_reference, q28_tables)
from spark_rapids_tpu import overrides as JO
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.sql import expressions as JE
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch import overrides as PO
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_exec as JX
from tests.harness import _rows, _sort_key
from tests.support import values_equal
from tests.torch_dual import placement, run_case

torch.set_num_threads(2)

PARTS = {"spark.sql.shuffle.partitions": "4"}
SHUFFLED = {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"}
# the JAX package's upload ring hangs over a host aggregate (its producer
# thread waits for the permit its own task holds): its side runs such a
# query with the ring off
NO_RING = {"spark.rapids.sql.format.parquet.deviceDecode.maxInFlight": "0"}
ONE_PERMIT_RING = {"spark.rapids.sql.concurrentGpuTasks": "1",
                   "spark.rapids.sql.format.parquet.deviceDecode"
                   ".maxInFlight": "2"}
LIMIT_S = 120


def jax_type(pt):
    if isinstance(pt, PT.DecimalType):
        return JT.DecimalType(pt.precision, pt.scale)
    if isinstance(pt, PT.ArrayType):
        return JT.ArrayType(jax_type(pt.element_type))
    return getattr(JT, type(pt).__name__)()


def jax_batch(pb) -> JHostBatch:
    """A port HostBatch's numpy columns as a JAX package HostBatch."""
    schema = JT.StructType([JT.StructField(f.name, jax_type(f.data_type))
                            for f in pb.schema.fields])
    return JHostBatch(schema, [
        JHostColumn(f.data_type, c.data, c.validity)
        for f, c in zip(schema.fields, pb.columns)], pb.num_rows)


class Pkg:
    """What a function that makes a query needs of one package."""

    def __init__(self, port: bool):
        self.port = port
        self.F = PF if port else JF
        self.E = PE if port else JE
        self.T = PT if port else JT

    def table(self, s, name: str, pb, parts: int = 4) -> None:
        s.createDataFrame(pb if self.port else jax_batch(pb),
                          num_partitions=parts).createOrReplaceTempView(name)


def normalize(text: str) -> str:
    """The port's words as the JAX package's, expression ids blanked."""
    text = text.replace("Torch", "Tpu").replace("GPU", "TPU")
    return re.sub(r"#\d+", "#", text)


def run(build, conf: dict, port: bool):
    """``(rows, (placement, fused shapes), printed explain text, the
    query's report)`` of one package, over every plan that ran the query
    (a cached relation's materialisation too)."""
    conf = dict(PARTS, **conf, **{"spark.rapids.sql.explain": "ALL"})
    pkg = Pkg(port)
    if port:
        s = TorchSparkSession(conf, device="cpu")
    else:
        s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    out = io.StringIO()
    try:
        df = build(s, pkg)
        s.start_capture()
        with contextlib.redirect_stdout(out):
            rows = _rows(df._execute().to_pydict())
        plans = s.get_captured_plans()
        shapes = sorted(repr(fused_shape(p)) for p in plans)
        return (rows, (placement(plans), shapes), out.getvalue(),
                s.last_rewrite_report)
    finally:
        if not port:
            s.stop()


def both(build, conf=None, ordered: bool = False, jax_conf=None):
    """Run ``build`` on both packages (``jax_conf`` added on the JAX
    package's side only) and hold rows, placement, explain lines,
    coverage and reason counts equal; returns the port's rows, placement
    and report."""
    conf = dict(conf or {})
    jrows, jplace, jtext, jrep = run(build, dict(conf, **(jax_conf or {})),
                                     port=False)
    prows, pplace, ptext, prep = run(build, conf, port=True)
    if not ordered:
        jrows = sorted(jrows, key=_sort_key)
        prows = sorted(prows, key=_sort_key)
    assert len(jrows) == len(prows), (len(jrows), len(prows))
    for jr, pr in zip(jrows, prows):
        for a, b in zip(jr, pr):
            assert values_equal(a, b, False), (jr, pr)
    assert jplace == pplace, (jplace, pplace)
    jplace, pplace = jplace[0], pplace[0]
    assert normalize(ptext) == re.sub(r"#\d+", "#", jtext), (jtext, ptext)
    assert prep.coverage == jrep.coverage
    assert {normalize(k): v for k, v in prep.reason_counts().items()} == \
        {re.sub(r"#\d+", "#", k): v for k, v in jrep.reason_counts().items()}
    assert [(normalize(n), [normalize(r) for r in rs])
            for n, rs in prep.fallbacks] \
        == [(n, [re.sub(r"#\d+", "#", r) for r in rs])
            for n, rs in jrep.fallbacks]
    return prows, pplace, prep


@contextlib.contextmanager
def time_limit():
    def expire(_sig, _frame):
        raise TimeoutError(f"the query ran over {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def force_device_raises(build, conf=None) -> None:
    """Under ``spark.rapids.sql.test.forceDevice=true`` any fallback is an
    ``AssertionError``, in both packages."""
    for port in (False, True):
        with pytest.raises(AssertionError, match="forceDevice"):
            run(build, dict(conf or {},
                            **{"spark.rapids.sql.test.forceDevice": "true"}),
                port)


# -- the data --------------------------------------------------------------

@pytest.fixture(scope="module")
def q13():
    t = q13_tables(300, 3000)
    return q13_batches(t), q13_reference(t)


@pytest.fixture(scope="module")
def q28():
    t = q28_tables(4000)
    return q28_batch(t), q28_reference(t)


@pytest.fixture(scope="module")
def lineitem():
    arrays = lineitem_arrays(3000)
    return host_batch_from_numpy(lineitem_fields(), arrays), arrays


def _q13(batches):
    def build(s, pkg):
        pkg.table(s, "customer", batches["customer"])
        pkg.table(s, "orders", batches["orders"])
        return s.sql(Q13)
    return build


def _sides():
    left = host_batch_from_numpy(
        [("k", PT.IntegerT), ("a", PT.LongT), ("s", PT.StringT)],
        [np.array([1, 2, 2, 3, 5, 7], np.int32),
         np.array([10, 20, 25, 30, 50, 70], np.int64),
         np.array(["1", "2", "2", "x3", "5", "7"], dtype=object)])
    right = host_batch_from_numpy(
        [("k2", PT.IntegerT), ("b", PT.LongT)],
        [np.array([2, 2, 3, 4, 5, 5], np.int32),
         np.array([15, 30, 35, 40, 45, 60], np.int64)])
    return left, right


def _joined(sql: str):
    def build(s, pkg):
        left, right = _sides()
        pkg.table(s, "l", left, 2)
        pkg.table(s, "r", right, 2)
        return s.sql(sql)
    return build


JOINS = {
    "left_conditional": "SELECT * FROM l LEFT JOIN r ON k = k2 AND a < b",
    "right_conditional": "SELECT * FROM l RIGHT JOIN r ON k = k2 AND a < b",
    "full_conditional": "SELECT * FROM l FULL OUTER JOIN r "
                        "ON k = k2 AND a < b",
    "non_equi_inner": "SELECT * FROM l JOIN r ON a < b",
    "cross": "SELECT * FROM l CROSS JOIN r",
    "global_mixed_distinct": "SELECT count(DISTINCT k2), sum(b), "
                             "max(b) FROM r",
}


# -- the queries -----------------------------------------------------------

@pytest.mark.parametrize("form", ["broadcast", "shuffled", "like_off"])
def test_q13(q13, form):
    batches, want = q13
    conf = {"broadcast": {}, "shuffled": SHUFFLED,
            "like_off": dict(SHUFFLED, **{
                "spark.rapids.sql.expression.Like": "false"})}[form]
    rows, where, _rep = both(_q13(batches), conf, ordered=True)
    assert rows == want
    joins = [(op, up, down) for op, up, down in where if "Join" in op]
    assert len(joins) == 1 and joins[0][1] == "device", where
    assert joins[0][2] == (("source", "device") if form == "broadcast"
                           else ("device", "device")), where
    force_device_raises(_q13(batches), conf)


def test_q28(q28):
    pb, want = q28

    def build(s, pkg):
        pkg.table(s, "store_sales", pb)
        return s.sql(Q28)
    rows, where, rep = both(build, ordered=True)
    check_q28_rows(rows, want, "q28")
    loops = [w for w in where if w[0] == "CpuBroadcastNestedLoopJoinExec"]
    assert len(loops) == 11, where
    assert "CpuHashAggregateExec" not in {w[0] for w in where}
    assert rep.coverage < 1.0
    force_device_raises(build)


@pytest.mark.parametrize("name", sorted(JOINS))
def test_joins(name):
    build = _joined(JOINS[name])
    _rows_, where, _rep = both(build)
    assert any(op.startswith("Cpu") for op, _u, _d in where)
    force_device_raises(build)


@pytest.mark.parametrize("op", ["HashAggregateExec", "SortExec",
                                "ShuffleExchangeExec", "ProjectExec",
                                "FilterExec"])
def test_q1_with_an_operator_off(lineitem, op):
    pb, arrays = lineitem

    def build(s, pkg):
        pkg.table(s, "lineitem", pb)
        return s.sql(Q1)
    conf = {f"spark.rapids.sql.exec.{op}": "false"}
    rows, where, rep = both(build, conf, ordered=True, jax_conf=NO_RING)
    check_q1_rows(rows, q1_reference(arrays))
    assert {w[0] for w in where} == {f"Cpu{op}"}, where
    assert all(f"spark.rapids.sql.exec.{op}=false" in r
               for r in rep.reason_counts())
    force_device_raises(build, conf)
    if op == "HashAggregateExec":
        # where the JAX package hangs: one permit, the ring two units deep
        # over the host aggregates, under a time limit
        with time_limit():
            rows, _shape, _text, _rep = run(build,
                                            dict(conf, **ONE_PERMIT_RING),
                                            port=True)
        check_q1_rows(rows, q1_reference(arrays))


def _ansi_join(s, pkg):
    left, right = _sides()
    pkg.table(s, "l", left, 2)
    pkg.table(s, "r", right, 2)
    F, E, T = pkg.F, pkg.E, pkg.T
    key = E.Cast(F.col("k").expr, T.LongT, ansi=True)
    return s.table("l").join(s.table("r"),
                             F.Column(E.EqualTo(key, F.col("k2").expr)))


def test_ansi_casts_in_join_keys():
    """The broadcast form runs with the join on the host. In the shuffled
    form the key's exchange stays on the host at the planner's partition
    count while the other side's, on the device, coalesces to one, and
    the JAX package's host join fails on the mismatch; the port plans it
    alike and fails alike."""
    rows, where, rep = both(_ansi_join)
    assert len(rows) == 7
    assert "ANSI casts in join keys run on CPU" in rep.reason_counts()
    force_device_raises(_ansi_join)
    texts = []
    for port in (False, True):
        conf = dict(PARTS, **SHUFFLED, **{"spark.rapids.sql.explain": "ALL"})
        s = TorchSparkSession(conf, device="cpu") if port else \
            TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
        df = _ansi_join(s, Pkg(port))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            plan = s.plan_physical(df.plan)
        texts.append((placement([plan]), out.getvalue()))
        with pytest.raises(AssertionError, match="co-partitioned"):
            df.collect()
    (jplace, jtext), (pplace, ptext) = texts
    assert jplace == pplace and normalize(ptext) == normalize(jtext)
    assert "ANSI casts in partition keys run on CPU" in ptext


def _arrays(s, pkg):
    pb = host_batch_from_numpy(
        [("k", PT.IntegerT), ("s", PT.StringT), ("v", PT.LongT)],
        [np.array([1, 2, 1, 3, 2], np.int32),
         np.array(["a,b", "c", "", "d,e,f", None], dtype=object),
         np.array([5, 6, 7, 8, 9], np.int64)])
    pb.columns[1].validity[4] = False
    pkg.table(s, "t", pb, 2)
    return s.table("t")


@pytest.mark.parametrize("shape", ["split", "collect_list"])
def test_split_and_collect_list(shape):
    def build(s, pkg):
        F = pkg.F
        df = _arrays(s, pkg)
        if shape == "split":
            return df.select("k", F.split("s", ",").alias("p"))
        return df.groupBy("k").agg(F.collect_list("v").alias("l"))
    _rows_, where, _rep = both(build)
    assert where
    force_device_raises(build)


def twice(v):
    return v * 2


@pytest.mark.parametrize("where_", ["filter", "sort_key"])
def test_pandas_udf_in_filter_and_sort_key(where_):
    pytest.importorskip("pandas")

    def build(s, pkg):
        F = pkg.F
        df = _arrays(s, pkg)
        u = F.pandas_udf(twice, "long")
        if where_ == "filter":
            return df.filter(u("v") > 13)
        return df.orderBy(u("v"))
    _rows_, where, rep = both(build, ordered=where_ == "sort_key")
    assert any("PandasUDF" in r for r in rep.reason_counts())
    force_device_raises(build)


def test_uncompiled_udf():
    def build(s, pkg):
        F = pkg.F
        u = F.udf(lambda x: int(str(x)) + 1, "int")
        return _arrays(s, pkg).select("k", u(F.col("v")).alias("u"))
    conf = {"spark.rapids.sql.udfCompiler.enabled": "true"}
    _rows_, where, rep = both(build, conf)
    assert any("PythonUDF" in r for r in rep.reason_counts())
    force_device_raises(build, conf)


def test_explain_string_shows_the_placement(q13):
    """``DataFrame.explain``'s text ends with the report: the fallback
    lines, and under ``ALL`` every device operator too; planning for it
    prints nothing of its own."""
    batches, _want = q13
    s = TorchSparkSession(dict(SHUFFLED, **{"spark.rapids.sql.explain":
                                            "NOT_ON_GPU"}), device="cpu")
    Pkg(True).table(s, "customer", batches["customer"])
    Pkg(True).table(s, "orders", batches["orders"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        text = s.explain_string(s.sql(Q13).plan)
    assert out.getvalue() == ""
    placement_ = text.split("== Placement ==\n")[1].splitlines()
    assert placement_ == [
        "!Exec <CpuShuffledHashJoinExec> cannot run on GPU because "
        "conditional left join runs on CPU (residual conditions are "
        "device-filtered for inner joins only)"]
    with contextlib.redirect_stdout(out):
        s.sql(Q13).collect()
    assert out.getvalue().splitlines() == placement_


def test_sql_disabled_runs_no_rewrite(q13):
    batches, want = q13
    s = TorchSparkSession({"spark.rapids.sql.enabled": "false"},
                          device="cpu")
    Pkg(True).table(s, "customer", batches["customer"])
    Pkg(True).table(s, "orders", batches["orders"])
    assert [tuple(r) for r in s.sql(Q13).collect()] == want
    assert s.last_rewrite_report is None
    assert not PO.has_device_op(s.last_plan)


# the JAX package's own fallback cases (``assert_tpu_fallback_collect``)
# and its global mixed DISTINCT, through ``tests/torch_dual.py``
JAX_FALLBACK_CASES = ["test_float_agg_opt_in", "test_fallback_disabled_exec",
                      "test_fallback_disabled_expression",
                      "test_incompat_substring_gated",
                      "test_collect_list_and_set",
                      "test_mixed_distinct_global"]


@pytest.mark.parametrize("case", JAX_FALLBACK_CASES)
def test_jax_fallback_cases(case):
    rec = run_case(JX, case)
    assert any(r[3] for r in rec.results), rec.results


# -- the cost model ----------------------------------------------------------

# each island: a device chain between a Python UDF's projection below it
# and one above it, so both of its ends are transitions
ISLANDS = {
    "wide_cheap_project": (lambda F, df: df.select(
        (F.col("a") + 1).alias("x"), "k"), ["x", "k"]),
    "like_filter": (lambda F, df: df.filter(F.col("s").like("%2%")),
                    ["k", "a", "s"]),
    "chain": (lambda F, df: df.filter(F.col("a") > 15).select(
        "k", (F.col("a") * 2).alias("y"), "s").filter(F.col("y") < 100),
        ["k", "y", "s"]),
}


@pytest.mark.parametrize("name", sorted(ISLANDS))
@pytest.mark.parametrize("wire,flat", [(150e6, 0.15), (2e12, 1e-9)])
def test_revert_small_islands_decides_as_the_jax_package(monkeypatch, name,
                                                         wire, flat):
    """A device island between two Python UDF projections (on the host in
    both packages): both packages' cost models, given the same
    constants, revert it or keep it alike, with the same rows and
    placement."""
    for mod in (JO, PO):
        monkeypatch.setattr(mod, "_WIRE_BYTES_PER_S", wire)
        monkeypatch.setattr(mod, "_ISLAND_FLAT_S", flat)
    island, cols = ISLANDS[name]

    def build(s, pkg):
        F = pkg.F
        left, _right = _sides()
        pkg.table(s, "l", left, 2)
        u = F.udf(lambda x: x, "bigint")
        df = s.table("l").select("k", u(F.col("a")).alias("a"), "s")
        return island(F, df).select(*cols, u(F.col("k")).alias("z"))
    _rows_, where, rep = both(build, {
        "spark.rapids.sql.optimizer.enabled": "true"})
    reverted = any("outweighs" in r for r in rep.reason_counts())
    assert reverted == (wire < 1e9), rep.fallbacks


# -- a gap of the port raises, never goes to the host ------------------------

GAP_SQL = "SELECT k + 1 AS k1, sum(v) AS s FROM t GROUP BY k + 1"


def _gap_table(s, pkg) -> None:
    pb = host_batch_from_numpy([("k", PT.LongT), ("v", PT.LongT)],
                               [np.arange(12) % 4, np.arange(12)])
    pkg.table(s, "t", pb)


def test_port_gap_raises_and_records_no_fallback():
    """An aggregate whose result list computes a grouping key: the JAX
    package's rewrite places the whole plan on its device (no fallback;
    its device aggregate then refuses the result list when it runs), and
    the port has not ported that result list (``unsupported_agg_reason``),
    so its rewrite raises ``NotImplementedError`` and places nothing on
    the host."""
    from spark_rapids_tpu.ops.exprs import DeviceUnsupported
    js = TpuSparkSession(dict(PARTS, **{"spark.rapids.sql.enabled":
                                        "true"}))
    try:
        _gap_table(js, Pkg(False))
        jdf = js.sql(GAP_SQL)
        jplan = js.plan_physical(jdf.plan)
        assert js.last_rewrite_report.fallbacks == []
        assert placement([jplan]) == []
        with pytest.raises(DeviceUnsupported, match="agg result expr"):
            jdf.collect()
    finally:
        js.stop()
    s = TorchSparkSession(dict(PARTS), device="cpu")
    _gap_table(s, Pkg(True))
    cpu = s._plan_cpu(s.sql(GAP_SQL).plan)
    report = PO.RewriteReport()
    with pytest.raises(NotImplementedError,
                       match="aggregate result expression .* is not "
                             "ported yet.*does not yet"):
        PO.apply_overrides(cpu, s.conf_obj, s.device, report, False)
    assert report.fallbacks == []
