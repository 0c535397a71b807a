"""TPC-DS q3 in both of its forms, and DataFrame joins of every ported
type, through the JAX package's TpuSparkSession (kernels on, interpreted
on the CPU) and the port's TorchSparkSession on the CPU: the ordered rows
must be identical. Inputs are made with numpy from a seed (bench.py's q3
generator, as ``chip_smoke.py`` copies it) and fed to both packages as
the same arrays.

bench.py's q3 text filters above both joins, so its broadcast build sides
are the whole dimension tables, beyond the joinProbe kernel's build cap:
it takes the sort-based FK fast path. With the dimension predicates
pushed into the joined subqueries the build sides compact to the
matching rows and every join goes through joinProbe."""

import numpy as np
import pytest
import torch

from chip_smoke import (Q3_BENCH, Q3_PARTITIONS, Q3_PUSHED, check_q3_rows,
                        q3_reference, q3_tables)
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_dual import dual_run

torch.set_num_threads(2)

N_SALES = 20_000
JAX_CONF = {"spark.rapids.sql.enabled": "true"}


def _types(mod):
    return {"long": mod.LongT, "int": mod.IntegerT, "str": mod.StringT,
            "dec72": mod.DecimalType(7, 2)}


def _jax_batch(cols, validities=None):
    types = _types(JT)
    validities = validities or [None] * len(cols)
    n = len(cols[0][2])
    schema = JT.StructType([JT.StructField(name, types[k])
                            for name, k, _a in cols])
    hcols = [JHostColumn(f.data_type, np.asarray(a),
                         np.ones(n, bool) if v is None else v).normalized()
             for f, (_n, _k, a), v in zip(schema.fields, cols, validities)]
    return JHostBatch(schema, hcols, n)


def _torch_batch(cols, validities=None):
    types = _types(PT)
    return host_batch_from_numpy([(name, types[k]) for name, k, _a in cols],
                                 [a for _n, _k, a in cols], validities)


def _plan_nodes(plan):
    out = [plan]
    for c in plan.children:
        out += _plan_nodes(c)
    return out


def _route_counts(plan):
    tot = {"joinProbe": 0, "fkFastPathJoins": 0}
    for p in _plan_nodes(plan):
        for k, v in getattr(p, "route_counts", {}).items():
            tot[k] += v
    return tot


@pytest.fixture(scope="module")
def q3_runs():
    """Both forms through both packages, once per module."""
    tables = q3_tables(N_SALES)
    out = {"reference": q3_reference(tables)}
    jax_s = TpuSparkSession(dict(JAX_CONF))
    port = TorchSparkSession({}, device="cpu")
    try:
        for name, cols in tables.items():
            jax_s.createDataFrame(_jax_batch(cols),
                                  num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
            port.createDataFrame(_torch_batch(cols),
                                 num_partitions=Q3_PARTITIONS[name]) \
                .createOrReplaceTempView(name)
        for form, sql in (("bench", Q3_BENCH), ("pushed", Q3_PUSHED)):
            jax_s.start_capture()
            want = [tuple(r) for r in jax_s.sql(sql).collect()]
            jplans = jax_s.get_captured_plans()
            snap = registry_snapshot(jplans)["metrics"]
            got = [tuple(r) for r in port.sql(sql).collect()]
            out[form] = (want, got, snap, port.last_plan)
            out[form + "_jax_plans"] = jplans
    finally:
        jax_s.stop()
    return out


@pytest.mark.parametrize("form", ["bench", "pushed"])
def test_q3_rows_identical_to_jax_package(q3_runs, form):
    want, got, _snap, _plan = q3_runs[form]
    assert len(want) >= 1
    assert got == want
    check_q3_rows(got, q3_runs["reference"], form)


def test_q3_forms_agree(q3_runs):
    assert q3_runs["bench"][1] == q3_runs["pushed"][1]


def test_q3_join_routes_match_jax_package(q3_runs):
    """Pushed-down predicates: every join dispatches joinProbe, as in the
    JAX package (8 stream partitions x 2 joins); bench's text: none, both
    joins on the sort-based FK fast path."""
    _w, _g, jsnap, jplan = q3_runs["pushed"]
    routes = _route_counts(jplan)
    assert routes["joinProbe"] == jsnap["kernelDispatchCount.joinProbe"]
    assert routes["joinProbe"] == 16
    assert routes["fkFastPathJoins"] == jsnap["fkFastPathJoins"] == 2
    _w, _g, bsnap, bplan = q3_runs["bench"]
    routes = _route_counts(bplan)
    assert bsnap.get("kernelDispatchCount.joinProbe", 0) == 0
    assert routes == {"joinProbe": 0, "fkFastPathJoins": 2}
    assert bsnap["fkFastPathJoins"] == 2


@pytest.mark.parametrize("form", ["bench", "pushed"])
def test_q3_plan_is_all_torch_between_transitions(q3_runs, form):
    names = [type(p).__name__ for p in _plan_nodes(q3_runs[form][3])]
    assert names[0] == "TorchColumnarToRowExec"
    for i, n in enumerate(names):
        if n == "CpuLocalScanExec":
            assert names[i - 1] == "TorchRowToColumnarExec"
        else:
            assert n.startswith("Torch") and n.endswith("Exec"), names
    for n in ("TorchBroadcastHashJoinExec", "TorchBroadcastExchangeExec",
              "TorchTopNExec", "TorchGlobalLimitExec"):
        assert n in names


@pytest.mark.parametrize("form", ["bench", "pushed"])
def test_q3_plan_and_dispatches_match_jax_package(q3_runs, form):
    """The same operators and exchange partition counts as the JAX
    package's plan (planner-inserted exchanges coalesced to one partition
    on one card: no murmur3), and the same kernel dispatches."""
    from spark_rapids_tpu_torch.metrics import plan_metrics
    from test_torch_runtime import dispatches, plan_shape
    _w, _g, jsnap, plan = q3_runs[form]
    (jplan,) = q3_runs[form + "_jax_plans"]
    kinds, exchanges = plan_shape(plan)
    assert (kinds, exchanges) == plan_shape(jplan)
    assert all(n == 1 for _p, n in exchanges)
    got = dispatches(plan_metrics(plan))
    assert got == dispatches(jsnap)
    assert got["kernelDispatchCount.murmur3"] == 0
    assert got["kernelDispatchCount.groupbyHash"] == 8


# ---------------------------------------------------------------------------
# DataFrame joins of every ported type
# ---------------------------------------------------------------------------

def _join_views(dup, m=300, n=3000, null_dim=False):
    """A fact table with 10% null foreign keys and keys past the dimension
    range, and a dimension with unique (or, with ``dup``, a quarter
    duplicated) keys and a string column; with ``null_dim`` the
    dimension's keys are also 5% null (returned as its validity)."""
    rng = np.random.default_rng(13)
    pk = np.arange(1, m + 1)
    if dup:
        pk = np.concatenate([pk, pk[: m // 4]])
    dim = [("pk", "long", pk),
           ("nm", "str", np.array([f"n{i}" for i in range(len(pk))],
                                  dtype=object))]
    fact = [("fk", "long", rng.integers(1, m + 120, n)),
            ("v", "long", rng.integers(0, 50, n))]
    fvalid = [rng.random(n) > 0.1, None]
    dvalid = [rng.random(len(pk)) > 0.05, None] if null_dim else None
    return fact, fvalid, dim, dvalid


def _sorted_rows(rows):
    return sorted((tuple(r) for r in rows),
                  key=lambda r: tuple((v is None, str(v)) for v in r))


def _join_rows(jt, dup, conf, null_dim=False, null_safe=False):
    fact, fvalid, dim, dvalid = _join_views(dup, null_dim=null_dim)

    def run(session, batch):
        f = session.createDataFrame(batch(fact, fvalid))
        d = session.createDataFrame(batch(dim, dvalid))
        on = (f["fk"].eqNullSafe(d["pk"]) if null_safe
              else f["fk"] == d["pk"])
        return _sorted_rows(f.join(d, on, jt).collect())
    jax_s = TpuSparkSession(dict(JAX_CONF, **conf))
    try:
        want = run(jax_s, _jax_batch)
    finally:
        jax_s.stop()
    port = TorchSparkSession(dict(conf), device="cpu")
    return want, run(port, _torch_batch), port.last_plan


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("jt", ["inner", "left", "right", "full",
                                "leftsemi", "leftanti"])
def test_join_rows_identical_to_jax_package(jt, dup):
    want, got, plan = _join_rows(jt, dup, {})
    assert len(want) > 0
    assert any(v is None for r in want for v in r) == \
        (jt not in ("inner", "leftsemi"))
    assert got == want
    names = [type(p).__name__ for p in _plan_nodes(plan)]
    broadcast = jt not in ("right", "full")
    assert ("TorchBroadcastHashJoinExec" in names) == broadcast
    routes = _route_counts(plan)
    # the dimension (<= 8192 rows) probes through the kernel for the
    # semi/anti masks, and for inner/left when its keys are unique
    kernel = jt in ("leftsemi", "leftanti") or (
        jt in ("inner", "left") and not dup)
    assert (routes["joinProbe"] > 0) == kernel
    assert (routes["fkFastPathJoins"] > 0) == (
        jt in ("inner", "left") and not dup)


@pytest.mark.parametrize("jt,conf", [
    ("inner", {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"}),
    ("left", {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"}),
    ("right", {"spark.rapids.sql.batchSizeRows": "700",
               "spark.sql.shuffle.partitions": "2"}),
    ("full", {"spark.rapids.sql.batchSizeRows": "700",
              "spark.sql.shuffle.partitions": "2"}),
])
def test_shuffled_and_chunked_joins_identical_to_jax_package(jt, conf):
    """Shuffled hash joins (broadcast off), and right/full outer joins
    whose stream side joins in chunks with the unmatched right rows
    emitted at the end."""
    want, got, plan = _join_rows(jt, True, conf)
    assert got == want
    names = [type(p).__name__ for p in _plan_nodes(plan)]
    assert "TorchShuffledHashJoinExec" in names
    assert "TorchBroadcastHashJoinExec" not in names
    if jt in ("right", "full"):
        # chunked: each partition yields its stream chunks, then the
        # unmatched right rows
        join = next(p for p in _plan_nodes(plan)
                    if type(p).__name__ == "TorchShuffledHashJoinExec")
        parts = join.device_partitions()
        assert sum(len(list(t())) for t in parts) > 2 * len(parts)
        # the rerun materialized the exchanges again: release their
        # store handles, as a collect does, so none outlives the test
        from spark_rapids_tpu_torch.memory import release_plan_handles
        release_plan_handles(plan)


@pytest.mark.parametrize("null_safe", [False, True])
@pytest.mark.parametrize("jt", ["inner", "leftsemi", "full"])
def test_null_dimension_keys_identical_to_jax_package(jt, null_safe):
    """Null keys on both sides: ``=`` never matches them; ``<=>``
    (eqNullSafe) matches null to null through a validity key word, on
    the sort plan and on the joinProbe route alike."""
    want, got, plan = _join_rows(jt, False, {}, null_dim=True,
                                 null_safe=null_safe)
    assert got == want
    if jt != "full":
        # a null foreign key survives only by matching a null key
        assert any(r[0] is None for r in want) == null_safe
    # several null build keys under <=> are one duplicated key: inner
    # loses its unique-key certificate and expands on the sort plan
    kernel = jt == "leftsemi" or (jt == "inner" and not null_safe)
    assert (_route_counts(plan)["joinProbe"] > 0) == kernel


def test_limit_without_order_identical_to_jax_package():
    """LocalLimit per partition, a single-partition exchange, then
    GlobalLimit: the first rows in partition order, as in the JAX
    package."""
    fact, fvalid, _dim, _dv = _join_views(False)
    sql = "SELECT fk, v FROM f WHERE v > 10 LIMIT 7"
    jax_s = TpuSparkSession(dict(JAX_CONF))
    try:
        jax_s.createDataFrame(_jax_batch(fact, fvalid),
                              num_partitions=3).createOrReplaceTempView("f")
        want = [tuple(r) for r in jax_s.sql(sql).collect()]
    finally:
        jax_s.stop()
    port = TorchSparkSession({}, device="cpu")
    port.createDataFrame(_torch_batch(fact, fvalid),
                         num_partitions=3).createOrReplaceTempView("f")
    got = [tuple(r) for r in port.sql(sql).collect()]
    assert len(want) == 7 and got == want
    names = [type(p).__name__ for p in _plan_nodes(port.last_plan)]
    assert "TorchLocalLimitExec" in names and "TorchGlobalLimitExec" in names
    assert "TorchTopNExec" not in names


@pytest.mark.parametrize("on", ["f.v < d.pk", "f.fk = d.pk AND f.v < d.pk"])
def test_unported_join_conditions_raise(on):
    """A join with no equi-key is a nested-loop join, which both packages
    run on their host engines (the same plan, the same rows); an
    equi-join with a residual condition runs on the device and gives the
    JAX package's rows."""
    fact, fvalid, dim, _dv = _join_views(False)
    sql = f"SELECT f.v, d.nm FROM f JOIN d ON {on}"
    port = TorchSparkSession({}, device="cpu")
    port.createDataFrame(_torch_batch(fact, fvalid)) \
        .createOrReplaceTempView("f")
    port.createDataFrame(_torch_batch(dim)).createOrReplaceTempView("d")
    if "=" not in on:
        def make(s, batch):
            s.createDataFrame(batch(fact, fvalid)).createOrReplaceTempView(
                "f")
            s.createDataFrame(batch(dim)).createOrReplaceTempView("d")
            return s.sql(sql)
        jax_rec, _port_rec = dual_run(lambda s: make(s, _jax_batch),
                                      lambda s: make(s, _torch_batch))
        assert jax_rec.results[0][1] and jax_rec.results[0][3] == [
            ("CpuBroadcastNestedLoopJoinExec", "device",
             ("source", "source"))]
        return
    jax_s = TpuSparkSession(dict(JAX_CONF))
    try:
        jax_s.createDataFrame(_jax_batch(fact, fvalid)) \
            .createOrReplaceTempView("f")
        jax_s.createDataFrame(_jax_batch(dim)).createOrReplaceTempView("d")
        want = sorted((tuple(r) for r in jax_s.sql(sql).collect()),
                      key=repr)
    finally:
        jax_s.stop()
    got = sorted((tuple(r) for r in port.sql(sql).collect()), key=repr)
    assert want and got == want
