"""Phase 15's legs at a small size through the JAX package's device path
and through the port on the CPU, from memory and from Parquet: TPC-DS
q98 in its pushed double form (a whole-partition window sum over an
aggregate), q51's store half (a running window per item, also
key-batched at a small ``batchSizeRows``), a q86-shaped rollup with a
rank (expand, a decimal aggregate, a rank over a decimal order key), the
same over a union of two views, and a range source under a group-by.
The tables are ``chip_smoke.windows_tables`` at 40,000 store_sales rows
(item and date_dim at bench's sizes), fed to both packages as the same
numpy arrays.

Tolerances: q98's and q51's double sums hold within 1e-12 relative of
the JAX package's rows and of the engine-free references (integer cents,
``chip_smoke.q98_reference``, ``q51_reference``), since the port's
segmented float scans add in another order than XLA; every other value
(keys, strings, ranks, the decimal totals, the range's counts and sums)
is exact. Each port plan is all ``Torch*`` with its window, expand,
union or range node, and fuses the stages the JAX package fuses
(``fused_shape``)."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (Q3_PARTITIONS, Q51_STORE, Q98_PUSHED, Q_RANGE,
                        check_close_rows, check_q51_rows, q51_reference,
                        q86_frame, q86_reference, q98_reference,
                        range_reference, windows_fields, windows_tables)
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_dual import assert_all_torch, rows_close

torch.set_num_threads(2)

N_SALES = 40_000
N_RANGE = 100_000
CONF = {"spark.sql.shuffle.partitions": "4",
        "spark.rapids.sql.variableFloatAgg.enabled": "true"}
# leg b's key-batched run: two device partitions, so the window's input
# holds a batch from each partition of the aggregate below it (at one
# partition the window gets one batch, which both packages window whole
# whatever batchSizeRows is), split into chunks of about this many rows
SMALL_BATCH = 2048
BATCHED = {"spark.rapids.sql.batchSizeRows": str(SMALL_BATCH),
           "spark.rapids.sql.shuffle.devicePartitions": "2"}
LEGS = [("q98_pushed", "memory"), ("q98_pushed", "parquet"),
        ("q51_store", "memory"), ("q51_store", "parquet"),
        ("q51_store_batched", "memory"),
        ("q86_rollup", "memory"), ("q86_rollup", "parquet"),
        ("union_rollup", "memory"), ("range_agg", "memory")]
NODE = {"q98_pushed": "TorchWindowExec", "q51_store": "TorchWindowExec",
        "q51_store_batched": "TorchWindowExec",
        "q86_rollup": "TorchExpandExec", "union_rollup": "TorchUnionExec",
        "range_agg": "TorchRangeExec"}


def _jax_type(pt):
    if type(pt).__name__ == "DecimalType":
        return JT.DecimalType(pt.precision, pt.scale)
    return getattr(JT, type(pt).__name__)()


def _batches(cols, double):
    fields, arrays = windows_fields(cols, double)
    n = len(arrays[0])
    schema = JT.StructType([JT.StructField(name, _jax_type(dt))
                            for name, dt in fields])
    jb = JHostBatch(schema, [
        JHostColumn(f.data_type, np.asarray(a), np.ones(n, bool))
        for f, a in zip(schema.fields, arrays)], n)
    return jb, host_batch_from_numpy(fields, arrays)


@pytest.fixture(scope="module")
def tables():
    return windows_tables(N_SALES)


def _names(plan):
    out = [type(plan).__name__]
    for c in plan.children:
        out += _names(c)
    return out


def _register(s, hb, name, parts):
    s.createDataFrame(hb, num_partitions=parts).createOrReplaceTempView(name)


def _query(s, F, leg):
    if leg in ("q98_pushed",):
        return s.sql(Q98_PUSHED)
    if leg.startswith("q51_store"):
        return s.sql(Q51_STORE)
    if leg == "q86_rollup":
        return q86_frame(s, F)
    if leg == "union_rollup":
        s.table("ss_a").union(s.table("ss_b")) \
            .createOrReplaceTempView("store_sales_u")
        return q86_frame(s, F, "store_sales_u")
    s.range(0, N_RANGE, 1, 8).createOrReplaceTempView("r")
    return s.sql(Q_RANGE)


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):
    """``{(leg, source): (jax rows, jax plan, port rows, port plan)}``."""
    base = str(tmp_path_factory.mktemp("windows"))
    batches = {(name, double): _batches(cols, double)
               for name, cols in tables.items() for double in (False, True)}
    writer = TorchSparkSession(device="cpu")
    paths = {}
    for (name, double), (_jb, pb) in batches.items():
        paths[name, double] = os.path.join(
            base, f"{name}_{'double' if double else 'decimal'}")
        writer.createDataFrame(pb, num_partitions=Q3_PARTITIONS[name]) \
            .write.mode("overwrite").parquet(paths[name, double])
    out = {}
    for leg, source in LEGS:
        double = leg.startswith(("q98", "q51"))
        conf = dict(CONF)
        if leg == "q51_store_batched":
            conf.update(BATCHED)
        js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                           "true"}))
        ps = TorchSparkSession(dict(conf), device="cpu")
        try:
            for name in tables:
                jb, pb = batches[name, double]
                if source == "memory":
                    _register(js, jb, name, Q3_PARTITIONS[name])
                    _register(ps, pb, name, Q3_PARTITIONS[name])
                else:
                    js.read.parquet(paths[name, double]) \
                        .createOrReplaceTempView(name)
                    ps.read.parquet(paths[name, double]) \
                        .createOrReplaceTempView(name)
            if leg == "union_rollup":
                jb, pb = batches["store_sales", False]
                half = jb.num_rows // 2
                for s, b in ((js, jb), (ps, pb)):
                    _register(s, b.slice(0, half), "ss_a", 4)
                    _register(s, b.slice(half, b.num_rows), "ss_b", 4)
            js.start_capture()
            want = [tuple(r) for r in _query(js, JF, leg).collect()]
            jplan = js.get_captured_plans()[-1]
            got = [tuple(r) for r in _query(ps, PF, leg).collect()]
            out[leg, source] = (want, jplan, got, ps.last_plan)
        finally:
            js.stop()
    return out


def _reference(tables, leg):
    if leg == "q98_pushed":
        return q98_reference(tables)
    if leg.startswith("q51"):
        return q51_reference(tables)
    if leg in ("q86_rollup", "union_rollup"):
        return q86_reference(tables)
    return range_reference(N_RANGE)


@pytest.mark.parametrize("leg,source", LEGS)
def test_rows_equal_jax_package(runs, leg, source):
    want, _jplan, got, _plan = runs[leg, source]
    assert want
    if leg.startswith("q51"):
        want, got = sorted(want), sorted(got)
    rows_close(want, got, approx=leg.startswith(("q98", "q51")))


@pytest.mark.parametrize("leg,source", LEGS)
def test_rows_equal_reference(runs, tables, leg, source):
    _want, _jplan, got, _plan = runs[leg, source]
    ref = _reference(tables, leg)
    if leg.startswith("q51"):
        check_q51_rows(got, ref, leg)
    elif leg == "q98_pushed":
        check_close_rows(got, ref, leg, {4, 5, 6})
    else:
        assert got == ref


@pytest.mark.parametrize("leg,source", LEGS)
def test_plan_all_torch_and_fused_as_jax_package(runs, leg, source):
    _want, jplan, _got, plan = runs[leg, source]
    assert_all_torch(plan)
    assert NODE[leg] in _names(plan)
    assert fused_shape(plan) == fused_shape(jplan)


def test_key_batched_window_runs_several_batches(runs):
    """Leg b at a small ``batchSizeRows`` over two device partitions:
    each window partition is key-batched into several chunks, and the
    rows equal the run that windows the whole partition at once."""
    plain = runs["q51_store", "memory"]
    batched = runs["q51_store_batched", "memory"]
    assert sorted(batched[2]) == sorted(plain[2])
    m = plan_metrics(batched[3])
    whole = plan_metrics(plain[3])

    def window_dispatches(plan):
        return sum(p.metrics.snapshot().get("dispatchCount", 0)
                   for p in _walk(plan)
                   if type(p).__name__ == "TorchWindowExec")
    assert window_dispatches(plain[3]) == 1
    assert window_dispatches(batched[3]) > 2
    assert m["numOutputRows"] and whole["numOutputRows"]


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def test_rollup_runs_groupby_hash_plain_version(runs):
    """The rollup's partial aggregate (keys i_category, i_class,
    spark_grouping_id; a decimal sum lane) and the range's take the
    groupbyHash route (its plain version on the CPU)."""
    for leg in ("q86_rollup", "range_agg"):
        m = plan_metrics(runs[leg, "memory"][3])
        assert m.get("kernelDispatchCount.groupbyHash", 0) > 0, leg
