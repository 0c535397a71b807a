"""TPC-H q12 through the JAX package's device path and through the port
on the CPU, from memory and from Parquet: the same seeded tables
(``chip_smoke.q12_tables`` at a small size, TPC-H's domains and sparse
order keys) fed to both packages as the same numpy arrays. The ordered
rows must be identical to each other and to the engine-free reference
(``chip_smoke.q12_reference``), the port's plan all ``Torch*`` with the
same fused stages as the JAX package's, the filter with its ``In``,
``CaseWhen``, ``Or`` and ``Not`` inside the fused partial-aggregate
stage, and the partial aggregate through groupbyHash's plain version.

q12 in its optimizer form (``chip_smoke.Q12_PUSHED``: the lineitem
predicates in a subquery below the join) runs under a static broadcast
threshold its lineitem estimate is over and a run-time one its filtered
build side is under, so both packages plan a shuffled join and demote
it to a broadcast at run time (``aqeBroadcastFlip`` 1 each, orders'
exchange dropped): the rows equal q12's, the fused stages the JAX
package's."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (Q12, Q12_PUSHED, plan_nodes_of, q12_fields,
                        q12_reference, q12_tables)
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_dual import assert_all_torch

torch.set_num_threads(2)

N_LINEITEM = 12_000
N_ORDERS = 3_000
CONF = {"spark.sql.shuffle.partitions": "4"}
PARTS = {"lineitem": 3, "orders": 2}
# shuffled at planning (lineitem's estimate is over 100 KiB), demoted at
# run time (the filtered build side is under 10 MiB)
DEMOTE = {"spark.rapids.sql.autoBroadcastJoinThreshold": "100k",
          "spark.rapids.sql.adaptive.autoBroadcastBytes": "10m"}


@pytest.fixture(scope="module")
def tables():
    return q12_tables(N_LINEITEM, N_ORDERS)


def _jax_batch(cols):
    fields, arrays = q12_fields(cols)
    n = len(arrays[0])
    schema = JT.StructType([JT.StructField(name, _jax_type(dt))
                            for name, dt in fields])
    return JHostBatch(schema, [
        JHostColumn(f.data_type, np.asarray(a), np.ones(n, bool))
        for f, a in zip(schema.fields, arrays)], n)


def _jax_type(pt):
    if type(pt).__name__ == "DecimalType":
        return JT.DecimalType(pt.precision, pt.scale)
    return getattr(JT, type(pt).__name__)()


def _torch_batch(cols):
    return host_batch_from_numpy(*q12_fields(cols))


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):
    """``{source: (jax rows, jax plan, port rows, port plan)}`` for the
    tables in memory and written as Parquet."""
    base = str(tmp_path_factory.mktemp("q12"))
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
            want = [tuple(r) for r in jax_s.sql(Q12).collect()]
            (jplan,) = jax_s.get_captured_plans()
            got = [tuple(r) for r in port.sql(Q12).collect()]
            out[source] = (want, jplan, got, port.last_plan)
    finally:
        jax_s.stop()
    return out


def _sessions(conf, paths, tables, source):
    """A JAX session and a port session with q12's views over the tables
    in memory or over their Parquet files."""
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    port = TorchSparkSession(dict(conf), device="cpu")
    for name, cols in tables.items():
        if source == "memory":
            jax_s.createDataFrame(_jax_batch(cols),
                                  num_partitions=PARTS[name]) \
                .createOrReplaceTempView(name)
            port.createDataFrame(_torch_batch(cols),
                                 num_partitions=PARTS[name]) \
                .createOrReplaceTempView(name)
        else:
            jax_s.read.parquet(paths[name]).createOrReplaceTempView(name)
            port.read.parquet(paths[name]).createOrReplaceTempView(name)
    return jax_s, port


@pytest.fixture(scope="module")
def pushed_runs(tables, runs, tmp_path_factory):
    """``{source: (jax rows, jax plan, jax metrics, port rows, port
    plan)}`` of Q12_PUSHED under ``DEMOTE``."""
    base = str(tmp_path_factory.mktemp("q12p"))
    writer = TorchSparkSession(device="cpu")
    paths = {}
    for name, cols in tables.items():
        paths[name] = os.path.join(base, name)
        writer.createDataFrame(_torch_batch(cols),
                               num_partitions=PARTS[name]) \
            .write.mode("overwrite").parquet(paths[name])
    out = {}
    for source in ("memory", "parquet"):
        jax_s, port = _sessions(dict(CONF, **DEMOTE), paths, tables,
                                source)
        try:
            jax_s.start_capture()
            want = [tuple(r) for r in jax_s.sql(Q12_PUSHED).collect()]
            (jplan,) = jax_s.get_captured_plans()
            jm = registry_snapshot([jplan])["metrics"]
        finally:
            jax_s.stop()
        got = [tuple(r) for r in port.sql(Q12_PUSHED).collect()]
        out[source] = (want, jplan, jm, got, port.last_plan)
    return out


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q12_pushed_demotes_in_both_packages(pushed_runs, runs, source):
    want, jplan, jm, got, plan = pushed_runs[source]
    assert got == want == runs[source][0]
    m = plan_metrics(plan)
    assert m["aqeBroadcastFlip"] == jm["aqeBroadcastFlip"] == 1
    assert m["aqeReplans"] == jm["aqeReplans"] == 1
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    # the executed plan: a shuffled join whose stream side (orders) lost
    # its exchange, whose build side (the filtered lineitem) kept it
    (join,) = [p for p in plan_nodes_of(plan) if hasattr(p, "route_counts")]
    assert type(join).__name__ == "TorchShuffledHashJoinExec"
    assert type(join.left).__name__ == "TorchRowToColumnarExec"
    assert type(join.right).__name__ == "TorchShuffleExchangeExec"



@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q12_rows_identical_to_jax_package_and_reference(runs, tables,
                                                         source):
    want, _jplan, got, _plan = runs[source]
    ref = q12_reference(tables)
    assert [r[0] for r in ref] == ["MAIL", "SHIP"]
    assert want == ref
    assert got == want


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q12_fused_stages_equal_jax_package(runs, source):
    _want, jplan, _got, plan = runs[source]
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    stage = ("TorchFusedStageExec",
             ("TorchFilterExec", "TorchHashAggregateExec"),
             "TorchHashAggregateExec")
    assert stage in fused_shape(plan)


@pytest.mark.parametrize("source", ["memory", "parquet"])
def test_q12_partial_aggregate_takes_the_kernel_route(runs, source):
    """The fused stage's partial aggregate over l_shipmode dispatches
    groupbyHash (its plain version here) with no overflow re-run; the
    Parquet leg decodes its row groups through decodeFused's plain
    version."""
    _want, _jplan, _got, plan = runs[source]
    m = plan_metrics(plan)
    assert m.get("kernelDispatchCount.groupbyHash", 0) > 0
    if source == "parquet":
        assert m.get("deviceDecodedBatches", 0) > 0
