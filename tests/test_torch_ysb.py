"""Phase 16's Yahoo Streaming Benchmark leg at a small size through the
JAX package's device path and through the port on the CPU: the windowed
campaign count (``chip_smoke.YSB_SQL``: views joined to the ad ->
campaign table, counted per campaign and ``window(event_time, '10
seconds')``) over ``chip_smoke.ysb_tables`` at 30,000 events (the 1,000
ads of 100 campaigns at full size), from memory, from Parquet and at
``shuffle.devicePartitions`` 8, fed to both packages as the same numpy
arrays.

Checked, every value exact: the rows against the JAX package's and
against the numpy reference (``chip_smoke.ysb_reference``); the port's
plan all ``Torch*`` and fused as the JAX package's (``fused_shape``:
the time window inside the aggregate's stage program); the ad join on
the joinProbe route; the kernel dispatches equal to the JAX package's
but for murmur3 at 8 device partitions, where the group-by's exchange
hashes a struct key (``campaign_id``, the window): the port hashes the
window's fields in the murmur3 kernel (``ops.hashing.struct_key_fields``),
one dispatch an exchange input batch, where the JAX package hashes
struct keys outside its kernel (``kernels/murmur3.py``
``hash_kernel_eligible``) and counts none."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (YSB_SHUFFLED, YSB_SQL, ysb_batches, ysb_reference,
                        ysb_tables)
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import dispatches, fused_shape

from spark_rapids_tpu_torch.exec.join import TorchBroadcastHashJoinExec
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_dual import assert_all_torch

torch.set_num_threads(2)

N_EVENTS = 30_000
PARTS = {"events": 8, "ads": 1}
CONF = {"spark.sql.shuffle.partitions": "8"}
LEGS = [("memory", "default"), ("parquet", "default"),
        ("memory", "shuffled")]


def jax_batch(pb) -> JHostBatch:
    """The same numpy columns as a JAX package HostBatch."""
    def jt(t):
        if type(t).__name__ == "ArrayType":
            return JT.ArrayType(jt(t.element_type))
        return getattr(JT, type(t).__name__)()
    schema = JT.StructType([JT.StructField(f.name, jt(f.data_type))
                            for f in pb.schema.fields])
    return JHostBatch(schema, [
        JHostColumn(f.data_type, c.data, c.validity)
        for f, c in zip(schema.fields, pb.columns)], pb.num_rows)


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


@pytest.fixture(scope="module")
def tables():
    return ysb_tables(N_EVENTS)


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):
    """``{(source, conf): (jax rows, jax plan, jax metrics, port rows,
    port plan)}``."""
    base = str(tmp_path_factory.mktemp("ysb"))
    batches = ysb_batches(tables)
    writer = TorchSparkSession(device="cpu")
    for name, b in batches.items():
        writer.createDataFrame(b, num_partitions=PARTS[name]) \
            .write.mode("overwrite").parquet(os.path.join(base, name))
    out = {}
    for source, which in LEGS:
        conf = dict(CONF, **(YSB_SHUFFLED if which == "shuffled" else {}))
        js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                           "true"}))
        ps = TorchSparkSession(dict(conf), device="cpu")
        try:
            for name, b in batches.items():
                if source == "memory":
                    js.createDataFrame(jax_batch(b),
                                       num_partitions=PARTS[name]) \
                        .createOrReplaceTempView(name)
                    ps.createDataFrame(b, num_partitions=PARTS[name]) \
                        .createOrReplaceTempView(name)
                else:
                    for s in (js, ps):
                        s.read.parquet(os.path.join(base, name)) \
                            .createOrReplaceTempView(name)
            js.start_capture()
            want = sorted(tuple(r) for r in js.sql(YSB_SQL).collect())
            jplan = js.get_captured_plans()[-1]
            jm = registry_snapshot([jplan])["metrics"]
            got = sorted(tuple(r) for r in ps.sql(YSB_SQL).collect())
            out[source, which] = (want, jplan, jm, got, ps.last_plan)
        finally:
            js.stop()
    return out


@pytest.mark.parametrize("source,which", LEGS)
def test_rows_equal_jax_package_and_reference(runs, tables, source, which):
    want, _jplan, _jm, got, _plan = runs[source, which]
    assert got == want
    assert got == ysb_reference(tables)
    assert len(got) > 1000


@pytest.mark.parametrize("source,which", LEGS)
def test_plan_all_torch_and_fused_as_jax_package(runs, source, which):
    _want, jplan, _jm, _got, plan = runs[source, which]
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    stages = [p for p in _walk(plan) if getattr(p, "sink_agg", None)]
    assert stages, "the partial aggregate absorbs the window's project"


@pytest.mark.parametrize("source,which", LEGS)
def test_ad_join_takes_join_probe(runs, source, which):
    plan = runs[source, which][4]
    (j,) = [p for p in _walk(plan)
            if isinstance(p, TorchBroadcastHashJoinExec)]
    # one a stream batch (the small Parquet files scan as one partition)
    assert j.route_counts["joinProbe"] >= 1
    assert j.route_counts["fkFastPathJoins"] == 1


@pytest.mark.parametrize("source,which", LEGS)
def test_dispatches_equal_jax_package_but_struct_murmur3(runs, source,
                                                         which):
    _want, _jplan, jm, _got, plan = runs[source, which]
    got = dispatches(plan_metrics(plan))
    want = dispatches(jm)
    if which == "shuffled":
        # the struct key's exchange: one murmur3 kernel dispatch an input
        # batch in the port, none in the JAX package
        assert want["kernelDispatchCount.murmur3"] == 0
        assert got["kernelDispatchCount.murmur3"] == PARTS["events"]
        got["kernelDispatchCount.murmur3"] = 0
    assert got == want
    if source == "parquet":
        assert got["kernelDispatchCount.decodeFused"] == sum(PARTS.values())
