"""The port's range, union and expand (rollup, cube) against the JAX
package's: its own cases of ``tests/test_device_exec.py`` (``test_union``,
``test_range``, ``test_rollup_on_device``, ``test_cube_on_device``), run
through the JAX package's device path and through
``TorchSparkSession(device="cpu")`` (``tests/torch_dual.py``), rows exact
(NaN equal to NaN, -0.0 distinct from 0.0). ``test_rollup_exact_values``
builds its own JAX session, so its rows are checked here against the
port directly. Also here: the session surface (``range``, the builder,
``active()``/``stop()``, plan capture), the range's batches at
``batchSizeRows``, and the plans: range as a fusion source, union
re-tagging its children, expand with ``spark_grouping_id``.
"""

import pytest

from tests import test_device_exec as JX
from tests.torch_dual import assert_all_torch, run_case

from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession


@pytest.mark.parametrize("name", ["test_union", "test_range",
                                  "test_rollup_on_device",
                                  "test_cube_on_device"])
def test_exec_case(name):
    run_case(JX, name)


def _names(plan):
    out = [type(plan).__name__]
    for c in plan.children:
        out += _names(c)
    return out


def test_rollup_exact_values():
    s = TorchSparkSession({}, device="cpu")
    try:
        df = s.createDataFrame(
            {"k": ["a", "a", "b"], "v": [1, 2, 4]}, "k string, v int")
        rows = {(r.k, r.s) for r in
                df.rollup("k").agg(PF.sum("v").alias("s")).collect()}
        assert rows == {("a", 3), ("b", 4), (None, 7)}
        assert "TorchExpandExec" in _names(s.last_plan)
        assert_all_torch(s.last_plan)
    finally:
        s.stop()


@pytest.mark.parametrize("args,want", [
    ((10,), list(range(10))), ((3, 17, 4), list(range(3, 17, 4))),
    ((10, 0, -3), list(range(10, 0, -3))), ((5, 5), [])])
def test_range_values(args, want):
    s = TorchSparkSession({}, device="cpu")
    assert [r.id for r in s.range(*args).collect()] == want


def test_range_batches_follow_batch_size_rows():
    from spark_rapids_tpu_torch.exec.basic import TorchRangeExec
    s = TorchSparkSession({"spark.rapids.sql.batchSizeRows": "100"},
                          device="cpu")
    df = s.range(0, 1000, 1, 3)
    assert df.count() == 1000
    plan = s.plan_physical(df.plan)
    rng = [p for p in _walk(plan) if isinstance(p, TorchRangeExec)][0]
    sizes = [b.row_count() for t in rng.device_partitions() for b in t()]
    # 334 + 334 + 332 rows in three runs, cut at 100 rows a batch
    assert sizes == [100, 100, 100, 34, 100, 100, 100, 34,
                     100, 100, 100, 32]
    b = next(iter(rng.device_partitions()[0]()))
    assert b.columns[0].validity is b.active


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def test_range_is_a_fusion_source_as_in_the_jax_package():
    from tests.test_torch_runtime import fused_shape
    from spark_rapids_tpu.sql.session import TpuSparkSession
    q = ("SELECT k, count(*) c, sum(id) s FROM (SELECT id % 7 k, id FROM r "
         "WHERE id > 3) t GROUP BY k")
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        js.range(0, 500, 1, 3).createOrReplaceTempView("r")
        jdf = js.sql(q)
        jrows = sorted(tuple(r) for r in jdf.collect())
        jshape = fused_shape(js.plan_physical(jdf.plan))
    finally:
        js.stop()
    ps = TorchSparkSession({}, device="cpu")
    ps.range(0, 500, 1, 3).createOrReplaceTempView("r")
    pdf = ps.sql(q)
    assert sorted(tuple(r) for r in pdf.collect()) == jrows
    assert fused_shape(ps.last_plan) == jshape
    assert "TorchRangeExec" in _names(ps.last_plan)


def test_union_retags_children_without_copy():
    from spark_rapids_tpu_torch.exec.basic import TorchUnionExec
    s = TorchSparkSession({}, device="cpu")
    a = s.createDataFrame({"x": [1, 2, 3]}, "x int", num_partitions=2)
    b = s.createDataFrame({"x": [4, 5]}, "x int", num_partitions=1)
    df = a.union(b)
    assert sorted(r.x for r in df.collect()) == [1, 2, 3, 4, 5]
    u = [p for p in _walk(s.last_plan) if isinstance(p, TorchUnionExec)][0]
    assert len(u.device_partitions()) == 3
    assert u.metrics.snapshot()["numOutputRows"] == 5


def test_builder_active_stop_and_capture():
    s = TorchSparkSession.builder.config(
        "spark.rapids.sql.batchSizeRows", "77").appName("x").master(
        "local").getOrCreate(device="cpu")
    try:
        assert TorchSparkSession.active() is s
        assert s.conf_obj.batch_size_rows == 77
        s2 = TorchSparkSession({}, device="cpu")
        assert TorchSparkSession.active() is s2
        s2.stop()
        assert TorchSparkSession.active() is s
        s.start_capture()
        s.range(5).collect()
        s.range(3).count()
        plans = s.get_captured_plans()
        assert len(plans) == 2
        assert all(type(p).__name__ == "TorchColumnarToRowExec"
                   for p in plans)
        s.range(2).collect()  # capture is off again: nothing added
        assert len(s.get_captured_plans()) == 2
    finally:
        s.stop()


def test_builder_without_cuda_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the builder takes it")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSparkSession.builder.getOrCreate()
