"""Phase 16's Stack Overflow tag queries at a small size through the JAX
package's device path and through the port on the CPU: the top tags
(explode), the tags related to ``python`` (explode under
``array_contains``) and the primary tags (``element_at``, ``size``), the
``chip_smoke.TAGS_SQL`` texts over ``chip_smoke.tags_tables`` at 4,000
questions (1-5 of 65,000 Zipf(1.0) tags each), from memory and from
Parquet, fed to both packages as the same numpy arrays.

Checked, every value exact: the rows against the JAX package's and
against the numpy reference (``chip_smoke.tags_reference``), those of
the LIMIT queries and every group of each query without its ORDER BY and
LIMIT (``chip_smoke.TAGS_ALL_SQL``: the generated names and the long
tail, which the LIMIT rows never reach); the port's
plan all ``Torch*`` and fused as the JAX package's (``fused_shape``;
Generate is no part of a stage program in either); the kernel
dispatches (groupbyHash on every partial batch, decodeFused on the
Parquet legs) equal to the JAX package's; the partial aggregate of the
top query re-running its overflowed batches sorted
(``overflow_reruns``); from Parquet, the array column decoded on the
host (``deviceFallbackColumns``), the flat ones by decodeFused."""

import os

import pytest
import torch

from chip_smoke import (TAGS_ALL_SQL, TAGS_SQL, tags_batch, tags_reference,
                        tags_tables)
from spark_rapids_tpu.metrics import registry_snapshot
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import dispatches, fused_shape
from test_torch_ysb import jax_batch

from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_dual import assert_all_torch

torch.set_num_threads(2)

N_POSTS = 4_000
PARTS = 8
CONF = {"spark.sql.shuffle.partitions": "8"}
LEGS = [(q, source) for source in ("memory", "parquet") for q in TAGS_SQL]


def _walk(p):
    yield p
    for n in getattr(p, "fused_ops", []):
        yield n
    for c in p.children:
        yield from _walk(c)


@pytest.fixture(scope="module")
def tables():
    return tags_tables(N_POSTS)


@pytest.fixture(scope="module")
def runs(tables, tmp_path_factory):
    """``{(query, source): (jax rows, jax plan, jax metrics, port rows,
    port plan, port scan metrics)}``, and under ``(query + "_all",
    source)`` both packages' sorted rows of every group."""
    path = os.path.join(str(tmp_path_factory.mktemp("tags")), "posts")
    pb = tags_batch(tables)
    TorchSparkSession(device="cpu").createDataFrame(
        pb, num_partitions=PARTS).write.mode("overwrite").parquet(path)
    out = {}
    for source in ("memory", "parquet"):
        js = TpuSparkSession(dict(CONF, **{"spark.rapids.sql.enabled":
                                           "true"}))
        ps = TorchSparkSession(dict(CONF), device="cpu")
        try:
            if source == "memory":
                js.createDataFrame(jax_batch(pb), num_partitions=PARTS) \
                    .createOrReplaceTempView("posts")
                ps.createDataFrame(pb, num_partitions=PARTS) \
                    .createOrReplaceTempView("posts")
            else:
                for s in (js, ps):
                    s.read.parquet(path).createOrReplaceTempView("posts")
            for q, sql in TAGS_SQL.items():
                js.start_capture()
                want = [tuple(r) for r in js.sql(sql).collect()]
                jplan = js.get_captured_plans()[-1]
                jm = registry_snapshot([jplan])["metrics"]
                got = [tuple(r) for r in ps.sql(sql).collect()]
                scans = [p.metrics.snapshot() for p in _walk(ps.last_plan)
                         if type(p).__name__ == "CpuFileScanExec"]
                out[q, source] = (want, jplan, jm, got, ps.last_plan, scans)
                out[q + "_all", source] = tuple(
                    sorted(tuple(r) for r in s.sql(TAGS_ALL_SQL[q])
                           .collect()) for s in (js, ps))
        finally:
            js.stop()
    return out


@pytest.mark.parametrize("query,source", LEGS)
def test_rows_equal_jax_package_and_reference(runs, tables, query, source):
    want, _jplan, _jm, got, _plan, _scans = runs[query, source]
    assert got == want
    assert got == tags_reference(tables)[query]
    assert got[0][0] == ("javascript" if query != "related" else got[0][0])


@pytest.mark.parametrize("query,source", LEGS)
def test_all_groups_equal_jax_package_and_reference(runs, tables, query,
                                                    source):
    want, got = runs[query + "_all", source]
    assert got == want
    assert got == tags_reference(tables)[query + "_all"]
    assert len(got) > 100


@pytest.mark.parametrize("query,source", LEGS)
def test_plan_all_torch_and_fused_as_jax_package(runs, query, source):
    _want, jplan, _jm, _got, plan, _scans = runs[query, source]
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    names = [type(p).__name__ for p in _walk(plan)]
    assert ("TorchGenerateExec" in names) == (query != "primary")


@pytest.mark.parametrize("query,source", LEGS)
def test_dispatches_equal_jax_package(runs, query, source):
    _want, _jplan, jm, _got, plan, scans = runs[query, source]
    got = dispatches(plan_metrics(plan))
    assert got == dispatches(jm)
    assert got["kernelDispatchCount.groupbyHash"] == PARTS
    if source == "parquet":
        assert got["kernelDispatchCount.decodeFused"] == PARTS
        (scan,) = scans
        assert scan["deviceFallbackColumns"] == PARTS  # the tags column
        assert scan["deviceDecodedBatches"] == PARTS


def test_top_query_reruns_overflowed_batches(runs):
    """Thousands of tags a batch at full size, hundreds here: the top
    query's partial batches overflow the group table and re-run on the
    sort-based partial aggregate, counted."""
    plan = runs["top", "memory"][4]
    (agg,) = [p for p in _walk(plan) if isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial"]
    assert agg.overflow_reruns > 0
