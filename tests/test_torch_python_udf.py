"""Pandas UDFs and mapInPandas in the port (``exec/python_exec.py``,
``python/pool.py``, ``python/worker.py``) against the JAX package's on
the same data: the port on the CPU, the JAX package's device path.

Checked: the JAX cases of ``tests/test_pandas_udf.py`` through
``tests/torch_dual.py`` (scalar UDFs over several types, two arguments
and the extractor's dedup, mapInPandas with the same and with a changed
row count); placement: the surrounding plan all ``Torch*`` with the
Python exec a stage boundary, fused as the JAX package's; a UDF error
raised with the worker's traceback, the worker serving the next call;
one worker reused across batches; the worker process importing neither
torch, jax nor either package (asked inside the worker) and the worker
module neither on import; a pandas UDF in a filter or a sort key kept
on the host as in the JAX package, with the same rows; ``stop()``
ending the workers. Each test that starts
workers runs under a time limit of its own."""

import os
import signal
import subprocess
import sys

import pytest
import torch

import test_pandas_udf
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.python_exec import _ipc_bytes, _ipc_read
from spark_rapids_tpu_torch.python import pool as P
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows
from tests.torch_dual import assert_all_torch, dual_run, run_case

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 60


@pytest.fixture(autouse=True)
def time_limit():
    """A test that waits on a worker fails after LIMIT_S seconds instead
    of hanging the run; the workers end with the test."""
    def expire(_sig, _frame):
        raise TimeoutError(f"test ran over {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        P.shutdown_worker_pool()


@pytest.mark.parametrize("case", [
    "test_scalar_pandas_udf_dual_session",
    "test_pandas_udf_two_args_and_dedup",
    "test_map_in_pandas_dual_session",
    "test_map_in_pandas_changes_row_count",
])
def test_jax_cases(case):
    run_case(test_pandas_udf, case)


def _placement(s, F):
    @F.pandas_udf("long")
    def twice(v):
        return v * 2

    df = s.createDataFrame({"a": list(range(100)), "b": [1.5] * 100},
                           "a long, b double", num_partitions=3)
    return df.filter(F.col("a") > 3).select(
        twice("a").alias("t"), (F.col("a") + 1).alias("a1")) \
        .filter(F.col("t") > 100).select("t", (F.col("a1") * 2).alias("a2"))


def test_placement_on_device_and_fused_as_jax_package():
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        js.start_capture()
        want = sorted(_rows(_placement(js, JF)._execute().to_pydict()))
        jplan = js.get_captured_plans()[-1]
    finally:
        js.stop()
    ps = TorchSparkSession(device="cpu")
    got = sorted(_rows(_placement(ps, F)._execute().to_pydict()))
    assert got == want
    assert [r[0] for r in got] == list(range(102, 200, 2))
    plan = ps.last_plan
    assert_all_torch(plan)
    assert fused_shape(plan) == fused_shape(jplan)
    assert "TorchArrowEvalPythonExec" in [
        k if isinstance(k, str) else k[0] for k in fused_shape(plan)]


def test_udf_error_propagates_and_worker_survives():
    @F.pandas_udf("long")
    def boom(v):
        raise ValueError("intentional udf failure")

    ps = TorchSparkSession(device="cpu")
    df = ps.createDataFrame({"a": [1, 2]}, "a long")
    with pytest.raises(P.PythonWorkerError, match="intentional udf failure"):
        df.select(boom("a").alias("b")).collect()
    pool = P.get_worker_pool(ps.conf_obj)
    assert pool._created == 1 and pool._idle.qsize() == 1

    @F.pandas_udf("long")
    def inc(v):
        return v + 1
    assert [r[0] for r in df.select(inc("a")).collect()] == [2, 3]
    assert pool._created == 1


def test_worker_pool_reuse():
    """One worker serves many batches (no process a batch)."""
    import cloudpickle
    import pyarrow as pa
    p = P.get_worker_pool(TorchConf({}))
    schema_ipc = _ipc_bytes(pa.schema([("x", pa.int64())]).empty_table())
    payload = ([cloudpickle.dumps(lambda s: s + 1)], [[0]], schema_ipc)
    for i in range(4):
        tbl = pa.table({"v": pa.array([i, i + 1], pa.int64())})
        out = _ipc_read(p.run("scalar", payload, _ipc_bytes(tbl)))
        assert out.column(0).to_pylist() == [i + 1, i + 2]
    assert p._created == 1 <= p.size


def test_many_batches_one_worker_rows_in_order():
    """Several partitions and batches through one worker, the result
    columns lined up with the device rows (the batch is compacted before
    its download: a filter leaves holes)."""
    ps = TorchSparkSession({"spark.rapids.sql.batchSizeRows": "64"},
                           device="cpu")

    @F.pandas_udf("string")
    def label(a, b):
        return a.astype(str) + ":" + b

    df = ps.createDataFrame({"a": list(range(1000)),
                             "b": [f"s{i % 7}" for i in range(1000)]},
                            "a long, b string", num_partitions=4)
    rows = df.filter(F.col("a") % 3 != 0).select(
        "a", label("a", "b").alias("l")).collect()
    assert [tuple(r) for r in rows] == [
        (a, f"{a}:s{a % 7}") for a in range(1000) if a % 3 != 0]
    assert P.get_worker_pool(ps.conf_obj)._created == 1


def test_worker_process_imports_no_engine():
    """Asked inside the worker: no torch, jax or engine module loaded."""
    @F.pandas_udf("string")
    def loaded(v):
        import sys as _sys

        import pandas as pd
        mods = sorted({m.split(".")[0] for m in _sys.modules} & {
            "torch", "jax", "jaxlib", "spark_rapids_tpu",
            "spark_rapids_tpu_torch"})
        return pd.Series([",".join(mods)] * len(v))

    ps = TorchSparkSession(device="cpu")
    rows = ps.createDataFrame({"a": [1, 2]}, "a long").select(
        loaded("a")).collect()
    # the worker runs as ``-m spark_rapids_tpu_torch.python.worker``: the
    # package and its empty ``python`` subpackage, nothing else
    assert {r[0] for r in rows} == {"spark_rapids_tpu_torch"}


def test_worker_module_imports_no_torch():
    code = ("import sys; import spark_rapids_tpu_torch.python.worker; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'jax', 'jaxlib', 'spark_rapids_tpu', 'pandas'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pandas_udf_in_filter_raises_with_the_fallback_reason():
    """A pandas UDF in a filter or a sort key is not extracted into the
    Python exec: both packages keep that filter or sort on the host, for
    the same reason, and give the same rows."""
    def twice(v):
        return v * 2

    def frame(s):
        return s.createDataFrame({"a": [1, 2, 3]}, "a long")

    for query, ordered in (
            (lambda df, u: df.filter(u("a") > 2), False),
            (lambda df, u: df.orderBy(u("a")), True)):
        _jax_rec, port_rec = dual_run(
            lambda s: query(frame(s), JF.pandas_udf(twice, "long")),
            lambda s: query(frame(s), F.pandas_udf(twice, "long")),
            ignore_order=not ordered)
        assert "PandasUDF" in port_rec.messages[0]


def test_stop_ends_the_workers():
    @F.pandas_udf("long")
    def inc(v):
        return v + 1

    ps = TorchSparkSession(device="cpu")
    ps.createDataFrame({"a": [1]}, "a long").select(inc("a")).collect()
    procs = [w.proc for w in list(P._POOL._idle.queue)]
    assert len(procs) == 1 and procs[0].poll() is None
    ps.stop()
    assert P._POOL is None
    assert procs[0].wait(timeout=10) is not None
