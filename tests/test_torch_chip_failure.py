"""Chip failures on the port's mesh (``retry.py`` ``TorchChipFailure``,
``degrade_on_chip_failure``, ``chip_checkpoint``; ``parallel/mesh.py``'s
healthy mesh), held against the JAX package's: the chip cases of
``tests/test_retry.py`` and its mesh-stream IO retry, on 8 emulated
``cpu`` chips beside the JAX package's 8 host devices.

An injected chip failure (``spark.rapids.sql.test.injectChipFailure``)
must demote the chip and finish the query on the survivors, down to the
single-chip path, with rows equal to the JAX package's degraded run and
its CPU engine's, and ``degradedChips`` counting each demoted chip once.
"""

import numpy as np
import pytest
import torch

from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.metrics import sum_plan_metrics
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.datagen import IntegerGen, LongGen, SmallIntGen, gen_batch
from tests.harness import _rows, _sort_key
from tests.torch_dual import port_batch

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    """8 emulated cpu chips and fresh injectors; the mesh, the emulation
    and the injectors are restored after each test."""
    prev_mesh, prev_em = PM.get_active_mesh(), PM.emulated_chips()
    PM.emulate_chips(8, CPU)
    PM.set_active_mesh(None)
    JR.reset_fault_injection()
    R.reset_fault_injection()
    yield
    JR.reset_fault_injection()
    R.reset_fault_injection()
    PM.set_active_mesh(prev_mesh)
    PM.emulate_chips(*prev_em) if prev_em else PM.emulate_chips(None)


def _ici_conf(chips: str, **extra):
    conf = {
        "spark.rapids.shuffle.mode": "ici",
        "spark.rapids.sql.test.injectChipFailure": chips,
        "spark.rapids.sql.batchSizeRows": "256",
    }
    conf.update(extra)
    return conf


def _shuffle_query(s, f, port: bool):
    b = gen_batch([("k", SmallIntGen()), ("v", LongGen()),
                   ("w", IntegerGen())], 3000, 15)
    df = s.createDataFrame(port_batch(b) if port else b, num_partitions=4)
    return df.repartition(8, "k").groupBy("k").agg(
        f.sum("v").alias("s"), f.count("w").alias("c"))


def _canon(rows):
    return sorted(rows, key=_sort_key)


def _run_both(q, conf):
    """The port's injected run, the JAX package's injected run and the
    JAX CPU engine's clean run: rows equal. Returns the port's plans and
    the JAX package's."""
    clean = {k: v for k, v in conf.items()
             if not k.startswith("spark.rapids.sql.test.inject")}
    cpu = TpuSparkSession(dict(clean, **{"spark.rapids.sql.enabled":
                                         "false"}))
    try:
        want = _rows(q(cpu, JF, False)._execute().to_pydict())
    finally:
        cpu.stop()
    JR.reset_fault_injection()
    js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled": "true"}))
    try:
        js.start_capture()
        jgot = _rows(q(js, JF, False)._execute().to_pydict())
        jplans = js.get_captured_plans()
    finally:
        js.stop()
    R.reset_fault_injection()
    s = TorchSparkSession(conf, device="cpu")
    try:
        s.start_capture()
        got = _rows(q(s, F, True)._execute().to_pydict())
        plans = s.get_captured_plans()
    finally:
        s.stop()
    assert _canon(got) == _canon(want)
    assert _canon(got) == _canon(jgot)
    return plans, jplans


def _metric(plans, name) -> int:
    return sum(v for p in plans for k, v in plan_metrics(p).items()
               if k == name)


def _jmetric(plans, name) -> int:
    return sum(sum_plan_metrics(plans, name).values())


def test_chip_failure_degrades_mesh_identical_results():
    """One persistently failing chip: the exchange demotes it and the
    query completes on the survivors with degradedChips > 0, as the JAX
    package's does."""
    plans, jplans = _run_both(_shuffle_query, _ici_conf("1"))
    assert _metric(plans, M.DEGRADED_CHIPS) == \
        _jmetric(jplans, "degradedChips") == 1
    assert _metric(plans, "numIciExchanges") >= 1
    assert PM.get_active_mesh() is None  # the session tore it down


def test_chip_failures_degrade_to_single_chip():
    """All but one chip failing walks the whole ladder down to the
    single-chip in-process path, never a failed query."""
    chips = ",".join(str(i) for i in range(7))
    plans, jplans = _run_both(_shuffle_query, _ici_conf(chips))
    assert _metric(plans, M.DEGRADED_CHIPS) == \
        _jmetric(jplans, "degradedChips") == 7
    assert _metric(plans, "numIciExchanges") == 0


def _write_parquet(tmp_path):
    path = str(tmp_path / "t")
    gen = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        gen.createDataFrame(
            gen_batch([("k", SmallIntGen()), ("v", LongGen())], 1200, 14),
            num_partitions=3).write.mode("overwrite").parquet(path)
    finally:
        gen.stop()
    return path


def test_chip_failure_with_mesh_scan(tmp_path):
    """Mesh scan and a failing chip: the degraded re-plan re-shards the
    reader streams over the survivors (scan and exchange demote
    together)."""
    path = _write_parquet(tmp_path)

    def q(s, f, port):
        return s.read.parquet(path).repartition(4, "k").groupBy("k") \
            .agg(f.sum("v").alias("s"))

    plans, jplans = _run_both(q, _ici_conf("0"))
    assert _metric(plans, M.DEGRADED_CHIPS) > 0
    assert _jmetric(jplans, "degradedChips") > 0
    units = {k: v for p in plans for k, v in plan_metrics(p).items()
             if k.startswith("meshScanUnits.chip")}
    # the run that finished scanned on the 7 survivors only
    assert "meshScanUnits.chip0" not in units and len(units) == 7


def test_mesh_sharded_streams_retry_io(tmp_path):
    """The per-chip reader streams of the mesh scan go through the same
    IO retry as a single stream."""
    path = _write_parquet(tmp_path)
    conf = {
        "spark.rapids.shuffle.mode": "ici",
        "spark.rapids.sql.test.injectIOError": "2",
        "spark.rapids.sql.reader.retryBackoffMs": "1",
    }
    s = TorchSparkSession(conf, device="cpu")
    try:
        s.start_capture()
        got = _rows(s.read.parquet(path).repartition(4, "k").groupBy("k")
                    .agg(F.sum("v").alias("s"))._execute().to_pydict())
        plans = s.get_captured_plans()
    finally:
        s.stop()
    assert _metric(plans, M.IO_RETRY_COUNT) > 0
    assert sum(v for p in plans for k, v in plan_metrics(p).items()
               if k.startswith("meshScanUnits.chip")) == 3
    cpu = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        want = _rows(cpu.read.parquet(path).groupBy("k").agg(
            JF.sum("v").alias("s"))._execute().to_pydict())
    finally:
        cpu.stop()
    assert _canon(got) == _canon(want)


class _StubPlan(P.PhysicalPlan):
    """A plan whose collect follows a script: ``ok`` returns no
    partitions, ``fail`` raises a chip failure, ``race`` demotes the chip
    from "another thread" and then raises."""

    def __init__(self, script, chip):
        self.children = []
        self._script = list(script)
        self._chip = chip

    @property
    def output(self):
        return []

    @property
    def schema(self):
        return T.StructType([])

    def partitions(self):
        step = self._script.pop(0)
        if step == "ok":
            return []
        if step == "race":
            PM.mark_chip_failed(self._chip)
        raise R.TorchChipFailure(self._chip)


def test_chip_failure_race_retries_not_reraises():
    """The collect decides retry or raise against a snapshot taken before
    its attempt: a chip another thread demoted during the attempt still
    retries; only a failure on a chip demoted before the attempt began
    raises (which bounds the loop)."""
    chip = 3
    with PM.active_mesh(PM.build_mesh()):
        assert _StubPlan(["fail", "ok"], chip).execute_collect() \
            .num_rows == 0
        assert chip in PM.failed_chips()
    with PM.active_mesh(PM.build_mesh()):
        assert _StubPlan(["race", "ok"], chip).execute_collect() \
            .num_rows == 0
    with PM.active_mesh(PM.build_mesh()):
        PM.mark_chip_failed(chip)
        with pytest.raises(R.TorchChipFailure):
            _StubPlan(["fail"], chip).execute_collect()


def test_degraded_mesh_state_resets_per_activation():
    with PM.active_mesh(PM.build_mesh()):
        assert PM.mark_chip_failed(0)
        assert not PM.mark_chip_failed(0)  # already demoted: no recount
        assert PM.degraded_chip_count() == 1
        hm = PM.healthy_mesh()
        assert hm is not None and 0 not in [c.id for c in hm.chips]
        for c in range(1, 7):
            PM.mark_chip_failed(c)
        assert PM.healthy_mesh() is None  # one survivor: no mesh
    with PM.active_mesh(PM.build_mesh()):
        assert PM.degraded_chip_count() == 0  # a fresh activation
        assert PM.healthy_mesh() is PM.get_active_mesh()


def test_injector_counts_chip_failures_persistently():
    """A failing chip fails at every checkpoint (persistent), and the
    injector counts each, as the JAX package's on_chip does."""
    from spark_rapids_tpu_torch.conf import TorchConf
    conf = TorchConf({"spark.rapids.sql.test.injectChipFailure": "2, 5"})
    for _ in range(3):
        with pytest.raises(R.TorchChipFailure) as ei:
            R.chip_checkpoint(conf, 5)
        assert ei.value.chip_id == 5
    R.chip_checkpoint(conf, 1)  # a healthy chip passes
    inj = R.get_fault_injector(conf)
    assert inj.chip_failures_injected == 3
    assert inj.stats()["chipFailuresInjected"] == 3
    # a chip failure is never retried as an out-of-memory error
    calls = []

    def boom():
        calls.append(1)
        raise R.TorchChipFailure(2)

    with pytest.raises(R.TorchChipFailure):
        R.with_retry(boom, conf)
    assert len(calls) == 1 and not R.is_oom_error(R.TorchChipFailure(2))


@pytest.mark.parametrize("chips", ["1", "0,1,2"])
def test_q1_shape_degrades_over_the_mesh_scan(tmp_path, chips):
    """The q1 shape from Parquet over 4 chips, with one chip and then
    three failing (the second leg ends on the single-chip path), rows
    equal to the clean run's."""
    from spark_rapids_tpu_torch import soak as SOAK
    PM.emulate_chips(4, CPU)
    SOAK.make_soak_data(str(tmp_path), device="cpu")
    sql = SOAK.Q1

    def run(conf):
        R.reset_fault_injection()
        s = TorchSparkSession(conf, device="cpu")
        try:
            s.read.parquet(str(tmp_path / "lineitem")) \
                .createOrReplaceTempView("lineitem")
            s.start_capture()
            rows = _rows(s.sql(sql)._execute().to_pydict())
            return rows, s.get_captured_plans()
        finally:
            s.stop()

    want, _ = run({})
    got, plans = run(_ici_conf(chips))
    assert got == want
    assert _metric(plans, M.DEGRADED_CHIPS) == len(chips.split(","))
