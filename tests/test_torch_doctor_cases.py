"""The doctor and query-history cases that the out-of-core and adaptive
suites of the JAX package carry (``tests/test_out_of_core.py``'s doctor
cases, ``tests/test_adaptive.py``'s history and doctor cases), run
against the port's ``telemetry.doctor`` and ``telemetry.history``: the
same history files give the JAX doctor's diagnosis, and the port's own
runs of the skewed join record what the JAX package's runs record."""

from __future__ import annotations

import os

import pytest
import torch

from spark_rapids_tpu.telemetry import doctor as JDOC

from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.sql.session import TorchSparkSession
from spark_rapids_tpu_torch.telemetry import doctor as DOC
from spark_rapids_tpu_torch.telemetry import history as H

import tests.test_adaptive as JA
import tests.test_out_of_core as JOOC

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_state():
    TR.reset_tracing()
    R.reset_fault_injection()
    H.reset_history()
    yield
    TR.reset_tracing()
    R.reset_fault_injection()
    H.reset_history()


# ---------------------------------------------------------------------------
# doctor over hand-written history records (the out-of-core cases)
# ---------------------------------------------------------------------------

def test_doctor_planned_big_input_is_bigger_input(tmp_path):
    """A correctly planned run far over budget spills by design with no
    retries: the doctor ranks biggerInput over retrySpill, as the JAX
    doctor does on the same records."""
    recs = [JOOC._hist_record(f"b{i}", wall=1.0, rows=1000)
            for i in range(3)]
    recs.append(JOOC._hist_record(
        "target", wall=3.0, rows=10000, retries=0, spill=50_000_000,
        poc={"plannedPartitions": 16, "budgetPressurePeak": 1000}))
    hdir = JOOC._write_history(tmp_path, recs)
    d = DOC.diagnose(hdir, "target")
    assert d.get("error") is None
    assert d["verdict"] == "biggerInput", d["verdicts"]
    by_class = {v["class"]: v for v in d["verdicts"]}
    assert by_class["biggerInput"]["score"] > \
        by_class.get("retrySpill", {"score": 0.0})["score"]
    assert any("planned out-of-core" in e
               for e in by_class["biggerInput"]["evidence"])
    assert d == JDOC.diagnose(hdir, "target")


def test_doctor_retry_storm_recommends_planned_out_of_core(tmp_path):
    """An unplanned retry storm keeps its retrySpill verdict, and the
    evidence names the confs that move the workload onto the planned
    tier."""
    recs = [JOOC._hist_record(f"b{i}", wall=1.0, rows=1000)
            for i in range(3)]
    recs.append(JOOC._hist_record("storm", wall=4.0, rows=1000, retries=9,
                                  spill=50_000_000))
    hdir = JOOC._write_history(tmp_path, recs)
    d = DOC.diagnose(hdir, "storm")
    assert d.get("error") is None
    by_class = {v["class"]: v for v in d["verdicts"]}
    assert "retrySpill" in by_class, d["verdicts"]
    assert any("deviceBudgetBytes" in e
               for e in by_class["retrySpill"]["evidence"])
    assert d == JDOC.diagnose(hdir, "storm")


# ---------------------------------------------------------------------------
# history and doctor over the port's own runs (the adaptive cases)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    d = tmp_path_factory.mktemp("adaptive_data")
    from tests.datagen import (IntegerGen, KeyStringGen, LongGen,
                               SmallIntGen, gen_batch)
    from spark_rapids_tpu.sql.session import TpuSparkSession
    gen = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        gen.createDataFrame(gen_batch(
            [("flag", KeyStringGen(cardinality=3)),
             ("status", SmallIntGen()), ("qty", LongGen()),
             ("price", IntegerGen())], 2000, 71), num_partitions=4) \
            .write.mode("overwrite").parquet(str(d / "lineitem"))
    finally:
        gen.stop()
    return str(d / "lineitem")


def _run_sql(lineitem, sql, **conf):
    s = TorchSparkSession({k: str(v) for k, v in conf.items()},
                          device="cpu")
    try:
        s.read.parquet(lineitem).createOrReplaceTempView("lineitem")
        return [tuple(r) for r in s.sql(sql).collect()]
    finally:
        s.stop()


def test_plan_signature_excludes_adaptive_and_fusion_confs(lineitem,
                                                           tmp_path):
    """adaptive.* and serve.batchFusion.* confs gate runtime behaviour,
    not plan shape: runs differing only in them land on one history
    signature, while a planning conf still splits it."""
    hdir = str(tmp_path / "hist")
    base = {"spark.rapids.sql.telemetry.history.dir": hdir,
            "spark.rapids.sql.planCache.enabled": "true"}
    _run_sql(lineitem, JA.QA, **base)
    _run_sql(lineitem, JA.QA, **base,
             **{"spark.rapids.sql.adaptive.enabled": "false",
                "spark.rapids.sql.adaptive.skewFactor": "9.5",
                "spark.rapids.sql.adaptive.autoBroadcastBytes": "123",
                "spark.rapids.sql.adaptive.targetPartitionBytes": "1m",
                "spark.rapids.sql.serve.batchFusion.enabled": "false",
                "spark.rapids.sql.serve.batchFusion.windowMs": "99",
                "spark.rapids.sql.serve.batchFusion.maxBatch": "4"})
    _run_sql(lineitem, JA.QA, **base,
             **{"spark.rapids.sql.batchSizeRows": "333"})
    recs = H.read_records(hdir)
    assert len(recs) == 3
    sigs = [r["signature"] for r in recs]
    assert sigs[0] == sigs[1]
    assert sigs[0] != sigs[2]


def _skewed_run(tmp_path, adaptive: bool):
    hdir = str(tmp_path / "hist")
    conf = {**JA._SKEW_BASE,
            "spark.rapids.sql.telemetry.history.dir": hdir,
            "spark.rapids.sql.profile.enabled": "true",
            "spark.rapids.sql.profile.dir": str(tmp_path / "prof")}
    if not adaptive:
        conf["spark.rapids.sql.adaptive.enabled"] = "false"
    s = TorchSparkSession({k: str(v) for k, v in conf.items()},
                          device="cpu")
    try:
        left, right = JA._skew_frames(s, 10, False)
        left.join(right, left["k"] == right["k2"], "inner").collect()
    finally:
        s.stop()
    return hdir


def test_doctor_skewed_shuffle_verdict(tmp_path):
    """The doctor reads the exchange statistics out of the port's profile
    and raises ``skewedShuffle`` when one partition dwarfs the median;
    the adaptive-off run records no aqeActions, so the evidence points
    at the adaptive confs."""
    hdir = _skewed_run(tmp_path, adaptive=False)
    recs = H.read_records(hdir)
    assert len(recs) == 1
    rec = recs[0]
    assert "aqeActions" not in rec
    d = DOC.diagnose(hdir, str(rec["queryId"]))
    assert d.get("error") is None
    assert d["exchangeSkew"].get("ratio", 0) >= 4.0, d["exchangeSkew"]
    classes = [v["class"] for v in d["verdicts"]]
    assert "skewedShuffle" in classes, d["verdicts"]
    sv = next(v for v in d["verdicts"] if v["class"] == "skewedShuffle")
    assert any("adaptive" in e for e in sv["evidence"]), sv
    assert "skewedShuffle" in DOC.format_diagnosis(d)
    # the JAX doctor reads the port's files to the same diagnosis
    assert JDOC.diagnose(hdir, str(rec["queryId"])) == d


def test_history_records_aqe_actions(tmp_path):
    """The adaptive-on run of the same skewed shape lands its replan
    counters in the history record's aqeActions, and the doctor's
    evidence says the skew was pre-split."""
    hdir = _skewed_run(tmp_path, adaptive=True)
    rec = H.read_records(hdir)[0]
    acts = rec.get("aqeActions")
    assert acts and acts.get("aqeSkewSplits", 0) > 0, rec
    assert acts.get("aqeReplans", 0) > 0
    d = DOC.diagnose(hdir, str(rec["queryId"]))
    assert d["aqeActions"] == acts
    if any(v["class"] == "skewedShuffle" for v in d["verdicts"]):
        sv = next(v for v in d["verdicts"]
                  if v["class"] == "skewedShuffle")
        assert any("pre-split" in e for e in sv["evidence"]), sv
    assert os.path.isdir(str(tmp_path / "prof"))
