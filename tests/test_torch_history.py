"""The query history (``telemetry/history.py``) held against the JAX
package's: the store's segments, compaction and crash safety; the pure
functions (``signature_aggregates``, ``trend_slope``, ``format_history``,
``sig_digest``, ``find_record``) and the SLO tracker giving identical
output from the same records; files either package writes read back by
the other; a session's records; and the server's warm start, which
seeds the lifecycle layer and replays the tuning controller's pre-warm
ledger so a restarted server's first query is a plan-cache hit."""

import glob
import os
import time

import pytest

from spark_rapids_tpu import lifecycle as JLC
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.telemetry import history as JH

from spark_rapids_tpu_torch import lifecycle as LC
from spark_rapids_tpu_torch import plan_cache as PC
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.sql.session import TorchSparkSession
from spark_rapids_tpu_torch.telemetry import history as H
from spark_rapids_tpu_torch.telemetry import tuning as TUN

from tests.torch_serve_support import (Q1S, TIMEOUT, clients, reset_state,
                                       rows, serving, write_tables)


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("hist_tables")))


def _rec(ts, sig="a" * 40, status="finished", wall=0.1, **kw):
    r = {"version": 1, "ts": ts, "signature": sig, "status": status,
         "wallSeconds": wall, "queueWaitSeconds": 0.0, "outputRows": 10}
    r.update(kw)
    return r


def _records(t0):
    """A mixed history: two signatures over hours, tenants, a failure, a
    retry, fallbacks, a cache hit and a tuning audit record."""
    recs = [_rec(t0 - (10 - i) * 3600, wall=0.1 + 0.05 * i,
                 tenant=("acme" if i % 2 else "beta"),
                 retryCount=(2 if i == 3 else 0), queryId=i)
            for i in range(6)]
    recs.append(_rec(t0 - 3000, status="failed", wall=0.0, queryId="q-f"))
    recs.append(_rec(t0 - 2000, sig="b" * 40, kernelFallbacks=2,
                     tenant="acme", wall=0.3, queryId="q-b"))
    recs.append(_rec(t0 - 1000, sig="b" * 40, wall=0.001,
                     resultCacheHit=True, tenant="acme"))
    recs.append(H.build_tuning_record(
        status=H.STATUS_TUNING, action="limitConcurrency",
        scope="a" * 40, knob="signatureConcurrency", old_value=None,
        new_value=2, evidence={}, epoch=1, signature="a" * 40))
    return recs


def test_store_roundtrip_and_torn_tail(tmp_path):
    d = str(tmp_path / "hist")
    store = H.HistoryStore(d, max_bytes=1 << 20, max_age_days=14)
    t0 = time.time() - 10
    for i in range(10):
        store.append(_rec(t0 + i, wall=0.1 * (i + 1),
                          tenant=("a" if i % 2 else "b")))
    seg = sorted(glob.glob(os.path.join(d, "history-*.jsonl")))[-1]
    with open(seg, "a") as f:
        f.write('{"version": 1, "ts": 99, "trunc')
    recs = H.read_records(d)
    assert [r["wallSeconds"] for r in recs] == \
        pytest.approx([0.1 * (i + 1) for i in range(10)])
    assert len(H.read_records(d, tenant="a")) == 5
    assert len(H.read_records(d, signature="a" * 40)) == 10
    # the other package reads the same files to the same records
    assert JH.read_records(d) == recs


def test_store_rotation_and_size_compaction(tmp_path):
    d = str(tmp_path / "hist")
    store = H.HistoryStore(d, max_bytes=2048, max_age_days=0)
    assert store.segment_target == 64 << 10  # the floor
    store.SEGMENT_FLOOR = 512  # tiny segments for the unit
    t0 = time.time()
    for i in range(200):
        store.append(_rec(t0 + i, extra_pad="x" * 64))
    store.compact()
    segs = glob.glob(os.path.join(d, "history-*.jsonl"))
    assert len(segs) > 1
    total = sum(os.path.getsize(p) for p in segs)
    assert total <= store.max_bytes + store.segment_target
    assert store.pruned_segments > 0
    recs = H.read_records(d)
    assert recs and recs[-1]["ts"] == pytest.approx(t0 + 199)


def test_store_age_compaction(tmp_path):
    d = str(tmp_path / "hist")
    store = H.HistoryStore(d, max_bytes=1 << 30, max_age_days=1)
    store.append(_rec(time.time() - 90000))
    with store._lock:
        store._open_segment_locked()
    store.append(_rec(time.time()))
    old_seg = sorted(glob.glob(os.path.join(d, "history-*.jsonl")))[0]
    past = time.time() - 2 * 86400
    os.utime(old_seg, (past, past))
    assert store.compact() == 1
    assert not os.path.exists(old_seg)
    assert len(H.read_records(d)) == 1


@pytest.mark.parametrize("fn", ["signature_aggregates", "trend_slope",
                                "format_history", "sig_digest",
                                "find_record"])
def test_pure_functions_match_jax_package(fn):
    recs = _records(time.time())
    if fn == "signature_aggregates":
        assert H.signature_aggregates(recs) == JH.signature_aggregates(recs)
    elif fn == "trend_slope":
        a = [r for r in recs if r.get("signature") == "a" * 40]
        assert H.trend_slope(a) == JH.trend_slope(a) != 0
    elif fn == "format_history":
        assert H.format_history(recs) == JH.format_history(recs)
        assert H.format_history([]) == JH.format_history([])
        assert H.format_history(recs, top=1) == \
            JH.format_history(recs, top=1)
    elif fn == "sig_digest":
        for s in ("a" * 40, "x" * 7, "SELECT 1||device:cpu"):
            assert H.sig_digest(s) == JH.sig_digest(s)
    else:
        for sel in ("3", "q-f", "q-b", "latest", "missing", "a" * 12):
            assert H.find_record(recs, sel) == JH.find_record(recs, sel)


def test_slo_tracker_matches_jax_package(tmp_path):
    recs = _records(time.time())
    out = {}
    for name, h, conf_cls in (("port", H, TorchConf), ("jax", JH, TpuConf)):
        d = str(tmp_path / name)
        store = h.HistoryStore(d, 1 << 30, 14)
        for r in recs:
            store.append(dict(r))
        conf = conf_cls({
            "spark.rapids.sql.telemetry.history.dir": d,
            "spark.rapids.sql.serve.slo.p99Ms": "200",
            "spark.rapids.sql.serve.slo.p99Ms.beta": "50",
            "spark.rapids.sql.serve.slo.window": str(11 * 3600)})
        tracker = h.SloTracker(conf)
        assert tracker.enabled
        out[name] = tracker.evaluate(max_age_s=0)
    assert out["port"] == out["jax"]
    assert out["port"]["beta"]["burnRatio"] > 0


def test_warm_start_seeds_the_lifecycle_like_jax(tmp_path):
    t0 = time.time()
    recs = [_rec(t0 - 100 + i, sig="s" * 40, wall=0.2 + 0.01 * i)
            for i in range(8)]
    recs += [_rec(t0 - 10 + i, sig="p" * 40, status="failed")
             for i in range(3)]
    got = {}
    for name, h, lc, conf_cls in (("port", H, LC, TorchConf),
                                  ("jax", JH, JLC, TpuConf)):
        d = str(tmp_path / name)
        store = h.HistoryStore(d, 1 << 30, 14)
        for r in recs:
            store.append(dict(r))
        lc.reset_lifecycle()
        summary = h.warm_start(conf_cls({
            "spark.rapids.sql.telemetry.history.dir": d,
            "spark.rapids.sql.serve.quarantineThreshold": "2"}))
        got[name] = (summary, lc.signature_p99("s" * 40),
                     lc.is_quarantined("p" * 40))
        again = h.warm_start(conf_cls({
            "spark.rapids.sql.telemetry.history.dir": d}))
        assert again["alreadyWarm"]
    assert got["port"] == got["jax"]
    assert got["port"][1] is not None and got["port"][2]


def test_session_writes_finished_and_failed_records(root, tmp_path):
    d = str(tmp_path / "hist")
    s = TorchSparkSession({"spark.rapids.sql.telemetry.history.dir": d,
                           "spark.rapids.sql.planCache.enabled": "true",
                           "spark.rapids.sql.serve.tenantId": "acme"},
                          device="cpu")
    s.read.parquet(os.path.join(root, "lineitem")) \
        .createOrReplaceTempView("lineitem")
    got = s.sql(Q1S).collect()
    with pytest.raises(Exception):
        s.sql("SELECT nope FROM lineitem").collect()
    recs = H.read_records(d)
    assert recs[0]["status"] == H.STATUS_FINISHED
    assert recs[0]["outputRows"] == len(got)
    assert recs[0]["tenant"] == "acme"
    assert len(recs[0]["signature"]) == 40
    assert recs[0]["kernelDispatches"] > 0
    assert all(k in H.HISTORY_FIELD_CATALOG for r in recs for k in r)


def test_server_warm_start_and_prewarm_replay(root, tmp_path):
    """A served q1 teaches the tuning controller its SQL; a compile-storm
    record then puts it in the pre-warm ledger. A new server over the
    same history, after a restart (plan cache and lifecycle cleared),
    warm-starts the watchdog's walls and replays the ledger before its
    first request, which is a plan-cache hit."""
    hdir = str(tmp_path / "hist")
    conf = {"spark.rapids.sql.telemetry.history.dir": hdir,
            "spark.rapids.sql.serve.tuning.enabled": "true",
            "spark.rapids.sql.serve.tuning.intervalS": "3600"}
    with serving("port", root, **conf) as srv:
        with clients()["port"](srv.port, tenant="t", timeout=TIMEOUT) as c:
            want = c.collect(Q1S)
            for _ in range(5):
                c.collect(Q1S)
        sig = H.read_records(hdir)[-1]["signature"]
        # a compile storm on the shape (the doctor's compileStorm)
        store = H.HistoryStore(hdir, 1 << 30, 14)
        store.append(_rec(time.time(), sig=sig, wall=5.0, jitMisses=64))
        srv._tuning.tick()
        assert sig in TUN.load_state(hdir)["prewarm"]
    # the restart: nothing of the first server's process state survives
    PC.PLAN_CACHE.clear()
    PC.set_prewarm_digests(set())
    LC.reset_lifecycle()
    H.reset_history()
    assert LC.signature_p99(sig) is None
    # views registered before start(), so the replay plans against them
    from tests.torch_serve_support import VIEWS, _conf
    from spark_rapids_tpu_torch.serve import QueryServer
    srv2 = QueryServer(_conf(conf), device="cpu")
    for v in VIEWS:
        srv2.register_view(v, os.path.join(root, v))
    srv2.start()
    try:
        assert srv2.warm_start_summary["walls"] >= 6
        assert LC.signature_p99(sig) is not None
        assert srv2._tuning.prewarm_replayed == 1
        with clients()["port"](srv2.port, tenant="t",
                               timeout=TIMEOUT) as c:
            batch, head = c.sql(Q1S)
            assert rows(batch) == want
            assert head["planCacheHit"] is True
    finally:
        assert srv2.shutdown(TIMEOUT)
