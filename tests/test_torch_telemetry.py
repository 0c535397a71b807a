"""Live telemetry (``telemetry/``) held against the JAX package's: the
trigger engine fires the same triggers from the same conditions; the
Prometheus renderer, ``format_top``, the doctor and ``bench_diff`` give
byte-identical output from the same input; and, in the port, a served
query's slow-query bundle carries a flight-recorder dump that loads,
the exporter's counters stay monotone across plan lifetimes, and the
doctor names the retry block of a query that rode OOM retries."""

import json
import os
import time

import pytest

from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.telemetry import bench_diff as JBD
from spark_rapids_tpu.telemetry import doctor as JDOC
from spark_rapids_tpu.telemetry import history as JH
from spark_rapids_tpu.telemetry import prometheus as JPROM
from spark_rapids_tpu.telemetry import top as JTOP
from spark_rapids_tpu.telemetry import triggers as JTRG

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.sql.session import TorchSparkSession
from spark_rapids_tpu_torch.telemetry import bench_diff as BD
from spark_rapids_tpu_torch.telemetry import doctor as DOC
from spark_rapids_tpu_torch.telemetry import history as H
from spark_rapids_tpu_torch.telemetry import prometheus as PROM
from spark_rapids_tpu_torch.telemetry import top as TOP
from spark_rapids_tpu_torch.telemetry import triggers as TRG

from tests.torch_serve_support import (Q1S, TIMEOUT, clients, reset_state,
                                       serving, write_tables)

@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("tel_tables")))


def _engine_run(mod, conf_cls, d):
    eng = mod.TriggerEngine()
    conf = conf_cls({
        "spark.rapids.sql.telemetry.dir": d,
        "spark.rapids.sql.telemetry.slowQueryMs": "50",
        "spark.rapids.sql.telemetry.hbmWatermark": "0.5",
        "spark.rapids.sql.telemetry.queueWatermark": "0.5",
        "spark.rapids.sql.telemetry.retryStormThreshold": "2",
        "spark.rapids.sql.telemetry.triggerMinIntervalS": "3600"})
    eng.configure(conf)
    for dev in (10, 40, 60, 90):
        eng.on_store_sample(dev, 100)
    for q in (1, 3, 6, 7):
        eng.on_admission(q, 10)
    for _ in range(4):
        eng.on_retry()
    for wall in (0.01, 0.2, 0.3):
        eng.on_query_end(conf, wall, tenant="t", query_id=1)
    assert eng.drain(10)
    st = eng.stats()
    names = sorted(os.path.basename(p).split("-", 3)[3]
                   for p in st["bundles"])
    return st["fired"], st["rateLimited"], names


def test_trigger_engine_fires_like_jax_package(tmp_path):
    port = _engine_run(TRG, TorchConf, str(tmp_path / "port"))
    jax = _engine_run(JTRG, TpuConf, str(tmp_path / "jax"))
    assert port == jax
    assert set(port[0]) == {"hbmWatermark", "queueSaturation",
                            "retryStorm", "slowQuery"}
    assert port[1]  # the rate limit held back the repeats


def test_unarmed_hooks_do_nothing():
    eng = TRG.TriggerEngine()
    TRG.on_store_sample(10 ** 12, 1)
    TRG.on_admission(10, 1)
    TRG.on_retry()
    assert not eng.armed and TRG.engine().stats()["fired"] == {}


def _fixed_stats():
    return {
        "host": "127.0.0.1", "port": 4242, "uptimeSeconds": 12.5,
        "queriesOk": 7, "queriesErr": 1, "queriesCancelled": 2, "qps": 0.56,
        "admission": {
            "inFlight": 1, "queued": 2, "admitted": 9, "rejected": 1,
            "throttledWaits": 3, "maxConcurrentQueries": 4,
            "maxQueued": 64,
            "tenants": {"a": {"admitted": 5, "rejected": 0, "inFlight": 1,
                              "queueWaitMs": {"p50": 1.5, "p99": 9.25},
                              "latencyMs": {"p50": 20.0, "p99": 80.5,
                                            "count": 5}},
                        "b": {"admitted": 4, "rejected": 1, "inFlight": 0,
                              "queueWaitMs": {"p50": 0.5, "p99": 2.0}}}},
        "tenantsHBM": {"a": {"liveBytes": 0, "peakBytes": 1 << 20,
                             "spillBytes": 0}},
        "lifecycle": {"queriesQuarantined": 1, "cancelledByReason":
                      {"deadline": 2}},
        "batchFusion": {"fusedQueries": 6, "fusedBatches": 2},
        "cache": {"result": {"hits": 3, "misses": 4, "entries": 2,
                             "bytes": 4096, "invalidations": 1,
                             "evictions": 0}},
        "slo": {"a": {"objectiveP99Ms": 50, "observedP99Ms": 80.5,
                      "windowQueries": 5, "violations": 2,
                      "burnRatio": 0.4}},
        "tuning": {"ticks": 3, "actionsByName": {"limitConcurrency": 1},
                   "actionsReverted": 0, "activeActions": 1,
                   "pinnedActions": 0, "prewarmedSignatures": 1},
    }


_SERVER_PREFIXES = ("srt_queries_", "srt_uptime", "srt_qps",
                    "srt_admission_", "srt_tenant_admitted",
                    "srt_tenant_rejected", "srt_tenant_in_flight",
                    "srt_tenant_queue_wait", "srt_tenant_latency",
                    "srt_aqe_batch", "srt_cache_", "srt_slo_",
                    "srt_tuning_")


def _server_part(text):
    keep = []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else line
        if name.startswith(_SERVER_PREFIXES):
            keep.append(line)
    return keep


def test_render_prometheus_server_families_match_jax_package():
    stats = _fixed_stats()
    port = _server_part(PROM.render_prometheus(server_stats=stats))
    jax = _server_part(JPROM.render_prometheus(server_stats=stats))
    assert port == jax
    assert 'srt_slo_burn_ratio{tenant="a"} 0.4' in port
    assert PROM.SERVER_FAMILY_HELP == JPROM.SERVER_FAMILY_HELP


@pytest.mark.parametrize("key", ["numOutputRows", "copyToDeviceTime",
                                 "peakDeviceMemory",
                                 "kernelDispatchCount.joinProbe",
                                 "deviceDecodedValues.PLAIN"])
def test_engine_family_names_match_jax_package(key):
    assert PROM.engine_family(key) == JPROM.engine_family(key)
    assert PROM.prom_name(key) == JPROM.prom_name(key)


def test_exporter_counters_stay_monotone_across_plan_lifetimes():
    import gc
    before, _ = PROM.aggregator().scrape()
    reg = M.MetricRegistry(owner="TorchProbeExec")
    reg.create("kernelDispatchCount.joinProbe").add(5)
    mid, changed = PROM.aggregator().scrape()
    assert changed >= 1
    key = "kernelDispatchCount.joinProbe"
    assert mid.get(key, 0) == before.get(key, 0) + 5
    del reg
    gc.collect()
    after, _ = PROM.aggregator().scrape()
    assert after.get(key, 0) == mid[key]


def test_registry_snapshot_scopes_to_an_epoch():
    """A snapshot over every live registry counts only those created at
    or after a ``begin_epoch()`` stamp when asked to."""
    old = M.MetricRegistry(owner="TorchOldExec")
    old.create("kernelDispatchCount.murmur3").add(3)
    epoch = M.begin_epoch()
    assert M.current_epoch() == epoch
    new = M.MetricRegistry(owner="TorchNewExec")
    new.create("kernelDispatchCount.murmur3").add(4)
    scoped = M.registry_snapshot(epoch=epoch)["metrics"]
    assert scoped["kernelDispatchCount.murmur3"] == 4
    assert M.registry_snapshot()["metrics"][
        "kernelDispatchCount.murmur3"] >= 7
    assert M.registry_snapshot(plans=[])["metrics"] == {}
    assert old.owner and new.owner


def test_format_top_matches_jax_package():
    stats = _fixed_stats()
    prev = dict(stats, queriesOk=3)
    assert TOP.format_top(stats) == JTOP.format_top(stats)
    assert TOP.format_top(stats, prev, 2.0) == \
        JTOP.format_top(stats, prev, 2.0)


def _bench_doc(scale: float) -> dict:
    return {"metric": "q1_rows_per_s", "value": 1000.0 * scale,
            "detail": {"device_wall_s": 2.0 / scale,
                       "tpcds_q3": {"device_wall_s": 1.5},
                       "cpu_engine_wall_s": 9.0,
                       "serving": {"concurrency": {"c4": {"qps": 40.0 *
                                                          scale}}},
                       "trace": {"tracingOverhead": 0.02 / scale}}}


def test_bench_diff_matches_jax_package(tmp_path):
    """Two synthetic bench results, in two of the layouts ``load_bench``
    reads (a harness wrapper under ``parsed``; a log whose last JSON line
    is the result), diffed both ways and against themselves."""
    a = tmp_path / "BENCH_r01.json"
    b = tmp_path / "BENCH_r02.json"
    a.write_text(json.dumps({"parsed": _bench_doc(1.0)}))
    b.write_text("warming up\n" + json.dumps(_bench_doc(0.7)) + "\n")
    for x, y in ((a, b), (b, a), (a, a)):
        rp = BD.bench_diff(BD.load_bench(str(x)), BD.load_bench(str(y)))
        rj = JBD.bench_diff(JBD.load_bench(str(x)), JBD.load_bench(str(y)))
        assert rp == rj
        assert BD.format_diff(rp) == JBD.format_diff(rj)
    assert BD.bench_diff(BD.load_bench(str(a)), BD.load_bench(str(b)))[
        "verdict"] == "regression"
    assert BD.latest_bench_file(str(tmp_path)) == \
        JBD.latest_bench_file(str(tmp_path)) == str(b)


def _rec(ts, sig="a" * 40, status="finished", wall=0.1, **kw):
    r = {"version": 1, "ts": ts, "signature": sig, "status": status,
         "wallSeconds": wall, "queueWaitSeconds": 0.0, "outputRows": 10}
    r.update(kw)
    return r


@pytest.mark.parametrize("target", [
    {"retryCount": 6, "spillBytes": 1 << 20},
    {"jitMisses": 64},
    {"kernelFallbacks": 6, "kernelFallbacksByName": {"joinProbe": 6}},
    {"outputRows": 100000},
    {"queueWaitSeconds": 2.0},
])
def test_doctor_verdicts_match_jax_package(tmp_path, target):
    t0 = time.time()
    recs = [_rec(t0 - 60 + i, wall=0.05, queryId=f"b{i}")
            for i in range(4)]
    recs.append(_rec(t0, wall=0.5, queryId="target", **target))
    d = str(tmp_path / "hist")
    store = H.HistoryStore(d, 1 << 30, 14)
    for r in recs:
        store.append(r)
    dp, dj = DOC.diagnose(d, "target"), JDOC.diagnose(d, "target")
    assert dp == dj
    assert DOC.format_diagnosis(dp) == JDOC.format_diagnosis(dj)
    sp, sj = DOC.scan_signatures(d), JDOC.scan_signatures(d)
    assert sp == sj
    assert DOC.format_scan(sp) == JDOC.format_scan(sj)
    assert dp["verdict"] != "unknown"
    assert DOC.diagnose(d, "bogus") == JDOC.diagnose(d, "bogus")


def test_exclusive_times_is_the_jax_packages():
    from spark_rapids_tpu.tools import exclusive_times as jx
    spans = [{"name": "op", "t0": 0.0, "t1": 10.0, "tid": 1},
             {"name": "retryBlock", "t0": 2.0, "t1": 5.0, "tid": 1},
             {"name": "op", "t0": 12.0, "t1": 13.0, "tid": 2}]
    assert DOC.exclusive_times([dict(s) for s in spans]) == \
        jx([dict(s) for s in spans])


def test_doctor_names_the_retry_block_of_a_port_query(root, tmp_path):
    """Clean baselines, then one run riding OOM retries, in the port: the
    doctor diagnoses it from the port's own history, profile and trace
    files, and the JAX package's doctor reads them to the same
    diagnosis."""
    hdir = str(tmp_path / "hist")
    conf = {"spark.rapids.sql.telemetry.history.dir": hdir,
            "spark.rapids.sql.planCache.enabled": "true",
            "spark.rapids.sql.profile.enabled": "true",
            "spark.rapids.sql.profile.dir": str(tmp_path / "prof"),
            "spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.dir": str(tmp_path / "traces"),
            "spark.rapids.sql.retry.backoffMs": "30",
            "spark.rapids.sql.retry.maxBackoffMs": "200"}

    def run(extra):
        s = TorchSparkSession(dict(conf, **extra), device="cpu")
        s.read.parquet(os.path.join(root, "lineitem")) \
            .createOrReplaceTempView("lineitem")
        return s.sql(Q1S).collect()

    want = [run({}) for _ in range(3)][0]
    TR.reset_tracing()
    assert run({"spark.rapids.sql.test.injectOOM": "2:2"}) == want
    R.reset_fault_injection()
    recs = H.read_records(hdir)
    assert len(recs) == 4 and len({r["signature"] for r in recs}) == 1
    assert recs[-1]["retryCount"] > 0
    qid = str(recs[-1]["queryId"])
    d = DOC.diagnose(hdir, qid)
    assert d["verdict"] == "retrySpill"
    assert d["divergentStage"] == "retryBlock"
    assert JDOC.diagnose(hdir, qid) == d


def test_served_slow_query_writes_a_bundle_with_a_ring_dump(root,
                                                            tmp_path):
    tel = str(tmp_path / "tel")
    with serving("port", root, **{
            "spark.rapids.sql.telemetry.slowQueryMs": "1",
            "spark.rapids.sql.telemetry.dir": tel}) as srv:
        with clients()["port"](srv.port, tenant="s", timeout=TIMEOUT) as c:
            c.collect(Q1S)
        assert TRG.engine().drain(TIMEOUT)
    bundles = [f for f in os.listdir(tel) if f.startswith("bundle-")]
    assert bundles and bundles[0].endswith("-slowQuery.json")
    with open(os.path.join(tel, bundles[0])) as f:
        b = json.load(f)
    assert b["serverStats"]["queriesOk"] >= 0
    loaded = TR.load_trace(b["ringDump"])
    assert any(i["name"] == "queryEnd" for i in loaded["instants"])
    assert any(s["name"] == "serveQueueWait" for s in loaded["spans"])


def test_top_renders_a_frame_from_a_port_server(root, capsys):
    with serving("port", root) as srv:
        with clients()["port"](srv.port, tenant="s", timeout=TIMEOUT) as c:
            c.collect(Q1S)
        assert TOP.run_top(srv.port, interval=0.05, iterations=1) == 0
    out = capsys.readouterr().out
    assert "admission:" in out and "serve 127.0.0.1" in out
    assert TOP.run_top(srv.port, once=True) == 1  # the server went away


def test_metrics_http_binds_the_loopback(root):
    import urllib.error
    import urllib.request
    with serving("port", root) as srv:
        hport = srv.start_metrics_http(0)
        assert srv._metrics_httpd.server_address[0] == "127.0.0.1"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{hport}/nothing",
                                   timeout=TIMEOUT)
        assert e.value.code == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{hport}/metrics",
                                    timeout=TIMEOUT) as r:
            assert r.status == 200
            assert b"srt_undescribed_metric_keys" in r.read()
