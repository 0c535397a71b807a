"""The span tracer, the event log and the metric levels, held against the
JAX package: TPC-H q1 and TPC-DS q3's pushed form read from Parquet by
the JAX package's TpuSparkSession (kernels interpreted on the CPU) and
by the port's TorchSparkSession(device="cpu") with tracing, profiling,
the event log and the query history on. Rows must equal the untraced
runs' in both packages, the two traces must record the same span and
instant kinds (``Tpu`` read as ``Torch``), each package's trace file
must load in the other's ``load_trace``, and the event logs must list
the same operators. Files are written under ``tmp_path``."""

import os
import threading

import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import (Q1, Q3_PUSHED, lineitem_arrays, lineitem_fields,
                        q3_tables)
from spark_rapids_tpu import event_log as JEL
from spark_rapids_tpu import metrics as JM
from spark_rapids_tpu import trace as JTR
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import event_log as EL
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession
from spark_rapids_tpu_torch.telemetry import ring as RING

torch.set_num_threads(2)

QUERIES = {"q1": Q1, "q3": Q3_PUSHED}


def _q3_types(mod):
    return {"long": mod.LongT, "int": mod.IntegerT, "str": mod.StringT,
            "dec72": mod.DecimalType(7, 2)}


@pytest.fixture(autouse=True)
def _fresh_tracing():
    TR.reset_tracing()
    JTR.reset_tracing()
    yield
    TR.reset_tracing()
    JTR.reset_tracing()


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """q1's lineitem (6,000 rows, 3 files of 2 row groups) and the q3
    tables (6,000 store_sales rows), 4 files each, as Parquet."""
    base = str(tmp_path_factory.mktemp("obs"))
    out = {}
    tbl = host_batch_to_arrow(host_batch_from_numpy(
        lineitem_fields(), lineitem_arrays(6000)))
    out["lineitem"] = os.path.join(base, "lineitem")
    os.makedirs(out["lineitem"])
    for i in range(3):
        pq.write_table(tbl.slice(i * 2000, 2000),
                       os.path.join(out["lineitem"], f"part-{i}.parquet"),
                       row_group_size=1000)
    tables = q3_tables(6000)
    s = TorchSparkSession(device="cpu")
    types = _q3_types(PT)
    for name in ("item", "date_dim", "store_sales"):
        cols = tables[name]
        batch = host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                                      [a for _c, _k, a in cols])
        out[name] = os.path.join(base, name)
        s.createDataFrame(batch, num_partitions=4).write \
            .mode("overwrite").parquet(out[name])
    return out


def _obs_conf(d: str, level: str = "DEBUG") -> dict:
    return {"spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.dir": os.path.join(d, "trace"),
            "spark.rapids.sql.profile.enabled": "true",
            "spark.rapids.sql.profile.dir": os.path.join(d, "profile"),
            "spark.rapids.sql.eventLog.dir": os.path.join(d, "events"),
            "spark.rapids.sql.telemetry.history.dir":
                os.path.join(d, "history"),
            "spark.rapids.sql.metrics.level": level}


def _run(pkg: str, views: dict, sql: str, conf: dict):
    """(rows, executed plans) of ``sql`` in one package."""
    if pkg == "jax":
        s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    else:
        s = TorchSparkSession(dict(conf), device="cpu")
    try:
        for name, path in views.items():
            s.read.parquet(path).createOrReplaceTempView(name)
        s.start_capture()
        rows = [tuple(r) for r in s.sql(sql).collect()]
        return rows, list(s.get_captured_plans())
    finally:
        s.stop()


def _only(d: str) -> str:
    (name,) = os.listdir(d)
    return os.path.join(d, name)


@pytest.fixture(scope="module")
def runs(views, tmp_path_factory):
    """Each query through both packages, traced and untraced."""
    from spark_rapids_tpu_torch.exec.fused import STAGE_CACHE
    out = {}
    for q, sql in QUERIES.items():
        for pkg in ("jax", "port"):
            TR.reset_tracing()
            JTR.reset_tracing()
            STAGE_CACHE.clear()
            d = str(tmp_path_factory.mktemp(f"{pkg}-{q}"))
            rows, plans = _run(pkg, views, sql, _obs_conf(d))
            plain, _ = _run(pkg, views, sql, {})
            out[pkg, q] = {"dir": d, "rows": rows, "plain": plain,
                           "plans": plans}
    return out


def _kinds(loaded) -> tuple:
    spans = {s["name"].replace("Tpu", "Torch") for s in loaded["spans"]}
    instants = {i["name"] for i in loaded["instants"]}
    return spans, instants


@pytest.mark.parametrize("q", list(QUERIES))
def test_traced_rows_match_untraced_in_both_packages(runs, q):
    j, p = runs["jax", q], runs["port", q]
    assert j["rows"] == j["plain"] == p["rows"] == p["plain"]
    assert p["rows"]


@pytest.mark.parametrize("q", list(QUERIES))
def test_span_and_instant_kinds_match_jax_package(runs, q):
    jt = JTR.load_trace(_only(os.path.join(runs["jax", q]["dir"], "trace")))
    pt = TR.load_trace(_only(os.path.join(runs["port", q]["dir"], "trace")))
    # a compile span marks a cache miss: whether the JAX package's
    # program caches are cold depends on what ran before in the process,
    # so it is left out of the comparison (the port's are cleared first)
    (jspans, jinst), (pspans, pinst) = _kinds(jt), _kinds(pt)
    assert pspans - {"compile"} == jspans - {"compile"}
    assert pinst == jinst
    assert {"kernelDispatch", "compile"} <= pspans


@pytest.mark.parametrize("q", list(QUERIES))
@pytest.mark.parametrize("direction", ["port-in-jax", "jax-in-port"])
def test_trace_files_load_in_the_other_package(runs, q, direction):
    src = "port" if direction == "port-in-jax" else "jax"
    path = _only(os.path.join(runs[src, q]["dir"], "trace"))
    own = (TR if src == "port" else JTR).load_trace(path)
    other = (JTR if src == "port" else TR).load_trace(path)
    assert other["spans"] == own["spans"]
    assert other["meta"]["outputRows"] == len(runs[src, q]["rows"])


@pytest.mark.parametrize("q", list(QUERIES))
def test_every_span_kind_is_catalogued(runs, q):
    pt = TR.load_trace(_only(os.path.join(runs["port", q]["dir"], "trace")))
    for s in pt["spans"]:
        name = s["name"]
        if name in TR.SPAN_CATALOG:
            continue
        owner, _, metric = name.partition(".")
        assert owner.startswith(("Torch", "FileScan")) \
            and M.describe_metric(metric) is not None, name
    for i in pt["instants"]:
        assert i["name"] in TR.INSTANT_CATALOG


@pytest.mark.parametrize("q", list(QUERIES))
def test_kernel_spans_equal_the_dispatch_counters(runs, q):
    """On the CPU every kernel's plain version is called directly (no
    graph replays), so the kernelDispatch spans of a kernel equal its
    kernelDispatchCount over the plan."""
    pt = TR.load_trace(_only(os.path.join(runs["port", q]["dir"], "trace")))
    spans: dict = {}
    for s in pt["spans"]:
        if s["name"] == "kernelDispatch":
            k = s["args"]["kernel"]
            spans[k] = spans.get(k, 0) + 1
    (plan,) = runs["port", q]["plans"]
    counts = {k.split(".", 1)[1]: v
              for k, v in M.plan_metrics(plan).items()
              if k.startswith("kernelDispatchCount.") and v}
    assert spans == counts
    assert counts.get("decodeFused", 0) > 0


@pytest.mark.parametrize("q", list(QUERIES))
def test_event_log_op_lists_match_jax_package(runs, q):
    (jev,) = list(JEL.read_events(os.path.join(runs["jax", q]["dir"],
                                               "events")))
    (pev,) = list(EL.read_events(os.path.join(runs["port", q]["dir"],
                                              "events")))
    assert [o["op"].replace("Tpu", "Torch") for o in jev["ops"]] == \
        [o["op"] for o in pev["ops"]]
    assert pev["status"] == jev["status"] == "finished"
    assert pev["outputRows"] == jev["outputRows"]
    assert pev["version"] == jev["version"]


def _metric_names(plans, describe) -> set:
    out = set()
    for p in plans:
        out |= set(M.plan_metrics(p)) if describe is M.describe_metric \
            else set(JM.registry_snapshot([p])["metrics"])
    return out


@pytest.mark.parametrize("level", ["ESSENTIAL", "MODERATE", "DEBUG"])
def test_metric_names_at_each_level_match_jax_package(views, level):
    conf = {"spark.rapids.sql.metrics.level": level}
    _rows, jplans = _run("jax", views, Q1, conf)
    _rows, pplans = _run("port", views, Q1, conf)
    jnames = set()
    for p in jplans:
        jnames |= set(JM.registry_snapshot([p])["metrics"])
    pnames = set()
    for p in pplans:
        pnames |= set(M.plan_metrics(p))
    # the port's own counters, which the JAX package has no metric for
    port_only = {M.PINNED_STREAM_COPIES, M.PLANNED_WORKING_SET}
    # a program cache's outcome depends on what ran before in the
    # process (a miss books stageCompileTime)
    cache = {M.STAGE_COMPILE_TIME, M.COMPILE_CACHE_HITS,
             M.COMPILE_CACHE_MISSES}
    assert pnames - port_only - cache == jnames - cache
    for name in pnames:
        assert M.describe_metric(name) is not None, name


def test_essential_level_keeps_only_essential_names(views):
    _rows, plans = _run("port", views, Q1,
                        {"spark.rapids.sql.metrics.level": "ESSENTIAL"})
    names = set()
    for p in plans:
        names |= set(M.plan_metrics(p))
    assert names and all(M.default_level(n) == M.ESSENTIAL for n in names)


class _Conf:
    def __init__(self, settings):
        self.settings = settings

    def get(self, entry):
        return entry.get(self.settings)


def test_sampling_stream_matches_jax_package(tmp_path):
    """The same seed samples the same queries in both packages."""
    seq = {}
    for name, mod in (("port", TR), ("jax", JTR)):
        mod.reset_tracing()
        c = _Conf({"spark.rapids.sql.trace.enabled": "true",
                   "spark.rapids.sql.trace.sampleRate": "0.4",
                   "spark.rapids.sql.trace.sampleSeed": "11",
                   "spark.rapids.sql.trace.dir": str(tmp_path / name)})
        toks = []
        for _ in range(24):
            tok = mod.begin_query(c)
            toks.append(tok)
            mod.end_query(c, tok)
        seq[name] = toks
    assert seq["port"] == seq["jax"]
    assert {"root", "unsampled"} == set(seq["port"])
    assert len(os.listdir(tmp_path / "port")) == seq["port"].count("root")


def test_disabled_tracing_is_one_none_check():
    assert TR.begin_query(_Conf({})) is None
    assert TR.active() is None
    with TR.span("compile", cache="x"):
        pass
    TR.instant("retryOOM", attempt=1)
    TR.counter("deviceStoreBytes", 1)
    assert TR.chip_of(object()) is None


def test_concurrent_queries_fold_without_losing_spans(views, tmp_path):
    """Four threads run q1 at once inside one open file-mode trace (the
    server's connection threads, with the upload ring's producers and
    the reader pool beside them): every query's spans land in the one
    file, which loads."""
    conf = {"spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.dir": str(tmp_path / "trace")}
    s = TorchSparkSession(dict(conf), device="cpu")
    s.read.parquet(views["lineitem"]).createOrReplaceTempView("lineitem")
    outer = TR.begin_query(s.conf_obj)
    assert outer == "root"
    results, errors = [], []

    def work():
        try:
            results.append([tuple(r) for r in s.sql(Q1).collect()])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    path = TR.end_query(s.conf_obj, outer)
    loaded = TR.load_trace(path)
    roots = [sp for sp in loaded["spans"]
             if sp["name"] == "TorchColumnarToRowExec.copyFromDeviceTime"]
    kern = [sp for sp in loaded["spans"] if sp["name"] == "kernelDispatch"]
    assert len(results) == 4 and all(r == results[0] for r in results)
    single = TR.load_trace(_single_q1_trace(views, tmp_path))
    one_roots = [sp for sp in single["spans"] if sp["name"] ==
                 "TorchColumnarToRowExec.copyFromDeviceTime"]
    one_kern = [sp for sp in single["spans"]
                if sp["name"] == "kernelDispatch"]
    assert len(roots) == 4 * len(one_roots)
    assert len(kern) == 4 * len(one_kern)
    assert len({sp["tid"] for sp in loaded["spans"]}) >= 4


def _single_q1_trace(views, tmp_path) -> str:
    TR.reset_tracing()
    d = tmp_path / "single"
    _run("port", {"lineitem": views["lineitem"]}, Q1,
         {"spark.rapids.sql.trace.enabled": "true",
          "spark.rapids.sql.trace.dir": str(d)})
    return _only(str(d))


def test_ring_mode_records_concurrent_queries_and_dumps(views, tmp_path):
    conf = {"spark.rapids.sql.trace.enabled": "true",
            "spark.rapids.sql.trace.mode": "ring",
            "spark.rapids.sql.trace.ringSpans": "100000"}
    s = TorchSparkSession(dict(conf), device="cpu")
    s.read.parquet(views["lineitem"]).createOrReplaceTempView("lineitem")
    threads = [threading.Thread(target=lambda: s.sql(Q1).collect())
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    ring = TR.ring_active()
    assert ring is not None and ring.queries_begun == 3
    path = RING.dump_ring(str(tmp_path))
    loaded = TR.load_trace(path)
    ends = [i for i in loaded["instants"] if i["name"] == "queryEnd"]
    assert len(ends) == 3
    assert JTR.load_trace(path)["spans"] == loaded["spans"]
    assert os.path.basename(path).startswith("trace-ring-")


@pytest.mark.parametrize("sink", ["file", "ring"])
def test_span_appends_lose_nothing_under_thread_switches(sink):
    """More recording threads than cores, switching every few
    microseconds: every span, instant and counter sample lands once."""
    import sys
    qt = TR.QueryTrace(1) if sink == "file" else RING.RingTrace(10 ** 6)
    n_threads, per = 32, 500
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def record(i):
            for j in range(per):
                qt.add("compile", j, j + 1, cache=str(i))
                qt.mark("retryOOM", attempt=j)
                qt.count("deviceStoreBytes", j)
        threads = [threading.Thread(target=record, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    snap = qt if sink == "file" else qt.snapshot()
    assert len(snap.spans) == len(snap.instants) == n_threads * per
    assert len(snap.counters) == n_threads * per
    per_thread = {}
    for sp in snap.spans:
        per_thread[sp[6]["cache"]] = per_thread.get(sp[6]["cache"], 0) + 1
    assert set(per_thread.values()) == {per}


def test_ring_is_bounded_per_thread():
    ring = RING.RingTrace(16)
    for i in range(100):
        ring.add("compile", i, i + 1, cache="x")
    snap = ring.snapshot()
    assert len(snap.spans) == 16


def test_kernel_dispatch_span_skips_graph_capture():
    """A launch recorded into a captured graph runs at each replay, whose
    span carries it, so it takes no kernelDispatch span of its own; with
    tracing off a launch takes no span either."""
    assert KR.dispatch_start() is None
    qt = TR.QueryTrace(1)
    TR._ACTIVE = qt
    try:
        with KR.recording_launches():
            assert KR.dispatch_start() is None
        t0 = KR.dispatch_start()
        assert t0 is not None
        KR.dispatch_end(t0, "groupbyHash", slots=64)
    finally:
        TR._ACTIVE = None
    assert [(s[0], s[6]) for s in qt.spans] == [
        ("kernelDispatch", {"kernel": "groupbyHash", "slots": 64})]


def test_chip_of_reads_the_cuda_index_only_when_tracing():
    class _B:
        active = torch.zeros(2, dtype=torch.bool)
    assert TR.chip_of(_B()) is None
    TR._ACTIVE = TR.QueryTrace(1)
    try:
        assert TR.chip_of(_B()) is None  # a CPU tensor has no card
    finally:
        TR._ACTIVE = None
