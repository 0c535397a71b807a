"""The port's cross-query plan cache (``spark_rapids_tpu_torch/
plan_cache.py``) against the JAX package's, and the locked launch and
graph counters.

Checked: the same hit and miss sequence as the JAX package over a run of
queries, signatures that normalize expression ids and keep literals,
skip the serve, adaptive, cache and injection keys and keep every
planning key, identical rows with the cache on and off (and equal to the
JAX package's), ``clone_plan``'s isolation (two clones of one template
run at once on two threads, each exact, the template untouched: no run
state, its metrics as built; run state reset in every clone; fresh
registries and locks; the fused stage's sink bound to the clone's own
ops), ``rebind_conf``, per-thread state of a session shared by two
threads, the pre-warm protector, and ``count_launch``, ``count_replay``
and the graph counters exact under many threads."""

from __future__ import annotations

import os
import threading

import pytest
import torch

from spark_rapids_tpu import plan_cache as JPC
from spark_rapids_tpu.sql.session import TpuSparkSession
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import plan_cache as PC
from spark_rapids_tpu_torch.exec import fused as F
from spark_rapids_tpu_torch.jit_cache import JitCache
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_serve_support import (Q1S, Q3S, TIMEOUT, VIEWS, in_thread,
                                       join, q1_at, q3_at, reset_state,
                                       write_tables)

torch.set_num_threads(2)

CACHE_ON = {"spark.rapids.sql.planCache.enabled": "true",
            "spark.rapids.sql.batchSizeRows": "512"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("plan_cache_tables")))


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


def _views(spark, root):
    for v in VIEWS:
        spark.read.parquet(os.path.join(root, v)).createOrReplaceTempView(v)
    return spark


def port_session(root, conf=CACHE_ON):
    return _views(TorchSparkSession(dict(conf), device="cpu"), root)


def jax_session(root, conf=CACHE_ON):
    return _views(TpuSparkSession(dict(conf)), root)


def _rows(df):
    return [tuple(r) for r in df.collect()]


SEQUENCE = (Q1S, Q3S, Q1S, q1_at(7), Q3S, q1_at(7), q3_at(3), Q1S)


def test_hit_miss_sequence_matches_jax(root):
    seqs = {}
    for name, make, mod in (("jax", jax_session, JPC),
                            ("port", port_session, PC)):
        s = make(root)
        out = []
        for sql in SEQUENCE:
            rows = _rows(s.sql(sql))
            out.append((mod.last_lookup_was_hit(), rows))
        seqs[name] = out
    assert seqs["port"] == seqs["jax"]
    assert [h for h, _r in seqs["port"]] == [
        False, False, True, False, True, True, False, True]


def test_rows_cache_on_equal_cache_off(root):
    on = port_session(root)
    off = port_session(root, {"spark.rapids.sql.batchSizeRows": "512"})
    for sql in (Q1S, Q3S, q1_at(3)):
        first = _rows(on.sql(sql))
        assert _rows(on.sql(sql)) == first == _rows(off.sql(sql))
    assert off.thread_plan_signature() is None
    assert on.thread_plan_signature() is not None


def test_per_thread_state_of_a_shared_session(root):
    s = port_session(root)
    got = {}
    go = threading.Event()

    def run(sql):
        assert go.wait(TIMEOUT)
        rows = _rows(s.sql(sql))
        return (rows, s.thread_plan_signature(), s.thread_last_plan(),
                s.thread_rewrite_report())
    ts = {sql: in_thread(run, sql) for sql in (Q1S, Q3S)}
    go.set()
    for sql, (t, res) in ts.items():
        join(t)
        got[sql] = res["value"]
    (r1, sig1, plan1, rep1), (r3, sig3, plan3, rep3) = got[Q1S], got[Q3S]
    assert sig1 != sig3 and plan1 is not plan3 and rep1 is not rep3
    assert r1 == _rows(port_session(root, {
        "spark.rapids.sql.batchSizeRows": "512"}).sql(Q1S))
    assert s.thread_plan_signature() is None  # this thread ran nothing


def _signature(session, sql, mod):
    plan = session.sql(sql).plan
    return mod.plan_signature(plan, session.conf_obj)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_signature_normalizes_expr_ids_and_keeps_literals(root, pkg):
    s, mod = ((jax_session(root), JPC) if pkg == "jax"
              else (port_session(root), PC))
    a = _signature(s, Q1S, mod)
    assert a == _signature(s, Q1S, mod)  # fresh expression ids each parse
    assert a != _signature(s, q1_at(7), mod)
    assert _signature(s, Q3S, mod) != _signature(s, q3_at(3), mod)
    assert len(mod.signature_digest(a)) == 40


@pytest.mark.parametrize("key,value,same", [
    ("spark.rapids.sql.serve.tenantId", "other", True),
    ("spark.rapids.sql.serve.maxQueued", "3", True),
    ("spark.rapids.sql.adaptive.enabled", "false", True),
    ("spark.rapids.sql.resultCache.enabled", "true", True),
    ("spark.rapids.sql.subplanCache.enabled", "true", True),
    ("spark.rapids.sql.test.injectOOM", "3", True),
    ("spark.rapids.sql.kernel.groupbyHash.tableSlots", "2048", True),
    ("spark.rapids.sql.batchSizeRows", "1024", False),
    ("spark.sql.shuffle.partitions", "3", False),
    ("spark.rapids.sql.hasNans", "false", False),
])
def test_signature_conf_keys_match_jax(root, key, value, same):
    got = {}
    for pkg, make, mod in (("jax", jax_session, JPC),
                           ("port", port_session, PC)):
        base = make(root)
        other = make(root, dict(CACHE_ON, **{key: value}))
        got[pkg] = _signature(base, Q1S, mod) == _signature(other, Q1S,
                                                              mod)
    assert got["port"] == got["jax"] == same


def _template(root, sql=Q1S):
    s = port_session(root)
    s.sql(sql).collect()
    (template, _report), = [v for v in PC.PLAN_CACHE._data.values()]
    return s, template


def _nodes(plan):
    out, seen = [], set()

    def walk(p):
        if id(p) in seen:
            return
        seen.add(id(p))
        out.append(p)
        for op in getattr(p, "fused_ops", []) or []:
            walk(op)
        for c in getattr(p, "children", []):
            walk(c)
    walk(plan)
    return out


@pytest.mark.parametrize("sql", [Q1S, Q3S])
def test_clones_run_concurrently_and_leave_the_template_untouched(root, sql):
    s, template = _template(root, sql)
    want = _rows(s.sql(sql))
    before = {id(n): n.metrics.snapshot() for n in _nodes(template)
              if getattr(n, "metrics", None) is not None}
    clones = [PC.clone_plan(template) for _ in range(2)]
    for c in clones:
        PC.rebind_conf(c, s.conf_obj)
    go = threading.Event()

    def run(plan):
        assert go.wait(TIMEOUT)
        return [tuple(r) for r in plan.execute_collect(1).rows()]
    threads = [in_thread(run, c) for c in clones]
    go.set()
    for t, res in threads:
        join(t)
        assert res.get("value") == want, res
    for node in _nodes(template):
        for attr, fresh in PC.RUN_STATE_ATTRS.items():
            if attr in vars(node):
                assert getattr(node, attr) == fresh, (node, attr)
        reg = getattr(node, "metrics", None)
        if reg is not None:
            assert reg.snapshot() == before[id(node)], node
            assert not reg.value("numOutputRows"), node
    a, b = (set(map(id, _nodes(c))) for c in clones)
    assert not a & b and not a & set(map(id, _nodes(template)))


def test_clone_resets_run_state_and_gives_fresh_registries(root):
    _s, template = _template(root, Q3S)
    nodes = _nodes(template)
    saved = {}
    for node in nodes:
        for attr in PC.RUN_STATE_ATTRS:
            if attr in vars(node):
                saved[(id(node), attr)] = getattr(node, attr)
                setattr(node, attr, "left over by a run")
    try:
        clone = PC.clone_plan(template)
    finally:
        for node in nodes:
            for attr in PC.RUN_STATE_ATTRS:
                if (id(node), attr) in saved:
                    setattr(node, attr, saved[(id(node), attr)])
    cnodes = _nodes(clone)
    assert len(cnodes) == len(nodes)
    for t, c in zip(nodes, cnodes):
        assert type(t) is type(c)
        for attr, fresh in PC.RUN_STATE_ATTRS.items():
            if attr in vars(c):
                assert getattr(c, attr) == fresh
        if getattr(t, "metrics", None) is not None:
            assert c.metrics is not t.metrics
            assert type(c.metrics) is type(t.metrics)
        for k, v in vars(t).items():
            if isinstance(v, type(threading.Lock())):
                assert getattr(c, k) is not v


def test_clone_binds_the_fused_sink_to_its_own_ops(root):
    _s, template = _template(root, Q1S)
    clone = PC.clone_plan(template)
    stages = [n for n in _nodes(clone) if isinstance(n, F.TorchFusedStageExec)
              and n.sink_agg is not None]
    assert stages
    for st in stages:
        assert st.sink_agg is st.fused_ops[-1]
        assert st.sink_agg._prelude_ops == st.fused_ops[:-1]
        assert st.sink_agg.children == st.children


def test_rebind_conf_points_every_node_at_the_session(root):
    s, template = _template(root, Q3S)
    other = port_session(root, dict(CACHE_ON, **{
        "spark.rapids.sql.serve.tenantId": "x"}))
    clone = PC.clone_plan(template)
    PC.rebind_conf(clone, other.conf_obj)
    confs = {id(n.conf) for n in _nodes(clone)
             if getattr(n, "conf", None) is not None}
    assert confs == {id(other.conf_obj)}


def test_get_or_clone_is_single_flight():
    builds = []
    in_build, release = threading.Event(), threading.Event()

    def build():
        builds.append(1)
        in_build.set()
        assert release.wait(TIMEOUT)
        return (TorchPlanStub(), None)
    t1, r1 = in_thread(PC.get_or_clone, "sig-single-flight", build)
    assert in_build.wait(TIMEOUT)
    t2, r2 = in_thread(PC.get_or_clone, "sig-single-flight", build)
    release.set()
    join(t1)
    join(t2)
    assert len(builds) == 1
    assert r1["value"][2] is True and r2["value"][2] is False
    assert r1["value"][0] is not r2["value"][0]


class TorchPlanStub:
    """A one-node plan for the cache's own mechanics."""

    def __init__(self):
        self.children = []
        self._cache = None


def test_prewarm_digests_protect_from_eviction():
    cache = JitCache("protectorTest", capacity=2)
    keep = "keep-me"
    cache.set_protector(lambda k: k == keep)
    cache.get_or_build(keep, lambda: 1)
    cache.get_or_build("b", lambda: 2)
    cache.get_or_build("c", lambda: 3)
    assert keep in cache and "b" not in cache and "c" in cache
    PC.set_prewarm_digests({PC.signature_digest("sig")})
    assert PC.prewarm_digests() == {PC.signature_digest("sig")}
    assert PC._prewarm_protected("sig")
    PC.set_prewarm_digests(())
    assert not PC._prewarm_protected("sig")


@pytest.mark.parametrize("threads", [4, 16])
def test_launch_and_graph_counters_exact_under_threads(threads):
    KR.reset_launches()
    F.reset_graph_counts()
    n = 2000
    go = threading.Event()

    def bump():
        assert go.wait(TIMEOUT)
        for _ in range(n):
            KR.count_launch("groupbyHash")
            KR.count_replay(["decodeFused", "joinProbe"])
            F._bump_graph_counts(replays=1, replay_host_ns=3)
    ts = [in_thread(bump) for _ in range(threads)]
    go.set()
    for t, res in ts:
        join(t)
        assert "error" not in res
    got = KR.launch_counts()
    assert got["groupbyHash"] == got["decodeFused"] == \
        got["joinProbe"] == threads * n
    assert F.GRAPH_COUNTS["replays"] == threads * n
    assert F.GRAPH_COUNTS["replay_host_ns"] == 3 * threads * n
    KR.reset_launches()
    F.reset_graph_counts()
    assert not any(KR.launch_counts().values())


def test_capture_records_instead_of_counting():
    KR.reset_launches()
    with KR.recording_launches() as names:
        KR.count_launch("murmur3")
    assert names == ["murmur3"] and KR.launch_counts()["murmur3"] == 0
    KR.count_replay(names)
    assert KR.launch_counts()["murmur3"] == 1
    KR.reset_launches()
