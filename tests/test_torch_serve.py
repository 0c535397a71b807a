"""The port's query server (``spark_rapids_tpu_torch/serve/``) against
the JAX package's on the same seeded Parquet tables and requests: the
port's ``QueryServer(device="cpu")`` beside the JAX package's on XLA:CPU.

Checked: identical rows at concurrency 1 and 4 (four tenants' clients at
once), the same admission outcomes (rejection at ``maxQueued``, the
per-tenant cap), same-shape batch fusion (one batch, one slot, the same
sizes), the wire in both directions (the JAX client against the port's
server and the port's client against the JAX server), the stats verb's
keys, clean shutdown, ``QueryServer()`` resolving to CUDA (raising
here), the A11b keys refused, and the ``metrics`` verb's error."""

from __future__ import annotations

import threading

import pytest
import torch

from spark_rapids_tpu_torch.serve import QueryServer
from spark_rapids_tpu_torch.serve.client import (ServeError,
                                                 ServeRejected)
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_serve_support import (Q1S, Q3S, TIMEOUT, clients, in_thread,
                                       join, park_tenant, port_leftovers,
                                       q1_at, q3_at, reset_state, rows,
                                       serving, settle, wait_until,
                                       write_tables)

torch.set_num_threads(2)

PACKAGES = ("jax", "port")
MIX = (Q1S, Q3S, q1_at(7), q3_at(3))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("serve_tables")))


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


def _drive(pkg: str, srv, concurrency: int) -> dict:
    """``concurrency`` tenants' clients at once, each sending the mix;
    returns {sql: [rows of each response]}."""
    client = clients()[pkg]
    out: dict = {}
    lock = threading.Lock()

    def tenant(i: int):
        with client(srv.port, tenant=f"t{i}", timeout=TIMEOUT) as c:
            for sql in MIX[i % 2:] + MIX[:i % 2]:
                got = c.collect(sql)
                with lock:
                    out.setdefault(sql, []).append(got)
    threads = [in_thread(tenant, i) for i in range(concurrency)]
    for t, res in threads:
        join(t)
        assert "error" not in res, res
    return out


@pytest.mark.parametrize("concurrency", [1, 4])
def test_rows_identical_to_jax(root, concurrency):
    got = {}
    for pkg in PACKAGES:
        with serving(pkg, root) as srv:
            got[pkg] = _drive(pkg, srv, concurrency)
    for sql in MIX:
        jax_rows = got["jax"][sql]
        assert len(jax_rows) == len(got["port"][sql]) == concurrency
        assert all(r == jax_rows[0] for r in jax_rows), sql
        assert all(r == jax_rows[0] for r in got["port"][sql]), sql


def _admission_outcome(pkg: str, root: str, conf: dict, second: str):
    """Park one query of tenant "a", then send one more from
    ``second``: its outcome ("rejected" with the message, or the rows),
    and the server's rejected count."""
    client = clients()[pkg]
    started, release = threading.Event(), threading.Event()
    with serving(pkg, root, **conf) as srv:
        park_tenant(srv, pkg, "a", started, release)
        ca = client(srv.port, tenant="a", timeout=TIMEOUT)
        t, res = in_thread(ca.collect, Q1S)
        assert started.wait(TIMEOUT)
        try:
            with client(srv.port, tenant=second, timeout=TIMEOUT) as c:
                try:
                    outcome = ("ok", c.collect(Q3S))
                except Exception as e:  # the rejection under test
                    outcome = (type(e).__name__, str(e))
        finally:
            release.set()
            join(t)
            ca.close()
        assert "error" not in res, res
        st = srv.stats()["admission"]
        return outcome, st["rejected"], res["value"]


@pytest.mark.parametrize("case,conf,second", [
    ("max_queued", {"spark.rapids.sql.serve.maxConcurrentQueries": 1,
                    "spark.rapids.sql.serve.maxQueued": 0}, "b"),
    ("per_tenant_cap", {"spark.rapids.sql.serve.maxConcurrentPerTenant": 1,
                        "spark.rapids.sql.serve.maxQueued": 0}, "a"),
    ("other_tenant_admitted",
     {"spark.rapids.sql.serve.maxConcurrentPerTenant": 1,
      "spark.rapids.sql.serve.maxQueued": 0}, "b"),
])
def test_admission_outcomes_match_jax(root, case, conf, second):
    jax = _admission_outcome("jax", root, conf, second)
    port = _admission_outcome("port", root, conf, second)
    assert port == jax
    (kind, detail), rejected, _parked_rows = port
    if case == "other_tenant_admitted":
        assert kind == "ok" and rejected == 0
    else:
        assert kind == "ServeRejected" and rejected == 1, port


def test_rejected_client_survives(root):
    with serving("port", root, **{
            "spark.rapids.sql.serve.maxConcurrentQueries": 1,
            "spark.rapids.sql.serve.maxQueued": 0}) as srv:
        started, release = threading.Event(), threading.Event()
        park_tenant(srv, "port", "a", started, release)
        ca = clients()["port"](srv.port, tenant="a", timeout=TIMEOUT)
        t, res = in_thread(ca.collect, Q1S)
        assert started.wait(TIMEOUT)
        with clients()["port"](srv.port, tenant="b", timeout=TIMEOUT) as c:
            with pytest.raises(ServeRejected):
                c.collect(Q3S)
            release.set()
            join(t)
            assert not c.broken
            assert c.collect(Q3S) == _oracle(root, Q3S)
        ca.close()


_ORACLE: dict = {}


def _oracle(root: str, sql: str) -> list:
    """The JAX package's rows of ``sql`` through its server (cached)."""
    if sql not in _ORACLE:
        with serving("jax", root) as srv:
            with clients()["jax"](srv.port, timeout=TIMEOUT) as c:
                _ORACLE[sql] = c.collect(sql)
    return _ORACLE[sql]


def _fusion(pkg: str, root: str):
    """A parked query saturates a one-slot server; four same-shape Q1S
    requests from two tenants arrive and fuse; returns their rows, the
    sizes on the wire and the fusion and admission counts."""
    client = clients()[pkg]
    started, release = threading.Event(), threading.Event()
    # the batch closes when its fourth member joins (maxBatch), well
    # inside the window: no timing decides who fuses
    conf = {"spark.rapids.sql.serve.maxConcurrentQueries": 1,
            "spark.rapids.sql.serve.batchFusion.windowMs": 60000,
            "spark.rapids.sql.serve.batchFusion.maxBatch": 4}
    with serving(pkg, root, **conf) as srv:
        park_tenant(srv, pkg, "slow", started, release)
        cs = client(srv.port, tenant="slow", timeout=TIMEOUT)
        ts, rs = in_thread(cs.collect, Q3S)
        assert started.wait(TIMEOUT)
        assert srv._admission.saturated()

        def member(tenant):
            with client(srv.port, tenant=tenant, timeout=TIMEOUT) as c:
                batch, head = c.sql(Q1S)
                return rows(batch), head.get("fusedWith", 1)
        members = [in_thread(member, t) for t in ("x", "y", "x", "y")]
        # the batch closes when every member joined, then its executor
        # queues for the parked query's slot
        wait_until(lambda: srv._admission.stats()["queued"] == 1,
                   "the fused batch's executor to queue")
        release.set()
        for t, res in members + [(ts, rs)]:
            join(t)
            assert "error" not in res, res
        cs.close()
        adm = srv.stats()["admission"]
        return ([m["value"] for _t, m in members],
                srv._fusion.stats(), adm["admitted"])


def test_batch_fusion_matches_jax(root):
    jax = _fusion("jax", root)
    port = _fusion("port", root)
    jrows, jstats, jadmitted = jax
    prows, pstats, padmitted = port
    assert [r for r, _n in prows] == [r for r, _n in jrows]
    assert all(r == prows[0][0] for r, _n in prows)
    assert pstats == jstats
    assert pstats["fusedBatches"] >= 1
    assert sorted(n for _r, n in prows) == sorted(n for _r, n in jrows)
    # every member is billed as admitted, the parked query too
    assert padmitted == jadmitted == 5


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_wire_in_both_directions(root, server_pkg, client_pkg):
    client = clients()[client_pkg]
    with serving(server_pkg, root) as srv:
        with client(srv.port, tenant="w", timeout=TIMEOUT) as c:
            assert c.ping()
            batch, head = c.sql(Q3S, query_id="q-7")
            assert rows(batch) == _oracle(root, Q3S)
            assert {"status", "tenant", "rows", "queueWaitMs", "execMs",
                    "planCacheHit", "queryId"} <= set(head)
            assert head["queryId"] == "q-7" and head["rows"] == len(
                rows(batch))
            assert c.cancel(query_id="nothing-running") == 0
            st = c.stats()
            assert st["queriesOk"] == 1
            assert st["admission"]["tenants"]["w"]["admitted"] == 1


def test_stats_keys_match_jax(root):
    keys = {}
    for pkg in PACKAGES:
        with serving(pkg, root) as srv:
            with clients()[pkg](srv.port, tenant="s", timeout=TIMEOUT) as c:
                c.collect(Q1S)
                keys[pkg] = c.stats()
    # the JAX package's telemetry, history, SLO and tuning sections come
    # with the observability slice (A11b)
    a11b = {"telemetry", "history", "slo", "tuning"}
    assert set(keys["jax"]) - a11b <= set(keys["port"])
    for section in ("admission", "lifecycle"):
        assert set(keys["jax"][section]) <= set(keys["port"][section])
    assert keys["port"]["tenantsHBM"]["s"]["liveBytes"] == 0
    assert keys["port"]["semaphore"]["inUse"] == 0
    assert "planRewrite" in keys["port"]["jitCaches"]


def test_shutdown_drains_and_leaves_nothing(root):
    with serving("port", root) as srv:
        with clients()["port"](srv.port, tenant="d", timeout=TIMEOUT) as c:
            assert c.collect(Q1S) == _oracle(root, Q1S)
        settle(srv)
    assert port_leftovers("d") == {"permits": 0, "handles": 0, "ledger": 0}


def test_metrics_verb_names_a11b(root):
    with serving("port", root) as srv:
        with clients()["port"](srv.port, timeout=TIMEOUT) as c:
            with pytest.raises(ServeError, match="A11b"):
                c.metrics()
            assert c.ping()
        with pytest.raises(NotImplementedError, match="A11b"):
            srv.start_metrics_http(0)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the server refuses to start without CUDA")
def test_server_without_device_needs_cuda():
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryServer({})


@pytest.mark.parametrize("key", [
    "spark.rapids.sql.serve.slo.p99Ms",
    "spark.rapids.sql.serve.slo.p99Ms.tenant1",
    "spark.rapids.sql.serve.tuning.enabled",
    "spark.rapids.sql.telemetry.dir",
    "spark.rapids.sql.telemetry.history.dir",
])
@pytest.mark.parametrize("entry", ["server", "session"])
def test_a11b_keys_raise(key, entry):
    with pytest.raises(NotImplementedError, match="A11b"):
        if entry == "server":
            QueryServer({key: "1"}, device="cpu")
        else:
            TorchSparkSession({key: "1"}, device="cpu")


def test_tenant_sessions_share_one_plan_cache(root):
    from spark_rapids_tpu_torch import plan_cache as PC
    misses0 = PC.stats()["misses"]
    with serving("port", root) as srv:
        heads = []
        for tenant in ("a", "b", "c"):
            with clients()["port"](srv.port, tenant=tenant,
                                   timeout=TIMEOUT) as c:
                heads.append(c.sql(Q3S)[1])
        assert [h["planCacheHit"] for h in heads] == [False, True, True]
        assert PC.stats()["misses"] - misses0 == 1
        assert set(srv.stats()["tenantsHBM"]) >= {"a", "b", "c"}
