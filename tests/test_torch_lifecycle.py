"""The port's query lifecycle (``spark_rapids_tpu_torch/lifecycle.py`` and
its checkpoints in the runtime) against the JAX package's.

Units: ``CancelToken`` (first cancel wins, an expired deadline converts),
``cancellable_sleep`` and ``cancellable_wait``, the cancellable semaphore
wait and jit-cache single-flight wait, the retry protocol's cancellable
backoff, the ``site:cancel`` injection leg, the percentile rule and the
quarantine streaks (each equal to the JAX package's), the watchdog, and
a cancelled session query closing its handles and returning its permit.
Through both servers: the statuses on the wire after a deadline, the
cancel verb, a disconnect, an injected stop and a drain, and quarantine
after the threshold, with the port's permits, store handles and tenant
ledger at 0 after each and the client still usable."""

from __future__ import annotations

import socket
import threading
import time

import pytest
import torch

from spark_rapids_tpu import lifecycle as JLC
from spark_rapids_tpu_torch import lifecycle as LC
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.jit_cache import JitCache
from spark_rapids_tpu_torch.resource import TorchSemaphore

from tests.torch_serve_support import (Q1S, Q3S, TIMEOUT, clients, in_thread,
                                       join, park_tenant, port_leftovers,
                                       reset_state, serving, settle,
                                       wait_until, write_tables)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("lifecycle_tables")))


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------

def test_cancel_token_first_cancel_wins():
    tok = LC.CancelToken(tenant="t", query_id="q")
    assert not tok.cancelled() and tok.reason is None
    assert tok.cancel(LC.REASON_CANCEL) is True
    assert tok.cancel(LC.REASON_DEADLINE) is False
    assert tok.reason == LC.REASON_CANCEL
    with pytest.raises(LC.TorchQueryCancelled) as e:
        tok.check()
    assert e.value.reason == LC.REASON_CANCEL


def test_expired_deadline_converts_to_a_cancel():
    tok = LC.CancelToken()
    tok.set_deadline(0.0)
    done = threading.Event()
    while time.monotonic() <= tok.deadline:
        done.wait(0.001)
    assert tok.cancelled() and tok.reason == LC.REASON_DEADLINE
    assert tok.remaining() < 0


def test_token_scope_nests_and_restores():
    a, b = LC.CancelToken(), LC.CancelToken()
    assert LC.current_token() is None
    with LC.token_scope(a):
        with LC.token_scope(b):
            assert LC.current_token() is b
        assert LC.current_token() is a
        with LC.token_scope(None):  # None keeps the outer token
            assert LC.current_token() is a
    assert LC.current_token() is None
    LC.checkpoint("batch")  # no token: a no-op


def test_cancellable_sleep_interrupts():
    tok = LC.CancelToken()
    t, res = in_thread(lambda: _sleep_under(tok, 30.0))
    tok.cancel(LC.REASON_CANCEL)
    join(t)
    assert isinstance(res.get("error"), LC.TorchQueryCancelled)
    assert res["error"].reason == LC.REASON_CANCEL


def _sleep_under(tok, seconds):
    with LC.token_scope(tok):
        LC.cancellable_sleep(seconds)


def test_cancellable_wait_returns_and_raises():
    ev = threading.Event()
    ev.set()
    with LC.token_scope(LC.CancelToken()):
        assert LC.cancellable_wait(ev, timeout=1.0) is True
        assert LC.cancellable_wait(threading.Event(), timeout=0.0) is False
    tok = LC.CancelToken()
    tok.cancel(LC.REASON_SHUTDOWN)
    with LC.token_scope(tok):
        with pytest.raises(LC.TorchQueryCancelled):
            LC.cancellable_wait(threading.Event(), timeout=30.0)


def test_cancel_interrupts_semaphore_wait():
    sem = TorchSemaphore(1)
    holder_in, holder_out = threading.Event(), threading.Event()

    def holder():
        sem.acquire_if_necessary()
        holder_in.set()
        holder_out.wait(TIMEOUT)
        sem.release_if_necessary()
    th, _r = in_thread(holder)
    assert holder_in.wait(TIMEOUT)
    tok = LC.CancelToken()

    def waiter():
        with LC.token_scope(tok):
            sem.acquire_if_necessary()
    tw, res = in_thread(waiter)
    tok.cancel(LC.REASON_CANCEL)
    join(tw)
    assert isinstance(res.get("error"), LC.TorchQueryCancelled)
    assert sem.in_use == 1  # the holder's: the cancelled waiter took none
    holder_out.set()
    join(th)
    assert sem.in_use == 0


def test_cancel_interrupts_jit_single_flight_wait():
    cache = JitCache("lifecycleTest")
    in_build, release = threading.Event(), threading.Event()

    def build():
        in_build.set()
        release.wait(TIMEOUT)
        return "program"
    tb, rb = in_thread(cache.get_or_build, "k", build)
    assert in_build.wait(TIMEOUT)
    tok = LC.CancelToken()

    def waiter():
        with LC.token_scope(tok):
            return cache.get_or_build("k", lambda: "other")
    tw, rw = in_thread(waiter)
    tok.cancel(LC.REASON_CANCEL)
    join(tw)
    assert isinstance(rw.get("error"), LC.TorchQueryCancelled)
    release.set()
    join(tb)
    assert rb["value"] == ("program", True)
    assert cache.get_or_build("k", lambda: "other") == ("program", False)


def test_retry_backoff_is_cancellable():
    conf = TorchConf({"spark.rapids.sql.test.injectOOM": "1:99",
                      "spark.rapids.sql.retry.backoffMs": "60000",
                      "spark.rapids.sql.retry.maxBackoffMs": "60000"})
    tok = LC.CancelToken()

    def run():
        with LC.token_scope(tok):
            R.with_retry(lambda: 1, conf)
    t, res = in_thread(run)
    tok.cancel(LC.REASON_DEADLINE)
    join(t)
    assert isinstance(res.get("error"), LC.TorchQueryCancelled)
    assert res["error"].reason == LC.REASON_DEADLINE


def test_cancel_is_never_retried():
    calls = []

    def fn():
        calls.append(1)
        raise LC.TorchQueryCancelled(LC.REASON_CANCEL)
    with pytest.raises(LC.TorchQueryCancelled):
        R.with_retry(fn, TorchConf({}))
    assert calls == [1]


@pytest.mark.parametrize("n", [1, 3])
def test_site_cancel_injection_counts_checkpoints(n):
    inj = R.get_fault_injector(TorchConf(
        {"spark.rapids.sql.test.injectOOM": f"site:cancel:{n}"}))
    tok = LC.CancelToken()
    with LC.token_scope(tok):
        for i in range(1, n):
            LC.checkpoint("batch")
            assert not tok.cancelled(), i
        with pytest.raises(LC.TorchQueryCancelled) as e:
            LC.checkpoint("batch")
    assert e.value.reason == LC.REASON_INJECTED
    assert inj.stats()["cancelsInjected"] == 1
    # the cancel leg is not an allocation schedule
    inj.on_alloc("upload")


@pytest.mark.parametrize("samples", [[], [3.0], [5, 1, 4, 2, 3],
                                     list(range(100, 0, -1)),
                                     [0.5, 0.25, 0.125, 9.0]])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99, 1.0])
def test_percentile_matches_jax(samples, q):
    assert LC.percentile(samples, q) == JLC.percentile(samples, q)


def test_quarantine_streaks_match_jax():
    events = ["fail", "fail", "ok", "fail", "fail", "fail", "ok", "fail"]
    for mod in (LC, JLC):
        mod.reset_lifecycle()
    for ev in events:
        for mod in (LC, JLC):
            if ev == "fail":
                mod.record_runtime_failure("sig", 3)
            else:
                mod.record_success("sig")
        assert LC.is_quarantined("sig") == JLC.is_quarantined("sig"), ev
        assert LC.quarantined_failures("sig") == \
            JLC.quarantined_failures("sig")
    assert LC.is_quarantined("sig") and LC.quarantined_failures("sig") == 3
    for mod in (LC, JLC):
        mod.reset_lifecycle()
    assert not LC.is_quarantined("sig")


def test_wall_history_and_watchdog():
    for _ in range(LC.WATCHDOG_MIN_SAMPLES - 1):
        LC.record_wall("s", 0.01)
    assert LC.signature_p99("s") is None  # a cold shape is never stuck
    LC.record_wall("s", 0.01)
    assert LC.signature_p99("s") == pytest.approx(0.01)
    wd = LC.StuckQueryWatchdog(TorchConf({
        "spark.rapids.sql.serve.watchdogFactor": "2",
        "spark.rapids.sql.serve.watchdogCancel": "true"}))
    tok = LC.CancelToken(tenant="t")
    tok.signature = "s"
    LC.register_query(tok)
    try:
        assert wd.scan() == 0  # still queued: not stuck
        tok.admitted = time.monotonic() - 1.0
        assert wd.scan() == 1 and wd.scan() == 0
        assert tok.reason == LC.REASON_WATCHDOG and wd.cancelled == 1
    finally:
        LC.unregister_query(tok)
    assert LC.lifecycle_stats()["liveQueries"] == 0


def test_cancelled_session_query_releases_everything(root):
    import os

    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    s = TorchSparkSession({"spark.rapids.sql.test.injectOOM":
                           "site:cancel:4",
                           "spark.rapids.sql.serve.tenantId": "solo"},
                          device="cpu")
    s.read.parquet(os.path.join(root, "lineitem")) \
        .createOrReplaceTempView("lineitem")
    with LC.token_scope(LC.CancelToken(tenant="solo")):
        with pytest.raises(LC.TorchQueryCancelled) as e:
            s.sql(Q1S).collect()
    assert e.value.reason == LC.REASON_INJECTED
    assert s.terminal_counts == {"cancelled": 1}
    assert port_leftovers("solo") == {"permits": 0, "handles": 0,
                                      "ledger": 0}
    R.reset_fault_injection()
    s2 = TorchSparkSession({"spark.rapids.sql.serve.tenantId": "solo"},
                           device="cpu")
    s2.read.parquet(os.path.join(root, "lineitem")) \
        .createOrReplaceTempView("lineitem")
    assert len(s2.sql(Q1S).collect()) > 0


# ---------------------------------------------------------------------------
# Through both servers: the statuses on the wire
# ---------------------------------------------------------------------------

def _scenario(pkg: str, root: str, case: str) -> dict:
    """One lifecycle case on one package's server: the wire's outcome,
    whether the client survived (its next query's rows), and, for the
    port, what the query left held."""
    client = clients()[pkg]
    conf = {}
    if case == "injected":
        conf["spark.rapids.sql.test.injectOOM"] = "site:cancel:3"
    started, release = threading.Event(), threading.Event()
    out = {}
    with serving(pkg, root, **conf) as srv:
        park_tenant(srv, pkg, "held", started, release)
        c = client(srv.port, tenant="held", timeout=TIMEOUT)
        if case == "deadline":
            t, res = in_thread(lambda: c.sql(Q1S, timeout_ms=300))
        elif case == "injected":
            release.set()
            t, res = in_thread(lambda: c.sql(Q1S))
        elif case == "disconnect":
            from spark_rapids_tpu_torch.serve import protocol as SP
            raw = socket.create_connection(("127.0.0.1", srv.port),
                                           timeout=TIMEOUT)
            SP.send_msg(raw, {"op": "sql", "sql": Q1S, "tenant": "held"})
            t, res = None, {}
        else:
            t, res = in_thread(lambda: c.sql(Q1S, query_id="victim"))
        if case != "injected":
            assert started.wait(TIMEOUT)
        if case == "cancel":
            with client(srv.port, tenant="ops", timeout=TIMEOUT) as op:
                out["cancelled"] = op.cancel(query_id="victim")
        elif case == "disconnect":
            raw.close()
            wait_until(lambda: srv.stats()["lifecycle"][
                "cancelledByReason"].get("disconnect", 0) == 1,
                "the disconnect monitor")
            out["by_reason"] = srv.stats()["lifecycle"]["cancelledByReason"]
        elif case == "shutdown":
            out["drained"] = srv.shutdown(0.2)
        if t is not None:
            join(t)
            err = res.get("error")
            out["wire"] = (type(err).__name__, getattr(err, "reason", None),
                           getattr(err, "where", None))
        if case != "shutdown":
            settle(srv)
            release.set()
            out["broken"] = c.broken
            # (the injected schedule goes on firing every 3rd checkpoint)
            if case != "injected":
                out["next"] = c.collect(Q3S)
        if pkg == "port":
            out["held"] = port_leftovers("held")
        c.close()
    return out


@pytest.mark.parametrize("case", ["deadline", "cancel", "disconnect",
                                  "injected", "shutdown"])
def test_statuses_on_the_wire_match_jax(root, case):
    jax = _scenario("jax", root, case)
    reset_state()
    port = _scenario("port", root, case)
    assert port.pop("held") == {"permits": 0, "handles": 0, "ledger": 0}
    assert port == jax
    want_reason = {"deadline": "deadline", "cancel": "cancel",
                   "injected": "injected", "shutdown": "shutdown"}
    if case in want_reason:
        assert port["wire"][:2] == ("ServeCancelled", want_reason[case])
    if case == "disconnect":
        assert port["by_reason"] == {"disconnect": 1}
    if case != "shutdown":
        assert port["broken"] is False
    if case not in ("shutdown", "injected"):
        assert port["next"]


def _quarantine(pkg: str, root: str) -> list:
    client = clients()[pkg]
    conf = {"spark.rapids.sql.serve.quarantineThreshold": 2,
            "spark.rapids.sql.test.injectIOError": "1:99",
            "spark.rapids.sql.reader.maxRetries": 1}
    outcomes = []
    with serving(pkg, root, **conf) as srv:
        with client(srv.port, tenant="q", timeout=TIMEOUT) as c:
            for _ in range(3):
                try:
                    c.sql(Q1S)
                    outcomes.append("ok")
                except Exception as e:  # the outcome under test
                    outcomes.append(type(e).__name__)
            assert not c.broken
        outcomes.append(srv.stats()["lifecycle"]["quarantinedSignatures"])
    return outcomes


def test_quarantine_after_threshold_matches_jax(root):
    jax = _quarantine("jax", root)
    reset_state()
    port = _quarantine("port", root)
    assert port == jax == ["ServeError", "ServeError", "ServeQuarantined", 1]
