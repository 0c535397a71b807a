"""Shared data and helpers of the port's serving tests
(``tests/test_torch_{serve,lifecycle,plan_cache,result_cache}.py``).

Both packages' ``QueryServer`` serve the same seeded tables, written once
as Parquet with pyarrow: the JAX package's on XLA:CPU (its kernels
interpreted), the port's with ``device="cpu"`` (the plain PyTorch
versions). A query is held mid-flight by a hook on the server's tenant
session that parks it on an event at a lifecycle checkpoint
(``park_tenant``), never by a sleep; every socket binds port 0; every
join and socket read has a timeout."""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np

Q1S = """
SELECT flag, status, sum(qty) AS sq, min(price) AS mn,
       max(price) AS mx, count(*) AS c
FROM lineitem WHERE qty % 5 != 0
GROUP BY flag, status ORDER BY flag, status
"""

Q3S = """
SELECT brand, sum(amt) AS sa, count(*) AS c
FROM fact JOIN dim ON item = item2
GROUP BY brand ORDER BY brand LIMIT 50
"""

VIEWS = ("lineitem", "fact", "dim")
BASE_CONF = {"spark.rapids.sql.batchSizeRows": "512"}
TIMEOUT = 60.0


def q1_at(mod: int) -> str:
    """Q1S with another literal (``qty % mod``)."""
    return Q1S.replace("qty % 5", f"qty % {mod}")


def q3_at(limit: int) -> str:
    """Q3S with another literal (its LIMIT)."""
    return Q3S.replace("LIMIT 50", f"LIMIT {limit}")


def write_tables(root: str, seed: int = 31) -> str:
    """The three seeded tables as Parquet under ``root`` (a directory a
    table, several files each); returns ``root``."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)

    def write(name, table, parts):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        per = (table.num_rows + parts - 1) // parts
        for i in range(parts):
            pq.write_table(table.slice(i * per, per), os.path.join(
                root, name, f"part-{i:05d}.parquet"))

    n = 3000
    write("lineitem", pa.table({
        "flag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
        "status": rng.integers(0, 5, n).astype(np.int32),
        "qty": rng.integers(-1000, 1000, n),
        "price": rng.integers(-5000, 5000, n).astype(np.int32)}), 4)
    write("fact", pa.table({
        "k": rng.integers(0, 5, 2500).astype(np.int32),
        "item": rng.integers(0, 400, 2500).astype(np.int32),
        "amt": rng.integers(0, 10 ** 6, 2500)}), 3)
    write("dim", pa.table({
        "item2": np.arange(400).astype(np.int32),
        "brand": np.array(["b0", "b1", "b2", "b3", "b4"])[
            rng.integers(0, 5, 400)]}), 2)
    return root


def _conf(conf: dict) -> dict:
    out = dict(BASE_CONF)
    out.update({k: str(v) for k, v in conf.items()})
    return out


def jax_server(root: str, **conf):
    from spark_rapids_tpu.serve import QueryServer
    srv = QueryServer(_conf(conf)).start()
    for v in VIEWS:
        srv.register_view(v, os.path.join(root, v))
    return srv


def port_server(root: str, **conf):
    from spark_rapids_tpu_torch.serve import QueryServer
    srv = QueryServer(_conf(conf), device="cpu").start()
    for v in VIEWS:
        srv.register_view(v, os.path.join(root, v))
    return srv


SERVERS = {"jax": jax_server, "port": port_server}


def clients():
    """``{package: ServeClient class}``."""
    from spark_rapids_tpu.serve import ServeClient as JC
    from spark_rapids_tpu_torch.serve import ServeClient as PC
    return {"jax": JC, "port": PC}


def lifecycle_module(pkg: str):
    if pkg == "jax":
        from spark_rapids_tpu import lifecycle
    else:
        from spark_rapids_tpu_torch import lifecycle
    return lifecycle


@contextlib.contextmanager
def serving(pkg: str, root: str, **conf):
    """One package's server over the tables, shut down (drained) on
    exit."""
    srv = SERVERS[pkg](root, **conf)
    try:
        yield srv
    finally:
        assert srv.shutdown(TIMEOUT), f"{pkg} server did not drain"


def rows(batch) -> list:
    return [tuple(r) for r in batch.rows()]


def park_tenant(srv, pkg: str, tenant: str, started: threading.Event,
                release: threading.Event) -> None:
    """Queries of ``tenant`` park, once admitted, on ``release`` at a
    lifecycle checkpoint (a cancellable wait) before they plan: a cancel,
    a deadline or a disconnect reaches them there; ``started`` is set
    when one parks."""
    lc = lifecycle_module(pkg)
    orig_session = srv._session

    def hook(t):
        s = orig_session(t)
        if t == tenant and not getattr(s, "_park_hook", False):
            orig_sql = s.sql

            def parked_sql(text):
                started.set()
                if not lc.cancellable_wait(release, timeout=TIMEOUT,
                                           site="batch"):
                    raise RuntimeError("parked query was never released")
                return orig_sql(text)
            s._park_hook = True
            s.sql = parked_sql
        return s
    srv._session = hook


def in_thread(fn, *args):
    """Run ``fn`` on a thread; returns ``(thread, result dict)`` with the
    return value under ``"value"`` or the exception under ``"error"``."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # the caller inspects it
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def join(t: threading.Thread) -> None:
    t.join(TIMEOUT)
    assert not t.is_alive(), "a client thread did not finish"


def reset_state() -> None:
    """Both packages' process state the serving tests touch."""
    from spark_rapids_tpu import lifecycle as JLC
    from spark_rapids_tpu import retry as JR
    from spark_rapids_tpu import trace as JTR
    from spark_rapids_tpu.plan_cache import PLAN_CACHE as JPC
    from spark_rapids_tpu.serve import result_cache as JRC
    from spark_rapids_tpu_torch import lifecycle as LC
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.plan_cache import PLAN_CACHE
    from spark_rapids_tpu_torch.serve import result_cache as RC
    from spark_rapids_tpu.telemetry import history as JH
    from spark_rapids_tpu.telemetry import triggers as JT
    from spark_rapids_tpu_torch import trace as TR
    from spark_rapids_tpu_torch.telemetry import history as H
    from spark_rapids_tpu_torch.telemetry import triggers as T
    JTR.reset_tracing()
    JT.engine().reset()
    JH.reset_history()
    TR.reset_tracing()
    T.engine().reset()
    H.reset_history()
    JR.reset_fault_injection()
    JRC.reset_subplan_cache()
    JLC.reset_lifecycle()
    JPC.clear()
    R.reset_fault_injection()
    RC.reset_subplan_cache()
    LC.reset_lifecycle()
    PLAN_CACHE.clear()


def port_leftovers(tenant: str) -> dict:
    """What a finished or cancelled port query must leave at 0: permits
    in use, open store handles, the tenant's live ledger bytes."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.resource import _SEMAPHORE
    store = memory._STORE
    return {"permits": _SEMAPHORE.in_use if _SEMAPHORE is not None else 0,
            "handles": store.live_handles() if store is not None else 0,
            "ledger": memory.store_tenant_stats().get(tenant, {}).get(
                "liveBytes", 0)}


def wait_until(pred, what: str, timeout: float = TIMEOUT) -> None:
    """Poll ``pred`` in short slices until it holds; fail after
    ``timeout`` seconds instead of hanging."""
    import time
    tick = threading.Event()
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        tick.wait(0.002)


def settle(srv, timeout: float = 10.0) -> None:
    """Wait until the server has nothing in flight: its last ``finally``
    may trail a response."""
    wait_until(lambda: srv._admission.stats()["inFlight"] == 0,
               "the server to finish its query", timeout)
