"""Chaos soak harness (the counterpart of ``spark_rapids_tpu.soak``;
docs/serving.md "Query lifecycle", docs/robustness.md).

The lifecycle layer's acceptance bar is not any single test but the
COMPOSITION: c mixed q1/q3 tenants hammering one QueryServer for M
rounds while the FaultInjector sweeps OOM / IO / budget /
cancel-checkpoint schedules AND the lifecycle layer injects deadlines,
explicit cancels, and client disconnects — asserting, per round:

- **no hangs** — a global watchdog bounds every round's worker join;
- **bit-identical survivors** — every query that completes returns
  exactly the serial CPU-oracle rows, no matter which faults fired
  around it;
- **clean terminal states** — a deadline/cancel/disconnect ends in
  ``status: cancelled`` (or a vanished client), never an error;
- **zero leaks after drain** — the server's graceful drain leaves the
  device/host store at its pre-round occupancy, the semaphore at full
  permits with none in use, zero live tenant sessions, and an empty
  lifecycle registry.

The harness is a library (``run_soak``); ``tests/test_torch_soak.py``
runs a small round on the CPU (``device="cpu"``). The rounds rotate over
``ROUND_SCHEDULES``, the JAX package's rotation: the six schedules of
``SCHEDULES`` and then ``MESH_ROUND``, which activates the mesh
(``spark.rapids.shuffle.mode=ici``) with chip 1 failing persistently, so
every served query degrades to the surviving chips and its rows must
still equal the oracle's. The mesh round runs at full concurrency:
served sessions serialize only their mesh exchange sections
(``serializeServedQueries``). With fewer than two visible chips (see
``parallel.mesh.emulate_chips``) it runs ``SCHEDULES[2]`` instead, as in
the JAX package.
"""

from __future__ import annotations

import gc
import os
import socket as _socket
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np

Q1 = """
SELECT flag, status, sum(qty) AS sq, min(price) AS mn,
       max(price) AS mx, count(*) AS c
FROM lineitem WHERE qty % 5 != 0
GROUP BY flag, status ORDER BY flag, status
"""

Q3 = """
SELECT brand, sum(amt) AS sa, count(*) AS c
FROM fact JOIN dim ON item = item2
GROUP BY brand ORDER BY brand LIMIT 50
"""

# per-round fault schedules, rotated by round index
SCHEDULES: List[Dict[str, str]] = [
    {},  # clean engine: only lifecycle injections (deadline/cancel/...)
    # memory pressure: a budget far below the working set forces the
    # planned out-of-core tier on every join/agg, while every 3rd
    # budget-oracle query lies (half the real headroom) — survivors
    # must stay bit-identical with NO retry storm (docs/out_of_core.md)
    {"spark.rapids.sql.memory.deviceBudgetBytes": "65536",
     "spark.rapids.sql.test.injectOOM": "site:budget:3"},
    {"spark.rapids.sql.test.injectOOM": "6"},
    {"spark.rapids.sql.test.injectIOError": "4"},
    {"spark.rapids.sql.test.injectOOM": "split:5",
     "spark.rapids.sql.test.injectIOError": "7"},
    {"spark.rapids.sql.test.injectOOM": "site:cancel:11"},
]

# the chip-failure round: the mesh, with chip 1 failing persistently
MESH_ROUND: Dict[str, str] = {
    "spark.rapids.shuffle.mode": "ici",
    "spark.rapids.sql.test.injectChipFailure": "1"}

# the rounds' rotation (the JAX package's SCHEDULES)
ROUND_SCHEDULES: List[Dict[str, str]] = SCHEDULES + [MESH_ROUND]

# per-query lifecycle action mix (seeded per (round, tenant, query))
_ACTIONS = ("none", "none", "none", "deadline", "cancel", "disconnect")


def make_soak_data(data_dir: str, seed: int = 7, device=None) -> None:
    """Deterministic lineitem/fact/dim parquet under ``data_dir`` (the
    same shapes and values as the JAX package's)."""
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    rng = np.random.RandomState(seed)
    gen = TorchSparkSession({"spark.rapids.sql.enabled": "false"},
                            device=device)
    try:
        n = 3000
        li = gen.createDataFrame({
            "flag": [("A", "B", "C")[i] for i in
                     rng.randint(0, 3, n)],
            "status": [int(v) for v in rng.randint(0, 5, n)],
            "qty": [int(v) for v in rng.randint(-50, 500, n)],
            "price": [int(v) for v in rng.randint(0, 10000, n)],
        }, num_partitions=4)
        li.write.mode("overwrite").parquet(
            os.path.join(data_dir, "lineitem"))
        nf = 2500
        fact = gen.createDataFrame({
            "item": [int(v) for v in rng.randint(0, 400, nf)],
            "amt": [int(v) for v in rng.randint(-1000, 1000, nf)],
        }, num_partitions=3)
        fact.write.mode("overwrite").parquet(
            os.path.join(data_dir, "fact"))
        nd = 400
        dim = gen.createDataFrame({
            "item2": [int(v) for v in rng.permutation(nd)],
            "brand": [("alpha", "beta", "gamma", "delta", "eps")[i]
                      for i in rng.randint(0, 5, nd)],
        }, num_partitions=2)
        dim.write.mode("overwrite").parquet(
            os.path.join(data_dir, "dim"))
    finally:
        gen.stop()


def _oracle_rows(data_dir: str, enabled: str,
                 device=None) -> Dict[str, list]:
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    spark = TorchSparkSession({"spark.rapids.sql.enabled": enabled,
                               "spark.rapids.sql.batchSizeRows": "512"},
                              device=device)
    try:
        for name in ("lineitem", "fact", "dim"):
            spark.read.parquet(os.path.join(data_dir, name)) \
                .createOrReplaceTempView(name)
        return {
            "q1": [tuple(r) for r in spark.sql(Q1)._execute().rows()],
            "q3": [tuple(r) for r in spark.sql(Q3)._execute().rows()],
        }
    finally:
        spark.stop()


def _raw_disconnect(port: int, tenant: str, sql: str,
                    delay_s: float) -> None:
    """Submit a query on a raw socket and vanish mid-flight — the
    disconnect-injection client (the server's monitor must cancel the
    query and free its slot/permit/ledger)."""
    from spark_rapids_tpu_torch.serve import protocol
    sock = _socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        protocol.send_msg(sock, {"op": "sql", "sql": sql,
                                 "tenant": tenant})
        time.sleep(delay_s)
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _run_round(rnd: int, data_dir: str, oracle: Dict[str, list],
               concurrency: int, queries_per_tenant: int, seed: int,
               schedule: Dict[str, str], log, device=None) -> Dict:
    from spark_rapids_tpu_torch import lifecycle as LC
    from spark_rapids_tpu_torch import memory as MEM
    from spark_rapids_tpu_torch import resource as RES
    from spark_rapids_tpu_torch import retry as R
    from spark_rapids_tpu_torch.serve import QueryServer, ServeClient
    from spark_rapids_tpu_torch.serve.client import (ServeCancelled,
                                                     ServeRejected)

    R.reset_fault_injection()
    permits = 2  # concurrentGpuTasks default the invariant checks pin
    conf = {
        "spark.rapids.sql.enabled": "true",
        "spark.rapids.sql.batchSizeRows": "512",
        "spark.rapids.sql.concurrentGpuTasks": str(permits),
        "spark.rapids.sql.serve.maxConcurrentQueries": "8",
        "spark.rapids.sql.serve.maxQueued": "64",
        "spark.rapids.sql.serve.maxConcurrentPerTenant": "8",
    }
    conf.update(schedule)
    store = MEM._STORE
    base_device = store.device_bytes if store is not None else 0
    base_host = store.host_bytes if store is not None else 0

    srv = QueryServer(conf, device=device).start()
    counts = {"ok": 0, "cancelled": 0, "rejected": 0,
              "disconnected": 0}
    errors: list = []
    lock = threading.Lock()
    try:
        for name in ("lineitem", "fact", "dim"):
            srv.register_view(name, os.path.join(data_dir, name))

        def tenant_worker(w: int) -> None:
            rng = np.random.RandomState(seed * 1000 + rnd * 100 + w)
            tenant = f"t{w}"
            try:
                with ServeClient(srv.port, tenant=tenant) as c:
                    for i in range(queries_per_tenant):
                        kind = "q1" if (w + i) % 2 == 0 else "q3"
                        sql = Q1 if kind == "q1" else Q3
                        action = _ACTIONS[rng.randint(len(_ACTIONS))]
                        try:
                            if action == "disconnect":
                                _raw_disconnect(
                                    srv.port, tenant + "-ghost", sql,
                                    0.02 + rng.rand() * 0.2)
                                with lock:
                                    counts["disconnected"] += 1
                                continue
                            qid: Optional[str] = None
                            timeout_ms: Optional[int] = None
                            canceller = None
                            if action == "deadline":
                                timeout_ms = int(1 + rng.randint(40))
                            elif action == "cancel":
                                qid = f"r{rnd}w{w}q{i}"
                                delay = 0.01 + rng.rand() * 0.25

                                def do_cancel(q=qid, t=tenant,
                                              d=delay):
                                    time.sleep(d)
                                    try:
                                        with ServeClient(
                                                srv.port,
                                                tenant=t) as cc:
                                            cc.cancel(query_id=q,
                                                      tenant=t)
                                    except Exception:
                                        pass
                                canceller = threading.Thread(
                                    target=do_cancel, daemon=True)
                                canceller.start()
                            batch, _h = c.sql(sql,
                                              timeout_ms=timeout_ms,
                                              query_id=qid)
                            rows = [tuple(r) for r in batch.rows()]
                            # SURVIVOR: must be bit-identical to the
                            # oracle no matter what faults fired
                            if rows != oracle[kind]:
                                with lock:
                                    errors.append(
                                        f"round {rnd} {tenant} "
                                        f"{kind}: rows diverged")
                            else:
                                with lock:
                                    counts["ok"] += 1
                            if canceller is not None:
                                canceller.join(timeout=10)
                        except ServeCancelled:
                            with lock:
                                counts["cancelled"] += 1
                        except ServeRejected:
                            with lock:
                                counts["rejected"] += 1
            except Exception as e:  # noqa: BLE001 - surfaced in report
                with lock:
                    errors.append(f"round {rnd} t{w}: {e!r}")

        threads = [threading.Thread(target=tenant_worker, args=(w,),
                                    name=f"soak-t{w}")
                   for w in range(concurrency)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # GLOBAL WATCHDOG: the no-hang assertion — a wedged queue,
        # lost wakeup, or undrainable wait shows up here, not as a
        # silently hung soak
        deadline = 60.0 + 25.0 * queries_per_tenant
        for t in threads:
            t.join(timeout=max(1.0, deadline -
                               (time.perf_counter() - t0)))
        hung = [t.name for t in threads if t.is_alive()]
        if hung:
            errors.append(f"round {rnd}: HUNG workers {hung}")
        wall = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        drained = srv.shutdown(timeout=60.0)
        drain_s = time.perf_counter() - t0

    # post-drain invariants (the leak-class acceptance criteria)
    invariants: Dict[str, object] = {"drained": drained,
                                     "drain_s": round(drain_s, 3)}
    gc.collect()
    store = MEM._STORE
    if store is not None:
        invariants["deviceBytes"] = store.device_bytes
        invariants["hostBytes"] = store.host_bytes
        if store.device_bytes > base_device:
            errors.append(
                f"round {rnd}: leaked device bytes "
                f"({store.device_bytes} > baseline {base_device})")
        if store.host_bytes > base_host:
            errors.append(
                f"round {rnd}: leaked host bytes "
                f"({store.host_bytes} > baseline {base_host})")
    sem = RES._SEMAPHORE
    if sem is not None:
        invariants["semaphorePermits"] = sem.permits
        invariants["semaphoreInUse"] = sem.in_use
        if sem.in_use != 0:
            errors.append(f"round {rnd}: {sem.in_use} leaked "
                          f"semaphore permits")
        if sem.permits != permits:
            errors.append(f"round {rnd}: semaphore resized to "
                          f"{sem.permits}, configured {permits}")
    with srv._sessions_lock:
        live_sessions = len(srv._sessions)
    invariants["liveSessions"] = live_sessions
    if live_sessions:
        errors.append(f"round {rnd}: {live_sessions} live sessions "
                      f"after drain")
    live_tokens = len(LC.live_queries())
    invariants["liveQueryTokens"] = live_tokens
    if live_tokens:
        errors.append(f"round {rnd}: {live_tokens} tokens still in "
                      f"the lifecycle registry")
    if not drained:
        errors.append(f"round {rnd}: drain did not complete")
    log(f"soak round {rnd}: schedule={schedule or 'clean'} "
        f"counts={counts} wall={wall:.1f}s drain={drain_s:.2f}s "
        f"errors={len(errors)}")
    return {"round": rnd, "schedule": schedule, "counts": counts,
            "wall_s": round(wall, 3), "invariants": invariants,
            "errors": errors}


def run_soak(rounds: int = 3, concurrency: int = 8,
             queries_per_tenant: int = 3, seed: int = 7,
             data_dir: Optional[str] = None,
             log=lambda msg: print(msg, flush=True),
             device=None, start_round: int = 0) -> Dict:
    """The chaos soak: returns the machine-readable report
    (``report["ok"]`` is the pass/fail verdict). ``device`` is the CUDA
    card unless the caller asks for the CPU. The rounds are
    ``start_round`` .. ``start_round + rounds - 1`` of the rotation
    (``start_round=6`` runs the mesh round first)."""
    from spark_rapids_tpu_torch import retry as R
    tmp = None
    if data_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="srt_soak_")
        data_dir = tmp.name
    try:
        if not os.path.isdir(os.path.join(data_dir, "lineitem")):
            make_soak_data(data_dir, seed=seed, device=device)
        oracle = _oracle_rows(data_dir, "true", device)
        cpu = _oracle_rows(data_dir, "false", device)
        assert oracle == cpu, "device oracle diverged from CPU engine"

        from spark_rapids_tpu_torch.parallel.mesh import visible_chips
        multi_chip = len(visible_chips(device)) >= 2
        round_reports = []
        all_errors: list = []
        for rnd in range(start_round, start_round + rounds):
            schedule = ROUND_SCHEDULES[rnd % len(ROUND_SCHEDULES)]
            if schedule is MESH_ROUND and not multi_chip:
                schedule = SCHEDULES[2]  # no mesh: the OOM round instead
            rep = _run_round(rnd, data_dir, oracle, concurrency,
                             queries_per_tenant, seed, schedule, log,
                             device=device)
            round_reports.append(rep)
            all_errors.extend(rep["errors"])
        R.reset_fault_injection()
        totals = {k: sum(r["counts"][k] for r in round_reports)
                  for k in ("ok", "cancelled", "rejected",
                            "disconnected")}
        return {
            "ok": not all_errors,
            "rounds": rounds,
            "concurrency": concurrency,
            "queriesPerTenant": queries_per_tenant,
            "totals": totals,
            "errors": all_errors,
            "roundReports": round_reports,
        }
    finally:
        if tmp is not None:
            tmp.cleanup()
