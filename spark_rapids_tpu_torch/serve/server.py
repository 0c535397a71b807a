"""The query server (the counterpart of
``spark_rapids_tpu.serve.server``; docs/serving.md).

A long-lived process accepting SQL over a local socket and multiplexing
N concurrent sessions onto ONE device runtime: one CUDA card unless the
caller asks for the CPU (``QueryServer(conf, device="cpu")``, as the
tests do). Division of labor:

- one ``TorchSparkSession`` per TENANT (lazily created, all sharing the
  process DeviceStore / TorchSemaphore / stage cache / plan-rewrite
  cache), so per-tenant conf, capture state and rewrite reports never
  clobber each other;
- ``AdmissionController`` in front: bounded queue with rejection,
  per-tenant in-flight caps, fair-share device-memory throttling off
  the store's per-tenant ledger;
- the tenant id bills the store's per-tenant live/peak/spill ledger
  (``serve.tenantId``);
- results return as Arrow IPC streams (protocol.py);
- every query runs under a lifecycle ``CancelToken`` (docs/serving.md
  "Query lifecycle"): deadlines from ``serve.queryTimeoutMs`` /
  per-request ``timeoutMs``, the ``cancel`` verb, a client-disconnect
  monitor, the stuck-query watchdog, the poison-query quarantine, and
  a graceful drain that cancels stragglers.

Server sessions enable the cross-query plan cache by default
(``spark.rapids.sql.planCache.enabled``), so repeated query shapes —
from ANY tenant — skip the plan rewrite, and the stage cache keeps each
stage's CUDA graph as it always did. Each connection thread runs its
query's device work on the thread's current stream, the default stream,
so two queries' stage-graph replays and kernels are ordered by it.

Not ported yet (ROADMAP A11b, the observability slice): the trace
flight recorder, the ``metrics`` verb and ``start_metrics_http``
(Prometheus), the query history and its warm start, SLO burn tracking
and the tuning controller. The ``metrics`` verb answers
``status: error`` naming A11b; ``start_metrics_http`` raises; a conf
that sets an A11b key raises at construction.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import (RESULT_CACHE_ENABLED,
                                         RESULT_CACHE_MAX_BYTES,
                                         RESULT_CACHE_MAX_ENTRIES,
                                         SERVE_BATCH_FUSION_ENABLED,
                                         SERVE_BATCH_FUSION_MAX_BATCH,
                                         SERVE_BATCH_FUSION_WINDOW_MS,
                                         SERVE_HOST, SERVE_PORT, TorchConf,
                                         refuse_unported)
from spark_rapids_tpu_torch.serve import protocol
from spark_rapids_tpu_torch.serve.scheduler import (AdmissionController,
                                                    QueryRejected,
                                                    percentile)

# what the A11b surfaces answer until the observability slice ports them
A11B_ERROR = ("not ported yet to spark_rapids_tpu_torch: the metrics "
              "verb and its Prometheus exporter come with the "
              "observability slice (ROADMAP A11b)")

_LAT_RESERVOIR = 4096


class QueryServer:
    """Multi-tenant SQL server over one device runtime.

    Usage::

        srv = QueryServer({"spark.rapids.sql.enabled": "true"})
        # (device="cpu" runs it on the host's plain PyTorch versions)
        srv.register_view("lineitem", "/data/lineitem")
        srv.start()                  # returns once the socket listens
        ... ServeClient(port=srv.port) ...
        srv.shutdown()               # drains in-flight queries
    """

    def __init__(self, conf: Optional[Dict] = None,
                 host: Optional[str] = None,
                 port: Optional[int] = None,
                 device=None):
        from spark_rapids_tpu_torch.sql.session import resolve_device
        base = dict(conf or {})
        refuse_unported(base)
        # the card unless the caller asks for the CPU: resolved once, so
        # a server without a card raises here, before it listens
        self.device = resolve_device(device)
        # serving default: cross-query plan caching ON unless the
        # operator explicitly disabled it
        base.setdefault("spark.rapids.sql.planCache.enabled", "true")
        # (the JAX package also turns its trace flight recorder on here;
        # that comes with the observability slice, A11b)
        self._base_conf = base
        cobj = TorchConf(base)
        self._conf_obj = cobj
        self.host = host if host is not None else str(cobj.get(SERVE_HOST))
        self.port = port if port is not None else int(cobj.get(SERVE_PORT))
        self._admission = AdmissionController(cobj)
        # same-signature batch fusion (docs/adaptive.md): when OFF the
        # coordinator is never constructed and _handle_sql takes the
        # classic acquire/execute path untouched
        self._fusion = None
        if bool(cobj.get(SERVE_BATCH_FUSION_ENABLED)):
            from spark_rapids_tpu_torch.serve.scheduler import \
                BatchFusionCoordinator
            self._fusion = BatchFusionCoordinator(
                int(cobj.get(SERVE_BATCH_FUSION_WINDOW_MS)),
                int(cobj.get(SERVE_BATCH_FUSION_MAX_BATCH)))
        # serve-tier result cache (docs/caching.md): when OFF the
        # cache is never constructed and every request takes the
        # execute path untouched
        self._result_cache = None
        if bool(cobj.get(RESULT_CACHE_ENABLED)):
            from spark_rapids_tpu_torch.serve.result_cache import ResultCache
            self._result_cache = ResultCache(
                int(cobj.get(RESULT_CACHE_MAX_ENTRIES)),
                int(cobj.get(RESULT_CACHE_MAX_BYTES)))
        self._sessions: Dict[str, object] = {}
        self._sessions_lock = threading.Lock()
        # per-tenant creation locks: concurrent first requests for ONE
        # tenant must build exactly one session (a discarded loser
        # would tear down shared state it happened to initialize),
        # without serializing OTHER tenants' requests
        self._tenant_locks: Dict[str, threading.Lock] = {}
        self._views: Dict[str, Tuple[str, str]] = {}  # name -> (fmt, path)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._stopping = threading.Event()
        self._started = time.perf_counter()
        # per-tenant end-to-end latency (queue + execute) reservoirs
        self._lat_lock = threading.Lock()
        self._tenant_lat: Dict[str, List[float]] = {}
        self.queries_ok = 0
        self.queries_err = 0
        # query lifecycle (docs/serving.md "Query lifecycle"):
        # in-flight sql requests tracked conn -> CancelToken so the
        # `cancel` verb, the disconnect monitor, and the drain
        # straggler pass can reach them; cancellations counted by
        # terminal reason
        self._live_lock = threading.Lock()
        self._inflight: Dict[object, object] = {}
        self.queries_cancelled = 0
        self.queries_quarantined = 0
        self._cancel_reasons: Dict[str, int] = {}
        from spark_rapids_tpu_torch.lifecycle import StuckQueryWatchdog
        self._watchdog = StuckQueryWatchdog(cobj)
        self._disco_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "QueryServer":
        """Bind + listen + start the accept loop; ``self.port`` holds
        the bound port (ephemeral when configured 0)."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, self.port))
        sock.listen(128)
        # bounded accept blocks: close() does not interrupt a thread
        # parked in accept(), and the kernel keeps the listener alive
        # until that accept returns — the timeout lets the loop observe
        # _stopping so shutdown actually releases the port
        sock.settimeout(0.2)
        self.port = sock.getsockname()[1]
        self._sock = sock
        self._started = time.perf_counter()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="torch-serve-accept",
            daemon=True)
        self._accept_thread.start()
        # lifecycle threads: the stuck-query watchdog (conf-gated) and
        # the client-disconnect monitor (always on — a vanished client
        # must not pin its admission slot/permit/ledger)
        self._watchdog.start()
        self._disco_thread = threading.Thread(
            target=self._disconnect_monitor, name="torch-serve-disco",
            daemon=True)
        self._disco_thread.start()
        return self

    def start_metrics_http(self, port: int,
                           host: Optional[str] = None) -> int:
        """The HTTP twin of the `metrics` verb: not ported yet."""
        raise NotImplementedError(A11B_ERROR)

    def shutdown(self, timeout: float = 60.0) -> bool:
        """Graceful drain (docs/serving.md "Query lifecycle"): stop
        accepting, reject queued queries, let in-flight queries finish
        within the drain deadline, then cooperatively CANCEL the
        stragglers (reason=shutdown — they return status=cancelled),
        stop tenant sessions, and release every lifecycle resource so
        the process exits with the store empty and all permits
        restored. Returns True when every in-flight query terminated
        (finished or cancelled) before return."""
        self._stopping.set()
        self._admission.begin_shutdown()
        self._watchdog.stop()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            # the port is only released once the accept loop exits
            self._accept_thread.join(timeout=5.0)
        drained = self._admission.drain(timeout)
        if not drained:
            # drain deadline passed: cancel the stragglers and give
            # them a short grace to unwind through their checkpoints
            from spark_rapids_tpu_torch.lifecycle import REASON_SHUTDOWN
            with self._live_lock:
                stragglers = list(self._inflight.values())
            for tok in stragglers:
                tok.cancel(REASON_SHUTDOWN)
            drained = self._admission.drain(
                max(5.0, min(30.0, timeout * 0.25)))
        if self._disco_thread is not None:
            self._disco_thread.join(timeout=5.0)
            self._disco_thread = None
        # after the drain, close remaining connections: idle clients
        # (pollers parked between requests) observe EOF and exit
        # cleanly instead of holding conn threads alive forever
        with self._conn_lock:
            conns = list(self._conns)
            self._conns = []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        with self._conn_lock:
            threads = list(self._conn_threads)
        for t in threads:
            t.join(timeout=max(0.1, timeout / max(1, len(threads))))
        with self._sessions_lock:
            sessions, self._sessions = dict(self._sessions), {}
        for s in sessions.values():
            try:
                s.stop()
            except Exception:
                pass
        # post-drain invariants (asserted by the soak harness): run the
        # collector once so any plan still referenced from an unwinding
        # frame drops its store handles via the weakref finalizers —
        # the store must read empty and the semaphore fully restored
        import gc
        gc.collect()
        return drained

    # -- catalog -----------------------------------------------------------

    def register_view(self, name: str, path: str,
                      fmt: str = "parquet") -> None:
        """Register a file-backed view for every tenant session
        (existing sessions update immediately, future sessions get it
        at creation)."""
        with self._sessions_lock:
            self._views[name] = (fmt, path)
            sessions = list(self._sessions.values())
        # a (re-)registered view may point existing SQL text at
        # different data under the same name — fingerprints alone
        # cannot see that until the paths change, so the result cache
        # starts over (docs/caching.md)
        if self._result_cache is not None:
            self._result_cache.bump_generation()
        for s in sessions:
            self._apply_view(s, name, fmt, path)

    @staticmethod
    def _apply_view(session, name: str, fmt: str, path: str) -> None:
        reader = session.read
        df = (reader.parquet(path) if fmt == "parquet"
              else reader.format(fmt).load(path))
        df.createOrReplaceTempView(name)

    def _session(self, tenant: str):
        """The tenant's session, created on first use: base conf +
        tenantId, every registered view applied. Construction happens
        under the TENANT's creation lock, OUTSIDE the sessions lock — a
        new tenant's session setup (view IO included) must not
        head-of-line-block other tenants' request handling, and exactly
        one session is ever constructed per tenant (no discarded loser
        that could tear down shared runtime state it initialized)."""
        with self._sessions_lock:
            s = self._sessions.get(tenant)
            if s is not None:
                return s
            tlock = self._tenant_locks.setdefault(tenant,
                                                  threading.Lock())
        with tlock:
            with self._sessions_lock:
                s = self._sessions.get(tenant)
                if s is not None:
                    return s
                views = dict(self._views)
            from spark_rapids_tpu_torch.sql.session import \
                TorchSparkSession
            conf = dict(self._base_conf)
            conf["spark.rapids.sql.serve.tenantId"] = tenant
            s = TorchSparkSession(conf, device=self.device)
            for name, (fmt, path) in views.items():
                self._apply_view(s, name, fmt, path)
            with self._sessions_lock:
                self._sessions[tenant] = s
                # views registered while we were constructing: apply
                # the delta (register_view covers the session from now
                # on; re-applying is an idempotent replace)
                missed = {n: v for n, v in self._views.items()
                          if n not in views}
        for name, (fmt, path) in missed.items():
            self._apply_view(s, name, fmt, path)
        return s

    # -- request handling --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _addr = self._sock.accept()
                conn.settimeout(None)  # requests block until served
            except socket.timeout:
                continue  # re-check _stopping
            except OSError:
                return  # socket closed by shutdown
            t = threading.Thread(target=self._handle_conn, args=(conn,),
                                 name="torch-serve-conn", daemon=True)
            with self._conn_lock:
                self._conn_threads.append(t)
                self._conns.append(conn)
                # drop finished threads so a long-lived server's list
                # stays bounded
                self._conn_threads = [x for x in self._conn_threads
                                      if x.is_alive() or x is t]
            t.start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                msg = protocol.recv_msg(conn)
                if msg is None:
                    return
                header, _payload = msg
                op = header.get("op")
                if op == "sql":
                    self._handle_sql(conn, header)
                elif op == "cancel":
                    self._handle_cancel(conn, header)
                elif op == "view":
                    self._handle_view(conn, header)
                elif op == "stats":
                    protocol.send_msg(conn, {"status": "ok",
                                             "stats": self.stats()})
                elif op in ("metrics", "stats-stream"):
                    # the Prometheus exposition comes with A11b
                    protocol.send_msg(conn, {"status": "error",
                                             "error": A11B_ERROR})
                elif op == "ping":
                    protocol.send_msg(conn, {"status": "ok"})
                elif op == "shutdown":
                    protocol.send_msg(conn, {"status": "ok"})
                    threading.Thread(target=self.shutdown,
                                     name="torch-serve-shutdown",
                                     daemon=True).start()
                    return
                else:
                    protocol.send_msg(conn, {
                        "status": "error",
                        "error": f"unknown op {op!r}"})
        except (protocol.ProtocolError, OSError):
            pass  # client went away / malformed stream: drop the conn
        finally:
            with self._conn_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- query lifecycle ---------------------------------------------------

    def _query_timeout_ms(self, tenant: str, header: Dict) -> int:
        """Deadline resolution (docs/serving.md "Query lifecycle"):
        the operator bound is the per-tenant conf override
        (``serve.queryTimeoutMs.<tenant>``) or the base
        ``serve.queryTimeoutMs``; the request's ``timeoutMs`` may
        TIGHTEN it (or set one where the operator set none) but never
        loosen or disable an operator-enforced bound. 0 = no
        deadline."""
        from spark_rapids_tpu_torch.conf import SERVE_QUERY_TIMEOUT_MS
        base = 0
        o = self._base_conf.get(
            "spark.rapids.sql.serve.queryTimeoutMs." + tenant)
        if o is not None:
            try:
                base = max(0, int(o))
            except (TypeError, ValueError):
                base = 0
        else:
            base = max(0, int(self._conf_obj.get(
                SERVE_QUERY_TIMEOUT_MS)))
        v = header.get("timeoutMs")
        if v is not None:
            try:
                req = max(0, int(v))
            except (TypeError, ValueError):
                return base
            if req > 0:
                return min(req, base) if base > 0 else req
        return base

    def _track(self, conn, token) -> None:
        from spark_rapids_tpu_torch import lifecycle as LC
        LC.register_query(token)
        with self._live_lock:
            self._inflight[conn] = token

    def _untrack(self, conn, token) -> None:
        from spark_rapids_tpu_torch import lifecycle as LC
        with self._live_lock:
            if self._inflight.get(conn) is token:
                self._inflight.pop(conn, None)
        LC.unregister_query(token)

    def _count_cancel(self, reason: str) -> None:
        with self._lat_lock:
            self.queries_cancelled += 1
            self._cancel_reasons[reason] = \
                self._cancel_reasons.get(reason, 0) + 1

    def _handle_cancel(self, conn: socket.socket, header: Dict) -> None:
        """The ``cancel`` protocol verb: cancel in-flight queries
        matching the given ``tenant`` and/or ``queryId`` (both
        optional; neither = every in-flight query — the operator
        hammer). Cancellation is cooperative: the response reports how
        many tokens were newly cancelled; each query returns
        ``status: cancelled`` on its OWN connection."""
        from spark_rapids_tpu_torch.lifecycle import REASON_CANCEL
        tenant = header.get("tenant")
        qid = header.get("queryId")
        with self._live_lock:
            tokens = list(self._inflight.values())
        n = 0
        for tok in tokens:
            if tenant is not None and tok.tenant != str(tenant):
                continue
            if qid is not None and tok.query_id != str(qid):
                continue
            if tok.cancel(REASON_CANCEL):
                n += 1
        protocol.send_msg(conn, {"status": "ok", "cancelled": n})

    def _disconnect_monitor(self) -> None:
        """Cancel-on-client-disconnect (docs/serving.md "Query
        lifecycle"): while a sql request executes, its connection
        thread is NOT reading the socket — this monitor select()s the
        in-flight connections and a readable socket whose peek returns
        EOF means the client vanished; its query is cancelled so the
        admission slot, semaphore permit, and tenant ledger free
        instead of riding a dead query to completion."""
        import select
        from spark_rapids_tpu_torch.lifecycle import REASON_DISCONNECT
        while not self._stopping.is_set():
            with self._live_lock:
                pairs = list(self._inflight.items())
            if not pairs:
                self._stopping.wait(0.05)
                continue
            try:
                readable, _, _ = select.select(
                    [c for c, _ in pairs], [], [], 0.05)
            except (OSError, ValueError):
                # a connection closed between snapshot and select:
                # re-snapshot next round
                self._stopping.wait(0.02)
                continue
            gone = set()
            saw_data = False
            for conn in readable:
                try:
                    if conn.recv(1, socket.MSG_PEEK) == b"":
                        gone.add(conn)
                    else:
                        # data while a response is pending =
                        # client-side pipelining; it stays buffered
                        # until the response goes out. The buffered
                        # bytes would make every select() return
                        # immediately, so pace the loop explicitly
                        # instead of busy-spinning a core for the
                        # whole query
                        saw_data = True
                except OSError:
                    gone.add(conn)
            for conn, tok in pairs:
                if conn in gone:
                    tok.cancel(REASON_DISCONNECT)
            if saw_data:
                self._stopping.wait(0.05)

    def _handle_view(self, conn: socket.socket, header: Dict) -> None:
        try:
            self.register_view(header["name"], header["path"],
                               header.get("fmt", "parquet"))
            protocol.send_msg(conn, {"status": "ok"})
        except Exception as e:  # noqa: BLE001 - reported to the client
            protocol.send_msg(conn, {"status": "error", "error": str(e)})

    def _cancelled_queued(self, conn, tenant: str, e,
                          where: str = "queued") -> None:
        """A query cancelled (or past its deadline) before it ran: no
        slot held, no session run. (The JAX package's server writes the
        query-history record here: A11b.)"""
        self._count_cancel(e.reason)
        protocol.send_msg(conn, {
            "status": "cancelled", "tenant": tenant,
            "reason": e.reason, "where": where})

    def _handle_sql(self, conn: socket.socket, header: Dict) -> None:
        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch import plan_cache as PC
        tenant = str(header.get("tenant") or "default")
        sql = header.get("sql") or ""
        t_req = time.perf_counter()
        session = self._session(tenant)
        # per-query lifecycle token: the deadline clock starts HERE, at
        # request admission, so queue wait counts against the budget;
        # the token is tracked for the cancel verb, the disconnect
        # monitor and the watchdog until the response is on the wire
        token = LC.CancelToken(
            tenant=tenant,
            query_id=(str(header["queryId"])
                      if header.get("queryId") is not None else None))
        timeout_ms = self._query_timeout_ms(tenant, header)
        if timeout_ms > 0:
            token.set_deadline(timeout_ms / 1000.0)
        self._track(conn, token)
        try:
            # result cache: consulted BEFORE admission AND before fusion:
            # a hit serves the stored Arrow payload with no device work,
            # no queue wait and no admission slot
            if self._result_cache is not None and \
                    self._try_result_cache(conn, tenant, sql, token, t_req):
                return
            if self._fusion is not None:
                # batch fusion: join/wait on a same-signature batch
                # INSTEAD of acquiring a per-query slot; the batch's raced
                # executor acquires the one slot for everyone
                self._handle_sql_fused(conn, tenant, sql, session, token,
                                       t_req)
                return
            try:
                wait_s = self._admission.acquire(tenant, token=token)
                # the watchdog measures RUNNING time from here
                token.mark_admitted()
            except QueryRejected as e:
                protocol.send_msg(conn, {"status": "rejected",
                                         "error": str(e),
                                         "tenant": tenant})
                return
            except LC.TorchQueryCancelled as e:
                # cancelled / past its deadline while still QUEUED: the
                # slot was never acquired, nothing to release
                self._cancelled_queued(conn, tenant, e)
                return
            try:
                t0 = time.perf_counter()
                with LC.token_scope(token):
                    batch = session.sql(sql)._execute()
                exec_s = time.perf_counter() - t0
                payload = protocol.batch_to_ipc(batch)
                # this thread planned and executed: its signature and
                # pre-execution fingerprints admit the exact payload
                # bytes the client is about to receive
                self._maybe_cache_result(session, sql, payload,
                                         batch.num_rows)
                resp = {
                    "status": "ok",
                    "tenant": tenant,
                    "rows": batch.num_rows,
                    "queueWaitMs": round(wait_s * 1e3, 3),
                    "execMs": round(exec_s * 1e3, 3),
                    # per-THREAD outcome: the request plans and executes
                    # on this connection thread, so it cannot misreport
                    # under concurrent queries
                    "planCacheHit": bool(PC.last_lookup_was_hit()),
                }
                if token.query_id is not None:
                    resp["queryId"] = token.query_id
                protocol.send_msg(conn, resp, payload)
                # counted AFTER the successful send: a query whose
                # response delivery fails must not land in both ok/err
                with self._lat_lock:
                    self.queries_ok += 1
                self._record_latency(tenant, time.perf_counter() - t_req)
            except Exception as e:  # noqa: BLE001 - reported to client
                self._send_failure(conn, tenant, e, wait_s)
            finally:
                self._admission.release(tenant)
        finally:
            self._untrack(conn, token)

    def _try_result_cache(self, conn, tenant: str, sql: str, token,
                          t_req: float) -> bool:
        """Serve ``sql`` from the result cache when a fingerprint-valid
        entry exists. True when the request was fully handled here (an
        identical payload served with no device work, no queue wait and
        no admission slot, only per-tenant billing) or when the query
        was cancelled at the pre-serve checkpoint; False falls through to
        admission and execution."""
        from spark_rapids_tpu_torch import lifecycle as LC
        entry = self._result_cache.lookup(sql)
        if entry is None:
            return False
        try:
            # one checkpoint before serving: a request cancelled (or past
            # its deadline) between receipt and the probe returns cleanly
            LC.checkpoint_token(token, "admission")
        except LC.TorchQueryCancelled as e:
            self._cancelled_queued(conn, tenant, e, where="cached")
            return True
        # a real admitted query on the tenant's ledger, served off the
        # cache: billed with a ZERO queue wait, no slot taken
        self._admission.bill_cache_hit(tenant)
        exec_s = time.perf_counter() - t_req
        resp = {
            "status": "ok",
            "tenant": tenant,
            "rows": entry.rows,
            "queueWaitMs": 0.0,
            "execMs": round(exec_s * 1e3, 3),
            # the entry exists because this shape planned and executed
            # before; no planning happened at all
            "planCacheHit": True,
            "resultCacheHit": True,
        }
        if token.query_id is not None:
            resp["queryId"] = token.query_id
        protocol.send_msg(conn, resp, entry.payload)
        with self._lat_lock:
            self.queries_ok += 1
        self._record_latency(tenant, time.perf_counter() - t_req)
        return True

    def _maybe_cache_result(self, session, sql: str, payload,
                            rows: int) -> None:
        """Admit a freshly executed query's payload. Must run on the
        thread that planned AND executed ``sql``: the plan signature and
        the pre-execution fingerprint capture are thread-local to it."""
        if self._result_cache is None:
            return
        from spark_rapids_tpu_torch.serve import result_cache as RC
        self._result_cache.put(
            sql, session.thread_plan_signature(),
            RC.current_execution_fingerprints(), payload, rows)

    def _handle_sql_fused(self, conn, tenant: str, sql: str, session,
                          token, t_req: float) -> None:
        """The batch-fusion twin of ``_handle_sql``'s admission and
        execute seam. This member joins its fusion batch instead of
        taking an admission slot; the batch's raced executor acquires
        the ONE slot, runs each distinct SQL once, bills every member's
        tenant ledger, and publishes per-member results. A size-1 batch
        (an idle server: the window only engages under saturation)
        keeps exact unfused semantics: its own token scopes the run."""
        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch import plan_cache as PC
        fb, member = self._fusion.join(
            sql, tenant, token, busy=self._admission.saturated())
        try:
            role = self._fusion.wait_role(
                fb, member,
                lambda: LC.checkpoint_token(token, "admission"))
            if role == "execute":
                try:
                    self._fusion.execute_batch(
                        fb, member, self._admission,
                        lambda s, t:
                        self._session(t).sql(s)._execute())
                except LC.TorchQueryCancelled:
                    # the executor-elect's own cancel/deadline while
                    # waiting for the admission slot: it was evicted and
                    # the role handed back (a queued outcome)
                    raise
                except BaseException:  # noqa: BLE001
                    # already published to every member (this one
                    # included) by execute_batch; delivered below
                    pass
        except LC.TorchQueryCancelled as e:
            # cancelled / past its deadline while waiting on the batch:
            # the member is EVICTED, the batch runs on without it
            self._cancelled_queued(conn, tenant, e)
            return
        wait_s = member.queue_wait_s
        err = member.error
        if err is not None:
            self._send_failure(conn, tenant, err, wait_s)
            return
        batch = member.result
        if batch is None:
            # the executor failed outside the per-group publish path:
            # report an error, never crash this handler
            with self._lat_lock:
                self.queries_err += 1
            protocol.send_msg(conn, {
                "status": "error", "tenant": tenant,
                "error": "fused batch executor failed"})
            return
        exec_s = max(0.0, time.perf_counter() - t_req - wait_s)
        payload = protocol.batch_to_ipc(batch)
        if role == "execute" and member.fused_size == 1:
            # only a size-1 executor ran exactly its OWN sql on this
            # thread, so the thread-local signature and fingerprints are
            # its own; multi-member batches skip population
            self._maybe_cache_result(session, sql, payload,
                                     batch.num_rows)
        resp = {
            "status": "ok",
            "tenant": tenant,
            "rows": batch.num_rows,
            "queueWaitMs": round(wait_s * 1e3, 3),
            "execMs": round(exec_s * 1e3, 3),
            # the executor thread planned, so its per-thread outcome is
            # exact; a follower rode the executor's shared plan (a cache
            # hit by construction)
            "planCacheHit": (bool(PC.last_lookup_was_hit())
                             if role == "execute" else True),
        }
        if member.fused_size >= 2:
            resp["fusedWith"] = member.fused_size
        if token.query_id is not None:
            resp["queryId"] = token.query_id
        protocol.send_msg(conn, resp, payload)
        with self._lat_lock:
            self.queries_ok += 1
        self._record_latency(tenant, time.perf_counter() - t_req)

    def _send_failure(self, conn, tenant: str, err: BaseException,
                      wait_s: float) -> None:
        """The response of a query that did not finish once admitted:
        rejected (a fused batch's gate), cancelled while running,
        quarantined, or failed; each counted."""
        from spark_rapids_tpu_torch import lifecycle as LC
        if isinstance(err, QueryRejected):
            protocol.send_msg(conn, {"status": "rejected",
                                     "error": str(err), "tenant": tenant})
        elif isinstance(err, LC.TorchQueryCancelled):
            self._count_cancel(err.reason)
            protocol.send_msg(conn, {
                "status": "cancelled", "tenant": tenant,
                "reason": err.reason, "where": "running",
                "queueWaitMs": round(wait_s * 1e3, 3)})
        elif isinstance(err, LC.TorchQueryQuarantined):
            with self._lat_lock:
                self.queries_quarantined += 1
            protocol.send_msg(conn, {
                "status": "quarantined", "tenant": tenant,
                "error": str(err), "failures": err.failures})
        else:
            with self._lat_lock:
                self.queries_err += 1
            protocol.send_msg(conn, {
                "status": "error", "tenant": tenant,
                "error": f"{type(err).__name__}: {err}"})

    def _record_latency(self, tenant: str, seconds: float) -> None:
        with self._lat_lock:
            lat = self._tenant_lat.setdefault(tenant, [])
            lat.append(seconds)
            del lat[:-_LAT_RESERVOIR]

    # -- observability -----------------------------------------------------

    def metrics_text(self) -> str:
        """The Prometheus exposition: not ported yet (A11b)."""
        raise NotImplementedError(A11B_ERROR)

    def stats(self) -> Dict:
        """Server metrics, under the JAX package's keys: admission
        counters and per-tenant queue-wait/latency percentiles, the
        plan and stage cache hit rates, the store's per-tenant ledger
        (``tenantsHBM``: device bytes), the lifecycle counters, batch
        fusion and the serve caches, and the semaphore (``semaphore``,
        a port addition: permits and ``inUse``)."""
        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch import memory
        from spark_rapids_tpu_torch import resource
        from spark_rapids_tpu_torch.jit_cache import cache_stats
        adm = self._admission.stats()
        with self._lat_lock:
            for t, lat in self._tenant_lat.items():
                entry = adm["tenants"].setdefault(t, {})
                entry["latencyMs"] = {
                    "p50": round(percentile(lat, 0.50) * 1e3, 3),
                    "p99": round(percentile(lat, 0.99) * 1e3, 3),
                    "count": len(lat),
                }
            cancelled = self.queries_cancelled
            reasons = dict(self._cancel_reasons)
            quarantined = self.queries_quarantined
            ok, err = self.queries_ok, self.queries_err
        uptime = max(1e-9, time.perf_counter() - self._started)
        sem = resource._SEMAPHORE
        out = {
            "host": self.host,
            "port": self.port,
            "device": str(self.device),
            "uptimeSeconds": round(uptime, 3),
            "queriesOk": ok,
            "queriesErr": err,
            "queriesCancelled": cancelled,
            "qps": round(ok / uptime, 4),
            "admission": adm,
            "tenantsHBM": memory.store_tenant_stats(),
            "jitCaches": cache_stats(),
            "lifecycle": {
                "cancelledByReason": reasons,
                "queriesQuarantined": quarantined,
                "watchdogFlagged": self._watchdog.flagged,
                "watchdogCancelled": self._watchdog.cancelled,
                **LC.lifecycle_stats(),
            },
            "semaphore": ({"permits": sem.permits, "inUse": sem.in_use}
                          if sem is not None else None),
        }
        if self._fusion is not None:
            out["batchFusion"] = self._fusion.stats()
        cache: Dict = {}
        if self._result_cache is not None:
            cache["result"] = self._result_cache.stats()
        from spark_rapids_tpu_torch.serve import result_cache as _rc
        sp = _rc.subplan_cache_stats()
        if sp is not None:
            cache["subplan"] = sp
        if cache:
            out["cache"] = cache
        return out
