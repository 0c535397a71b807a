"""Admission control for the query server (the counterpart of
``spark_rapids_tpu.serve.scheduler``; docs/serving.md).

Sits IN FRONT of the existing ``TorchSemaphore``: the semaphore bounds
how many *tasks* touch the device at once, this controller bounds how
many *queries* execute at all and how many wait, so a traffic burst
degrades into bounded queueing + explicit rejection instead of a pile
of half-admitted queries thrashing the device memory pool (the GpuSemaphore /
``concurrentGpuTasks`` division of labor from SURVEY §2.1, lifted one
level up).

Three policies compose in ``_eligible``:

1. **capacity** — at most ``serve.maxConcurrentQueries`` in flight,
   at most ``serve.maxQueued`` waiting (beyond that: REJECT, the
   backpressure contract);
2. **per-tenant cap** — at most ``serve.maxConcurrentPerTenant`` in
   flight per tenant, so one chatty tenant cannot occupy every slot;
3. **fair-share device-memory throttle** — a tenant the DeviceStore
   reports over its fair share (``serve.fairShareFactor`` x budget / live
   tenants, the PR-6 per-owner ledger generalized per tenant) is
   passed over while OTHER tenants wait; it runs again once its
   working set drains or the queue empties of competitors (no
   starvation: a lone tenant is never throttled).

Admission order is FIFO among eligible tickets — an earlier ticket
that could run always runs first, so the queue cannot invert arrival
order except where policy demands it.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import (SERVE_MAX_CONCURRENT,
                                         SERVE_MAX_PER_TENANT,
                                         SERVE_MAX_QUEUED, TorchConf)

# bounded reservoir per tenant: enough for stable p99 at bench scale
# without unbounded growth on a long-lived server
_RESERVOIR = 4096


class QueryRejected(Exception):
    """Admission refused (queue full or server shutting down); the
    server maps this to a ``status: rejected`` response."""


# ONE copy of the nearest-rank rule (lifecycle.py): the admission
# stats, bench legs, and the watchdog's p99 must agree on what a
# percentile means; re-exported here for the existing import sites
from spark_rapids_tpu_torch.lifecycle import percentile  # noqa: E402,F401


class _Ticket:
    __slots__ = ("seq", "tenant", "signature")

    def __init__(self, seq: int, tenant: str,
                 signature: Optional[str] = None):
        self.seq = seq
        self.tenant = tenant
        # signature digest HINT (docs/tuning.md): the plan signature
        # is only known after planning, so admission-time signature
        # policy runs off the server's learned sql->digest map; an
        # unhinted query is never signature-throttled
        self.signature = signature


class AdmissionController:
    def __init__(self, conf: TorchConf):
        self.max_concurrent = max(1, int(conf.get(SERVE_MAX_CONCURRENT)))
        self.max_queued = max(0, int(conf.get(SERVE_MAX_QUEUED)))
        self.max_per_tenant = max(1, int(conf.get(SERVE_MAX_PER_TENANT)))
        self._cv = threading.Condition()
        self._queue: List[_Ticket] = []
        self._seq = 0
        self._in_flight = 0
        self._tenant_flight: Dict[str, int] = {}
        self._shutdown = False
        # tuning-controller actuators (the controller itself comes with
        # the observability slice, ROADMAP A11b): per-signature
        # concurrency ceilings (digest -> limit; a retrySpill action
        # narrows a thrashing shape) and per-tenant admission weights
        # (weight scales the per-tenant cap; an sloBurn action widens
        # a burning tenant before its p99 objective breaches)
        self._sig_limits: Dict[str, int] = {}
        self._sig_flight: Dict[str, int] = {}
        self._weights: Dict[str, float] = {}
        # server metrics (docs/serving.md): admitted/rejected totals,
        # per-tenant counts, queue-wait reservoirs
        self.admitted = 0
        self.rejected = 0
        self.throttled_waits = 0  # admissions delayed by fair share
        self._tenant_admitted: Dict[str, int] = {}
        self._tenant_rejected: Dict[str, int] = {}
        self._tenant_waits: Dict[str, List[float]] = {}

    # -- tuning actuators --------------------------------------------------

    def set_signature_limit(self, digest: str,
                            limit: Optional[int]) -> None:
        """Cap in-flight queries for one signature digest (None or a
        non-positive limit clears the cap). The caller (the
        TuningController's ACTION_CATALOG clamps) owns bounding."""
        with self._cv:
            if limit is None or int(limit) <= 0:
                self._sig_limits.pop(digest, None)
            else:
                self._sig_limits[digest] = int(limit)
            self._cv.notify_all()

    def signature_limit(self, digest: str) -> Optional[int]:
        with self._cv:
            return self._sig_limits.get(digest)

    def set_tenant_weight(self, tenant: str,
                          weight: Optional[float]) -> None:
        """Scale one tenant's per-tenant concurrency cap (1.0 or None
        clears). The effective cap is max(1, round(maxConcurrentPerTenant
        * weight)) — bounded below so no weight can starve a tenant."""
        with self._cv:
            if weight is None or abs(float(weight) - 1.0) < 1e-9:
                self._weights.pop(tenant, None)
            else:
                self._weights[tenant] = float(weight)
            self._cv.notify_all()

    def tenant_weight(self, tenant: str) -> float:
        with self._cv:
            return self._weights.get(tenant, 1.0)

    # -- policy ------------------------------------------------------------

    def _over_share(self) -> Dict[str, int]:
        from spark_rapids_tpu_torch import memory
        store = memory._STORE
        if store is None:
            return {}
        try:
            return store.over_share_tenants()
        except Exception:
            return {}

    def _tenant_cap(self, tenant: str) -> int:
        w = self._weights.get(tenant)
        if w is None:
            return self.max_per_tenant
        return max(1, int(round(self.max_per_tenant * w)))

    def _tenant_ok(self, tenant: str) -> bool:
        return self._tenant_flight.get(tenant, 0) < \
            self._tenant_cap(tenant)

    def _sig_ok(self, signature: Optional[str]) -> bool:
        if not signature:
            return True
        limit = self._sig_limits.get(signature)
        if limit is None:
            return True
        return self._sig_flight.get(signature, 0) < limit

    def _count_rejection(self, tenant: str) -> None:
        """Every wire-level rejection (queue full OR shutdown) counts;
        call under the condition lock."""
        self.rejected += 1
        self._tenant_rejected[tenant] = \
            self._tenant_rejected.get(tenant, 0) + 1

    def _eligible(self, tk: _Ticket, over: Dict[str, int]) -> bool:
        if self._in_flight >= self.max_concurrent:
            return False
        if not self._tenant_ok(tk.tenant):
            return False
        if not self._sig_ok(tk.signature):
            # tuning signature cap: the shape yields its slot without
            # blocking anything behind it (same no-head-of-line rule
            # as the per-tenant cap)
            return False
        others_waiting = any(e.tenant != tk.tenant for e in self._queue)
        if tk.tenant in over and others_waiting:
            # fair-share throttle: over-share tenants yield the slot
            # while anyone else is waiting (never starved — the gate
            # opens the moment the queue is all theirs)
            return False
        # FIFO among eligible: an earlier ticket that could run now
        # goes first
        for e in self._queue:
            if e is tk:
                return True
            if self._tenant_ok(e.tenant) and self._sig_ok(e.signature) \
                    and not (
                    e.tenant in over and any(
                        o.tenant != e.tenant for o in self._queue
                        if o is not e)):
                return False
        return True

    # -- acquire/release ---------------------------------------------------

    def acquire(self, tenant: str, token=None,
                signature: Optional[str] = None) -> float:
        """Block until the query may execute; returns the queue wait in
        seconds. Raises QueryRejected when the queue is full (the
        backpressure path) or the server is shutting down. With a
        lifecycle ``token``, a cancellation or deadline expiry WHILE
        QUEUED raises TorchQueryCancelled and releases the queue slot —
        deadlines are enforced from admission time (docs/serving.md
        "Query lifecycle"). ``signature`` is the learned digest hint
        the tuning signature caps key on; release() must receive the
        same hint."""
        t0 = time.perf_counter()
        throttled = False
        with self._cv:
            if self._shutdown:
                self._count_rejection(tenant)
                raise QueryRejected("server is shutting down")
            self._seq += 1
            tk = _Ticket(self._seq, tenant, signature)
            self._queue.append(tk)
            # the JAX package's telemetry queue-saturation trigger fires
            # here; triggers come with the observability slice (A11b)
            # maxQueued bounds WAITING queries: a ticket that can run
            # immediately is admitted regardless (maxQueued=0 means
            # "reject whenever anything must wait", not "reject all")
            if not self._eligible(tk, self._over_share()) and \
                    len(self._queue) > self.max_queued:
                self._queue.remove(tk)
                self._count_rejection(tenant)
                raise QueryRejected(
                    f"queue full ({self.max_queued} waiting)")
            try:
                while True:
                    if self._shutdown:
                        # counted like every other wire-level rejection
                        # (stats must reconcile with what clients saw)
                        self._count_rejection(tenant)
                        raise QueryRejected("server is shutting down")
                    if token is not None:
                        # cancelled / past-deadline while queued: the
                        # BaseException cleanup below releases the
                        # ticket and wakes the queue (the admission
                        # wait is a lifecycle checkpoint, so the
                        # site:cancel injection schedule counts it)
                        from spark_rapids_tpu_torch.lifecycle import \
                            checkpoint_token
                        checkpoint_token(token, "admission")
                    over = self._over_share()
                    if self._eligible(tk, over):
                        break
                    if tk.tenant in over:
                        throttled = True
                    # bounded wait: the fair-share signal lives in the
                    # DeviceStore and changes without notifying this
                    # condition, so re-evaluate periodically
                    self._cv.wait(timeout=0.05)
            except BaseException:
                self._queue.remove(tk)
                self._cv.notify_all()
                raise
            self._queue.remove(tk)
            self._in_flight += 1
            self._tenant_flight[tenant] = \
                self._tenant_flight.get(tenant, 0) + 1
            if signature:
                self._sig_flight[signature] = \
                    self._sig_flight.get(signature, 0) + 1
            self.admitted += 1
            self._tenant_admitted[tenant] = \
                self._tenant_admitted.get(tenant, 0) + 1
            if throttled:
                self.throttled_waits += 1
            wait = time.perf_counter() - t0
            waits = self._tenant_waits.setdefault(tenant, [])
            waits.append(wait)
            del waits[:-_RESERVOIR]
        # (the JAX package records a serveQueueWait span here: A11b)
        return wait

    def bill_fused_member(self, tenant: str, wait_s: float) -> None:
        """FIFO-fairness accounting for batch fusion (docs/adaptive.md):
        a fused batch occupies ONE execution slot, but every member
        query is a real admission from its tenant's point of view —
        admitted totals and the queue-wait reservoir bill per member,
        so `stats()`/Prometheus and the fair-share picture cannot
        under-report a tenant just because its queries fused. No slot
        is taken (the executor's own acquire holds the batch's one)."""
        with self._cv:
            self.admitted += 1
            self._tenant_admitted[tenant] = \
                self._tenant_admitted.get(tenant, 0) + 1
            waits = self._tenant_waits.setdefault(tenant, [])
            waits.append(max(0.0, wait_s))
            del waits[:-_RESERVOIR]

    def bill_cache_hit(self, tenant: str) -> None:
        """Result-cache-hit accounting (docs/caching.md): a hit is
        served BEFORE admission — no slot, no queue wait — but it is a
        real admitted query from the tenant's point of view, so the
        admitted totals and queue-wait reservoir bill it exactly like a
        fused member (with a zero wait — that zero is the product)."""
        self.bill_fused_member(tenant, 0.0)

    def saturated(self) -> bool:
        """Queue-pressure hint for the batch-fusion window gate
        (docs/adaptive.md): anything waiting, or every slot occupied.
        An unsaturated server closes fusion batches immediately, so
        fusion never adds latency when there is no queue to amortize."""
        with self._cv:
            return bool(self._queue) or \
                self._in_flight >= self.max_concurrent

    def release(self, tenant: str,
                signature: Optional[str] = None) -> None:
        with self._cv:
            self._in_flight -= 1
            n = self._tenant_flight.get(tenant, 0) - 1
            if n > 0:
                self._tenant_flight[tenant] = n
            else:
                self._tenant_flight.pop(tenant, None)
            if signature:
                s = self._sig_flight.get(signature, 0) - 1
                if s > 0:
                    self._sig_flight[signature] = s
                else:
                    self._sig_flight.pop(signature, None)
            self._cv.notify_all()

    def begin_shutdown(self) -> None:
        """Queued (not yet admitted) queries are rejected; in-flight
        queries run to completion (the clean-shutdown contract)."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait for in-flight queries to finish; True when drained."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            while self._in_flight > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(0.1, left))
        return True

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict:
        with self._cv:
            tenants = (set(self._tenant_admitted)
                       | set(self._tenant_rejected)
                       | set(self._tenant_waits))
            per_tenant = {}
            for t in sorted(tenants):
                waits = self._tenant_waits.get(t, [])
                per_tenant[t] = {
                    "admitted": self._tenant_admitted.get(t, 0),
                    "rejected": self._tenant_rejected.get(t, 0),
                    "inFlight": self._tenant_flight.get(t, 0),
                    "queueWaitMs": {
                        "p50": round(percentile(waits, 0.50) * 1e3, 3),
                        "p99": round(percentile(waits, 0.99) * 1e3, 3),
                    },
                }
            return {
                "maxConcurrentQueries": self.max_concurrent,
                "maxQueued": self.max_queued,
                "maxConcurrentPerTenant": self.max_per_tenant,
                "inFlight": self._in_flight,
                "queued": len(self._queue),
                "admitted": self.admitted,
                "rejected": self.rejected,
                "throttledWaits": self.throttled_waits,
                "tenants": per_tenant,
                "signatureLimits": dict(self._sig_limits),
                "tenantWeights": dict(self._weights),
            }


# ---------------------------------------------------------------------------
# Same-signature batch fusion (docs/adaptive.md)
# ---------------------------------------------------------------------------


class _FusionMember:
    """One query's seat in a fused batch. ``evicted`` flips when the
    member's OWN lifecycle token cancels: the member leaves, the batch
    never aborts (the PR-13 cancel contract under fusion)."""

    __slots__ = ("sql", "tenant", "token", "arrive_t", "evicted",
                 "result", "error", "queue_wait_s", "fused_size")

    def __init__(self, sql: str, tenant: str, token):
        self.sql = sql
        self.tenant = tenant
        self.token = token
        self.arrive_t = time.monotonic()
        self.evicted = False
        self.result = None
        self.error: Optional[BaseException] = None
        self.queue_wait_s = 0.0
        self.fused_size = 1


class _FusionBatch:
    __slots__ = ("key", "deadline", "max_batch", "members", "closed",
                 "executor", "done")

    def __init__(self, key: str, window_s: float, max_batch: int):
        self.key = key
        self.deadline = time.monotonic() + window_s
        self.max_batch = max_batch
        self.members: List[_FusionMember] = []
        self.closed = False
        self.executor: Optional[_FusionMember] = None
        self.done = threading.Event()


class BatchFusionCoordinator:
    """Collects same-shape queries — identical literal-normalized SQL,
    ``adaptive.fusion_key`` — arriving within ``batchFusion.windowMs``
    and executes the whole batch under ONE admission slot: identical
    texts share a single execution, distinct literal bindings run
    back-to-back on the same connection thread, each on its own cached
    plan template.

    Roles are raced, not fixed: every member waits on its batch, and
    the FIRST surviving member to observe the batch closed claims the
    executor role. A would-be executor that cancels while waiting is
    just another eviction — some other member executes, so a single
    cancel can never abort the batch. Fairness is per member: the
    executor's ``execute_batch`` bills every other member's tenant
    ledger and queue wait through
    ``AdmissionController.bill_fused_member``.

    The window only engages while the server is saturated (the
    ``busy`` hint at ``join``): an idle server closes the batch
    immediately and pays zero added latency."""

    # member wait-loop poll tick (the batch window is O(10ms))
    _TICK = 0.002

    def __init__(self, window_ms: int, max_batch: int):
        self._window_s = max(0.0, window_ms / 1000.0)
        self._max_batch = max(1, max_batch)
        self._lock = threading.Lock()
        self._open: Dict[str, _FusionBatch] = {}
        # members delivered out of batches of size >= 2, and such
        # batches — the server's batchFusion stats / srt_aqe_* families
        self.fused_queries = 0
        self.fused_batches = 0

    def join(self, sql: str, tenant: str, token,
             busy: bool) -> "Tuple[_FusionBatch, _FusionMember]":
        from spark_rapids_tpu_torch.adaptive import fusion_key
        key, _ = fusion_key(sql)
        m = _FusionMember(sql, tenant, token)
        with self._lock:
            fb = self._open.get(key)
            if fb is not None and not fb.closed:
                fb.members.append(m)
                if len(fb.members) >= fb.max_batch:
                    fb.closed = True
                    self._open.pop(key, None)
                return fb, m
            fb = _FusionBatch(key,
                              self._window_s if busy else 0.0,
                              self._max_batch)
            fb.members.append(m)
            self._open[key] = fb
            return fb, m

    def wait_role(self, fb: _FusionBatch, m: _FusionMember,
                  checkpoint) -> str:
        """Block until this member becomes the batch's executor
        (returns ``"execute"``) or the batch completes (``"done"``).
        ``checkpoint`` runs every tick and raises to cancel; on cancel
        the member is evicted — only it aborts, never the batch."""
        while True:
            try:
                checkpoint()
            except BaseException:
                with self._lock:
                    m.evicted = True
                raise
            with self._lock:
                if fb.done.is_set():
                    return "done"
                if not fb.closed and \
                        time.monotonic() >= fb.deadline:
                    fb.closed = True
                    if self._open.get(fb.key) is fb:
                        del self._open[fb.key]
                if fb.closed and fb.executor is None:
                    fb.executor = m
                    return "execute"
            fb.done.wait(self._TICK)

    def execute_batch(self, fb: _FusionBatch, m: _FusionMember,
                      admission: AdmissionController, run_sql) -> None:
        """Executor side: acquire the batch's ONE slot under the
        executor's tenant, bill every member, run each distinct SQL
        once for its surviving members via ``run_sql(sql, tenant)``
        (executed under the session of one of its own requesters), and
        publish per-member results. Every exit path resolves the done
        event or hands the executor role back — a failure (admission
        rejection included) reaches members as their error, never as a
        hang."""
        from spark_rapids_tpu_torch.lifecycle import TorchQueryCancelled
        try:
            # the executor-elect waits for the slot under its OWN
            # token: a deadline expiring here is still a
            # cancelled-WHILE-QUEUED outcome for it
            admission.acquire(m.tenant, token=m.token)
        except TorchQueryCancelled:
            # personal to the executor-elect — evict it and hand the
            # role back so a surviving member re-races (the batch never
            # aborts on one member's cancel); done only fires when
            # nobody is left to claim the role
            with self._lock:
                m.evicted = True
                fb.executor = None
                if not any(not mm.evicted for mm in fb.members):
                    fb.done.set()
            raise
        except BaseException as e:
            # rejection/shutdown applies to the whole batch: every
            # member would have met the same gate
            with self._lock:
                for mm in fb.members:
                    mm.error = e
                fb.done.set()
            raise
        try:
            t_admit = time.monotonic()
            with self._lock:
                members = list(fb.members)
                # evicted members were cancelled while QUEUED: like the
                # unfused path they are never billed as admitted and do
                # not count toward the fused size
                live_members = [mm for mm in members if not mm.evicted]
                size = len(live_members)
            for mm in members:
                mm.queue_wait_s = max(0.0, t_admit - mm.arrive_t)
            for mm in live_members:
                mm.fused_size = size
                if mm.token is not None:
                    # the watchdog measures RUNNING time from here for
                    # every member — fusion wait is queue wait, not
                    # runtime
                    mm.token.mark_admitted()
                if mm is not m:
                    admission.bill_fused_member(mm.tenant,
                                                mm.queue_wait_s)
            groups: Dict[str, List[_FusionMember]] = {}
            for mm in members:
                groups.setdefault(mm.sql, []).append(mm)
            from spark_rapids_tpu_torch import lifecycle as LC
            for sql, mems in groups.items():
                live = [mm for mm in mems if not mm.evicted]
                if not live:
                    continue
                try:
                    if len(live) == 1 and live[0].token is not None:
                        # a group with ONE surviving requester keeps
                        # exact unfused lifecycle semantics: its own
                        # token scopes the execution, so deadlines /
                        # cancel / drain reach the running query
                        with LC.token_scope(live[0].token):
                            res = run_sql(sql, live[0].tenant)
                    else:
                        # >=2 requesters: tokenless — one member's
                        # cancel evicts only that member, never the
                        # shared execution
                        res = run_sql(sql, live[0].tenant)
                    for mm in mems:
                        mm.result = res
                except BaseException as e:
                    for mm in mems:
                        mm.error = e
            if size >= 2:
                with self._lock:
                    self.fused_batches += 1
                    self.fused_queries += size
        finally:
            admission.release(m.tenant)
            fb.done.set()

    def stats(self) -> Dict:
        with self._lock:
            return {"fusedQueries": self.fused_queries,
                    "fusedBatches": self.fused_batches}
