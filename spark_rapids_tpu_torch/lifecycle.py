"""Query lifecycle: deadlines, cooperative cancellation, the
stuck-query watchdog, and the poison-query quarantine (the counterpart
of ``spark_rapids_tpu.lifecycle``; docs/serving.md "Query lifecycle").

The serving tier multiplexes tenants onto one device runtime, but
nothing before this module could *stop* a query: a query that compiles
forever, thrashes retry, or whose client vanished held its admission
slot, semaphore permit, and HBM ledger until it finished on its own.
The reference plugin leans on Spark's task-kill layer for exactly this
(SURVEY.md — Spark remains the fault-tolerance layer); this module is
the session-server twin of that layer:

- :class:`CancelToken` — one per served query, threaded through
  ``execute_collect`` via a thread-local scope
  (:func:`token_scope`) and CHECKED at the engine's existing choke
  points (the batch loop, retry backoff sleeps, semaphore/admission
  waits, jit-cache single-flight waits, the scan prefetch ring), so
  cancellation is cooperative: the running thread raises
  :class:`TorchQueryCancelled` at its next checkpoint, the semaphore and
  admission slot release through the existing finally paths, and the
  query's spillable handles close deterministically
  (``memory.release_plan_handles``).
- **Deadlines** — a token may carry a monotonic deadline
  (``spark.rapids.sql.serve.queryTimeoutMs``, per-tenant overridable,
  client-suppliable per request); every checkpoint converts an expired
  deadline into a cancellation with reason ``deadline``, enforced from
  request admission (a query can time out while still queued).
- **Stuck-query watchdog** — :class:`StuckQueryWatchdog`: a running
  query whose elapsed wall exceeds ``serve.watchdogFactor`` x its
  plan-cache signature's observed p99 is flagged and (when
  ``serve.watchdogCancel``) cancelled with reason ``watchdog``. The
  JAX package also fires a ``stuckQuery`` slow-query bundle through
  its telemetry trigger engine; that comes with the observability
  slice (ROADMAP A11b).
- **Poison-query quarantine** — a signature that fails
  ``serve.quarantineThreshold`` CONSECUTIVE times with a runtime-fatal
  error (cancellations and timeouts never count) is blacklisted:
  further submissions raise :class:`TorchQueryQuarantined` before
  touching the device, so a poison shape fails fast instead of
  re-wedging the runtime. One success clears the streak.

Fault injection: the ``site:cancel:N`` leg of the injection grammar
(docs/robustness.md) counts these checkpoints and cancels the live
token at the Nth one, which is how the chaos soak sweeps cancellation
through every wait site deterministically.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

# cancellation reasons (the wire's `reason` field and the state
# machine's terminal states, docs/serving.md)
REASON_CANCEL = "cancel"          # explicit `cancel` protocol verb
REASON_DEADLINE = "deadline"      # queryTimeoutMs expired
REASON_DISCONNECT = "disconnect"  # client connection went away
REASON_WATCHDOG = "watchdog"      # stuck-query watchdog (conf-gated)
REASON_SHUTDOWN = "shutdown"      # drain deadline cancelled stragglers
REASON_INJECTED = "injected"      # FaultInjector site:cancel schedule

# how long a wait may go between cancellation checks: every cancellable
# wait in the engine re-checks at least this often, which bounds
# cancellation latency at (slice + one batch interval)
WAIT_SLICE_S = 0.05

# a signature needs this many observed walls before the watchdog trusts
# its p99 (a cold shape must not look "stuck" against one warm sample)
WATCHDOG_MIN_SAMPLES = 5


class TorchQueryCancelled(RuntimeError):
    """The query's CancelToken was cancelled (or its deadline expired);
    raised cooperatively at the next lifecycle checkpoint. ``reason``
    is one of the REASON_* constants."""

    def __init__(self, reason: str, msg: str = ""):
        super().__init__(msg or f"query cancelled ({reason})")
        self.reason = reason


class TorchQueryQuarantined(RuntimeError):
    """The query's plan signature is quarantined after K consecutive
    runtime-fatal failures; it fails fast without touching the device
    (docs/serving.md 'Query lifecycle')."""

    def __init__(self, signature: str, failures: int):
        super().__init__(
            f"query signature quarantined after {failures} consecutive "
            f"runtime-fatal failures (spark.rapids.sql.serve."
            f"quarantineThreshold)")
        self.signature = signature
        self.failures = failures


class CancelToken:
    """Per-query cancellation + deadline state. Thread-safe: any
    thread may cancel; the executing threads observe it at their next
    checkpoint. First cancel wins (the reason never flips)."""

    __slots__ = ("tenant", "query_id", "started", "admitted",
                 "deadline", "_event", "_reason", "_lock", "signature",
                 "watchdog_flagged")

    def __init__(self, tenant: Optional[str] = None,
                 query_id: Optional[str] = None):
        self.tenant = tenant
        self.query_id = query_id
        self.started = time.monotonic()
        # when the query LEFT the admission queue (set by the server):
        # the watchdog measures running time from here, so queue wait
        # under load can never make a healthy query look stuck
        self.admitted: Optional[float] = None
        self.deadline: Optional[float] = None  # monotonic seconds
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._lock = threading.Lock()
        # plan-cache signature, attached by session.plan_physical once
        # planning resolves it (the watchdog keys its p99 on this)
        self.signature: Optional[str] = None
        self.watchdog_flagged = False

    def set_deadline(self, timeout_s: float) -> None:
        """Arm the deadline ``timeout_s`` seconds from the token's
        creation (admission time) — NOT from now, so queue wait counts
        against the budget."""
        self.deadline = self.started + max(0.0, timeout_s)

    def cancel(self, reason: str) -> bool:
        """Request cooperative cancellation; returns True when this
        call was the FIRST cancel (the recorded reason)."""
        with self._lock:
            if self._reason is not None:
                return False
            self._reason = reason
        self._event.set()
        # the JAX package records a queryCancelled trace instant here;
        # span tracing comes with the observability slice (A11b)
        return True

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def cancelled(self) -> bool:
        """True when cancelled OR past deadline (an expired deadline
        converts into a cancellation with reason ``deadline`` the
        first time anyone looks)."""
        if self._event.is_set():
            return True
        if self.deadline is not None and \
                time.monotonic() > self.deadline:
            self.cancel(REASON_DEADLINE)
            return True
        return False

    def check(self) -> None:
        """Raise :class:`TorchQueryCancelled` when the query should stop
        (the checkpoint primitive every wait site calls)."""
        if self.cancelled():
            raise TorchQueryCancelled(self._reason or REASON_CANCEL)

    def elapsed(self) -> float:
        return time.monotonic() - self.started

    def mark_admitted(self) -> None:
        self.admitted = time.monotonic()

    def run_elapsed(self) -> Optional[float]:
        """Seconds since admission (None while still queued) — the
        quantity comparable to the recorded EXECUTION walls."""
        if self.admitted is None:
            return None
        return time.monotonic() - self.admitted

    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (None when no deadline)."""
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()


# ---------------------------------------------------------------------------
# Thread-local token scope + checkpoints
# ---------------------------------------------------------------------------

_TLS = threading.local()


def current_token() -> Optional[CancelToken]:
    """The calling thread's active CancelToken (None outside a served
    query — every checkpoint is then one thread-local read)."""
    return getattr(_TLS, "token", None)


@contextlib.contextmanager
def token_scope(token: Optional[CancelToken]):
    """Install ``token`` as the calling thread's active token. Pool
    threads do NOT inherit it automatically — the task-drain and scan
    producer paths capture the creating thread's token explicitly and
    re-enter this scope (a thread-local cannot follow work across
    pools by itself)."""
    prev = getattr(_TLS, "token", None)
    _TLS.token = token if token is not None else prev
    try:
        yield
    finally:
        _TLS.token = prev


def checkpoint_token(token: Optional[CancelToken],
                     site: str = "") -> None:
    """The checkpoint primitive against an EXPLICIT token (the
    admission queue holds the token before any scope is installed):
    consults the ``site:cancel:N`` injection schedule, then raises
    :class:`TorchQueryCancelled` when the token is cancelled or past its
    deadline."""
    if token is None:
        return
    from spark_rapids_tpu_torch import retry as _retry
    inj = _retry._INJECTOR
    if inj is not None:
        inj.on_cancel_point(token, site)
    token.check()


def checkpoint(site: str = "") -> None:
    """One cooperative cancellation checkpoint: no-op without an active
    token; raises :class:`TorchQueryCancelled` when the token is
    cancelled or past its deadline. ``site`` names the checkpoint class
    (``batch``, ``prefetch``, ``retryBackoff``, ``semaphore``,
    ``jitWait``, ``admission`` — docs/robustness.md site catalog) for
    diagnostics; the ``site:cancel:N`` injection schedule counts EVERY
    checkpoint regardless of its site tag."""
    checkpoint_token(getattr(_TLS, "token", None), site)


def cancellable_sleep(seconds: float, site: str = "retryBackoff"
                      ) -> None:
    """Sleep that a cancellation interrupts: one checkpoint up front
    (deterministic injection counting — a long backoff is ONE
    checkpoint), then the sleep proceeds in bounded slices re-checking
    the token, so a cancelled query never sleeps through its deadline.
    Plain ``time.sleep`` outside a query scope."""
    checkpoint(site)
    tok = getattr(_TLS, "token", None)
    if tok is None:
        if seconds > 0:
            time.sleep(seconds)
        return
    end = time.monotonic() + max(0.0, seconds)
    while True:
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, WAIT_SLICE_S))
        tok.check()


def cancellable_wait(event: threading.Event,
                     timeout: Optional[float] = None,
                     site: str = "jitWait") -> bool:
    """``event.wait`` that a cancellation interrupts (the jit-cache
    single-flight wait and similar parked states). Returns the event
    state like ``Event.wait``; raises :class:`TorchQueryCancelled` when
    the caller's token cancels first."""
    tok = getattr(_TLS, "token", None)
    if tok is None:
        return event.wait(timeout)
    checkpoint(site)
    end = None if timeout is None else time.monotonic() + timeout
    while True:
        left = WAIT_SLICE_S if end is None else \
            min(WAIT_SLICE_S, end - time.monotonic())
        if left is not None and left <= 0:
            return event.is_set()
        if event.wait(left):
            return True
        tok.check()


# ---------------------------------------------------------------------------
# Live-query registry (the watchdog's and the server's view of what is
# in flight; the server registers at request receipt and unregisters in
# its response finally)
# ---------------------------------------------------------------------------

_LIVE_LOCK = threading.Lock()
_LIVE: Dict[int, CancelToken] = {}


def register_query(token: CancelToken) -> None:
    with _LIVE_LOCK:
        _LIVE[id(token)] = token


def unregister_query(token: CancelToken) -> None:
    with _LIVE_LOCK:
        _LIVE.pop(id(token), None)


def live_queries() -> List[CancelToken]:
    with _LIVE_LOCK:
        return list(_LIVE.values())


# ---------------------------------------------------------------------------
# Per-signature wall history (the watchdog's p99 source) + quarantine
# ---------------------------------------------------------------------------

_HIST_LOCK = threading.Lock()
# signature -> bounded deque of observed walls; the outer dict is a
# bounded LRU so thousands of ad-hoc shapes cannot grow it without
# limit (same discipline as the plan cache itself)
_WALLS: "OrderedDict[str, deque]" = OrderedDict()
_WALLS_CAP = 256
_WALL_SAMPLES = 64

# both bounded LRU like _WALLS: thousands of distinct ad-hoc shapes
# must not grow lifecycle state without limit on a long-lived server
_FATAL_STREAK: "OrderedDict[str, int]" = OrderedDict()
_STREAK_CAP = 1024
# signature -> failures at blacklist; evicting the OLDEST quarantined
# signature at the cap un-blacklists it, which is the same operator
# contract as a restart (the blacklist is a circuit breaker, not an
# audit log)
_QUARANTINED: "OrderedDict[str, int]" = OrderedDict()
_QUARANTINE_CAP = 256


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile of an unsorted sample list (0 when
    empty). ONE copy of the small-n rank rule: the admission stats,
    the bench legs, and the watchdog's p99 all share it."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[idx]


def record_wall(signature: str, wall_s: float) -> None:
    """One successful query's wall for its signature (execute_plan
    calls this when the plan cache resolved a signature)."""
    with _HIST_LOCK:
        dq = _WALLS.get(signature)
        if dq is None:
            dq = _WALLS[signature] = deque(maxlen=_WALL_SAMPLES)
        _WALLS.move_to_end(signature)
        dq.append(wall_s)
        while len(_WALLS) > _WALLS_CAP:
            _WALLS.popitem(last=False)


def signature_p99(signature: str,
                  min_samples: int = WATCHDOG_MIN_SAMPLES
                  ) -> Optional[float]:
    """The signature's observed p99 wall, or None below
    ``min_samples`` (the watchdog must not flag a cold shape)."""
    with _HIST_LOCK:
        dq = _WALLS.get(signature)
        if dq is None or len(dq) < max(1, min_samples):
            return None
        samples = list(dq)
    return percentile(samples, 0.99)


def record_runtime_failure(signature: str, threshold: int) -> bool:
    """One runtime-fatal failure of ``signature`` (cancellations and
    timeouts never reach here); returns True when this failure CROSSED
    the quarantine threshold."""
    with _HIST_LOCK:
        n = _FATAL_STREAK.get(signature, 0) + 1
        _FATAL_STREAK[signature] = n
        _FATAL_STREAK.move_to_end(signature)
        while len(_FATAL_STREAK) > _STREAK_CAP:
            _FATAL_STREAK.popitem(last=False)
        if threshold > 0 and n >= threshold \
                and signature not in _QUARANTINED:
            _QUARANTINED[signature] = n
            _QUARANTINED.move_to_end(signature)
            while len(_QUARANTINED) > _QUARANTINE_CAP:
                _QUARANTINED.popitem(last=False)
            return True
    return False


def record_success(signature: str) -> None:
    """One success clears the signature's consecutive-failure streak
    (a quarantined signature stays quarantined — the operator lifts it
    by restarting or via reset_lifecycle)."""
    with _HIST_LOCK:
        _FATAL_STREAK.pop(signature, None)


def is_quarantined(signature: Optional[str]) -> bool:
    if signature is None:
        return False
    with _HIST_LOCK:
        return signature in _QUARANTINED


def quarantined_failures(signature: str) -> int:
    with _HIST_LOCK:
        return _QUARANTINED.get(signature, 0)


def lifecycle_stats() -> Dict:
    """Process lifecycle counters for the server stats surface."""
    with _HIST_LOCK:
        quarantined = len(_QUARANTINED)
    with _LIVE_LOCK:
        live = len(_LIVE)
    return {"liveQueries": live, "quarantinedSignatures": quarantined}


# bumped by every reset: the history warm-start keys its replay on
# (dir, generation), so one process lifetime replays a store at most
# once per reset — a second server start must not double-count
# failure streaks into the SAME live state (history.warm_start)
_GENERATION = [0]


def lifecycle_generation() -> int:
    with _HIST_LOCK:
        return _GENERATION[0]


def reset_lifecycle() -> None:
    """Test hook: drop the wall history, quarantine state, and the
    live-query registry."""
    with _HIST_LOCK:
        _WALLS.clear()
        _FATAL_STREAK.clear()
        _QUARANTINED.clear()
        _GENERATION[0] += 1
    with _LIVE_LOCK:
        _LIVE.clear()


# ---------------------------------------------------------------------------
# Stuck-query watchdog
# ---------------------------------------------------------------------------

class StuckQueryWatchdog:
    """Scans the live-query registry on an interval: a query whose
    elapsed wall exceeds ``serve.watchdogFactor`` x its signature's
    observed p99 is flagged and — when ``serve.watchdogCancel`` —
    cooperatively cancelled with reason ``watchdog``. Queries without a
    resolved signature (still planning, or plan cache off) and
    signatures with fewer than WATCHDOG_MIN_SAMPLES observed walls are
    never flagged."""

    SCAN_INTERVAL_S = 0.2

    def __init__(self, conf_obj):
        from spark_rapids_tpu_torch.conf import (SERVE_WATCHDOG_CANCEL,
                                                 SERVE_WATCHDOG_FACTOR)
        self.factor = float(conf_obj.get(SERVE_WATCHDOG_FACTOR))
        self.cancel_stuck = bool(conf_obj.get(SERVE_WATCHDOG_CANCEL))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.flagged = 0
        self.cancelled = 0

    @property
    def enabled(self) -> bool:
        return self.factor > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="torch-lifecycle-watchdog",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.SCAN_INTERVAL_S):
            try:
                self.scan()
            except Exception:
                pass  # the watchdog must never take down the server

    def scan(self) -> int:
        """One pass over the live queries; returns how many were newly
        flagged (exposed for tests — the loop just calls this)."""
        flagged = 0
        for tok in live_queries():
            if tok.watchdog_flagged or tok.signature is None:
                continue
            p99 = signature_p99(tok.signature)
            if p99 is None:
                continue
            # RUNNING time only: the p99 history records execution
            # walls, so queue wait under load must not count against
            # the comparison (a still-queued query cannot be stuck —
            # its deadline covers that)
            elapsed = tok.run_elapsed()
            if elapsed is None or \
                    elapsed <= self.factor * max(p99, 1e-6):
                continue
            tok.watchdog_flagged = True
            flagged += 1
            self.flagged += 1
            # the JAX package fires a stuckQuery slow-query bundle
            # through its telemetry trigger engine here; bundles come
            # with the observability slice (A11b)
            if self.cancel_stuck and tok.cancel(REASON_WATCHDOG):
                self.cancelled += 1
        return flagged
