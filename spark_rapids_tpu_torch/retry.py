"""OOM retry and split-and-retry protocol, reader IO retry, and the
deterministic fault injector (the counterpart of
``spark_rapids_tpu.retry``; the reference's RmmRapidsRetryIterator and
DeviceMemoryEventHandler).

- ``with_retry(fn, conf, metrics)`` runs one device operation under the
  retry protocol: on an out-of-memory error it recovers (``_recover``:
  releases least-recently-used stage graphs, spills the device store
  down, backs off) and re-attempts up to
  ``spark.rapids.sql.retry.maxRetries`` times, then raises.
- ``with_split_retry(batch, fn, conf, metrics)``: when the retries run
  out, or the failure asks for a split, the input batch splits in half
  by rows and each half runs on its own; the results come back in row
  order, so their concatenation is the unsplit result.
- ``io_with_retry(fn, conf, metrics)``: bounded backoff for transient
  reader IO errors, raising the original error after
  ``spark.rapids.sql.reader.maxRetries``.

What counts as an out-of-memory error (``is_oom_error``) is narrower
than the JAX package's text heuristic: ``torch.OutOfMemoryError`` (the
caching allocator's, raised after it has freed its cached blocks and
tried once more), a kernel launch that returned
``cudaErrorMemoryAllocation``, and the injected exceptions. Any other
error, a sticky CUDA error above all (an illegal address, a launch
failure leaves the context unusable), propagates: retrying it would hide
a fault. A retry re-runs the same code, so a kernel is never swapped for
its plain version.

The injector (``spark.rapids.sql.test.injectOOM`` / ``injectIOError``)
throws synthetic faults at the Nth wrapped allocation or reader access,
with the JAX package's grammar. The wrap sites differ between the two
packages, so one schedule can hit different operations in each; only
the rows are comparable across them. ``site:cancel:N`` is the lifecycle
leg: it counts the query lifecycle's cancellation checkpoints
(``lifecycle.checkpoint``) and cancels the live query's token at the Nth
one (``on_cancel_point``). Every backoff sleep is a cancellable sleep,
so a cancelled query never sleeps through its deadline, and a
cancellation is never retried. Not ported: mesh chip-failure degrade
(ROADMAP A12), trace spans and telemetry hooks (A11b).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, List, Optional, TypeVar

import torch

from spark_rapids_tpu_torch import metrics as M

T = TypeVar("T")


class TorchRetryOOM(MemoryError):
    """Retryable device allocation failure: recover (release stage
    graphs, spill the store) and re-attempt."""


class TorchSplitAndRetryOOM(TorchRetryOOM):
    """Retrying at the same size will not help: split the input batch in
    half by rows and process the halves on their own."""


def is_oom_error(e: BaseException) -> bool:
    """True for the errors the protocol retries: the injected
    exceptions, the caching allocator's ``torch.OutOfMemoryError``, and
    a kernel launch that returned ``cudaErrorMemoryAllocation``."""
    if isinstance(e, (TorchRetryOOM, torch.OutOfMemoryError)):
        return True
    from spark_rapids_tpu_torch.kernels import (CUDA_ERROR_MEMORY_ALLOCATION,
                                                KernelError)
    return isinstance(e, KernelError) and \
        e.code == CUDA_ERROR_MEMORY_ALLOCATION


# ---------------------------------------------------------------------------
# Injection suppression: the recovery path's own spill, split and fallback
# work never takes another injected fault
# ---------------------------------------------------------------------------

_tls = threading.local()


def _suppressed() -> bool:
    return getattr(_tls, "suppress", 0) > 0


@contextlib.contextmanager
def suppress_injection():
    _tls.suppress = getattr(_tls, "suppress", 0) + 1
    try:
        yield
    finally:
        _tls.suppress -= 1


# ---------------------------------------------------------------------------
# Deterministic fault injector
# ---------------------------------------------------------------------------

class _Schedule:
    """A parsed injection spec:

    - ``"N"``        fire once at every Nth event
    - ``"N:K"``      at every Nth event, fail K consecutive attempts
                     (K > retry.maxRetries forces split-and-retry)
    - ``"split:N"``  throw TorchSplitAndRetryOOM at every Nth event
    - ``"seed:S:P"`` seeded random: each event fails with probability P
    - ``"site:NAME:SPEC"`` any of the above, counting only events tagged
      with site NAME (``site:upload`` = the upload's copy to the card,
      issued ahead by the ring or by the synchronous protocol);
      ``site:budget:SPEC`` counts budget-oracle queries and makes the
      firing query report half the real headroom, never an error;
      ``site:cancel:SPEC`` counts lifecycle cancellation checkpoints and
      cancels the live query's token (reason ``injected``) when it fires
    """

    __slots__ = ("every_n", "streak", "split", "seed", "prob", "rng",
                 "site")

    def __init__(self, every_n=0, streak=1, split=False, seed=0,
                 prob=0.0, site=""):
        self.every_n = every_n
        self.streak = max(1, streak)
        self.split = split
        self.seed = seed
        self.prob = prob
        self.site = site
        # each schedule follows its own seeded stream
        self.rng = random.Random(seed) if prob > 0.0 else None


def _parse_schedule(spec: str) -> Optional[_Schedule]:
    s = str(spec or "").strip().lower()
    if not s or s in ("0", "false", "off", "none"):
        return None
    if s.startswith("site:"):
        _, name, rest = s.split(":", 2)
        sched = _parse_schedule(rest)
        if sched is not None:
            sched.site = name
        return sched
    if s.startswith("split:"):
        return _Schedule(every_n=int(s[len("split:"):]), split=True)
    if s.startswith("seed:"):
        _, seed, prob = s.split(":")
        return _Schedule(seed=int(seed), prob=float(prob))
    if ":" in s:
        n, k = s.split(":")
        return _Schedule(every_n=int(n), streak=int(k))
    return _Schedule(every_n=int(s))


class FaultInjector:
    """Deterministic synthetic-fault source, one per distinct injection
    conf and process: a schedule is a property of the process's
    timeline, like the reference's RMM inject-OOM hook."""

    def __init__(self, oom_spec: str = "", io_spec: str = ""):
        self._oom = _parse_schedule(oom_spec)
        # site:budget is the planning leg: it counts budget-oracle
        # queries, and its fault is a halved headroom report
        self._budget = None
        if self._oom is not None and self._oom.site == "budget":
            self._budget, self._oom = self._oom, None
        # site:cancel is the lifecycle leg: it counts cancellation
        # checkpoints, and its fault is a cooperative cancel
        self._cancel = None
        if self._oom is not None and self._oom.site == "cancel":
            self._cancel, self._oom = self._oom, None
        self._io = _parse_schedule(io_spec)
        self._lock = threading.Lock()
        self._alloc_count = 0
        self._oom_streak = 0
        self._io_count = 0
        self._io_streak = 0
        self._budget_count = 0
        self._cancel_count = 0
        self.cancels_injected = 0
        self.oom_injected = 0
        self.io_injected = 0
        self.budget_faults_injected = 0

    @staticmethod
    def _fire(sched: _Schedule, count: int) -> bool:
        if sched.prob > 0.0:
            return sched.rng.random() < sched.prob
        return sched.every_n > 0 and count % sched.every_n == 0

    def on_alloc(self, site: str = "") -> None:
        """Checkpoint at one wrapped device allocation attempt; ``site``
        tags a named allocation class for ``site:NAME:...``."""
        if self._oom is None or _suppressed():
            return
        if self._oom.site and self._oom.site != site:
            return
        with self._lock:
            if self._oom_streak > 0:
                self._oom_streak -= 1
                self.oom_injected += 1
                raise TorchRetryOOM("injected OOM (consecutive-failure "
                                    "streak, spark.rapids.sql.test."
                                    "injectOOM)")
            self._alloc_count += 1
            if not self._fire(self._oom, self._alloc_count):
                return
            self.oom_injected += 1
            if self._oom.split:
                raise TorchSplitAndRetryOOM(
                    f"injected split-OOM at allocation {self._alloc_count} "
                    "(spark.rapids.sql.test.injectOOM)")
            self._oom_streak = self._oom.streak - 1
            raise TorchRetryOOM(
                f"injected OOM at allocation {self._alloc_count} "
                "(spark.rapids.sql.test.injectOOM)")

    def on_io(self, path: str = "") -> None:
        """Checkpoint at one reader IO attempt."""
        if self._io is None or _suppressed():
            return
        with self._lock:
            if self._io_streak > 0:
                self._io_streak -= 1
                self.io_injected += 1
                raise IOError(f"injected IO error reading {path!r} "
                              "(spark.rapids.sql.test.injectIOError)")
            self._io_count += 1
            if not self._fire(self._io, self._io_count):
                return
            self.io_injected += 1
            self._io_streak = self._io.streak - 1
            raise IOError(f"injected IO error reading {path!r} "
                          "(spark.rapids.sql.test.injectIOError)")

    def on_cancel_point(self, token, site: str = "") -> None:
        """Checkpoint at one lifecycle cancellation checkpoint
        (``lifecycle.checkpoint``): a ``site:cancel:N`` schedule cancels
        the live query's token at the Nth one, so the query unwinds
        through the cooperative-cancel protocol, not the retry protocol.
        Recovery paths are exempt like every other injection site."""
        if self._cancel is None or token is None or _suppressed():
            return
        with self._lock:
            self._cancel_count += 1
            if not self._fire(self._cancel, self._cancel_count):
                return
            self.cancels_injected += 1
        from spark_rapids_tpu_torch.lifecycle import REASON_INJECTED
        token.cancel(REASON_INJECTED)

    def on_budget_query(self) -> bool:
        """Checkpoint at one budget-oracle headroom query: True when a
        ``site:budget`` schedule fires (the oracle then reports half the
        real headroom)."""
        if self._budget is None or _suppressed():
            return False
        with self._lock:
            self._budget_count += 1
            if not self._fire(self._budget, self._budget_count):
                return False
            self.budget_faults_injected += 1
            return True

    def stats(self) -> dict:
        with self._lock:
            return {"allocations": self._alloc_count,
                    "oomInjected": self.oom_injected,
                    "ioInjected": self.io_injected,
                    "budgetFaultsInjected": self.budget_faults_injected,
                    "cancelsInjected": self.cancels_injected}


_INJECTOR: Optional[FaultInjector] = None
_INJECTOR_KEY: Optional[tuple] = None
_INJECTOR_LOCK = threading.Lock()


def get_fault_injector(conf) -> Optional[FaultInjector]:
    """The process's injector for the conf's injection keys; None (no
    cost) when injection is off. A conf with other keys gets a fresh
    injector with fresh counters."""
    if conf is None:
        return None
    from spark_rapids_tpu_torch.conf import INJECT_IO_ERROR, INJECT_OOM
    key = (str(conf.get(INJECT_OOM) or ""),
           str(conf.get(INJECT_IO_ERROR) or ""))
    if key == ("", ""):
        return None
    global _INJECTOR, _INJECTOR_KEY
    with _INJECTOR_LOCK:
        if _INJECTOR is None or _INJECTOR_KEY != key:
            _INJECTOR = FaultInjector(*key)
            _INJECTOR_KEY = key
        return _INJECTOR


def reset_fault_injection() -> None:
    """Drop the injector, so the next query sees a fresh schedule."""
    global _INJECTOR, _INJECTOR_KEY
    with _INJECTOR_LOCK:
        _INJECTOR = None
        _INJECTOR_KEY = None


# ---------------------------------------------------------------------------
# Retry combinators
# ---------------------------------------------------------------------------

def _retry_limits(conf) -> tuple:
    if conf is None:
        return 3, 1, 100
    from spark_rapids_tpu_torch.conf import (RETRY_BACKOFF_MS,
                                             RETRY_MAX_BACKOFF_MS,
                                             RETRY_MAX_RETRIES)
    return (int(conf.get(RETRY_MAX_RETRIES)),
            int(conf.get(RETRY_BACKOFF_MS)),
            int(conf.get(RETRY_MAX_BACKOFF_MS)))


def _recover(conf, metrics, attempt: int, backoff_ms: int,
             max_backoff_ms: int) -> None:
    """One recovery step. The port's cached stage graphs each pin a
    private memory pool (XLA executables hold no buffers, so the JAX
    package only spills its store): the first attempt releases the
    least recently used half of them (a lone program stays), later
    attempts all. Then the
    device store spills down (half its device bytes on the first
    attempt, all of them later), then a bounded exponential backoff.
    The bytes freed count in ``spillBytesOnRetry``. Outside a capture
    the caching allocator frees its cached blocks before it raises; while
    a stage graph is being captured it cannot (PyTorch skips that during
    a capture), so an OOM raised inside a capture may leave free cached
    blocks reserved: they are returned here, after the capture ended."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.exec.fused import release_stage_programs
    t0 = time.perf_counter_ns()
    with suppress_injection():
        freed = release_stage_programs(everything=attempt > 1)
        store = (memory.get_device_store(conf) if conf is not None
                 else memory._STORE)
        if store is not None:
            target = store.device_bytes // 2 if attempt == 1 else 0
            freed += store.spill_device_down(target)
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
        delay = min(backoff_ms * (1 << (attempt - 1)), max_backoff_ms)
        if delay > 0:
            # a cancelled or timed-out query must not sleep through its
            # deadline
            from spark_rapids_tpu_torch.lifecycle import cancellable_sleep
            cancellable_sleep(delay / 1000.0, site="retryBackoff")
    if metrics is not None:
        metrics.create(M.RETRY_COUNT).add(1)
        if freed:
            metrics.create(M.SPILL_BYTES_ON_RETRY).add(freed)
        metrics.create(M.RETRY_BLOCK_TIME).add(time.perf_counter_ns() - t0)


def with_retry(fn: Callable[[], T], conf=None, metrics=None, *,
               splittable: bool = False, site: str = "") -> T:
    """Run ``fn`` under the OOM-retry protocol (withRetryNoSplit). On an
    out-of-memory error (``is_oom_error``) recover and re-attempt, up to
    ``spark.rapids.sql.retry.maxRetries`` times; after them a real OOM is
    raised as ``TorchRetryOOM`` from it. ``fn`` must be safe to run
    again. ``splittable=True`` (``with_split_retry``) passes a
    ``TorchSplitAndRetryOOM`` to the caller instead of retrying it."""
    inj = get_fault_injector(conf)
    max_retries, backoff_ms, max_backoff_ms = _retry_limits(conf)
    attempt = 0
    while True:
        try:
            if inj is not None:
                inj.on_alloc(site)
            return fn()
        except TorchSplitAndRetryOOM:
            if splittable:
                raise
            attempt += 1
            if attempt > max_retries:
                raise
        except TorchRetryOOM:
            attempt += 1
            if attempt > max_retries:
                raise
        except Exception as e:
            # a cooperative cancel is not an OOM: it unwinds, never
            # retried (is_oom_error refuses it)
            if not is_oom_error(e):
                raise
            attempt += 1
            if attempt > max_retries:
                raise TorchRetryOOM(f"device OOM after {max_retries} "
                                    f"retries: {e}") from e
        _recover(conf, metrics, attempt, backoff_ms, max_backoff_ms)


def with_split_retry(batch, fn: Callable[[Any], T], conf=None,
                     metrics=None, *, split=None,
                     split_first: bool = False) -> List[T]:
    """Split-and-retry (RmmRapidsRetryIterator.withRetry with
    splitSpillableInHalfByRows): run ``fn`` on ``batch``; when its retry
    protocol runs out, or the failure asks for a split, the piece splits
    in half by rows and the halves run on their own, recursively.
    Returns the per-piece results in row order. A piece that cannot
    split (one row) takes the plain retry protocol, which raises after
    its retries."""
    if split is None:
        split = split_device_batch
    stack = [batch]
    out: List[T] = []
    first = True
    while stack:
        b = stack.pop()
        if first and split_first:
            first = False
            halves = _split_piece(b, split, metrics)
            if halves is None:
                stack.append(b)  # cannot split: one plain attempt
            else:
                stack.extend(reversed(halves))
            continue
        first = False
        try:
            out.append(with_retry(lambda: fn(b), conf, metrics,
                                  splittable=True))
        except TorchRetryOOM:
            halves = _split_piece(b, split, metrics)
            if halves is None:
                out.append(with_retry(lambda: fn(b), conf, metrics))
                continue
            stack.extend(reversed(halves))
    return out


def _split_piece(b, split, metrics) -> Optional[list]:
    with suppress_injection():
        halves = split(b)
    if not halves or len(halves) < 2:
        return None
    if metrics is not None:
        metrics.create(M.SPLIT_RETRY_COUNT).add(1)
    return halves


def io_with_retry(fn: Callable[[], T], conf=None, metrics=None,
                  path: str = "") -> T:
    """Bounded exponential backoff for transient reader IO errors
    (``OSError``); the first error is raised after
    ``spark.rapids.sql.reader.maxRetries`` retries."""
    inj = get_fault_injector(conf)
    if conf is not None:
        from spark_rapids_tpu_torch.conf import (READER_MAX_RETRIES,
                                                 READER_RETRY_BACKOFF_MS)
        max_retries = int(conf.get(READER_MAX_RETRIES))
        backoff_ms = int(conf.get(READER_RETRY_BACKOFF_MS))
    else:
        max_retries, backoff_ms = 3, 1
    attempt = 0
    first_err: Optional[OSError] = None
    while True:
        try:
            if inj is not None:
                inj.on_io(path)
            return fn()
        except OSError as e:
            if first_err is None:
                first_err = e
            attempt += 1
            if attempt > max_retries:
                raise first_err
            if metrics is not None:
                metrics.create(M.IO_RETRY_COUNT).add(1)
            t0 = time.perf_counter_ns()
            from spark_rapids_tpu_torch.lifecycle import cancellable_sleep
            cancellable_sleep(
                min(backoff_ms * (1 << (attempt - 1)), 1000) / 1000.0,
                site="retryBackoff")
            if metrics is not None:
                metrics.create(M.RETRY_BLOCK_TIME).add(
                    time.perf_counter_ns() - t0)


# ---------------------------------------------------------------------------
# Split policies
# ---------------------------------------------------------------------------

def split_host_batch(hb) -> Optional[list]:
    """HostBatch -> two halves by rows (the upload's split policy)."""
    n = hb.num_rows
    if n <= 1:
        return None
    return [hb.slice(0, n // 2), hb.slice(n // 2, n)]


def half_pids(active: torch.Tensor) -> torch.Tensor:
    """Partition id 0 for the first half of the active rows (by rank),
    1 for the rest."""
    a = active.to(torch.int64)
    rank = torch.cumsum(a, 0) - 1
    return torch.where(rank * 2 < a.sum(), 0, 1).to(torch.int32)


def split_device_batch(b) -> Optional[list]:
    """DeviceBatch -> halves with about equal active rows, order kept
    (splitSpillableInHalfByRows), through the exchange's
    ``split_by_pid``: each half lands at its own smaller capacity bucket,
    so the memory really shrinks. Reads the row count on the host: this
    runs only on the recovery path."""
    n = b.row_count()
    if n <= 1:
        return None
    from spark_rapids_tpu_torch.exec.exchange import split_by_pid
    parts = split_by_pid(b, half_pids(b.active), 2)
    return [p for p in parts if p is not None]
