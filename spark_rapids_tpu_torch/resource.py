"""RAII-style resource helpers and the device semaphore (the counterpart
of ``spark_rapids_tpu.resource``; the reference's ``Arm`` trait and
GpuSemaphore).

``with_resource`` and ``close_on_except`` tie a closable's lifetime to a
scope, as the reference's withResource / closeOnExcept do. The semaphore
bounds how many task threads touch the card at once: the row-to-columnar
upload acquires it before its first device write, the columnar-to-row
transition releases it when its partition is drained or fails. The port
runs one task thread, so the semaphore is uncontended; it is kept for
its contract, that a query that fails returns every permit. A plan run
inside a running query (a cached relation's materialisation) keeps the
thread's permit across its own transitions (``hold_across``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Optional, TypeVar

T = TypeVar("T")


def _close(r: Any) -> None:
    close = getattr(r, "close", None)
    if callable(close):
        close()


def _close_all(resource: Any) -> None:
    if isinstance(resource, (list, tuple)):
        for r in resource:
            _close(r)
    else:
        _close(resource)


@contextlib.contextmanager
def with_resource(resource: T) -> Iterator[T]:
    """Close ``resource`` (or each element of a list or tuple of
    closables) on exit."""
    try:
        yield resource
    finally:
        _close_all(resource)


@contextlib.contextmanager
def close_on_except(resource: T) -> Iterator[T]:
    """Close ``resource`` only if the body raises (Arm.closeOnExcept)."""
    try:
        yield resource
    except BaseException:
        _close_all(resource)
        raise


class TorchSemaphore:
    """Permits for task threads that touch the card. Reentrant per
    thread: repeated acquires on one thread do not nest, so one release
    frees the thread's permit however many uploads it made. The wait is
    recorded as ``semaphoreWaitTime`` on the caller's registry."""

    def __init__(self, permits: int):
        self.permits = max(1, permits)
        self._in_use = 0
        self._cv = threading.Condition()
        self._held = threading.local()

    def acquire_if_necessary(self, metrics=None) -> None:
        if getattr(self._held, "count", 0) > 0:
            return
        t0 = time.perf_counter_ns()
        with self._cv:
            while self._in_use >= self.permits:
                self._cv.wait()
            self._in_use += 1
        if metrics is not None:
            from spark_rapids_tpu_torch import metrics as M
            metrics.create(M.SEMAPHORE_WAIT_TIME).add(
                time.perf_counter_ns() - t0)
        self._held.count = 1

    def release_if_necessary(self) -> None:
        """Release the calling thread's permit, if it holds one and no
        ``hold_across`` keeps it."""
        if getattr(self._held, "pinned", 0) > 0:
            return
        if getattr(self._held, "count", 0) > 0:
            self._held.count = 0
            with self._cv:
                self._in_use -= 1
                self._cv.notify()

    @contextlib.contextmanager
    def hold_across(self) -> Iterator[None]:
        """Keep the calling thread's permit, if it holds one, across a
        nested plan's run: that plan's columnar-to-row transition would
        otherwise release the permit of the query the thread is running.
        A thread without a permit gets the nested plan's own acquire and
        release."""
        if getattr(self._held, "count", 0) == 0:
            yield
            return
        self._held.pinned = getattr(self._held, "pinned", 0) + 1
        try:
            yield
        finally:
            self._held.pinned -= 1

    def held_by_caller(self) -> bool:
        """Whether the calling thread holds a permit."""
        return getattr(self._held, "count", 0) > 0

    def resize(self, permits: int) -> None:
        """Change the permit count in place; holders keep their permits
        and new acquires wait under the new bound."""
        with self._cv:
            self.permits = max(1, int(permits))
            self._cv.notify_all()

    @property
    def in_use(self) -> int:
        with self._cv:
            return self._in_use


_SEMAPHORE: Optional[TorchSemaphore] = None
_SEMAPHORE_LOCK = threading.Lock()


def get_semaphore(conf) -> TorchSemaphore:
    """The process's semaphore, sized by
    ``spark.rapids.sql.concurrentGpuTasks`` (a conf with another count
    resizes it in place, keeping held permits)."""
    global _SEMAPHORE
    from spark_rapids_tpu_torch.conf import CONCURRENT_GPU_TASKS
    want = max(1, int(conf.get(CONCURRENT_GPU_TASKS)))
    with _SEMAPHORE_LOCK:
        if _SEMAPHORE is None:
            _SEMAPHORE = TorchSemaphore(want)
        elif _SEMAPHORE.permits != want:
            _SEMAPHORE.resize(want)
        return _SEMAPHORE
