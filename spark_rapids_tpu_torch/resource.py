"""RAII-style resource helpers and the device semaphore (the counterpart
of ``spark_rapids_tpu.resource``; the reference's ``Arm`` trait and
GpuSemaphore).

``with_resource`` and ``close_on_except`` tie a closable's lifetime to a
scope, as the reference's withResource / closeOnExcept do. The semaphore
bounds how many task threads touch the card at once: the row-to-columnar
upload acquires it before its first device write, the columnar-to-row
transition releases it when its partition is drained or fails, and so
does a task when it ends. The query server runs several queries at
once, each on its connection thread, so the permits are contended
there; the wait is a lifecycle checkpoint (a cancelled or timed-out
query stops waiting and raises, holding nothing), and a query that
fails or is cancelled returns every permit. A
plan run inside a running query (a cached relation's materialisation)
keeps the task's permit across its own transitions (``hold_across``),
and a host operator between two transitions, whose transitions release
and take the permit again mid-partition, takes the task's own permit,
on whichever thread drains it (``adopt``).
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


class _TaskPermit:
    """One task's hold on the semaphore: whether it holds a permit, and
    how many ``hold_across`` scopes keep it."""

    __slots__ = ("count", "pinned")

    def __init__(self):
        self.count = 0
        self.pinned = 0


class TorchSemaphore:
    """Permits for tasks that touch the card. A permit belongs to a task,
    not to a thread: each thread is its own task unless it adopts
    another's (``adopt``), as the upload ring's producer thread adopts
    the task thread that runs the partition. So a host operator between
    two transitions, drained on the producer thread, releases and takes
    again the task's own permit and never waits on it. Reentrant per
    task: repeated acquires do not nest, so one release frees the task's
    permit however many uploads it made. The wait is recorded as
    ``semaphoreWaitTime`` on the caller's registry."""

    def __init__(self, permits: int):
        self.permits = max(1, permits)
        self._in_use = 0
        self._cv = threading.Condition()
        self._held = threading.local()

    def current_task(self) -> _TaskPermit:
        """The calling thread's task (its own unless it adopted one)."""
        task = getattr(self._held, "task", None)
        if task is None:
            task = self._held.task = _TaskPermit()
        return task

    @contextlib.contextmanager
    def adopt(self, task: _TaskPermit) -> Iterator[None]:
        """Run the calling thread as part of ``task``: its acquires and
        releases are the task's."""
        prev = getattr(self._held, "task", None)
        self._held.task = task
        try:
            yield
        finally:
            self._held.task = prev

    def acquire_if_necessary(self, metrics=None) -> None:
        task = self.current_task()
        if task.count > 0:
            return
        t0 = time.perf_counter_ns()
        with self._cv:
            while task.count == 0 and self._in_use >= self.permits:
                # bounded wait + lifecycle checkpoint: a cancelled query
                # must not park here; raising leaves the count untouched
                self._cv.wait(timeout=0.05)
                if task.count == 0 and self._in_use >= self.permits:
                    from spark_rapids_tpu_torch.lifecycle import checkpoint
                    checkpoint("semaphore")
            if task.count == 0:
                self._in_use += 1
                task.count = 1
        if metrics is not None:
            from spark_rapids_tpu_torch import metrics as M
            metrics.create(M.SEMAPHORE_WAIT_TIME).add(
                time.perf_counter_ns() - t0)

    def release_if_necessary(self) -> None:
        """Release the calling task's permit, if it holds one and no
        ``hold_across`` keeps it."""
        task = self.current_task()
        with self._cv:
            if task.pinned > 0 or task.count == 0:
                return
            task.count = 0
            self._in_use -= 1
            self._cv.notify_all()

    @contextlib.contextmanager
    def hold_across(self) -> Iterator[None]:
        """Keep the calling task's permit, if it holds one, across a
        nested plan's run: that plan's columnar-to-row transition would
        otherwise release the permit of the query the task is running.
        A task without a permit gets the nested plan's own acquire and
        release."""
        task = self.current_task()
        if task.count == 0:
            yield
            return
        task.pinned += 1
        try:
            yield
        finally:
            task.pinned -= 1

    def held_by_caller(self) -> bool:
        """Whether the calling task holds a permit."""
        return self.current_task().count > 0

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


def release_current_thread() -> None:
    """Release the calling task's permit if the semaphore exists (before
    a thread blocks on a task pool or a lock, and when a task ends)."""
    if _SEMAPHORE is not None:
        _SEMAPHORE.release_if_necessary()
