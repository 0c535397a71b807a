"""The flight recorder: a fixed-size lock-free ring buffer behind the
existing Tracer (``spark.rapids.sql.trace.mode=ring``).

The recorder is a drop-in span sink for the trace hooks: it exposes
exactly the ``QueryTrace`` recording surface (``add``/``mark``/
``count``/``_thread``), so every instrumented choke point — metric
timer mirrors, dispatch spans, store transitions, retry markers, JIT
compiles — records into it with the SAME one-``None``-check hot path.
Storage differs: instead of unbounded per-query lists, each thread owns
a ``collections.deque(maxlen=N)`` (append is atomic under the GIL and
O(1) with eviction built in), so memory is bounded at roughly
``threads x ringSpans`` records no matter how long the process serves.

``dump_ring`` snapshots the rings and writes the standard Chrome-trace
JSON (``trace-ring-<pid>-<seq>.json``), so Perfetto and ``load_trace``
read dumps as they read per-query traces — that is what a slow-query
bundle embeds (triggers.py).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from spark_rapids_tpu_torch.trace import (QueryTrace, _clean,
                                          write_chrome_trace)


class RingTrace(QueryTrace):
    """Process-lifetime span sink with per-thread bounded rings.

    Unlike a ``QueryTrace`` (one query, cleared at end), a ``RingTrace``
    is installed once and shared by every query; ``trace.end_query``
    leaves only a ``queryEnd`` marker. The hot path takes no lock:
    per-thread rings are created with ``dict.setdefault`` (atomic) and
    appended with ``deque.append`` (atomic, evicts the oldest record
    when full)."""

    __slots__ = ("capacity", "_span_rings", "_instant_rings",
                 "_counter_ring", "queries_begun", "dropped_snapshots",
                 "_dump_lock", "_dump_seq")

    is_ring = True

    def __init__(self, capacity: int, tenant: Optional[str] = None):
        super().__init__(0, tenant=tenant)
        self.capacity = max(16, int(capacity))
        self._span_rings: Dict[int, deque] = {}
        self._instant_rings: Dict[int, deque] = {}
        self._counter_ring: deque = deque(maxlen=self.capacity)
        self.queries_begun = 0
        self.dropped_snapshots = 0
        self._dump_lock = threading.Lock()
        self._dump_seq = 0

    # -- recording (the QueryTrace surface, lock-free) ---------------------

    def _ring(self, rings: Dict[int, deque], ident: int) -> deque:
        r = rings.get(ident)
        if r is None:
            r = rings.setdefault(ident, deque(maxlen=self.capacity))
        return r

    def add(self, kind: str, t0: int, t1: int, batch=None, chip=None,
            **attrs) -> None:
        ident = self._thread()
        self._ring(self._span_rings, ident).append(
            (kind, t0, t1, ident, batch, chip, _clean(attrs)))

    def mark(self, kind: str, **attrs) -> None:
        ident = self._thread()
        self._ring(self._instant_rings, ident).append(
            (kind, time.perf_counter_ns(), ident, _clean(attrs)))

    def count(self, series: str, value) -> None:
        self._counter_ring.append((series, time.perf_counter_ns(),
                                   value))

    # -- snapshot + dump ---------------------------------------------------

    def _copy_live(self, container) -> list:
        # writers mutate concurrently: deque appends (and dict inserts
        # from a thread's FIRST record) never invalidate existing
        # elements but CAN raise "mutated during iteration" — retry a
        # few times, then accept a tiny loss rather than lose the
        # whole dump (the busy-server moment is exactly when a dump
        # matters)
        for _ in range(8):
            try:
                return list(container)
            except RuntimeError:
                continue
        self.dropped_snapshots += 1
        return []

    def snapshot(self) -> QueryTrace:
        """A plain ``QueryTrace`` holding a point-in-time copy of every
        ring (writers keep recording concurrently), ready for
        ``write_chrome_trace``."""
        qt = QueryTrace.__new__(QueryTrace)
        qt.query_id = self.queries_begun
        qt.tenant = self.tenant
        qt.t0 = self.t0
        qt.wall_t0 = self.wall_t0
        qt.spans = [s for ident in sorted(self._copy_live(
                        self._span_rings))
                    for s in self._copy_live(
                        self._span_rings.get(ident, ()))]
        qt.instants = [i for ident in sorted(self._copy_live(
                           self._instant_rings))
                       for i in self._copy_live(
                           self._instant_rings.get(ident, ()))]
        qt.counters = self._copy_live(self._counter_ring)
        qt._thread_names = dict(
            (k, self._thread_names.get(k, str(k)))
            for k in self._copy_live(self._thread_names))
        return qt

    def dump(self, out_dir: str) -> str:
        """Write the current ring contents as one Chrome-trace file
        (``trace-ring-<pid>-<seq>.json``) under ``out_dir`` and return
        its path (the `trace-` prefix of a per-query trace file)."""
        snap = self.snapshot()
        with self._dump_lock:
            self._dump_seq += 1
            seq = self._dump_seq
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"trace-ring-{os.getpid()}-{seq:05d}.json")
        write_chrome_trace(path, snap)
        return path


def dump_ring(out_dir: str) -> Optional[str]:
    """Dump the installed flight recorder (None when ring mode is not
    active) — the trigger engine's and the CLI's entry point."""
    from spark_rapids_tpu_torch import trace as _trace
    qt = _trace.ring_active()
    if qt is None:
        return None
    try:
        return qt.dump(out_dir)
    except Exception:
        return None  # observability must not take down execution
