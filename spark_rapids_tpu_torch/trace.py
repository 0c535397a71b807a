"""Pipeline-wide span tracer with Chrome-trace export (the counterpart
of ``spark_rapids_tpu.trace``; Dapper-style).

The port's hot path is concurrent: the upload ring's producer thread,
the MULTITHREADED reader pool, the server's connection threads, and
stage programs replayed as CUDA graphs; wall-clock counters alone cannot
attribute its time. This module records a low-overhead, thread-safe
span stream

    (query_id, batch_id, chip, thread, kind, t0, t1, attrs)

recorded at the engine's existing choke points and exported as
Chrome-trace-event JSON — one file per query under
``spark.rapids.sql.trace.dir`` — that loads directly in Perfetto /
chrome://tracing. The file format is the JAX package's: a file either
package writes loads in the other's ``load_trace``.

Spans time the host: a ``kernelDispatch`` span is the enqueue of one
kernel launch, and a ``TorchFusedStageExec.dispatch`` span the enqueue
of one stage program (a CUDA graph replay on the card), not the
kernel's run on the card, just as the JAX package's spans time XLA's
asynchronous dispatch. A replayed graph's kernels do not pass through
their wrappers: the replay span carries them in its ``kernels`` attr.

Integration contract (docs/observability.md):

- ``MetricRegistry.timed``/``timed_wall`` mirror every metric timer
  into a span with the SAME interval, so the event log, the profiler,
  and the trace agree on one set of numbers by construction.
- Sites without a metric timer (fused/agg dispatch, semaphore waits,
  spills, stage captures and kernel builds) measure ONCE and feed both
  channels.
- Retry/backoff/split/chip-failure events are instant markers; the
  retry recovery block (spill + backoff) is a nested ``retryBlock``
  span so the offline analyzer's *exclusive* self-time report undoes
  the documented retryBlockTime-inside-opTime double count.

Overhead discipline: when no trace is active (``trace.enabled`` off,
or the query was not sampled per ``trace.sampleRate``) every hook is a
single module-global ``None`` check; span recording itself is a tuple
append under the GIL (no lock on the hot path), safe from any thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from spark_rapids_tpu_torch.conf import (TRACE_DIR, TRACE_ENABLED,  # noqa: F401
                                         TRACE_MODE, TRACE_RING_SPANS,
                                         TRACE_SAMPLE_RATE,
                                         TRACE_SAMPLE_SEED)


# ---------------------------------------------------------------------------
# Span catalog (tests/test_torch_rules.py checks every literal span and
# instant kind recorded in the port against these tables, so a dump's
# vocabulary cannot drift from them). Metric-mirror spans are the
# dynamic family `<Exec>.<metric>`: every member resolves through
# metrics.describe_metric instead.
# ---------------------------------------------------------------------------

SPAN_CATALOG: Dict[str, str] = {
    "scanPrefetch": "scan producer thread reading+packing one staged "
                    "batch (mirrors scanPrefetchTime)",
    "uploadAhead": "async upload of a staged batch issued ahead of "
                   "the consuming stage (docs/scan.md)",
    "finishUpload": "host->device upload completion per staging mode "
                    "and chip",
    "TorchFusedStageExec.dispatch": "one fused-stage program dispatch: "
                                    "a CUDA graph replay on the card "
                                    "(chip, compile flag, kernels= the "
                                    "replayed kernels)",
    "TorchHashAggregateExec.dispatch": "one aggregation program dispatch "
                                       "(mode, kernel= attr, kernels= "
                                       "the replayed kernels)",
    "kernelDispatch": "one hand-written CUDA kernel launch (kernel= "
                      "names it; the host enqueue, docs/kernels.md)",
    "exchangeMaterialize": "exchange input drain + partition "
                           "materialization",
    "compile": "a build on a cache miss: a stage program's warm-up and "
               "CUDA graph capture (cache=stage) or the kernels' nvcc "
               "build (cache=nvcc)",
    "semaphoreWait": "wall blocked on the device semaphore",
    "serveQueueWait": "admission-queue wait of a served query "
                      "(docs/serving.md)",
    "spillToHost": "device->host store demotion",
    "spillToDisk": "host->disk store demotion",
    "promoteFromDisk": "disk->host store promotion",
    "promoteToDevice": "host->device store promotion",
    "retryBlock": "spill+backoff recovery inside an OOM retry (the "
                  "retryBlockTime interval)",
    "aqeReplan": "an adaptive runtime replan over measured exchange "
                 "stats (action= broadcastDemotion/skewSplit; "
                 "docs/adaptive.md)",
    "resultCacheHit": "a query served verbatim from the result cache "
                      "— zero device work, zero queue wait, zero "
                      "admission slot (docs/caching.md)",
    "autotuneSweep": "one kernel autotune sweep at a new (kernel, "
                     "bucket, card) key: every candidate validated, then "
                     "timed (kernel=/bucket=/candidates=/applied=; "
                     "kernels/autotune.py)",
    "meshStack": "per-chip slots padded to the common capacity bucket "
                 "on their chips before the mesh exchange",
    "meshSizeExchange": "the mesh exchange's [n, n] per-(source, "
                        "destination) row-count read",
    "meshExchange": "the mesh all-to-all: each chip's send blocks moved "
                    "to their destination chips",
    "externalShuffle": "one exchange's partitions written as SRTB files "
                       "and read back (spark.rapids.shuffle.mode="
                       "external)",
    "cacheEntryDrop": "the device pool dropped a cache-tier entry "
                      "under pressure instead of spilling a live "
                      "query's batch (docs/caching.md)",
}

INSTANT_CATALOG: Dict[str, str] = {
    "autotuneTableUnwritable": "the autotuner could not append to its "
                               "table under kernel.autotune.dir: this "
                               "process keeps its winners in memory",
    "retryOOM": "an OOM retry re-attempted the operation",
    "splitRetry": "an input batch split in half after OOM exhaustion",
    "chipFailure": "a mesh chip was demoted after persistent failure",
    "ioRetry": "a transient reader IO error was retried",
    "compileCacheContention": "a thread blocked on another thread's "
                              "in-progress compile of the same key",
    "queryEnd": "a query finished while the ring recorder was active "
                "(wallSeconds/rows/error attrs)",
    "telemetryTrigger": "a telemetry trigger fired (trigger= names it; "
                        "docs/observability.md 'Live telemetry')",
    "queryCancelled": "a query's CancelToken was cancelled (reason= "
                      "cancel/deadline/disconnect/watchdog/shutdown/"
                      "injected; docs/serving.md 'Query lifecycle')",
    "oocJoinPlan": "the budget oracle partitioned a hash join into "
                   "spill-backed buckets (modulus=/depth=; depth > 0 "
                   "is a recursive escalation — docs/out_of_core.md)",
    "oocAggPlan": "the budget oracle bucketed an aggregation by "
                  "grouping-key hash (modulus=/depth=; "
                  "docs/out_of_core.md)",
}


# ---------------------------------------------------------------------------
# Active-trace state (process-wide, like the DeviceStore / FaultInjector)
# ---------------------------------------------------------------------------

class QueryTrace:
    """Span sink for one traced query. ``add``/``mark`` are called from
    task/pool threads concurrently; CPython ``list.append`` is atomic
    under the GIL, so the hot path takes no lock."""

    __slots__ = ("query_id", "t0", "wall_t0", "spans", "instants",
                 "counters", "_thread_names", "tenant")

    def __init__(self, query_id: int, tenant: Optional[str] = None):
        self.query_id = query_id
        # serving tenancy: the tenant of the session that OPENED the
        # trace (concurrent queries from other sessions fold their
        # spans into this file — the documented process-timeline
        # limitation — but the root attribution names its owner)
        self.tenant = tenant
        self.t0 = time.perf_counter_ns()
        self.wall_t0 = time.time()
        # span record: (kind, t0_ns, t1_ns, thread_ident, batch, chip,
        #               attrs-or-None)
        self.spans: List[Tuple] = []
        # instant record: (kind, t_ns, thread_ident, attrs-or-None)
        self.instants: List[Tuple] = []
        # counter sample: (series, t_ns, value) — Chrome "C" events;
        # the device/host pool occupancy timeline (docs/observability.md)
        self.counters: List[Tuple] = []
        self._thread_names: Dict[int, str] = {}

    def _thread(self) -> int:
        t = threading.current_thread()
        ident = t.ident or 0
        if ident not in self._thread_names:
            self._thread_names[ident] = t.name
        return ident

    def add(self, kind: str, t0: int, t1: int, batch=None, chip=None,
            **attrs) -> None:
        self.spans.append((kind, t0, t1, self._thread(), batch, chip,
                           _clean(attrs)))

    def mark(self, kind: str, **attrs) -> None:
        self.instants.append((kind, time.perf_counter_ns(),
                              self._thread(), _clean(attrs)))

    def count(self, series: str, value) -> None:
        self.counters.append((series, time.perf_counter_ns(), value))


def _clean(attrs: dict) -> Optional[dict]:
    if not attrs:
        return None
    out = {k: v for k, v in attrs.items() if v is not None}
    return out or None


# Hot-path flag: hooks read this module global directly (one attribute
# load when tracing is off). Guarded by _LOCK only for begin/end.
_ACTIVE: Optional[QueryTrace] = None
_LOCK = threading.Lock()
# an installed flight recorder parked while a file-mode root query
# owns _ACTIVE: the ring is process-lifetime state and a file trace
# must not destroy it (restored when the file trace closes)
_RING_STASH: Optional[QueryTrace] = None
_DEPTH = 0           # nested execute_plan calls (scalar subqueries)
_SEQ = 0             # traced-candidate query counter (sampling stream)
_RNG: Optional[random.Random] = None
_RNG_SEED: Optional[int] = None


def active() -> Optional[QueryTrace]:
    return _ACTIVE


def ring_active():
    """The installed flight recorder (telemetry.ring.RingTrace) when
    trace.mode=ring has been activated, else None."""
    qt = _ACTIVE
    return qt if getattr(qt, "is_ring", False) else None


def reset_tracing() -> None:
    """Drop the sampling stream + query counter so the next query sees
    a fresh deterministic schedule (tests call this between runs, like
    retry.reset_fault_injection). Uninstalls an active ring recorder
    too."""
    global _ACTIVE, _DEPTH, _SEQ, _RNG, _RNG_SEED, _RING_STASH
    with _LOCK:
        _ACTIVE = None
        _RING_STASH = None
        _DEPTH = 0
        _SEQ = 0
        _RNG = None
        _RNG_SEED = None


def begin_query(conf_obj) -> Optional[str]:
    """Start (or join) a query trace. Returns an opaque token for
    ``end_query`` — ``None`` when tracing is disabled, ``"root"`` when
    this call opened the trace, ``"ring"`` when the flight recorder is
    the sink (trace.mode=ring — installed on first use, shared by
    every query for the process life), ``"nested"``/``"unsampled"``
    otherwise. Nested queries (scalar subqueries executed during
    planning) fold their spans into the outer query's trace; so does a
    concurrent query from another session thread (documented
    limitation — span streams are a property of the process
    timeline)."""
    global _ACTIVE, _DEPTH, _SEQ, _RNG, _RNG_SEED, _RING_STASH
    if conf_obj is None or not bool(conf_obj.get(TRACE_ENABLED)):
        return None
    if str(conf_obj.get(TRACE_MODE)).lower() == "ring":
        # flight recorder: always on once installed, never sampled,
        # never cleared at query end — the interesting query is the
        # one you didn't pre-instrument. A query that begins while a
        # file-mode trace is open folds into that trace instead (the
        # nested-scope contract above).
        with _LOCK:
            if _ACTIVE is None:
                from spark_rapids_tpu_torch.telemetry.ring import RingTrace
                from spark_rapids_tpu_torch.conf import SERVE_TENANT_ID
                _ACTIVE = RingTrace(
                    int(conf_obj.get(TRACE_RING_SPANS)),
                    tenant=str(conf_obj.get(SERVE_TENANT_ID)) or None)
            elif not getattr(_ACTIVE, "is_ring", False):
                # a file-mode trace is open: fold into it WITHOUT
                # touching its depth bookkeeping (the "folded" token
                # is a no-op at end_query)
                return "folded"
            _ACTIVE.queries_begun += 1
            return "ring"
    with _LOCK:
        _DEPTH += 1
        if _DEPTH > 1:
            return "nested"
        _SEQ += 1
        rate = float(conf_obj.get(TRACE_SAMPLE_RATE))
        if rate < 1.0:
            seed = int(conf_obj.get(TRACE_SAMPLE_SEED))
            if _RNG is None or _RNG_SEED != seed:
                _RNG = random.Random(seed)
                _RNG_SEED = seed
            if _RNG.random() >= rate:
                return "unsampled"
        from spark_rapids_tpu_torch.conf import SERVE_TENANT_ID
        if getattr(_ACTIVE, "is_ring", False):
            # park the process-lifetime flight recorder for the file
            # trace's duration — a file-mode query must not destroy
            # the ring's accumulated history (restored at end_query)
            _RING_STASH = _ACTIVE
        _ACTIVE = QueryTrace(
            _SEQ, tenant=str(conf_obj.get(SERVE_TENANT_ID)) or None)
        return "root"


def end_query(conf_obj, token: Optional[str], wall_s: float = 0.0,
              rows: int = 0, error: bool = False) -> Optional[str]:
    """Close a ``begin_query`` scope; on the outermost sampled close,
    write the Chrome-trace file and return its path. Failures never
    break the query (observability must not take down execution)."""
    global _ACTIVE, _DEPTH, _RING_STASH
    if token is None:
        return None
    if token == "folded":
        return None
    if token == "ring":
        # the recorder stays installed; the query leaves only a
        # boundary marker (the trigger engine receives wall/rows via
        # its own query-end hook, telemetry/triggers.py)
        qt = ring_active()
        if qt is not None:
            qt.mark("queryEnd", wallSeconds=round(wall_s, 6), rows=rows,
                    error=bool(error) or None)
        return None
    with _LOCK:
        _DEPTH = max(0, _DEPTH - 1)
        if token != "root":
            return None
        # reinstall a parked flight recorder, if any
        qt, _ACTIVE, _RING_STASH = _ACTIVE, _RING_STASH, None
    if qt is None:
        return None
    try:
        trace_dir = str(conf_obj.get(TRACE_DIR))
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(
            trace_dir, f"trace-{os.getpid()}-q{qt.query_id:05d}.json")
        write_chrome_trace(path, qt, wall_s=wall_s, rows=rows,
                           error=error)
        return path
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Recording helpers (the instrumentation surface)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def span(kind: str, batch=None, chip=None, **attrs) -> Iterator[None]:
    """Trace-only span (sites whose duration already reaches a metric
    through another channel, e.g. store stats). One None check when
    tracing is off."""
    qt = _ACTIVE
    if qt is None:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        qt.add(kind, t0, time.perf_counter_ns(), batch=batch, chip=chip,
               **attrs)


def instant(kind: str, **attrs) -> None:
    """Point-in-time marker (retry/backoff/split/chip-failure events)."""
    qt = _ACTIVE
    if qt is not None:
        qt.mark(kind, **attrs)


def counter(series: str, value) -> None:
    """Counter sample (Chrome "C" event): Perfetto renders each series
    as a stepped occupancy track next to the span lanes. Used by the
    DeviceStore so the HBM/host pool timeline sits beside the query's
    spans. One None check when tracing is off."""
    qt = _ACTIVE
    if qt is not None:
        qt.count(series, value)


def chip_of(batch) -> Optional[int]:
    """The CUDA device index a device batch lies on, for span
    attribution: None on the CPU, and None (without looking at the
    batch) when tracing is off."""
    if _ACTIVE is None:
        return None
    try:
        dev = batch.active.device
        return dev.index if dev.type == "cuda" else None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Chrome trace-event export
# ---------------------------------------------------------------------------
#
# Spans are emitted as matched B/E pairs (ph "B"/"E"), instants as ph
# "i". Within one recording thread, context-manager spans are properly
# nested (LIFO); a span that spans a generator yield can resume on a
# different consumer thread and partially overlap its lane's stack, so
# the writer assigns spans greedily to LANES: a span joins the first
# lane whose open spans all fully contain it, otherwise it opens an
# overflow lane (tid "<thread>!k"). Every lane's event stream is
# strictly nested and time-ordered, which is exactly what the Chrome
# B/E semantics (and the schema test) require.

def _us(t_ns: int, base_ns: int) -> float:
    return round((t_ns - base_ns) / 1000.0, 3)


def _lane_events(spans: List[Tuple], base: int, pid: int,
                 tid0: int) -> Tuple[List[dict], int]:
    """Per-source-thread span list -> correctly nested B/E streams over
    one or more lanes. Returns (events, lanes_used)."""
    events: List[dict] = []
    # lane state: list of stacks; each stack holds (t1, kind) of opens
    lanes: List[List[Tuple[int, str]]] = []
    lane_ev: List[List[dict]] = []
    for kind, t0, t1, _ident, batch, chip, attrs in sorted(
            spans, key=lambda s: (s[1], -s[2])):
        args: Dict[str, Any] = {}
        if batch is not None:
            args["batch"] = batch
        if chip is not None:
            args["chip"] = chip
        if attrs:
            args.update(attrs)
        placed = False
        for li in range(len(lanes)):
            stack, ev = lanes[li], lane_ev[li]
            while stack and stack[-1][0] <= t0:
                ct1, ckind = stack.pop()
                ev.append({"name": ckind, "ph": "E", "pid": pid,
                           "tid": tid0 + li, "ts": _us(ct1, base)})
            if not stack or stack[-1][0] >= t1:
                b = {"name": kind, "ph": "B", "pid": pid,
                     "tid": tid0 + li, "ts": _us(t0, base)}
                if args:
                    b["args"] = args
                ev.append(b)
                stack.append((t1, kind))
                placed = True
                break
        if not placed:
            li = len(lanes)
            b = {"name": kind, "ph": "B", "pid": pid, "tid": tid0 + li,
                 "ts": _us(t0, base)}
            if args:
                b["args"] = args
            lanes.append([(t1, kind)])
            lane_ev.append([b])
    for li, stack in enumerate(lanes):
        while stack:
            ct1, ckind = stack.pop()
            lane_ev[li].append({"name": ckind, "ph": "E", "pid": pid,
                                "tid": tid0 + li, "ts": _us(ct1, base)})
    for ev in lane_ev:
        events.extend(ev)
    return events, max(1, len(lanes))


def write_chrome_trace(path: str, qt: QueryTrace, wall_s: float = 0.0,
                       rows: int = 0, error: bool = False) -> None:
    base = qt.t0
    pid = os.getpid()
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"spark-rapids-tpu-torch q{qt.query_id}"}}]
    by_thread: Dict[int, List[Tuple]] = {}
    for s in qt.spans:
        by_thread.setdefault(s[3], []).append(s)
    tid = 1
    for ident in sorted(by_thread):
        ev, lanes = _lane_events(by_thread[ident], base, pid, tid)
        name = qt._thread_names.get(ident, str(ident))
        for li in range(lanes):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid + li,
                           "args": {"name": name if li == 0
                                    else f"{name}!{li}"}})
        events.extend(ev)
        tid += lanes
    # instants get a dedicated lane per source thread, time-sorted:
    # sharing the span lane would interleave timestamps out of order
    # (a ring dump always carries markers older than the lane's last
    # span end), breaking the per-tid monotonicity the schema test —
    # and Perfetto's track model — expect
    ins_by_thread: Dict[int, List[Tuple]] = {}
    for ins in qt.instants:
        ins_by_thread.setdefault(ins[2], []).append(ins)
    for ident in sorted(ins_by_thread):
        name = qt._thread_names.get(ident, str(ident))
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": f"{name}!i"}})
        for kind, t_ns, _ident, attrs in sorted(
                ins_by_thread[ident], key=lambda i: i[1]):
            ev = {"name": kind, "ph": "i", "s": "t", "pid": pid,
                  "tid": tid, "ts": _us(t_ns, base)}
            if attrs:
                ev["args"] = attrs
            events.append(ev)
        tid += 1
    if qt.counters:
        # counter tracks get a lane of their own: samples from many
        # threads interleave in append order, so sort by time to keep
        # the per-tid stream monotone (the schema test's invariant)
        ctid = tid
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": ctid, "args": {"name": "counters"}})
        for series, t_ns, value in sorted(qt.counters,
                                          key=lambda c: c[1]):
            events.append({"name": series, "ph": "C", "pid": pid,
                           "tid": ctid, "ts": _us(t_ns, base),
                           "args": {"value": value}})
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "version": 1,
            "queryId": qt.query_id,
            "pid": pid,
            "wallSeconds": round(wall_s, 6),
            "outputRows": rows,
            "error": bool(error),
            "startUnixTime": qt.wall_t0,
            "spanCount": len(qt.spans),
            "instantCount": len(qt.instants),
            "counterCount": len(qt.counters),
        },
    }
    if qt.tenant:
        doc["otherData"]["tenant"] = qt.tenant
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        # default=str: attr values are normally JSON scalars, but an
        # exotic attr must degrade to its repr, never kill the write
        json.dump(doc, f, default=str)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

def load_trace(path: str) -> Dict[str, Any]:
    """Parse a written trace back into spans/instants (timestamps in
    microseconds from trace start). B/E pairs are matched per tid with
    a stack, exactly the Chrome semantics."""
    with open(path) as f:
        doc = json.load(f)
    spans: List[dict] = []
    instants: List[dict] = []
    counters: List[dict] = []
    tid_names: Dict[int, str] = {}
    stacks: Dict[int, List[dict]] = {}
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        tid = ev.get("tid", 0)
        if ph == "M":
            if ev.get("name") == "thread_name":
                tid_names[tid] = ev.get("args", {}).get("name", str(tid))
        elif ph == "B":
            stacks.setdefault(tid, []).append(ev)
        elif ph == "E":
            st = stacks.get(tid)
            if not st:
                raise ValueError(f"unmatched E event at ts={ev.get('ts')}")
            b = st.pop()
            if b.get("name") != ev.get("name"):
                raise ValueError(
                    f"B/E name mismatch: {b.get('name')} vs "
                    f"{ev.get('name')}")
            spans.append({"name": b["name"], "t0": float(b["ts"]),
                          "t1": float(ev["ts"]), "tid": tid,
                          "args": b.get("args", {})})
        elif ph in ("i", "I"):
            instants.append({"name": ev.get("name"),
                             "ts": float(ev.get("ts", 0)), "tid": tid,
                             "args": ev.get("args", {})})
        elif ph == "C":
            counters.append({"name": ev.get("name"),
                             "ts": float(ev.get("ts", 0)),
                             "value": ev.get("args", {}).get("value")})
    leftover = {t: st for t, st in stacks.items() if st}
    if leftover:
        raise ValueError(f"unmatched B events on tids {sorted(leftover)}")
    return {"spans": spans, "instants": instants, "counters": counters,
            "meta": doc.get("otherData", {}), "tidNames": tid_names}
