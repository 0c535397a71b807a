"""Persistent query-history store: the serving tier's cross-run
performance memory (docs/observability.md "Query history").

Every reservoir the watchdog, the quarantine and the stats surface keep
dies with the process, so a restart is a cold start that cannot tell
"stuck" from "first time". The reference's retrospective tier (the
qualification/profiling tools) mines *persisted* Spark event logs
across runs; this module is that durability layer for the engine:

- **one compact record per finished query** (``HISTORY_FIELD_CATALOG``
  is the schema), appended at query close from
  ``session.execute_plan`` (every terminal status it sees) and from the
  query server (terminal outcomes the session never starts, e.g.
  cancelled while still queued);
- **crash-safe bounded storage**: JSONL segments
  (``history-<ms>-<pid>-<seq>.jsonl``) rotated at a fraction of
  ``telemetry.history.maxBytes`` and compacted whole-segment-at-a-time
  by total size and ``telemetry.history.maxAgeDays`` — a record is one
  line, a torn tail line is skipped by the reader, and compaction never
  truncates mid-record;
- **read API**: :func:`read_records` (filtering by age/tenant/
  signature) and :func:`signature_aggregates` (count, p50/p99, trend
  slope, retry/fallback rates) — the substrate for ``format_history``,
  the doctor (telemetry/doctor.py), warm-start, and SLO burn;
- **warm-start** (:func:`warm_start`): at server start, replay the
  history into the lifecycle layer — per-signature wall reservoirs and
  consecutive-failure streaks — so the stuck-query watchdog and the
  poison-query quarantine work from query one after a restart;
- **SLO burn** (:class:`SloTracker`): per-tenant p99 objectives
  (``serve.slo.p99Ms[.<tenant>]``) evaluated over the history window,
  exported as ``srt_slo_*`` Prometheus families and fired as a
  rate-limited ``sloBurn`` bundle through the trigger engine.

Appending is one lock + one line write + flush; everything heavier
(compaction file deletes) is amortized and never under a query's
hot-path lock. History writes never raise — observability must not
take down execution.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from spark_rapids_tpu_torch.conf import (SERVE_QUARANTINE_THRESHOLD,
                                         SERVE_SLO_P99_MS, SERVE_SLO_WINDOW,
                                         TELEMETRY_DIR,
                                         TELEMETRY_HISTORY_DIR,
                                         TELEMETRY_HISTORY_MAX_AGE_DAYS,
                                         TELEMETRY_HISTORY_MAX_BYTES,
                                         TELEMETRY_HISTORY_WARM_START,
                                         TELEMETRY_MIN_INTERVAL_S)

HISTORY_VERSION = 1

# terminal statuses a record may carry (the event log's `status` field
# uses the same vocabulary, so history and event logs agree on query
# outcomes by construction)
STATUS_FINISHED = "finished"
STATUS_CANCELLED = "cancelled"
STATUS_TIMED_OUT = "timed-out"
STATUS_QUARANTINED = "quarantined"
STATUS_FAILED = "failed"
HISTORY_STATUSES = (STATUS_FINISHED, STATUS_CANCELLED, STATUS_TIMED_OUT,
                    STATUS_QUARANTINED, STATUS_FAILED)

# control-plane statuses: TuningController audit records (an applied
# action / a guardrail or manual rollback). They live in the SAME
# store as query records — the audit trail rides the store's
# durability and compaction — but they are NOT query outcomes:
# aggregates, SLO windows, doctor baselines, and warm-start replay all
# exclude them, the same discipline as cache-served records
# (docs/tuning.md).
STATUS_TUNING = "tuning"
STATUS_REVERT = "revert"
TUNING_STATUSES = (STATUS_TUNING, STATUS_REVERT)

# The record schema. Every field a record construction site in this
# module writes MUST be a key here (tests/test_torch_history.py), and the
# generated observability doc renders this table — the store's on-disk
# vocabulary can never drift from the documentation.
HISTORY_FIELD_CATALOG: Dict[str, str] = {
    "version": "record format version (currently 1)",
    "ts": "unix wall-clock seconds at record append (query close)",
    "queryId": "process query id (int) or the wire queryId (string)",
    "tenant": "serving tenant id (absent for untenanted sessions)",
    "signature": "plan-cache signature digest of the query shape "
                 "(plan_cache.signature_digest — the lifecycle "
                 "layer's key; absent when the plan cache is off or "
                 "planning never resolved one)",
    "status": "terminal status: finished / cancelled / timed-out / "
              "quarantined / failed",
    "reason": "cancellation reason (cancel/deadline/disconnect/"
              "watchdog/shutdown/injected) when status is cancelled "
              "or timed-out",
    "wallSeconds": "execution wall seconds (admission to terminal "
                   "state; 0 for queries that never started)",
    "queueWaitSeconds": "admission-queue wait seconds (served queries "
                        "only)",
    "outputRows": "result rows (finished queries)",
    "retryCount": "OOM retries accumulated by the query's plan",
    "splitRetryCount": "split-and-retry events accumulated by the "
                       "query's plan",
    "spillBytes": "device bytes spilled by the query's plan",
    "kernelDispatches": "kernel launches "
                        "(sum of kernelDispatchCount.*)",
    "kernelFallbacks": "kernel oracle fallbacks "
                       "(sum of kernelFallbacks.*; 0 in the port)",
    "kernelFallbacksByName": "per-kernel oracle fallback counts "
                             "(nonzero kernelFallbacks.<name> entries; "
                             "present only when any fired) — the "
                             "doctor's kernelFallback verdict names "
                             "the culprit kernel(s) from these",
    "jitMisses": "compile-cache misses billed to the query's plan "
                 "(compileCacheMisses)",
    "fallbackCoverage": "rewrite device-operator coverage (0..1) from "
                        "the explain report",
    "peakHbmBytes": "device-store pool peak bytes observed at query "
                    "close",
    "profilePath": "this query's profile artifact "
                   "(spark.rapids.sql.profile.*), when written",
    "tracePath": "this query's Chrome-trace file "
                 "(spark.rapids.sql.trace.*), when written",
    "aqeActions": "adaptive replan counters from the executed plan "
                  "(aqeReplans/aqeBroadcastFlip/aqeSkewSplits/"
                  "aqeCoalescedPartitions; nonzero entries only, "
                  "present only when any fired — docs/adaptive.md)",
    "resultCacheHit": "true when the query was served verbatim from "
                      "the serve-tier result cache (docs/caching.md); "
                      "cache-served records are EXCLUDED from doctor "
                      "baselines, SLO windows, warm-start replay, and "
                      "per-signature wall aggregates — a near-zero "
                      "cached wall must not poison a shape's baseline",
    "plannedOutOfCore": "planned out-of-core counters from the "
                        "executed plan (plannedPartitions/"
                        "plannedOutOfCoreEscalations/"
                        "budgetPressurePeak; nonzero entries only, "
                        "present only when the budget oracle engaged "
                        "— docs/out_of_core.md); the doctor uses this "
                        "to classify planned big-input spill as "
                        "biggerInput rather than retrySpill",
    "action": "tuning/revert records: the ACTION_CATALOG action name "
              "(docs/tuning.md)",
    "scope": "tuning/revert records: what the action applied to — a "
             "signature digest or tenant:<id>",
    "knob": "tuning/revert records: the knob the action wrote (a "
            "registered conf key, or an internal knob like "
            "signatureConcurrency / tenantWeight / prewarm)",
    "oldValue": "tuning/revert records: the knob value before the "
                "write (what a revert restores)",
    "newValue": "tuning/revert records: the clamped knob value after "
                "the write",
    "evidence": "tuning/revert records: why — the verdict, baseline "
                "p50/p99, and the observed window that motivated the "
                "action or triggered the rollback",
    "epoch": "tuning/revert records: the controller's monotonic "
             "action id (tools tuning pins/reverts by it)",
}


# ---------------------------------------------------------------------------
# Store
# ---------------------------------------------------------------------------

class HistoryStore:
    """Bounded, crash-safe JSONL store under one directory. Appends are
    serialized by an internal lock; segments rotate at
    ``maxBytes // 4`` (min 64 KiB) and compaction deletes whole
    segments oldest-first by total size, then by age."""

    COMPACT_EVERY = 64  # appends between compaction sweeps
    SEGMENT_FLOOR = 64 << 10  # smallest rotation target (bytes)

    def __init__(self, dir_path: str, max_bytes: int,
                 max_age_days: float):
        self.dir = dir_path
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_days) * 86400.0
        self._lock = threading.Lock()
        self._fh = None
        self._seg_bytes = 0
        self._seq = 0
        self.appended = 0
        self.pruned_segments = 0

    @property
    def segment_target(self) -> int:
        return max(self.SEGMENT_FLOOR, self.max_bytes // 4)

    def _open_segment_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        os.makedirs(self.dir, exist_ok=True)
        self._seq += 1
        name = (f"history-{int(time.time() * 1000):013d}-"
                f"{os.getpid()}-{self._seq:04d}.jsonl")
        self._fh = open(os.path.join(self.dir, name), "a",
                        encoding="utf-8")
        self._seg_bytes = 0

    def append(self, rec: Dict[str, Any]) -> None:
        """Append one record (one JSON line, flushed) and amortize
        compaction. Never raises."""
        try:
            line = json.dumps(rec, default=str) + "\n"
            with self._lock:
                if self._fh is None or \
                        self._seg_bytes + len(line) > self.segment_target:
                    self._open_segment_locked()
                self._fh.write(line)
                self._fh.flush()
                self._seg_bytes += len(line)
                self.appended += 1
                if self.appended % self.COMPACT_EVERY == 0:
                    self._compact_locked()
        except Exception:
            pass  # observability must not take down execution

    def _segments(self) -> List[str]:
        try:
            return sorted(
                os.path.join(self.dir, f) for f in os.listdir(self.dir)
                if f.startswith("history-") and f.endswith(".jsonl"))
        except OSError:
            return []

    def compact(self) -> int:
        """Run one compaction sweep now; returns segments deleted."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        deleted = 0
        active = None
        if self._fh is not None:
            active = os.path.realpath(self._fh.name)
        segs = self._segments()
        sizes = {}
        for p in segs:
            try:
                sizes[p] = os.path.getsize(p)
            except OSError:
                sizes[p] = 0
        total = sum(sizes.values())
        now = time.time()
        for p in segs:
            if os.path.realpath(p) == active:
                continue  # never delete the segment being written
            too_big = self.max_bytes > 0 and total > self.max_bytes
            too_old = self.max_age_s > 0 and \
                (now - _segment_mtime(p)) > self.max_age_s
            if not (too_big or too_old):
                continue
            try:
                os.unlink(p)
                total -= sizes.get(p, 0)
                deleted += 1
                self.pruned_segments += 1
            except OSError:
                pass
        return deleted

    def stats(self) -> Dict[str, Any]:
        segs = self._segments()
        total = 0
        for p in segs:
            try:
                total += os.path.getsize(p)
            except OSError:
                pass
        return {"dir": self.dir, "segments": len(segs),
                "totalBytes": total, "appended": self.appended,
                "prunedSegments": self.pruned_segments}


def _segment_mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return time.time()


# one store per directory, process-wide: a restarted QueryServer in the
# same process reuses the writer; two sessions on one dir share it
_STORES: Dict[str, HistoryStore] = {}
_STORES_LOCK = threading.Lock()


def store_for(conf_obj) -> Optional[HistoryStore]:
    """The process HistoryStore for the session's configured
    ``telemetry.history.dir`` (None when unset = history disabled)."""
    if conf_obj is None:
        return None
    dir_path = str(conf_obj.get(TELEMETRY_HISTORY_DIR) or "")
    if not dir_path:
        return None
    key = os.path.realpath(dir_path)
    with _STORES_LOCK:
        store = _STORES.get(key)
        if store is None:
            store = _STORES[key] = HistoryStore(
                dir_path,
                int(conf_obj.get(TELEMETRY_HISTORY_MAX_BYTES)),
                float(conf_obj.get(TELEMETRY_HISTORY_MAX_AGE_DAYS)))
        return store


def reset_history() -> None:
    """Test hook: forget the per-directory writer singletons and the
    warm-start replay markers (on-disk segments are untouched — that
    is the point of the store)."""
    with _STORES_LOCK:
        for s in _STORES.values():
            with s._lock:
                if s._fh is not None:
                    try:
                        s._fh.close()
                    except OSError:
                        pass
                    s._fh = None
        _STORES.clear()
    with _WARM_LOCK:
        _WARM_DONE.clear()


# ---------------------------------------------------------------------------
# Record construction (the write path)
# ---------------------------------------------------------------------------

def _plan_counters(physical) -> Dict[str, Any]:
    """The per-query counter deltas from the executed plan's registries
    (the registries ARE the delta — same contract as the trigger
    engine's query-end hook)."""
    if physical is None:
        return {}
    from spark_rapids_tpu_torch.metrics import registry_snapshot
    vals = registry_snapshot(plans=[physical])["metrics"]
    out = {
        "retryCount": int(vals.get("retryCount", 0)),
        "splitRetryCount": int(vals.get("splitRetryCount", 0)),
        "spillBytes": int(vals.get("spillBytes", 0)),
        "jitMisses": int(vals.get("compileCacheMisses", 0)),
        "kernelDispatches": sum(
            v for k, v in vals.items()
            if k.startswith("kernelDispatchCount.")),
        "kernelFallbacks": sum(
            v for k, v in vals.items()
            if k.startswith("kernelFallbacks.")),
    }
    by_name = {k.split(".", 1)[1]: int(v) for k, v in vals.items()
               if k.startswith("kernelFallbacks.") and v}
    if by_name:
        out["kernelFallbacksByName"] = by_name
    poc = {k: int(vals[k]) for k in ("plannedPartitions",
                                     "plannedOutOfCoreEscalations",
                                     "budgetPressurePeak")
           if vals.get(k)}
    if poc:
        out["plannedOutOfCore"] = poc
    return out


def _aqe_actions(physical) -> Dict[str, int]:
    """Adaptive replan counters from the executed plan (nonzero
    entries only), so ``tools doctor`` can attribute a wall change
    between two runs of ONE signature — adaptive and unadaptive runs
    share signatures by the plan_signature exclusion — to an AQE
    decision delta instead of a shape change (docs/adaptive.md)."""
    if physical is None:
        return {}
    from spark_rapids_tpu_torch.metrics import registry_snapshot
    vals = registry_snapshot(plans=[physical])["metrics"]
    return {k: int(vals[k])
            for k in ("aqeReplans", "aqeBroadcastFlip",
                      "aqeSkewSplits", "aqeCoalescedPartitions")
            if vals.get(k)}


def build_record(*, status: str, reason: Optional[str] = None,
                 signature: Optional[str] = None,
                 tenant: Optional[str] = None,
                 query_id=None, wall_s: float = 0.0,
                 queue_wait_s: float = 0.0, rows: int = 0,
                 physical=None, report=None,
                 profile_path: Optional[str] = None,
                 trace_path: Optional[str] = None,
                 result_cache_hit: bool = False) -> Dict[str, Any]:
    """One history record. Every key written here must be a
    HISTORY_FIELD_CATALOG entry."""
    from spark_rapids_tpu_torch import memory
    rec: Dict[str, Any] = {
        "version": HISTORY_VERSION,
        "ts": time.time(),
        "status": status,
        "wallSeconds": round(float(wall_s), 6),
        "queueWaitSeconds": round(float(queue_wait_s), 6),
        "outputRows": int(rows),
    }
    if query_id is not None:
        rec["queryId"] = query_id
    if tenant:
        rec["tenant"] = tenant
    if signature:
        rec["signature"] = signature
    if reason:
        rec["reason"] = reason
    for k, v in _plan_counters(physical).items():
        rec[k] = v
    acts = _aqe_actions(physical)
    if acts:
        rec["aqeActions"] = acts
    if report is not None:
        try:
            rec["fallbackCoverage"] = round(
                float(report.summary().get("coverage", 1.0)), 4)
        except Exception:
            pass
    store = memory._STORE
    if store is not None:
        try:
            rec["peakHbmBytes"] = int(
                store.stats().get("peakDeviceBytes", 0))
        except Exception:
            pass
    if profile_path:
        rec["profilePath"] = profile_path
    if trace_path:
        rec["tracePath"] = trace_path
    if result_cache_hit:
        rec["resultCacheHit"] = True
    return rec


def build_tuning_record(*, status: str, action: str, scope: str,
                        knob: str, old_value, new_value,
                        evidence: Dict[str, Any], epoch: int,
                        tenant: Optional[str] = None,
                        signature: Optional[str] = None
                        ) -> Dict[str, Any]:
    """One TuningController audit record (status ``tuning`` or
    ``revert``). Lives in history.py so the ``history-field`` lint
    rule pins its fields to HISTORY_FIELD_CATALOG like every other
    record construction site."""
    rec: Dict[str, Any] = {
        "version": HISTORY_VERSION,
        "ts": time.time(),
        "status": status,
        "action": action,
        "scope": scope,
        "knob": knob,
        "oldValue": old_value,
        "newValue": new_value,
        "evidence": evidence,
        "epoch": int(epoch),
    }
    if tenant:
        rec["tenant"] = tenant
    if signature:
        rec["signature"] = signature
    return rec


def record_query_close(conf_obj, **kwargs) -> None:
    """Append one query-close record when history is configured; the
    session's and the server's shared write hook. Never raises."""
    try:
        store = store_for(conf_obj)
        if store is None:
            return
        store.append(build_record(**kwargs))
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Read API
# ---------------------------------------------------------------------------

def read_records(path: str, since: Optional[float] = None,
                 tenant: Optional[str] = None,
                 signature: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    """Load history records from a directory (every history-*.jsonl,
    chronological) or one file. Torn/corrupt lines (a crash mid-append)
    are skipped; older records are normalized (``status`` defaults to
    finished, ``version`` to 1). ``since`` is a unix-seconds lower
    bound on ``ts``."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("history-") and f.endswith(".jsonl"))
    else:
        files = [path]
    out: List[Dict[str, Any]] = []
    for fp in files:
        if since is not None:
            # a segment's mtime is its LAST append: when even that is
            # older than the bound, every record inside is too — skip
            # the parse entirely (the SLO tracker's windowed reads
            # must not re-parse the whole store every scrape)
            try:
                if os.path.getmtime(fp) < since:
                    continue
            except OSError:
                continue
        try:
            with open(fp, encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            continue  # compacted away under the reader
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail line: crash-safety contract
            if not isinstance(rec, dict):
                continue
            rec.setdefault("version", 1)
            rec.setdefault("status", STATUS_FINISHED)
            if since is not None and float(rec.get("ts", 0)) < since:
                continue
            if tenant is not None and rec.get("tenant") != tenant:
                continue
            if signature is not None and \
                    rec.get("signature") != signature:
                continue
            out.append(rec)
    out.sort(key=lambda r: float(r.get("ts", 0)))
    return out


def _percentile(samples: List[float], q: float) -> float:
    from spark_rapids_tpu_torch.lifecycle import percentile
    return percentile(samples, q)


def trend_slope(records: List[Dict[str, Any]]) -> float:
    """Least-squares slope of wallSeconds over ts, in seconds of wall
    per HOUR of history — a positive slope means the shape is getting
    slower run over run (0 below 2 samples)."""
    pts = [(float(r.get("ts", 0)), float(r.get("wallSeconds", 0)))
           for r in records]
    if len(pts) < 2:
        return 0.0
    t0 = pts[0][0]
    xs = [t - t0 for t, _ in pts]
    ys = [w for _, w in pts]
    n = len(pts)
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0:
        return 0.0
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
    return slope * 3600.0


def signature_aggregates(records: List[Dict[str, Any]]
                         ) -> Dict[str, Dict[str, Any]]:
    """Per-signature aggregates over a record list: count, wall
    p50/p99, trend slope, retry/fallback rates, status histogram, and
    the tenants that ran the shape. Finished records drive the latency
    numbers; every terminal status counts in the histogram."""
    by_sig: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("status") in TUNING_STATUSES:
            # controller audit records carry the signature they acted
            # on but are not query outcomes: counting them would make
            # the aggregates differ with tuning on vs off
            continue
        sig = r.get("signature")
        if sig:
            by_sig.setdefault(sig, []).append(r)
    out: Dict[str, Dict[str, Any]] = {}
    for sig, recs in by_sig.items():
        fin = [r for r in recs if r.get("status") == STATUS_FINISHED]
        # cache-served queries count in the histogram but never drive
        # the latency numbers: a near-zero cached wall would crater a
        # shape's p50/p99 and trend slope (docs/caching.md)
        fin = [r for r in fin if not r.get("resultCacheHit")]
        walls = [float(r.get("wallSeconds", 0)) for r in fin]
        statuses: Dict[str, int] = {}
        tenants = set()
        for r in recs:
            statuses[r.get("status", STATUS_FINISHED)] = \
                statuses.get(r.get("status", STATUS_FINISHED), 0) + 1
            if r.get("tenant"):
                tenants.add(r["tenant"])
        retries = sum(1 for r in fin
                      if (r.get("retryCount", 0)
                          + r.get("splitRetryCount", 0)) > 0)
        fallbacks = sum(1 for r in fin
                        if r.get("kernelFallbacks", 0) > 0)
        out[sig] = {
            "count": len(recs),
            "finished": len(fin),
            "wallP50": round(_percentile(walls, 0.50), 6),
            "wallP99": round(_percentile(walls, 0.99), 6),
            "trendSlopePerHour": round(trend_slope(fin), 6),
            "retryRate": round(retries / len(fin), 4) if fin else 0.0,
            "fallbackRate": round(fallbacks / len(fin), 4) if fin
            else 0.0,
            "statuses": statuses,
            "tenants": sorted(tenants),
        }
    return out


def format_history(records: List[Dict[str, Any]], top: int = 30) -> str:
    """The `tools history` table: per-signature rows ranked by query
    count, plus a per-tenant rollup (docs/observability.md)."""
    lines = ["=== TPU Query History ===",
             f"{len(records)} records", ""]
    if not records:
        lines.append("no history records found")
        return "\n".join(lines)
    aggs = signature_aggregates(records)
    lines.append(
        f"  {'signature':14s} {'tenants':14s} {'n':>5s} {'ok':>5s} "
        f"{'p50_s':>8s} {'p99_s':>8s} {'trend/h':>9s} {'retry%':>7s} "
        f"{'fb%':>5s}  statuses")
    ranked = sorted(aggs.items(), key=lambda kv: -kv[1]["count"])
    for sig, a in ranked[:top]:
        sts = ",".join(f"{k}:{v}" for k, v in sorted(a["statuses"].items()))
        tns = ",".join(a["tenants"])[:14] or "-"
        lines.append(
            f"  {sig_digest(sig):14s} {tns:14s} {a['count']:5d} "
            f"{a['finished']:5d} {a['wallP50']:8.3f} "
            f"{a['wallP99']:8.3f} {a['trendSlopePerHour']:+9.4f} "
            f"{a['retryRate']:7.1%} {a['fallbackRate']:5.0%}  {sts}")
    # per-tenant rollup over finished records
    by_tenant: Dict[str, List[float]] = {}
    for r in records:
        if r.get("status") == STATUS_FINISHED:
            by_tenant.setdefault(r.get("tenant") or "-", []).append(
                float(r.get("wallSeconds", 0)))
    lines += ["", f"  {'tenant':14s} {'queries':>8s} {'p50_s':>8s} "
              f"{'p99_s':>8s}"]
    for t, walls in sorted(by_tenant.items()):
        lines.append(f"  {t:14s} {len(walls):8d} "
                     f"{_percentile(walls, 0.5):8.3f} "
                     f"{_percentile(walls, 0.99):8.3f}")
    return "\n".join(lines)


def sig_digest(signature: str) -> str:
    """Short display form of a signature. Records normally carry the
    40-hex ``plan_cache.signature_digest`` already — show its prefix;
    anything else (a raw plan string in a hand-built record) is hashed
    down to the same shape."""
    import hashlib
    import re
    if re.fullmatch(r"[0-9a-f]{12,64}", signature):
        return signature[:12]
    return hashlib.sha1(signature.encode()).hexdigest()[:12]


def find_record(records: List[Dict[str, Any]], selector: str
                ) -> Optional[Dict[str, Any]]:
    """Resolve a `tools doctor` selector against a record list: a
    queryId (exact match on either id form), a signature digest
    (sig_digest prefix), or a signature prefix — newest match wins."""
    sel = str(selector)
    for r in reversed(records):
        if str(r.get("queryId")) == sel:
            return r
    for r in reversed(records):
        if r.get("status") in TUNING_STATUSES:
            continue  # audit records are not diagnosable queries
        sig = r.get("signature")
        if sig and (sig_digest(sig).startswith(sel)
                    or sig.startswith(sel)):
            return r
    return None


# ---------------------------------------------------------------------------
# Warm-start (docs/observability.md "Query history")
# ---------------------------------------------------------------------------

# most recent history records replayed at warm-start: the lifecycle
# reservoirs are bounded anyway; replaying an unbounded store would
# only cost startup time
_WARM_START_CAP = 10_000

# dirs already replayed into the CURRENT lifecycle generation: a
# second server start in one process must not replay the same records
# on top of live streaks (that would double-count failures toward the
# quarantine threshold); a lifecycle reset (the restart simulation)
# bumps the generation and re-enables replay
_WARM_LOCK = threading.Lock()
_WARM_DONE: Dict[str, int] = {}


def warm_start(conf_obj) -> Dict[str, Any]:
    """Seed the lifecycle layer from the history store: finished
    records feed ``lifecycle.record_wall`` (the watchdog's p99
    source) and clear failure streaks; failed records replay
    ``record_runtime_failure`` so a signature that crossed the
    quarantine threshold before the restart is blacklisted from query
    one. Cancelled/timed-out/quarantined records never count — the
    same rules as the live paths. Returns a summary for the server
    stats/log."""
    out = {"enabled": False, "records": 0, "walls": 0,
           "failures": 0, "quarantined": 0, "alreadyWarm": False}
    if conf_obj is None:
        return out
    dir_path = str(conf_obj.get(TELEMETRY_HISTORY_DIR) or "")
    if not dir_path or not bool(
            conf_obj.get(TELEMETRY_HISTORY_WARM_START)):
        return out
    if not os.path.isdir(dir_path):
        out["enabled"] = True
        return out
    from spark_rapids_tpu_torch import lifecycle as LC
    gen = LC.lifecycle_generation()
    key = os.path.realpath(dir_path)
    with _WARM_LOCK:
        if _WARM_DONE.get(key) == gen:
            # this store already seeded the CURRENT lifecycle state:
            # replaying again would double-count failure streaks
            out["enabled"] = True
            out["alreadyWarm"] = True
            return out
        _WARM_DONE[key] = gen
    thr = int(conf_obj.get(SERVE_QUARANTINE_THRESHOLD))
    records = read_records(dir_path)[-_WARM_START_CAP:]
    out["enabled"] = True
    out["records"] = len(records)
    for rec in records:  # chronological: streaks replay in order
        if rec.get("status") in TUNING_STATUSES:
            continue  # controller audit rows never seed lifecycle
        sig = rec.get("signature")
        if not sig:
            continue
        status = rec.get("status")
        if status == STATUS_FINISHED:
            if not rec.get("resultCacheHit"):
                # a cache-served wall is not an execution wall: seeding
                # the watchdog's p99 history with near-zero values
                # would make every real run look stuck
                LC.record_wall(sig, float(rec.get("wallSeconds", 0.0)))
                out["walls"] += 1
            if thr > 0:
                LC.record_success(sig)
        elif status == STATUS_FAILED and thr > 0:
            out["failures"] += 1
            if LC.record_runtime_failure(sig, thr):
                out["quarantined"] += 1
    return out


# ---------------------------------------------------------------------------
# SLO burn tracking (docs/observability.md "SLO tracking")
# ---------------------------------------------------------------------------

_SLO_PREFIX = "spark.rapids.sql.serve.slo.p99Ms."
_SLO_CACHE_S = 1.0  # evaluate() result cache (scrapes are frequent)


class SloTracker:
    """Per-tenant latency objectives evaluated over the history
    window. The server embeds one; ``stats()`` exposes the evaluation
    and the Prometheus renderer exports it as ``srt_slo_*`` families.
    A tenant whose observed p99 exceeds its objective fires a
    rate-limited ``sloBurn`` bundle through the trigger engine."""

    def __init__(self, conf_obj):
        self._conf = conf_obj
        self._dir = str(conf_obj.get(TELEMETRY_HISTORY_DIR) or "")
        self._window_s = float(conf_obj.get(SERVE_SLO_WINDOW))
        self._base_ms = int(conf_obj.get(SERVE_SLO_P99_MS))
        self._overrides: Dict[str, int] = {}
        for k, v in conf_obj.settings.items():
            if str(k).startswith(_SLO_PREFIX):
                try:
                    self._overrides[str(k)[len(_SLO_PREFIX):]] = \
                        max(0, int(v))
                except (TypeError, ValueError):
                    pass
        self._lock = threading.Lock()
        self._cached_at = 0.0
        self._cached: Dict[str, Dict[str, Any]] = {}

    @property
    def enabled(self) -> bool:
        return bool(self._dir) and (
            self._base_ms > 0 or any(self._overrides.values()))

    def objective_ms(self, tenant: str) -> int:
        return self._overrides.get(tenant, self._base_ms)

    def evaluate(self, max_age_s: float = _SLO_CACHE_S
                 ) -> Dict[str, Dict[str, Any]]:
        """Per-tenant SLO state over the window: objective, observed
        p99, window query count, violations (queries over the
        objective), and burn ratio (violations / count). Cached for
        ``max_age_s`` so a scrape storm doesn't re-read the store."""
        if not self.enabled:
            return {}
        now = time.monotonic()
        with self._lock:
            # validity is the timestamp, NOT the payload: an empty
            # evaluation (SLO armed, no tenanted records yet) must
            # cache too, or every scrape re-reads the store
            if self._cached_at and now - self._cached_at < max_age_s:
                return self._cached
        since = time.time() - self._window_s
        by_tenant: Dict[str, List[float]] = {}
        for rec in read_records(self._dir, since=since):
            if rec.get("status") != STATUS_FINISHED:
                # non-query statuses — including the controller's
                # tuning/revert audit records — never enter the window
                continue
            if rec.get("resultCacheHit"):
                # cache-served queries are excluded from the SLO
                # window: near-zero cached walls would mask a real
                # latency burn behind a high hit rate
                continue
            t = rec.get("tenant")
            if not t:
                continue
            by_tenant.setdefault(t, []).append(
                float(rec.get("wallSeconds", 0.0)) * 1e3)
        out: Dict[str, Dict[str, Any]] = {}
        tenants = set(by_tenant) | {
            t for t, v in self._overrides.items() if v > 0}
        for t in sorted(tenants):
            obj = self.objective_ms(t)
            if obj <= 0:
                continue
            walls_ms = by_tenant.get(t, [])
            violations = sum(1 for w in walls_ms if w > obj)
            out[t] = {
                "objectiveP99Ms": obj,
                "observedP99Ms": round(
                    _percentile(walls_ms, 0.99), 3),
                "windowQueries": len(walls_ms),
                "violations": violations,
                "burnRatio": round(violations / len(walls_ms), 4)
                if walls_ms else 0.0,
            }
        with self._lock:
            self._cached_at = now
            self._cached = out
        return out

    def on_query_close(self, tenant: Optional[str]) -> None:
        """Query-close evaluation point (the server calls this after
        the finished record lands): when the tenant's observed p99
        over the window exceeds its objective, fire a rate-limited
        ``sloBurn`` bundle through the trigger engine."""
        if not tenant or not self.enabled:
            return
        obj = self.objective_ms(tenant)
        if obj <= 0:
            return
        state = self.evaluate().get(tenant)
        if state is None or state["observedP99Ms"] <= obj:
            return
        from spark_rapids_tpu_torch.telemetry import triggers as _triggers
        eng = _triggers.engine()
        eng._ensure_worker()
        eng._maybe_fire(
            "sloBurn",
            {"tenant": tenant, **state,
             "windowSeconds": self._window_s},
            out_dir=str(self._conf.get(TELEMETRY_DIR)),
            min_interval=float(
                self._conf.get(TELEMETRY_MIN_INTERVAL_S)))
