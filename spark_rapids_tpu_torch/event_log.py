"""Per-query JSON event logs + offline readers (the reference tools/
module's data source: Spark event logs parsed by Qualification.scala:34
and Profiler.scala:31; here the engine writes its own compact format).

Enabled by ``spark.rapids.sql.eventLog.dir``: each completed collect()
appends ONE JSON line to ``events-<pid>-<session>.jsonl`` in that
directory with the plan, per-operator device placement and fallback
reasons, per-operator metrics, spill-store stats, wall time, and row
counts. ``read_events`` loads a log (or a directory of logs) back for
offline tools.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

_LOCK = threading.Lock()
_SEQ = [0]


def next_query_id() -> int:
    """Process-wide query-completion sequence, SHARED between the event
    log and the profile writer so one query's event line and profile
    artifact carry the same queryId (the session allocates one id per
    query and passes it to both)."""
    with _LOCK:
        _SEQ[0] += 1
        return _SEQ[0]


def _collect_ops(physical) -> List[Dict[str, Any]]:
    from spark_rapids_tpu_torch.exec.base import TorchExec
    ops: List[Dict[str, Any]] = []

    def walk(p, depth=0):
        entry: Dict[str, Any] = {
            "op": type(p).__name__,
            "depth": depth,
            "device": isinstance(p, TorchExec),
        }
        m = getattr(p, "metrics", None)
        if m is not None:
            # ALL created metrics, zero-valued included: an op that saw
            # 0 rows (or degradedChips=0) must be distinguishable from
            # one whose metric was never created (v2 event format)
            vals = {k: v.value for k, v in m.metrics.items()}
            if vals:
                entry["metrics"] = vals
        ops.append(entry)
        # fused stages keep their constituent execs (with fanned-back
        # metrics) off the child axis; log them SHALLOW under the
        # stage (their child links point back into the chain)
        for op in getattr(p, "fused_ops", []):
            fe: Dict[str, Any] = {"op": type(op).__name__,
                                  "depth": depth + 1, "device": True,
                                  "fused": True}
            fm = getattr(op, "metrics", None)
            if fm is not None:
                vals = {k: v.value for k, v in fm.metrics.items()}
                if vals:
                    fe["metrics"] = vals
            ops.append(fe)
        for c in getattr(p, "children", []):
            walk(c, depth + 1)
    walk(physical)
    return ops


# event-line format version: 2 adds zero-valued metrics, the compact
# conf snapshot, the fault-injector summary, and the terminal
# status/reason fields (finished/cancelled/timed-out/quarantined/
# failed — the same vocabulary as the query-history store, so event
# logs and history records agree on query outcomes); readers treat
# absent version as 1 and absent status as finished (read_events
# normalizes)
EVENT_VERSION = 2


def write_event(log_dir: str, session_id: int, physical,
                rewrite_report, wall_s: float, rows: int,
                store_stats: Optional[Dict[str, int]] = None,
                conf=None,
                memory_by_op: Optional[Dict[str, Dict[str, int]]] = None,
                query_id=None,
                tenant: Optional[str] = None,
                status: str = "finished",
                reason: Optional[str] = None) -> None:
    """Append one query-completion event; failures never break the
    query (observability must not take down execution). ``physical``
    may be None for queries that terminated before planning resolved
    (e.g. cancelled mid-plan); ``query_id`` is the process int
    sequence, or the server's wire queryId string for served
    terminal outcomes — the SAME value the query-history record
    carries, so the two sinks join."""
    try:
        os.makedirs(log_dir, exist_ok=True)
        qid = query_id if query_id is not None else next_query_id()
        rec: Dict[str, Any] = {
            "event": "queryCompleted",
            "version": EVENT_VERSION,
            "ts": time.time(),
            "queryId": qid,
            "status": status,
            "wallSeconds": round(wall_s, 6),
            "outputRows": rows,
            "plan": repr(physical) if physical is not None else None,
            "ops": _collect_ops(physical) if physical is not None
            else [],
        }
        if reason:
            # cancellation reason (cancel/deadline/disconnect/
            # watchdog/shutdown/injected) for cancelled/timed-out lines
            rec["reason"] = reason
        if tenant:
            # serving tenancy: the session's tenant id rides on every
            # event line so offline tools can slice per tenant
            rec["tenant"] = tenant
        if rewrite_report is not None:
            rec["replacedAny"] = rewrite_report.replaced_any
            rec["fallbacks"] = [
                {"op": name, "reasons": list(reasons)}
                for name, reasons in rewrite_report.fallbacks]
            # aggregated per-query fallback summary (coverage + reason
            # histogram) so offline tools need not re-walk the reasons
            summary = getattr(rewrite_report, "summary", None)
            if callable(summary):
                rec["fallbackSummary"] = {
                    k: v for k, v in summary().items()
                    if k in ("deviceOps", "coverage", "reasonCounts")}
        if store_stats:
            rec["storeStats"] = store_stats
        if memory_by_op:
            # per-operator peak/live HBM (the store's owner-attributed
            # ledger, memory.py) rides along in each line
            rec["memoryByOperator"] = memory_by_op
        if conf is not None:
            # compact snapshot: only the session's EXPLICIT settings
            # (defaults are derivable from the code version); enough to
            # re-run the query's configuration offline
            rec["conf"] = {k: str(v)
                           for k, v in sorted(conf.settings.items())}
            from spark_rapids_tpu_torch.retry import get_fault_injector
            inj = get_fault_injector(conf)
            if inj is not None:
                rec["faultInjector"] = inj.stats()
        path = os.path.join(
            log_dir, f"events-{os.getpid()}-{session_id}.jsonl")
        with _LOCK, open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except Exception:
        pass


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """Load events from one .jsonl file or every events-*.jsonl in a
    directory."""
    files: List[str]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("events-") and f.endswith(".jsonl"))
    else:
        files = [path]
    for fp in files:
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if line:
                    ev = json.loads(line)
                    # pre-versioning lines are format 1; lines written
                    # before the terminal-status field are finished by
                    # construction (failure paths did not log then)
                    ev.setdefault("version", 1)
                    if ev.get("event") == "queryCompleted":
                        ev.setdefault("status", "finished")
                    yield ev
