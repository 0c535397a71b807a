"""Qualification, profiling and trace tools, the generated docs, and the
``tools`` CLI (the counterpart of ``spark_rapids_tpu.tools``).

API:
  qualify(session, df)       -> QualificationReport
  qualify_sql(session, sql)  -> QualificationReport
  profile(session, df)       -> ProfileReport (runs the query)
  qualify_log / profile_log  -> offline reports over event logs
  critical_path, exclusive_times, chip_occupancy, top_spans,
  analyze_trace, format_trace_report, hotspots_report
                             -> offline analysis of Chrome-trace files
  generate_supported_ops / generate_observability_docs /
  generate_tuning_docs       -> docs/torch/*.md (with conf.generate_docs)

The offline readers take the files either package wrote: an event log,
a trace or a profile of the JAX package gives the JAX tools' report,
with the device named as the card ("GPU") instead of "TPU".

CLI (every JAX command, the same flags and exit codes, plus ``--device``;
the default is the CUDA card, the tests pass ``cpu``):
  python -m spark_rapids_tpu_torch.tools qualify "SELECT ..." --view t=path
  python -m spark_rapids_tpu_torch.tools docs --out docs/torch
  python -m spark_rapids_tpu_torch.tools lint
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# the transitions the offline qualification does not rate, in the names
# of both packages (their event logs read alike)
_TRANSITIONS = ("TorchRowToColumnar", "TorchColumnarToRow",
                "TpuRowToColumnar", "TpuColumnarToRow")
# aggregation dispatch spans the hotspots report splits by kernel bucket
_AGG_DISPATCH = ("TorchHashAggregateExec.dispatch",
                 "TpuHashAggregateExec.dispatch")


@dataclass
class QualificationReport:
    """Per-operator device placement + fallback reasons."""

    device_ops: List[str] = field(default_factory=list)
    cpu_ops: List[Tuple[str, List[str]]] = field(default_factory=list)
    plan_string: str = ""

    @property
    def op_coverage(self) -> float:
        total = len(self.device_ops) + len(self.cpu_ops)
        return (len(self.device_ops) / total) if total else 1.0

    def format(self) -> str:
        lines = ["=== GPU Qualification Report ===",
                 f"operator coverage: {self.op_coverage:.0%} "
                 f"({len(self.device_ops)} on GPU, "
                 f"{len(self.cpu_ops)} on CPU)", ""]
        if self.device_ops:
            lines.append("runs on GPU:")
            lines += [f"  + {o}" for o in self.device_ops]
        if self.cpu_ops:
            lines.append("stays on CPU:")
            for name, reasons in self.cpu_ops:
                lines.append(f"  - {name}")
                lines += [f"      because {r}" for r in reasons]
        lines += ["", "physical plan:", self.plan_string]
        return "\n".join(lines)


def _device_nodes(physical):
    """Every device operator of a plan, pre-order; a fused stage's
    constituents follow it, visited shallow (their child links point back
    into the chain)."""
    from spark_rapids_tpu_torch.exec.base import TorchExec

    def walk(p):
        if isinstance(p, TorchExec):
            yield p
        yield from getattr(p, "fused_ops", [])
        for c in p.children:
            yield from walk(c)
    return list(walk(physical))


def _op_name(p) -> str:
    return p.simple_string().split()[0]


def qualify(session, df) -> QualificationReport:
    """Rewrite the plan (without executing it) and report placement."""
    physical = session.plan_physical(df.plan)
    report = QualificationReport(
        plan_string=session.explain_string(df.plan, physical=physical))
    rewrite = session.last_rewrite_report
    if rewrite is not None:
        for name, reasons in rewrite.fallbacks:
            report.cpu_ops.append((name, list(reasons)))
    report.device_ops = [_op_name(p) for p in _device_nodes(physical)]
    return report


def qualify_sql(session, sql: str) -> QualificationReport:
    return qualify(session, session.sql(sql))


@dataclass
class ProfileReport:
    """Executed-query metrics per operator (profiling tool)."""

    rows: int = 0
    operators: List[Tuple[str, Dict[str, int]]] = field(
        default_factory=list)

    def format(self) -> str:
        lines = ["=== GPU Profile Report ===", f"output rows: {self.rows}"]
        for name, metrics in self.operators:
            lines.append(f"  {name}")
            for k, v in sorted(metrics.items()):
                lines.append(f"      {k}: {v}")
        return "\n".join(lines)


def profile(session, df) -> ProfileReport:
    """Execute the query and collect every device operator's metric
    registry (its non-zero values)."""
    physical = session.plan_physical(df.plan)
    try:
        result = physical.execute_collect()
    finally:
        from spark_rapids_tpu_torch.memory import release_plan_handles
        release_plan_handles(physical)
    out = ProfileReport(rows=result.num_rows)
    for p in _device_nodes(physical):
        vals = {name: m.value for name, m in list(p.metrics.metrics.items())
                if m.value}
        out.operators.append((_op_name(p), vals))
    return out


# -- offline (event-log) tools ---------------------------------------------

def qualify_log(log_path: str) -> str:
    """Score logged queries for device suitability: per-query operator
    coverage + a histogram of fallback reasons."""
    from spark_rapids_tpu_torch.event_log import read_events
    lines = ["=== GPU Qualification Report (offline) ===",
             f"log: {log_path}", ""]
    reason_counts: Dict[str, int] = {}
    n_q = 0
    covs: List[float] = []
    for ev in read_events(log_path):
        if ev.get("event") != "queryCompleted":
            continue
        n_q += 1
        rated = [o for o in ev.get("ops", [])
                 if not o["op"].startswith(_TRANSITIONS)]
        dev = sum(1 for o in rated if o.get("device"))
        cov = dev / (len(rated) or 1)
        covs.append(cov)
        lines.append(f"query {ev.get('queryId')}: "
                     f"{cov:.0%} of operators on GPU, "
                     f"{ev.get('wallSeconds', 0):.3f}s, "
                     f"{ev.get('outputRows', 0)} rows")
        for fb in ev.get("fallbacks", []):
            for r in fb.get("reasons", []):
                reason_counts[r] = reason_counts.get(r, 0) + 1
    if not n_q:
        lines.append("no queryCompleted events found")
        return "\n".join(lines)
    score = sum(covs) / len(covs)
    lines += ["", f"queries: {n_q}",
              f"mean operator coverage: {score:.0%}",
              ("recommendation: ACCELERATE" if score >= 0.5 else
               "recommendation: investigate fallbacks first")]
    if reason_counts:
        lines += ["", "fallback reasons (by frequency):"]
        for r, c in sorted(reason_counts.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {c:4d}x {r}")
    return "\n".join(lines)


def profile_log(log_path: str) -> str:
    """Aggregate per-operator metrics + a text timeline across logged
    queries."""
    from spark_rapids_tpu_torch.event_log import read_events
    lines = ["=== GPU Profile Report (offline) ===",
             f"log: {log_path}", ""]
    op_metrics: Dict[str, Dict[str, int]] = {}
    events = [ev for ev in read_events(log_path)
              if ev.get("event") == "queryCompleted"]
    if not events:
        lines.append("no queryCompleted events found")
        return "\n".join(lines)
    t0 = min(ev["ts"] - ev.get("wallSeconds", 0) for ev in events)
    span = max(max(ev["ts"] for ev in events) - t0, 1e-9)
    lines.append("timeline (each bar spans the query's wall time):")
    width = 50
    for ev in events:
        start = ev["ts"] - ev.get("wallSeconds", 0) - t0
        dur = ev.get("wallSeconds", 0)
        a = int(start / span * width)
        b = max(a + 1, int((start + dur) / span * width))
        bar = " " * a + "#" * (b - a)
        lines.append(f"  q{ev.get('queryId'):>3} |{bar:<{width}}| "
                     f"{dur:.3f}s")
        for o in ev.get("ops", []):
            for k, v in o.get("metrics", {}).items():
                d = op_metrics.setdefault(o["op"], {})
                d[k] = d.get(k, 0) + v
        st = ev.get("storeStats")
        if st and st.get("spillCount"):
            lines.append(f"       spills: {st['spillCount']} "
                         f"({st.get('spilledDeviceBytes', 0)} bytes)")
    lines += ["", "aggregate operator metrics:"]
    for op, ms in sorted(op_metrics.items()):
        lines.append(f"  {op}")
        for k, v in sorted(ms.items()):
            lines.append(f"      {k}: {v}")
    return "\n".join(lines)


# -- offline trace analysis -------------------------------------------------
# (critical path, exclusive self-time and per-card occupancy over one
# query's Chrome-trace file; docs/torch/observability.md explains how to
# read each section)

def _trace_bounds(spans: List[dict]) -> Tuple[float, float]:
    t0 = min(s["t0"] for s in spans)
    t1 = max(s["t1"] for s in spans)
    return t0, max(t1, t0 + 1e-9)


def critical_path(spans: List[dict]) -> Tuple[Dict[str, float], float]:
    """Backward walk from the last span end to the first span start: at
    each point the most immediate covering span (the latest start) owns
    the segment; where nothing covers, the gap is idle. Returns
    (microseconds attributed per span name, idle us): the chain of work
    that set the query's wall."""
    if not spans:
        return {}, 0.0
    import heapq
    t_begin, t_end = _trace_bounds(spans)
    desc = sorted(spans, key=lambda s: -s["t1"])
    attr: Dict[str, float] = {}
    idle = 0.0
    heap: List[Tuple[float, int]] = []  # (-t0, index into desc)
    i = 0
    cur = t_end
    while cur > t_begin + 1e-9:
        while i < len(desc) and desc[i]["t1"] >= cur - 1e-9:
            heapq.heappush(heap, (-desc[i]["t0"], i))
            i += 1
        # a span whose t0 >= cur can never cover this or any smaller cur
        while heap and -heap[0][0] >= cur - 1e-9:
            heapq.heappop(heap)
        if heap:
            neg_t0, idx = heap[0]
            s = desc[idx]
            seg_start = max(-neg_t0, t_begin)
            attr[s["name"]] = attr.get(s["name"], 0.0) + (cur - seg_start)
            cur = seg_start
        elif i < len(desc):
            nxt = min(cur, max(desc[i]["t1"], t_begin))
            idle += cur - nxt
            cur = nxt
        else:
            idle += cur - t_begin
            cur = t_begin
    return attr, idle


def exclusive_times(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    """Per span name: count, total us, and EXCLUSIVE us (total minus
    directly nested child spans on the same lane): the ``retryBlock``
    span nested inside an operator's timer span comes off the operator's
    self-time. The doctor's stage evidence reads this one copy."""
    out: Dict[str, Dict[str, float]] = {}
    by_tid: Dict[int, List[dict]] = {}
    for s in spans:
        by_tid.setdefault(s["tid"], []).append(s)
    for ss in by_tid.values():
        ss.sort(key=lambda s: (s["t0"], -(s["t1"] - s["t0"])))
        stack: List[dict] = []
        for s in ss:
            s["_child"] = 0.0
            while stack and stack[-1]["t1"] <= s["t0"] + 1e-9:
                stack.pop()
            if stack:
                stack[-1]["_child"] += s["t1"] - s["t0"]
            stack.append(s)
        for s in ss:
            d = out.setdefault(s["name"],
                               {"count": 0, "total": 0.0,
                                "exclusive": 0.0})
            d["count"] += 1
            dur = s["t1"] - s["t0"]
            d["total"] += dur
            d["exclusive"] += max(0.0, dur - s.pop("_child"))
    return out


def chip_occupancy(spans: List[dict]) -> Dict[int, Dict]:
    """Busy/idle per card from card-attributed spans (uploads,
    dispatches): merged busy intervals, occupancy over the trace window,
    and the top idle gaps."""
    t_begin, t_end = _trace_bounds(spans) if spans else (0.0, 1.0)
    per: Dict[int, List[Tuple[float, float]]] = {}
    for s in spans:
        chip = s.get("args", {}).get("chip")
        if chip is not None:
            per.setdefault(int(chip), []).append((s["t0"], s["t1"]))
    out: Dict[int, Dict] = {}
    for chip, ivs in sorted(per.items()):
        ivs.sort()
        merged: List[List[float]] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        gaps = []
        prev = t_begin
        for a, b in merged:
            if a > prev:
                gaps.append((prev, a - prev))
            prev = max(prev, b)
        if t_end > prev:
            gaps.append((prev, t_end - prev))
        gaps.sort(key=lambda g: -g[1])
        out[chip] = {
            "busy_us": round(busy, 1),
            "occupancy": round(busy / (t_end - t_begin), 4),
            "dispatches": len(ivs),
            "topIdleGaps_us": [round(g[1], 1) for g in gaps[:3]],
        }
    return out


def top_spans(spans: List[dict], n: int = 10) -> List[dict]:
    ranked = sorted(spans, key=lambda s: -(s["t1"] - s["t0"]))[:n]
    return [{"name": s["name"], "dur_us": round(s["t1"] - s["t0"], 1),
             "t0_us": round(s["t0"], 1), "tid": s["tid"],
             "args": s.get("args", {})} for s in ranked]


def analyze_trace(path: str) -> Dict:
    """Machine-readable analysis of one trace file."""
    from spark_rapids_tpu_torch.trace import load_trace
    tr = load_trace(path)
    spans = tr["spans"]
    out: Dict = {"file": path, "meta": tr["meta"],
                 "spanCount": len(spans),
                 "instantCount": len(tr["instants"])}
    if not spans:
        return out
    cp, idle = critical_path(spans)
    total = sum(cp.values()) + idle
    out["criticalPath_s"] = {
        k: round(v / 1e6, 4)
        for k, v in sorted(cp.items(), key=lambda kv: -kv[1])}
    out["criticalPathIdle_s"] = round(idle / 1e6, 4)
    out["criticalPathSpan_s"] = round(total / 1e6, 4)
    out["occupancy"] = chip_occupancy(spans)
    out["topSpans"] = top_spans(spans, 5)
    return out


def format_trace_report(path: str, top: int = 10) -> str:
    """Human-readable trace report (the `tools trace` CLI output)."""
    from spark_rapids_tpu_torch.trace import load_trace
    tr = load_trace(path)
    spans, instants, meta = tr["spans"], tr["instants"], tr["meta"]
    lines = ["=== GPU Trace Report ===", f"trace: {path}",
             f"query {meta.get('queryId')}: "
             f"{meta.get('wallSeconds', 0):.3f}s wall, "
             f"{meta.get('outputRows', 0)} rows, "
             f"{len(spans)} spans, {len(instants)} markers", ""]
    if not spans:
        lines.append("no spans recorded")
        return "\n".join(lines)
    t_begin, t_end = _trace_bounds(spans)
    window = t_end - t_begin
    cp, idle = critical_path(spans)
    lines.append(f"critical path ({window / 1e6:.3f}s traced window):")
    for name, us in sorted(cp.items(), key=lambda kv: -kv[1]):
        lines.append(f"  {us / 1e6:8.3f}s  {us / window:5.1%}  {name}")
    lines.append(f"  {idle / 1e6:8.3f}s  {idle / window:5.1%}  (idle)")
    lines += ["", "exclusive self-time per operator (retry/compile "
              "blocks subtracted from their enclosing spans):"]
    excl = exclusive_times(spans)
    ranked = sorted(excl.items(), key=lambda kv: -kv[1]["exclusive"])
    lines.append(f"  {'span':44s} {'count':>6s} {'total_s':>9s} "
                 f"{'self_s':>9s}")
    for name, d in ranked[:top]:
        lines.append(f"  {name:44s} {d['count']:6d} "
                     f"{d['total'] / 1e6:9.3f} "
                     f"{d['exclusive'] / 1e6:9.3f}")
    occ = chip_occupancy(spans)
    lines += ["", "per-chip occupancy (chip-attributed spans over the "
              "traced window):"]
    if occ:
        for chip, d in occ.items():
            gaps = ", ".join(f"{g / 1e3:.1f}ms"
                             for g in d["topIdleGaps_us"]) or "-"
            lines.append(f"  chip {chip}: {d['occupancy']:6.1%} busy, "
                         f"{d['dispatches']} dispatches, "
                         f"top idle gaps: {gaps}")
    else:
        lines.append("  (no chip-attributed spans)")
    lines += ["", f"top {top} slowest spans:"]
    for s in top_spans(spans, top):
        extra = ""
        if s["args"]:
            extra = "  " + ", ".join(
                f"{k}={v}" for k, v in sorted(s["args"].items()))
        lines.append(f"  {s['dur_us'] / 1e3:9.1f}ms  {s['name']}{extra}")
    if instants:
        counts: Dict[str, int] = {}
        for ins in instants:
            counts[ins["name"]] = counts.get(ins["name"], 0) + 1
        lines += ["", "instant markers:"]
        for name, c in sorted(counts.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {c:5d}x {name}")
    return "\n".join(lines)


def _hotspot_name(s: dict) -> str:
    """A span's family in the hotspots report: kernel dispatches split
    by (kernel, capacity bucket), flagged ``(untuned)`` when they ran the
    kernel's own launch."""
    a = s.get("args", {})
    k = a.get("kernel")
    if k and (s["name"] == "kernelDispatch" or s["name"] in _AGG_DISPATCH):
        b = a.get("bucket")
        bucket = f"@{b}" if b is not None else ""
        flag = " (untuned)" if "tuned" in a and not a["tuned"] else ""
        return f"{s['name']}[{k}{bucket}]{flag}"
    return s["name"]


def hotspots_report(paths: List[str], top: int = 20) -> str:
    """Rank EXCLUSIVE self-time per span family across a whole trace
    directory (the `tools hotspots` CLI): a family's summed self-time is
    the ceiling on what a faster kernel can save. Kernel dispatches are
    split out per (kernel, capacity bucket)
    (`kernelDispatch[<name>@<bucket>]`), and dispatches that ran on
    default launch parameters are flagged `(untuned)`: the autotuner's
    remaining targets."""
    from spark_rapids_tpu_torch.trace import load_trace
    agg: Dict[str, Dict[str, float]] = {}
    window = 0.0
    for fp in paths:
        spans = load_trace(fp)["spans"]
        if not spans:
            continue
        t0, t1 = _trace_bounds(spans)
        window += t1 - t0
        for name, d in exclusive_times(
                [dict(s, name=_hotspot_name(s)) for s in spans]).items():
            e = agg.setdefault(name, {"count": 0, "total": 0.0,
                                      "exclusive": 0.0})
            e["count"] += d["count"]
            e["total"] += d["total"]
            e["exclusive"] += d["exclusive"]
    lines = ["=== GPU Hotspot Report ===",
             f"{len(paths)} trace file(s), "
             f"{window / 1e6:.3f}s summed traced window", "",
             "exclusive self-time per span family (the next kernel "
             "targets — docs/torch/kernels.md):", ""]
    if not agg:
        lines.append("no spans recorded")
        return "\n".join(lines)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1]["exclusive"])
    lines.append(f"  {'span':44s} {'count':>7s} {'total_s':>9s} "
                 f"{'self_s':>9s} {'self%':>6s}")
    for name, d in ranked[:top]:
        pct = d["exclusive"] / window if window else 0.0
        lines.append(f"  {name:44s} {d['count']:7d} "
                     f"{d['total'] / 1e6:9.3f} "
                     f"{d['exclusive'] / 1e6:9.3f} {pct:6.1%}")
    return "\n".join(lines)


# -- the CLI ----------------------------------------------------------------

COMMANDS = ["qualify", "profile", "docs", "trace", "hotspots", "serve",
            "serve-client", "lint", "top", "bench-diff", "soak", "history",
            "doctor", "tuning"]


def _parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="spark_rapids_tpu_torch.tools",
        description="GPU qualification/profiling tools")
    ap.add_argument("command", choices=COMMANDS)
    ap.add_argument("sql", nargs="?", help="SQL text to analyze (live "
                    "mode; omit when using --log), the trace "
                    "file/directory for the trace/hotspots commands, "
                    "a profile-*.json file/directory for the "
                    "profile command (spark.rapids.sql.profile.dir "
                    "output), the server port for `top`, the "
                    "BASELINE bench JSON for `bench-diff`, the "
                    "history directory for `history`, or the "
                    "queryId/signature selector for `doctor`")
    ap.add_argument("paths", nargs="*",
                    help="bench-diff: the CANDIDATE bench JSON, or a "
                    "directory holding BENCH_r*.json files (the "
                    "newest round is the candidate)")
    ap.add_argument("--device", default="cuda",
                    help="qualify/profile/serve/soak: the torch device "
                    "the engine runs on (default cuda, the card; cpu "
                    "runs the plain PyTorch versions)")
    ap.add_argument("--view", action="append", default=[],
                    help="name=path parquet view registrations")
    ap.add_argument("--log", help="offline mode: event-log file or "
                    "directory (spark.rapids.sql.eventLog.dir output)")
    ap.add_argument("--out", default="docs/torch",
                    help="docs: output directory for generated markdown")
    ap.add_argument("--top", type=int, default=10,
                    help="trace: rows per report section")
    ap.add_argument("--conf", action="append", default=[],
                    help="serve: key=value spark.rapids confs")
    ap.add_argument("--host", default=None, help="serve/serve-client: "
                    "bind/connect host (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve: bind port (0/unset = ephemeral); "
                    "serve-client: server port (required)")
    ap.add_argument("--tenant", default=None,
                    help="serve-client: tenant id for the request "
                    "(default 'default'); history: restrict the "
                    "report to one tenant")
    ap.add_argument("--since", default=None,
                    help="history: only records newer than this — a "
                    "number of seconds ago (e.g. 3600) or an ISO "
                    "timestamp (2026-08-04T12:00)")
    ap.add_argument("--history", default=None,
                    help="doctor/tuning: the query-history directory "
                    "(spark.rapids.sql.telemetry.history.dir)")
    ap.add_argument("--signature", default=None,
                    help="history: restrict the report to one "
                    "signature digest (full 40-hex or a prefix)")
    ap.add_argument("--all", action="store_true",
                    help="doctor: batch mode — diagnose every "
                    "signature's newest record and rank regressions "
                    "worst-first (--top rows)")
    ap.add_argument("--pin", type=int, default=None, metavar="EPOCH",
                    help="tuning: pin the action (exempt from the "
                    "guardrail's auto-revert)")
    ap.add_argument("--unpin", type=int, default=None, metavar="EPOCH",
                    help="tuning: clear the pin")
    ap.add_argument("--revert", type=int, default=None, metavar="EPOCH",
                    help="tuning: request a rollback — the controller "
                    "honors it at its next tick (or skips the action "
                    "at the next server start)")
    ap.add_argument("--stats", action="store_true",
                    help="serve-client: print server stats instead of "
                    "running SQL")
    ap.add_argument("--json", action="store_true",
                    help="lint: machine-readable JSON output "
                    "(same as --format=json)")
    ap.add_argument("--format", default=None, dest="lint_format",
                    choices=["human", "json", "github"],
                    help="lint: output format; `github` emits "
                    "workflow-command annotations (::error ...)")
    ap.add_argument("--changed-only", nargs="?", const="HEAD",
                    default=None, metavar="BASE",
                    help="lint: restrict findings to files in `git "
                    "diff --name-only BASE` (default HEAD) plus "
                    "untracked files; the analysis still covers the "
                    "whole package")
    ap.add_argument("--time-budget", type=float, default=None,
                    help="lint: fail (exit 2) when the analysis wall "
                    "exceeds this many seconds (default: "
                    "time_budget_s in torch-lint.json, 60s)")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="lint: capture current findings into the "
                    "baseline file as accepted debt (stale entries "
                    "are pruned)")
    ap.add_argument("--root", default=None,
                    help="lint: repo root to analyze (default: the "
                    "installed package's parent directory)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve: also serve GET /metrics (Prometheus "
                    "text) over HTTP on this port (0 = ephemeral)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="top: seconds between stats polls")
    ap.add_argument("--iterations", type=int, default=0,
                    help="top: frames to render before exiting "
                    "(0 = until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="top: render exactly one frame and exit")
    ap.add_argument("--rounds", type=int, default=5,
                    help="soak: chaos rounds (fault schedules rotate "
                    "per round)")
    ap.add_argument("--concurrency", type=int, default=8,
                    help="soak: concurrent tenants")
    ap.add_argument("--queries", type=int, default=3,
                    help="soak: queries per tenant per round")
    ap.add_argument("--seed", type=int, default=7,
                    help="soak: deterministic action/schedule seed")
    ap.add_argument("--data", default=None,
                    help="soak: existing data directory (default: "
                    "generate into a temp dir)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="bench-diff: relative regression threshold "
                    "for gating checks (default 0.10)")
    return ap


def _main(argv: List[str]) -> int:
    ap = _parser()
    # intermixed: `serve-client --port N "SELECT ..."` must parse
    args = ap.parse_intermixed_args(argv)
    handler = _HANDLERS.get(args.command)
    if handler is not None:
        return handler(args, ap)
    if args.command == "profile":
        rc = _profile_files(args)
        if rc is not None:
            return rc
    # qualify / profile: offline over an event log, or live SQL
    if args.log:
        print(qualify_log(args.log) if args.command == "qualify"
              else profile_log(args.log))
        return 0
    if not args.sql:
        ap.error("provide SQL text or --log <path>")
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    spark = TorchSparkSession({"spark.rapids.sql.enabled": "true"},
                              device=args.device)
    try:
        for v in args.view:
            name, _, path = v.partition("=")
            spark.read.parquet(path).createOrReplaceTempView(name)
        df = spark.sql(args.sql)
        if args.command == "qualify":
            print(qualify(spark, df).format())
        else:
            print(profile(spark, df).format())
    finally:
        spark.stop()
    return 0


def _lint_main(args, ap) -> int:
    # exit contract: 0 clean / 1 findings / 2 internal error
    from spark_rapids_tpu_torch.lint import run_cli
    return run_cli(root=args.root, as_json=args.json,
                   fix_baseline=args.fix_baseline, fmt=args.lint_format,
                   changed_only=args.changed_only,
                   time_budget=args.time_budget)


def _top_main(args, ap) -> int:
    from spark_rapids_tpu_torch.telemetry.top import run_top
    target = args.sql or (str(args.port) if args.port else None)
    if not target:
        ap.error("top requires the server port (or host:port)")
    host, _, port_s = target.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        ap.error(f"top: not a port: {target!r}")
    return run_top(port, host=host or args.host or "127.0.0.1",
                   interval=args.interval, iterations=args.iterations,
                   once=args.once)


def _soak_main(args, ap) -> int:
    # exit 0 when every round completed with zero hangs, diverged
    # survivors, or post-drain leaks; 1 otherwise
    import json as _json

    from spark_rapids_tpu_torch.soak import run_soak
    report = run_soak(rounds=args.rounds, concurrency=args.concurrency,
                      queries_per_tenant=args.queries, seed=args.seed,
                      data_dir=args.data, device=args.device)
    print(_json.dumps(report, indent=2, default=str))
    return 0 if report["ok"] else 1


def _profile_files(args) -> Optional[int]:
    """`tools profile <path>` renders written profile artifacts; returns
    None when the argument is SQL text (the live profiler runs it)."""
    import os
    # an argument that LOOKS like a path but does not exist is an error,
    # not SQL text
    looks_like_path = bool(args.sql) and (
        os.path.exists(args.sql) or args.sql.endswith(".json")
        or (os.sep in args.sql and " " not in args.sql))
    if looks_like_path and not os.path.exists(args.sql):
        print(f"no such profile file or directory: {args.sql}")
        return 1
    if not looks_like_path:
        return None
    from spark_rapids_tpu_torch.profile import format_profile, read_profiles
    n = 0
    for prof in read_profiles(args.sql):
        if n:
            print()
        print(format_profile(prof, top=args.top))
        n += 1
    if not n:
        print(f"no profile-*.json files in {args.sql}")
        return 1
    return 0


def _trace_main(args, ap) -> int:
    import os
    path = args.sql or args.log
    if not path:
        ap.error("provide a trace file or directory "
                 "(spark.rapids.sql.trace.dir output)")
    # a missing path is an error (exit 1); an existing but empty trace
    # dir is an answer ("no spans found", exit 0)
    if not os.path.exists(path):
        print(f"no such trace file or directory: {path}")
        return 1
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("trace-") and f.endswith(".json"))
        if not files:
            print(f"no spans found (no trace-*.json files in {path})")
            return 0
    else:
        files = [path]
    try:
        if args.command == "hotspots":
            print(hotspots_report(files, top=args.top))
            return 0
        for i, fp in enumerate(files):
            if i:
                print()
            print(format_trace_report(fp, top=args.top))
    except (ValueError, KeyError) as e:  # incl. JSONDecodeError
        print(f"not a readable Chrome-trace file: {e}")
        return 1
    return 0


def write_docs(out: str) -> List[str]:
    """Write the four generated docs under ``out``; returns their paths."""
    import os

    os.makedirs(out, exist_ok=True)
    written = []
    for fname, gen in doc_generators():
        path = os.path.join(out, fname)
        with open(path, "w", encoding="utf-8") as f:
            f.write(gen())
        written.append(path)
    return written


def _docs_main(args, ap) -> int:
    paths = write_docs(args.out)
    print("wrote " + ", ".join(paths))
    return 0


def _parse_since(raw, ap) -> float:
    """`--since` value -> unix-seconds lower bound: a number means that
    many seconds ago, anything else must parse as an ISO timestamp."""
    import datetime
    import time as _t
    try:
        return _t.time() - float(raw)
    except (TypeError, ValueError):
        pass
    try:
        return datetime.datetime.fromisoformat(str(raw)).timestamp()
    except ValueError:
        ap.error(f"--since: not seconds-ago or an ISO timestamp: "
                 f"{raw!r}")


def _history_main(args, ap) -> int:
    """`tools history <dir>`: exit 0 on a rendered report (an empty store
    is an answer), 1 on a missing path."""
    import json as _json
    import os

    from spark_rapids_tpu_torch.telemetry.history import (
        format_history, read_records, signature_aggregates)
    path = args.sql or args.history
    if not path:
        ap.error("history requires the history directory "
                 "(spark.rapids.sql.telemetry.history.dir output)")
    if not os.path.exists(path):
        print(f"no such history file or directory: {path}")
        return 1
    since = _parse_since(args.since, ap) if args.since else None
    sig = args.signature
    if sig and len(sig) == 40:
        records = read_records(path, since=since, tenant=args.tenant,
                               signature=sig)
    else:
        records = read_records(path, since=since, tenant=args.tenant)
        if sig:
            records = [r for r in records
                       if str(r.get("signature", "")).startswith(sig)]
    if args.json:
        print(_json.dumps({
            "records": len(records),
            "signatures": signature_aggregates(records),
        }, indent=2, default=str))
        return 0
    print(format_history(records, top=max(args.top, 10)))
    return 0


def _doctor_main(args, ap) -> int:
    """`tools doctor <queryId|signature> --history <dir>`: exit 0 with a
    verdict, 1 when the selector or the directory does not resolve."""
    import json as _json
    import os

    from spark_rapids_tpu_torch.telemetry.doctor import (
        diagnose, format_diagnosis, format_scan, scan_signatures)
    if not args.sql and not args.all:
        ap.error("doctor requires a queryId or signature selector "
                 "(or --all for the batch scan)")
    if not args.history:
        ap.error("doctor requires --history <dir> "
                 "(spark.rapids.sql.telemetry.history.dir output)")
    if not os.path.exists(args.history):
        print(f"no such history file or directory: {args.history}")
        return 1
    if args.all:
        scans = scan_signatures(args.history, top=max(args.top, 1))
        print(_json.dumps(scans, indent=2, default=str) if args.json
              else format_scan(scans))
        return 0
    d = diagnose(args.history, args.sql)
    print(_json.dumps(d, indent=2, default=str) if args.json
          else format_diagnosis(d))
    return 1 if d.get("error") else 0


def _tuning_main(args, ap) -> int:
    """`tools tuning --history <dir>`: the TuningController's action
    ledger; --pin/--unpin/--revert write control flags into the state
    file, which the controller honors at its next tick. Exit 0 on a
    rendered report, 1 when the directory or the epoch does not
    resolve."""
    import json as _json
    import os

    from spark_rapids_tpu_torch.telemetry.tuning import (
        format_tuning, load_state, save_state)
    path = args.sql or args.history
    if not path:
        ap.error("tuning requires the history directory "
                 "(spark.rapids.sql.telemetry.history.dir output)")
    if not os.path.isdir(path):
        print(f"no such history directory: {path}")
        return 1
    state = load_state(path)
    edits = [(args.pin, "pinned", True), (args.unpin, "pinned", False),
             (args.revert, "revertRequested", True)]
    for epoch, key, value in edits:
        if epoch is None:
            continue
        hit = next((a for a in state.get("actions", [])
                    if int(a.get("epoch", -1)) == epoch), None)
        if hit is None:
            print(f"no tuning action with epoch {epoch}")
            return 1
        hit[key] = value
        save_state(path, state)
        print(f"epoch {epoch}: {key} = {value}")
    if args.json:
        print(_json.dumps(state, indent=2, default=str))
        return 0
    print(format_tuning(state))
    return 0


def _bench_diff_main(args, ap) -> int:
    """`tools bench-diff <a> <b|dir>`: exit 0 when no gating check
    regressed, 1 on regression, 2 on unusable inputs."""
    import json as _json
    import os

    from spark_rapids_tpu_torch.telemetry.bench_diff import (
        DEFAULT_THRESHOLD, bench_diff, format_diff, latest_bench_file)
    if not args.sql or not args.paths:
        ap.error("bench-diff requires <baseline.json> "
                 "<candidate.json | dir>")
    a, b = args.sql, args.paths[0]
    if os.path.isdir(b):
        picked = latest_bench_file(b, exclude=a)
        if picked is None:
            print(f"no BENCH_r*.json files in {b}")
            return 2
        b = picked
    for p in (a, b):
        if not os.path.exists(p):
            print(f"no such bench file: {p}")
            return 2
    try:
        report = bench_diff(
            a, b, threshold=(args.threshold if args.threshold is not None
                             else DEFAULT_THRESHOLD))
    except ValueError as e:
        print(f"bench-diff: {e}")
        return 2
    print(_json.dumps(report, indent=2) if args.json
          else format_diff(report))
    return 1 if report["verdict"] == "regression" else 0


def _serve_main(args, ap) -> int:
    """`tools serve`: run the query server until interrupted. Views from
    --view name=path, confs from --conf key=value; --metrics-port adds
    the Prometheus HTTP twin."""
    import json as _json
    import signal
    import threading

    from spark_rapids_tpu_torch.conf import (SERVE_DRAIN_TIMEOUT_MS,
                                             TorchConf)
    from spark_rapids_tpu_torch.serve import QueryServer
    conf = {"spark.rapids.sql.enabled": "true"}
    for kv in args.conf:
        k, _, v = kv.partition("=")
        conf[k.strip()] = v.strip()
    srv = QueryServer(conf, host=args.host, port=args.port,
                      device=args.device)
    srv.start()
    metrics_port = None
    if args.metrics_port is not None:
        metrics_port = srv.start_metrics_http(args.metrics_port)
    for v in args.view:
        name, _, path = v.partition("=")
        srv.register_view(name, path)
    print(_json.dumps({"event": "serving", "host": srv.host,
                       "port": srv.port, "metricsPort": metrics_port,
                       "views": sorted(v.partition("=")[0]
                                       for v in args.view)}),
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    while not stop.is_set() and not srv._stopping.is_set():
        stop.wait(0.2)
    # graceful drain: in-flight queries finish inside
    # serve.drainTimeoutMs, stragglers are cancelled
    drain_s = max(1.0, int(TorchConf(conf).get(
        SERVE_DRAIN_TIMEOUT_MS)) / 1000.0)
    drained = srv.shutdown(timeout=drain_s)
    print(_json.dumps({"event": "stopped", "drained": drained,
                       **srv.stats()}, default=str), flush=True)
    return 0


def _serve_client_main(args, ap) -> int:
    """`tools serve-client`: one SQL round trip (or --stats) against a
    running server (either package's: the wire is the same)."""
    import json as _json

    from spark_rapids_tpu_torch.serve import ServeClient
    if args.port is None:
        ap.error("serve-client requires --port")
    with ServeClient(args.port, host=args.host or "127.0.0.1",
                     tenant=args.tenant or "default") as c:
        if args.stats:
            print(_json.dumps(c.stats(), indent=2))
            return 0
        if not args.sql:
            ap.error("provide SQL text (or --stats)")
        batch, header = c.sql(args.sql)
        names = [f.name for f in batch.schema.fields]
        print("\t".join(names))
        for row in batch.rows():
            print("\t".join(str(v) for v in row))
        print(_json.dumps({k: header[k] for k in
                           ("rows", "queueWaitMs", "execMs",
                            "planCacheHit") if k in header}))
    return 0


_HANDLERS = {
    "lint": _lint_main, "serve": _serve_main,
    "serve-client": _serve_client_main, "top": _top_main,
    "bench-diff": _bench_diff_main, "history": _history_main,
    "doctor": _doctor_main, "tuning": _tuning_main, "soak": _soak_main,
    "trace": _trace_main, "hotspots": _trace_main, "docs": _docs_main,
}


# -- generated docs ----------------------------------------------------------

def generate_supported_ops() -> str:
    """docs/torch/supported_ops.md: one row per exec and per expression
    rule of the port's rule table, with its conf key, type signature
    (``typesig``) and compatibility notes, derived from the live tables
    so the doc cannot drift from the code."""
    from spark_rapids_tpu_torch import overrides as O
    from spark_rapids_tpu_torch import typesig as TS
    from spark_rapids_tpu_torch.ops import exprs as X
    from spark_rapids_tpu_torch.sql import expressions as E
    lines = [
        "# Supported operators and expressions (PyTorch/CUDA port)",
        "",
        "Generated from the port's rule table "
        "(`python -m spark_rapids_tpu_torch.tools docs`); the per-op "
        "conf keys disable individual replacements, like the "
        "reference's `spark.rapids.sql.exec.*` / "
        "`spark.rapids.sql.expression.*` keys. An operator or "
        "expression that is refused runs on the host with the JAX "
        "package's reason. DECIMAL means precision up to 38 (128-bit) "
        "wherever it appears.",
        "",
        "## Execs",
        "",
        "| Exec | Description | Conf key | Supported types |",
        "|---|---|---|---|",
    ]
    for rule in sorted(O._EXEC_RULES.values(), key=lambda r: r.name):
        lines.append(f"| {rule.name} | {rule.desc} | `{rule.conf_key}` "
                     f"| {TS.sig_of(rule.sig).render()} |")
    lines += [
        "",
        "## Expressions",
        "",
        "| Expression | Conf key | Output types | Input types | Notes |",
        "|---|---|---|---|---|",
    ]
    # every expression the device evaluates: the handlers, and literals
    # (the port folds them into each program instead of a handler)
    for name, cls in sorted((c.__name__, c)
                            for c in list(X._HANDLERS) + [E.Literal]):
        out_sig, in_sig = O._EXPR_SIGS.get(cls, (X.FLAT, X.FLAT))
        note = O.INCOMPAT.get(cls, "")
        lines.append(
            f"| {name} | `spark.rapids.sql.expression.{name}` "
            f"| {TS.sig_of(out_sig).render()} "
            f"| {TS.sig_of(in_sig).render()} | {note} |")
    lines += [
        "",
        "## Parquet device decode (encoding matrix)",
        "",
        "Device decode is the scan path under the `PERFILE` and "
        "`MULTITHREADED` readers: the scan stages still-encoded page "
        "bytes and the hand-written `decodeFused` CUDA kernel "
        "(`spark_rapids_tpu_torch/csrc/decode_fused.cu`) decodes every "
        "device column of a row group in one launch. Cells marked "
        "fallback decode on the host through pyarrow for that column "
        "only (counted in `deviceFallbackColumns`); rows are the same "
        "either way. `COALESCING` keeps the host decode. Compression "
        "is undone on the host.",
        "",
        "| Type | PLAIN | PLAIN_DICTIONARY / RLE_DICTIONARY | "
        "DELTA_BINARY_PACKED / DELTA_LENGTH_BYTE_ARRAY | "
        "BYTE_STREAM_SPLIT | DELTA_BYTE_ARRAY |",
        "|---|---|---|---|---|---|",
        "| BOOLEAN | device (v2 RLE pages too) | n/a | n/a | n/a | n/a |",
        "| INT32 (byte/short/int/date/decimal) | device | device | "
        "device | device | n/a |",
        "| INT64 (long/timestamp-micros/decimal) | device | device | "
        "device | device | n/a |",
        "| INT96 (legacy timestamp) | fallback | fallback | fallback "
        "| fallback | n/a |",
        "| FLOAT | device | device | n/a | device | n/a |",
        "| DOUBLE | device | device | n/a | device | n/a |",
        "| FIXED_LEN_BYTE_ARRAY (decimal64/decimal128) | device | "
        "device | fallback | fallback | n/a |",
        "| BYTE_ARRAY (string/binary) | device | device | device "
        "(DELTA_LENGTH) | n/a | fallback |",
        "| nested (LIST/MAP/STRUCT, repeated) | fallback | fallback "
        "| fallback | fallback | fallback |",
    ]
    return "\n".join(lines) + "\n"


def metric_name_constants() -> List[Tuple[str, str]]:
    """Every metric-name constant defined in the port's metrics.py."""
    from spark_rapids_tpu_torch import metrics as M
    return sorted(
        (n, v) for n, v in vars(M).items()
        if n.isupper() and not n.startswith("_") and isinstance(v, str))


def _conf_rows(pred) -> List[str]:
    from spark_rapids_tpu_torch import conf as C
    return [f"| {e.key} | {C.doc_default(e)} | {e.doc} |"
            for e in sorted(C.registered_entries(), key=lambda e: e.key)
            if pred(e.key)]


def generate_observability_docs() -> str:
    """docs/torch/observability.md: the span model, the trace, profile,
    event-log and telemetry keys, how to read the offline reports, and
    the catalogs (Prometheus families, history fields, doctor verdicts,
    span and instant kinds, metric names) rendered from the live
    tables."""
    from spark_rapids_tpu_torch.metrics import (METRIC_DESCRIPTIONS,
                                                METRIC_PREFIX_DESCRIPTIONS)
    from spark_rapids_tpu_torch.telemetry.doctor import VERDICT_CLASSES
    from spark_rapids_tpu_torch.telemetry.history import \
        HISTORY_FIELD_CATALOG
    from spark_rapids_tpu_torch.telemetry.prometheus import \
        SERVER_FAMILY_HELP
    from spark_rapids_tpu_torch.trace import INSTANT_CATALOG, SPAN_CATALOG
    lines = [
        "# Observability (PyTorch/CUDA port)",
        "",
        "Generated by `python -m spark_rapids_tpu_torch.tools docs`.",
        "",
        "## Span model",
        "",
        "With `spark.rapids.sql.trace.enabled` the engine records spans",
        "`(kind, t0, t1, thread, batch, chip, attrs)` at its choke points",
        "and writes one Chrome-trace JSON file a query",
        "(`trace-<pid>-q<n>.json` under `spark.rapids.sql.trace.dir`), or",
        "keeps them in per-thread rings (`trace.mode=ring`, the query",
        "server's default). Spans time the host: a `kernelDispatch` span",
        "is the enqueue of one hand-written CUDA kernel launch",
        "(`kernel=`, `bucket=` the capacity, `tuned=` whether the",
        "autotuner's winner ran), and a stage's CUDA graph replay is one",
        "`TorchFusedStageExec.dispatch` span whose `kernels` attr names",
        "the kernels the replay launched. Metric timers mirror their",
        "intervals into `<Exec>.<metric>` spans. Both packages read each",
        "other's trace files.",
        "",
        "## Configuration",
        "",
        "| Key | Default | Description |",
        "|---|---|---|",
    ]
    lines += _conf_rows(lambda k: k.startswith((
        "spark.rapids.sql.trace.", "spark.rapids.sql.profile.",
        "spark.rapids.sql.telemetry.", "spark.rapids.sql.eventLog.",
        "spark.rapids.sql.metrics.")) or k == "spark.rapids.sql.explain")
    lines += [
        "",
        "## Reading the offline reports",
        "",
        "`python -m spark_rapids_tpu_torch.tools trace <file-or-dir>`",
        "prints the critical path (the chain of spans that set the",
        "query's wall, idle gaps included), the exclusive self-time of",
        "each span family (nested spans subtracted), the per-card",
        "occupancy of card-attributed spans with the top idle gaps, the",
        "slowest spans and the instant markers.",
        "`tools hotspots <dir>` ranks exclusive self-time across a",
        "trace directory and splits kernel dispatches by (kernel,",
        "capacity bucket), flagging `(untuned)` the dispatches that ran",
        "the kernel's own launch parameters.",
        "`tools profile <file-or-dir>` renders the per-query profile",
        "artifacts (`spark.rapids.sql.profile.dir`); `tools qualify",
        "--log <dir>` and `tools profile --log <dir>` score and profile",
        "event logs; `tools history`, `tools doctor` and `tools tuning`",
        "read the query-history directory.",
        "",
        "## Prometheus families",
        "",
        "| Family | Type | Help |",
        "|---|---|---|",
    ]
    for name, (ftype, help_text) in sorted(SERVER_FAMILY_HELP.items()):
        lines.append(f"| `{name}` | {ftype} | {help_text} |")
    lines += ["", "## Query-history fields", "", "| Field | Meaning |",
              "|---|---|"]
    for fname, fdesc in sorted(HISTORY_FIELD_CATALOG.items()):
        lines.append(f"| `{fname}` | {fdesc} |")
    lines += ["", "## Doctor verdicts", "", "| Verdict | Meaning |",
              "|---|---|"]
    for vname, vdesc in sorted(VERDICT_CLASSES.items()):
        lines.append(f"| `{vname}` | {vdesc} |")
    lines += ["", "## Span and instant kinds", "",
              "| Span kind | Meaning |", "|---|---|"]
    for kind, desc in sorted(SPAN_CATALOG.items()):
        lines.append(f"| `{kind}` | {desc} |")
    lines += ["", "| Instant kind | Meaning |", "|---|---|"]
    for kind, desc in sorted(INSTANT_CATALOG.items()):
        lines.append(f"| `{kind}` | {desc} |")
    lines += ["", "## Metric-name reference", "",
              "| Metric key | Description |", "|---|---|"]
    for name, desc in sorted(METRIC_DESCRIPTIONS.items()):
        lines.append(f"| `{name}` | {desc} |")
    for prefix, desc in sorted(METRIC_PREFIX_DESCRIPTIONS.items()):
        lines.append(f"| `{prefix}*` | {desc} |")
    lines += ["", "| Constant | Metric key |", "|---|---|"]
    for const, name in metric_name_constants():
        lines.append(f"| {const} | `{name}` |")
    return "\n".join(lines) + "\n"


def generate_tuning_docs() -> str:
    """docs/torch/tuning.md: the serving tier's feedback controller (its
    action catalog rendered from ``ACTION_CATALOG``) and the kernel
    autotuner (its grids rendered from ``kernels.autotune._GRIDS``),
    with their keys."""
    from spark_rapids_tpu_torch.kernels.autotune import _GRIDS
    from spark_rapids_tpu_torch.telemetry.tuning import ACTION_CATALOG
    lines = [
        "# Tuning (PyTorch/CUDA port)",
        "",
        "Generated by `python -m spark_rapids_tpu_torch.tools docs`.",
        "",
        "## The serving tier's controller",
        "",
        "With `spark.rapids.sql.serve.tuning.enabled` the query server's",
        "controller reads the query history each tick, acts on a",
        "signature whose doctor verdict repeats, and reverts an action",
        "whose guard window shows no gain. `tools tuning --history <dir>`",
        "lists the actions; `--pin`, `--unpin` and `--revert EPOCH` write",
        "flags the controller honours at its next tick.",
        "",
        "| Action | Trigger verdict | Knob | Bounds | What it does |",
        "|---|---|---|---|---|",
    ]
    for name, cat in sorted(ACTION_CATALOG.items()):
        knobs = cat.get("knobs", [cat["knob"]])
        knob_s = " / ".join(f"`{k}`" for k in knobs)
        lines.append(
            f"| `{name}` | {cat['verdict']} | {knob_s} | "
            f"[{cat['min']}, {cat['max']}] | {cat['doc']} |")
    lines += ["", "| Key | Default | Description |", "|---|---|---|"]
    lines += _conf_rows(
        lambda k: k.startswith("spark.rapids.sql.serve.tuning."))
    lines += [
        "",
        "## The kernel autotuner",
        "",
        "With `spark.rapids.sql.kernel.autotune.enabled` the first launch",
        "of a kernel at a new (kernel, capacity bucket, card) sweeps the",
        "grid below: each candidate is validated against its oracle",
        "(groupbyHash against a numpy group-by, decodeFused byte for byte",
        "against its default launch) and only then timed with CUDA",
        "events; the fastest is recorded in `kernel-autotune.jsonl`",
        "under `spark.rapids.sql.kernel.autotune.dir` and applied when it",
        "beats the default. Off, the table is read-only. The knobs and",
        "the launch arguments they set are in docs/torch/kernels.md.",
        "",
        "| Kernel | Candidates, in sweep order |",
        "|---|---|",
    ]
    for kernel, grid in sorted(_GRIDS.items()):
        cells = ", ".join("`{}`" if not p else "`" + ", ".join(
            f"{k}={v}" for k, v in sorted(p.items())) + "`" for p in grid)
        lines.append(f"| {kernel} | {cells} |")
    lines += ["", "| Key | Default | Description |", "|---|---|---|"]
    lines += _conf_rows(
        lambda k: k.startswith("spark.rapids.sql.kernel."))
    return "\n".join(lines) + "\n"


def doc_generators():
    """(file name, generator) of each generated doc, in `tools docs`
    order."""
    from spark_rapids_tpu_torch.conf import generate_docs
    return (("configs.md", generate_docs),
            ("supported_ops.md", generate_supported_ops),
            ("observability.md", generate_observability_docs),
            ("tuning.md", generate_tuning_docs))


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv[1:]))
