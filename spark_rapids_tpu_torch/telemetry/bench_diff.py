"""``bench_diff(a, b)``: regression tracking across bench
rounds (docs/observability.md "Live telemetry").

The repo accumulates one bench JSON per round (BENCH_r01.json ...);
without a differ the trajectory is loose files a human eyeballs. This
module turns it into an enforced curve: diff the headline rows/s and
the detail legs (device walls, decode overlap, kernel A/B, serving QPS,
tracing/profiling overheads) between two bench outputs against
configurable thresholds, emit a machine-readable verdict, and exit
nonzero on regression — bench.py runs it against the previous round as
part of every bench, and CI can gate on it.

Check semantics: ``a`` is the baseline (older), ``b`` the candidate
(newer). A *gating* check regresses when the candidate is worse than
the baseline by more than the relative threshold in the metric's bad
direction; *informational* checks (CPU-engine walls, retry counters —
environment/workload shaped) report their change but never trip the
verdict.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

DEFAULT_THRESHOLD = 0.10

# (dot path into the bench JSON, direction, gating?, label)
# direction: "higher" = bigger is better (throughput), "lower" =
# smaller is better (walls, overhead ratios)
CHECKS: List[Tuple[str, str, bool, str]] = [
    ("value", "higher", True, "headline q1 rows/s"),
    ("detail.device_wall_s", "lower", True, "q1 device wall"),
    ("detail.tpcds_q3.device_wall_s", "lower", True, "q3 device wall"),
    ("detail.cpu_engine_wall_s", "lower", False, "q1 CPU-engine wall"),
    ("detail.fusion.q1_fusion_speedup", "higher", True,
     "q1 fusion speedup"),
    ("detail.decode.ab.pipelineSpeedup", "higher", True,
     "scan pipeline speedup"),
    ("detail.decode.ab.deviceDecodeSpeedup", "higher", True,
     "device-decode speedup"),
    ("detail.trace.scanOverlap.overlapRatio", "higher", True,
     "scan overlap ratio"),
    ("detail.trace.tracingOverhead", "lower", True,
     "file-tracing overhead"),
    ("detail.profile.profilingOverhead", "lower", True,
     "profiling overhead"),
    ("detail.kernels.wallSpeedup", "higher", True,
     "kernel-tier wall speedup"),
    ("detail.kernels.aggDrainSpeedup", "higher", True,
     "q1 agg-drain speedup"),
    ("detail.kernels.decodeFused.wallSpeedup", "higher", True,
     "fused-decode wall speedup (fused vs chain)"),
    ("detail.kernels.decodeFused.fused.programsPerBatch", "lower", True,
     "fused-decode programs per batch"),
    ("detail.kernels.autotune.warmSweeps", "lower", True,
     "autotune warm-start sweeps (zero when the table holds)"),
    ("detail.kernels.autotune.coldTotal_s", "lower", False,
     "autotune cold-sweep leg wall"),
    ("detail.serving.concurrency.c1.qps", "higher", True,
     "serving QPS @ c=1"),
    ("detail.serving.concurrency.c4.qps", "higher", True,
     "serving QPS @ c=4"),
    ("detail.serving.concurrency.c16.qps", "higher", True,
     "serving QPS @ c=16"),
    ("detail.telemetry.ringOverhead", "lower", True,
     "ring-recorder overhead"),
    ("detail.lifecycle.cancelLatency.p50_s", "lower", False,
     "cancel latency p50"),
    ("detail.lifecycle.cancelLatency.p99_s", "lower", False,
     "cancel latency p99"),
    ("detail.lifecycle.drain.drain_s", "lower", False,
     "graceful-drain wall with in-flight queries"),
    ("detail.lifecycle.quarantine.failFastMs", "lower", False,
     "quarantine fail-fast latency"),
    ("detail.robustness.legs.oomEveryN.retryCount", "lower", False,
     "retries under injected OOM"),
    ("detail.robustness.legs.oomEveryN.slowdown_vs_clean", "lower",
     False, "injected-OOM slowdown"),
    # planned out-of-core (docs/out_of_core.md): the gate is the
    # 1.0/0.0 indicator — raw retryCount can't gate through the
    # va==0 short-circuit below, so bench.py derives the boolean
    ("detail.outOfCore.plannedPathClean", "higher", True,
     "planned out-of-core path stayed retry-free"),
    ("detail.outOfCore.legs.budget10x.slowdown_vs_clean", "lower",
     False, "10x-over-budget slowdown"),
    ("detail.outOfCore.legs.budget10x.plannedPartitions", "lower",
     False, "10x-over-budget planned partitions"),
    ("detail.outOfCore.legs.budget10x.retryCount", "lower", False,
     "10x-over-budget retries (0 on the planned path)"),
    ("detail.adaptive.skew.speedup", "higher", True,
     "skewed-join adaptive speedup"),
    ("detail.adaptive.coalesce.dispatchDelta", "higher", False,
     "AQE coalesce dispatch savings"),
    ("detail.adaptive.batchFusion.qpsSpeedup", "higher", False,
     "same-signature batch-fusion QPS speedup"),
    ("detail.resultCache.replay.warmQps", "higher", True,
     "dashboard-replay warm QPS @ c=16"),
    ("detail.resultCache.replay.qpsSpeedup", "higher", True,
     "result-cache replay QPS speedup (warm vs cold)"),
    ("detail.resultCache.replay.hitRate", "higher", True,
     "result-cache replay hit rate"),
    ("detail.resultCache.subplan.buildSpeedup", "higher", False,
     "subplan-cache join build-time speedup"),
    ("detail.history.appendOverhead", "lower", False,
     "query-history append overhead"),
    ("detail.history.doctor.roundTripMs", "lower", False,
     "tools doctor round-trip latency"),
    ("detail.history.doctor.stormWall_s", "lower", False,
     "forced retry-storm wall (doctor leg)"),
    ("detail.tuning.prewarm.hitOnRestart", "higher", False,
     "tuning pre-warm plan-cache hit on restart"),
    ("detail.tuning.prewarm.restartSpeedup", "higher", False,
     "tuning pre-warm first-request restart speedup"),
    ("detail.tuning.kernelFallback.flipped", "higher", False,
     "tuning kernel-fallback conf flip applied"),
    ("detail.tuning.guard.autoReverted", "higher", False,
     "tuning guardrail auto-revert of the injected harmful action"),
]


def _resolve(doc: Any, dotted: str) -> Optional[float]:
    cur = doc
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def load_bench(path: str) -> Dict:
    """One bench result from any of the shapes it ships in: the bench
    output object itself, a harness wrapper holding it under
    ``parsed`` (or as a JSON line inside ``tail``/stdout text — the
    BENCH_r0*.json layout), or a log whose last JSON line carries a
    ``metric`` field."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        if "metric" in doc:
            return doc
        parsed = doc.get("parsed")
        if isinstance(parsed, dict) and "metric" in parsed:
            return parsed
        tail = doc.get("tail")
        if isinstance(tail, str):
            text = tail
    for line in reversed(text.splitlines()):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            cand = json.loads(line)
        except ValueError:
            continue
        if isinstance(cand, dict) and "metric" in cand:
            return cand
    raise ValueError(f"no bench JSON object found in {path}")


def latest_bench_file(dir_path: str,
                      exclude: Optional[str] = None) -> Optional[str]:
    """The newest BENCH_r*.json in ``dir_path`` by round-name order
    (BENCH_r05 > BENCH_r04), excluding ``exclude`` when given."""
    files = sorted(glob.glob(os.path.join(dir_path, "BENCH_r*.json")))
    if exclude is not None:
        ex = os.path.realpath(exclude)
        files = [f for f in files if os.path.realpath(f) != ex]
    return files[-1] if files else None


def bench_diff(a, b, threshold: float = DEFAULT_THRESHOLD) -> Dict:
    """Diff two bench outputs (paths or already-loaded dicts); returns
    the machine-readable report: ``verdict`` is ``"regression"`` iff
    any gating check worsened beyond ``threshold`` (relative)."""
    a_doc = load_bench(a) if isinstance(a, str) else a
    b_doc = load_bench(b) if isinstance(b, str) else b
    checks: List[Dict] = []
    regressed: List[str] = []
    improved: List[str] = []
    missing: List[str] = []
    for path, direction, gating, label in CHECKS:
        va, vb = _resolve(a_doc, path), _resolve(b_doc, path)
        if va is None or vb is None:
            missing.append(path)
            continue
        if va == 0:
            change = 0.0
        elif direction == "higher":
            change = (vb - va) / abs(va)   # + = better
        else:
            change = (va - vb) / abs(va)   # + = better (smaller wall)
        is_reg = gating and change < -threshold
        entry = {
            "path": path, "label": label, "direction": direction,
            "gating": gating, "a": va, "b": vb,
            "change": round(change, 4), "regressed": is_reg,
        }
        checks.append(entry)
        if is_reg:
            regressed.append(path)
        elif change > threshold:
            improved.append(path)
    return {
        "verdict": "regression" if regressed else "ok",
        "threshold": threshold,
        "a": a if isinstance(a, str) else "<inline>",
        "b": b if isinstance(b, str) else "<inline>",
        "regressed": regressed,
        "improved": improved,
        "missing": missing,
        "checks": checks,
    }


def format_diff(report: Dict) -> str:
    lines = ["=== TPU Bench Diff ===",
             f"baseline:  {report['a']}",
             f"candidate: {report['b']}",
             f"threshold: {report['threshold']:.0%} relative "
             f"(gating checks only)", ""]
    lines.append(f"  {'check':32s} {'baseline':>12s} {'candidate':>12s} "
                 f"{'change':>8s}")
    for c in report["checks"]:
        flag = "REGRESSED" if c["regressed"] else (
            "improved" if c["change"] > report["threshold"] else "")
        gate = "" if c["gating"] else " (info)"
        lines.append(
            f"  {c['label']:32s} {c['a']:12.4f} {c['b']:12.4f} "
            f"{c['change']:+8.1%} {flag}{gate}")
    if report["missing"]:
        lines += ["", f"not comparable ({len(report['missing'])} "
                  f"checks missing a side): "
                  + ", ".join(report["missing"])]
    lines += ["", f"verdict: {report['verdict'].upper()}"]
    return "\n".join(lines)
