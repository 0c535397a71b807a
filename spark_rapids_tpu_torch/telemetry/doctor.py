"""The doctor: automated "why is this query slow" diagnosis over
the query-history store (docs/observability.md "tools doctor").

A slow query's history record, profile artifact, and trace file carry
everything a human would grep for; this module does the grep. Given a
queryId or signature selector it:

1. resolves the target record in the history store;
2. builds the signature's **historical baseline** from the other
   finished records of the same shape (wall p50/p99, mean queue wait,
   retry/fallback/jit-miss rates, mean rows, mean per-stage times from
   their profile artifacts);
3. diffs the target's **per-stage self-times** against that baseline,
   stage by stage (profile-artifact time metrics aggregated by stage
   key — ``retryBlockTime`` -> ``retryBlock`` — with the trace file's
   exclusive self-times as corroborating evidence when present);
4. scores the **verdict taxonomy** below and emits a ranked verdict
   with concrete evidence lines.

The taxonomy (VERDICT_CLASSES renders into the generated doc):
queue-wait vs compile-storm vs retry/spill vs kernel-fallback vs
scan-bound vs genuinely-bigger-input, with ``unknown`` when nothing
diverges enough to blame.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

# the one copy of the trace's exclusive self-times (the doctor's stage
# evidence and `tools trace` read the same numbers)
from spark_rapids_tpu_torch.tools import exclusive_times
from spark_rapids_tpu_torch.telemetry.history import (STATUS_FINISHED,
                                                      find_record,
                                                      read_records,
                                                      sig_digest)

# verdict class -> what it means (the generated observability doc
# renders this table; the doctor's `verdict` field is one of the keys)
VERDICT_CLASSES: Dict[str, str] = {
    "queueWait": "the query spent its time waiting for admission, not "
                 "executing — the server was saturated, not the query "
                 "slow",
    "compileStorm": "jit-cache misses well above the signature's "
                    "baseline — compilation (cold caches, capacity "
                    "eviction, or a shape flip) dominated the wall",
    "retrySpill": "OOM retry / split-retry / spill activity above "
                  "baseline — the retryBlock recovery wall (spill + "
                  "backoff) stretched the query",
    "kernelFallback": "Pallas kernel calls fell back to the XLA-op "
                      "oracle composition above baseline — check "
                      "kernel confs / tableSlots",
    "scanBound": "scan-side stages (decode, prefetch, upload) diverge "
                 "from baseline — input IO/decode got slower, not the "
                 "compute",
    "biggerInput": "the query genuinely processed more data than its "
                   "baseline runs (rows well above baseline, stages "
                   "scaled roughly uniformly)",
    "skewedShuffle": "a materialized exchange in the profile artifact "
                     "is heavily skewed (max partition well above the "
                     "median) — one partition serializes the stage; "
                     "check the aqeActions field / "
                     "spark.rapids.sql.adaptive.skewFactor "
                     "(docs/adaptive.md)",
    "unknown": "no stage or counter diverges enough from the "
               "signature's baseline to name a cause",
}

# stage-name fragments whose divergence indicates a scan-bound /
# compile-bound query (matched as substrings — the profile vocabulary
# is metric stems like `decode`, the trace vocabulary span names like
# `FileScan.decodeTime` / `scanPrefetch`)
_SCAN_FRAGMENTS = ("decode", "scanPrefetch", "uploadAhead",
                   "copyToDevice", "readFileRange")
_COMPILE_FRAGMENTS = ("compile",)


def _profile_stage_times(profile_path: str) -> Dict[str, float]:
    """Per-stage self-times (seconds) from one profile artifact: every
    time metric on every plan node (fused constituents included),
    aggregated by stage key — the metric name with its ``Time`` suffix
    dropped, so ``retryBlockTime`` contributes to stage
    ``retryBlock``."""
    import json
    out: Dict[str, float] = {}
    try:
        with open(profile_path, encoding="utf-8") as f:
            prof = json.load(f)
    except (OSError, ValueError):
        return out

    def add(entry: Dict[str, Any]) -> None:
        for k, v in (entry.get("metrics") or {}).items():
            if not v or not k.endswith(("Time", "time")):
                continue
            stage = k[:-4]
            # metric-mirror names are bare (opTime on every exec);
            # keep them bare so stages aggregate across operators
            out[stage] = out.get(stage, 0.0) + float(v) / 1e9

    def walk(entry: Dict[str, Any]) -> None:
        add(entry)
        for fe in entry.get("fused", []):
            add(fe)
        for c in entry.get("children", []):
            walk(c)

    plan = prof.get("plan")
    if isinstance(plan, dict):
        walk(plan)
    return out


def _profile_exchange_skew(profile_path: str) -> Dict[str, Any]:
    """The WORST exchange-partition skew in one profile artifact:
    max/median partition-byte ratio over every plan node that recorded
    the exchange-stat metrics ``_materialize`` captures
    (docs/adaptive.md). Empty dict when the artifact is unreadable or
    no exchange materialized."""
    import json
    try:
        with open(profile_path, encoding="utf-8") as f:
            prof = json.load(f)
    except (OSError, ValueError):
        return {}
    worst: Dict[str, Any] = {}

    def visit(entry: Dict[str, Any]) -> None:
        m = entry.get("metrics") or {}
        mx = float(m.get("exchangeMaxPartitionBytes", 0))
        med = float(m.get("exchangeMedianPartitionBytes", 0))
        if mx > 0 and med > 0:
            ratio = mx / med
            if ratio > worst.get("ratio", 0.0):
                worst.update({
                    "ratio": round(ratio, 2),
                    "maxBytes": int(mx),
                    "medianBytes": int(med),
                    "node": entry.get("op") or "exchange"})
        for fe in entry.get("fused", []):
            visit(fe)
        for c in entry.get("children", []):
            visit(c)

    plan = prof.get("plan")
    if isinstance(plan, dict):
        visit(plan)
    return worst


def _trace_self_times(trace_path: str) -> Dict[str, float]:
    """Exclusive self-times (seconds) per span family from one trace
    file — corroborating evidence next to the profile-based stage
    diff."""
    try:
        from spark_rapids_tpu_torch.trace import load_trace
        spans = load_trace(trace_path)["spans"]
        return {name: d["exclusive"] / 1e6
                for name, d in exclusive_times(spans).items()}
    except Exception:
        return {}


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def _record_stage_times(rec: Dict[str, Any],
                        use_trace: bool) -> Dict[str, float]:
    """One record's per-stage times from its artifacts: EXCLUSIVE
    self-times per span family when traces are the chosen source
    (nested spans — retryBlock inside operator timers — subtracted, so
    the divergent stage is attributable), profile time metrics
    otherwise."""
    if use_trace:
        tp = rec.get("tracePath")
        if tp and os.path.exists(str(tp)):
            return _trace_self_times(str(tp))
        return {}
    pp = rec.get("profilePath")
    if pp and os.path.exists(str(pp)):
        return _profile_stage_times(str(pp))
    return {}


def _pick_stage_source(target: Dict[str, Any],
                       base: List[Dict[str, Any]]) -> bool:
    """True = use traces. Traces win when the target AND at least one
    baseline record still have trace files on disk (both sides must
    speak one stage vocabulary for the diff to mean anything)."""
    def has_trace(r) -> bool:
        tp = r.get("tracePath")
        return bool(tp) and os.path.exists(str(tp))
    return has_trace(target) and any(has_trace(r) for r in base)


def _baseline(records: List[Dict[str, Any]],
              target: Dict[str, Any]) -> Dict[str, Any]:
    """Aggregate the signature's OTHER finished records into the
    comparison baseline (counter means + mean per-stage times from
    whichever of their artifacts still exist on disk)."""
    from spark_rapids_tpu_torch.lifecycle import percentile
    # an unsignatured target (plan cache off) gets an EMPTY baseline:
    # matching None == None would aggregate unrelated query shapes
    # into a meaningless comparison
    sig = target.get("signature")
    base = [r for r in records
            if sig and r is not target
            and r.get("status") == STATUS_FINISHED
            and r.get("signature") == sig
            # cache-served records carry near-zero walls and no device
            # work — aggregating them would make every real execution
            # look like a regression (docs/caching.md)
            and not r.get("resultCacheHit")]
    walls = [float(r.get("wallSeconds", 0)) for r in base]
    use_trace = _pick_stage_source(target, base)
    stage_sets: List[Dict[str, float]] = []
    for r in base:
        st = _record_stage_times(r, use_trace)
        if st:
            stage_sets.append(st)
    stages: Dict[str, float] = {}
    if stage_sets:
        keys = set()
        for s in stage_sets:
            keys.update(s)
        for k in keys:
            stages[k] = _mean([s.get(k, 0.0) for s in stage_sets])
    return {
        "useTrace": use_trace,
        "count": len(base),
        "wallP50": percentile(walls, 0.50),
        "wallP99": percentile(walls, 0.99),
        "queueWaitMean": _mean(
            [float(r.get("queueWaitSeconds", 0)) for r in base]),
        "retriesMean": _mean(
            [float(r.get("retryCount", 0)
                   + r.get("splitRetryCount", 0)) for r in base]),
        "spillBytesMean": _mean(
            [float(r.get("spillBytes", 0)) for r in base]),
        "fallbacksMean": _mean(
            [float(r.get("kernelFallbacks", 0)) for r in base]),
        "jitMissesMean": _mean(
            [float(r.get("jitMisses", 0)) for r in base]),
        "rowsMean": _mean(
            [float(r.get("outputRows", 0)) for r in base]),
        "stages": stages,
        "stagedRuns": len(stage_sets),
    }


def _stage_diff(target_stages: Dict[str, float],
                base_stages: Dict[str, float]
                ) -> List[Dict[str, float]]:
    keys = set(target_stages) | set(base_stages)
    rows = []
    for k in keys:
        t = target_stages.get(k, 0.0)
        b = base_stages.get(k, 0.0)
        rows.append({"stage": k, "targetS": round(t, 4),
                     "baselineS": round(b, 4),
                     "deltaS": round(t - b, 4)})
    rows.sort(key=lambda r: -r["deltaS"])
    return rows


def diagnose(history_dir: str, selector: str) -> Dict[str, Any]:
    """Run the full diagnosis; returns the machine-readable report
    (``format_diagnosis`` renders it). ``error`` is set when the
    selector does not resolve."""
    records = read_records(history_dir)
    target = find_record(records, selector)
    if target is None:
        return {"error": f"no history record matches {selector!r} "
                         f"in {history_dir}"}
    return diagnose_record(records, target)


def diagnose_record(records: List[Dict[str, Any]],
                    target: Dict[str, Any]) -> Dict[str, Any]:
    """Diagnose one already-resolved record against an already-loaded
    record list — the store is read ONCE however many signatures the
    batch scan walks."""
    sig = target.get("signature")
    base = _baseline(records, target)

    wall = float(target.get("wallSeconds", 0))
    queue_wait = float(target.get("queueWaitSeconds", 0))
    retries = float(target.get("retryCount", 0)
                    + target.get("splitRetryCount", 0))
    spill = float(target.get("spillBytes", 0))
    fallbacks = float(target.get("kernelFallbacks", 0))
    jit_misses = float(target.get("jitMisses", 0))
    rows = float(target.get("outputRows", 0))

    target_stages = _record_stage_times(target, base["useTrace"])
    diff = _stage_diff(target_stages, base["stages"]) \
        if target_stages else []
    divergent = diff[0]["stage"] if diff and diff[0]["deltaS"] > 0 \
        else None
    # a stage can only "explain the regression" when there IS one: the
    # target must be meaningfully slower than its baseline p50, or the
    # share denominators would divide run-to-run jitter by epsilon and
    # confidently blame a stage on a perfectly normal run
    wall_delta = wall - base["wallP50"]
    regressed = base["count"] > 0 and base["wallP50"] > 0 and \
        wall_delta > max(0.01, 0.05 * base["wallP50"])

    def stage_share(fragments: Tuple[str, ...]) -> float:
        """Fraction of the wall regression explained by stages whose
        name contains one of the fragments (substring match bridges
        the profile-metric and trace-span vocabularies); 0 when the
        query did not regress against its baseline."""
        if not regressed:
            return 0.0
        d = sum(r["deltaS"] for r in diff
                if r["deltaS"] > 0 and any(
                    f.lower() in r["stage"].lower()
                    for f in fragments))
        return min(1.0, d / wall_delta)

    verdicts: List[Dict[str, Any]] = []

    def verdict(cls: str, score: float, evidence: List[str]) -> None:
        if score > 0:
            verdicts.append({"class": cls, "score": round(score, 4),
                             "evidence": evidence})

    # queue-wait: the time went to admission, not execution
    total = wall + queue_wait
    qfrac = queue_wait / total if total > 0 else 0.0
    if qfrac > 0.4 and queue_wait > 2 * max(base["queueWaitMean"],
                                            1e-3):
        verdict("queueWait", qfrac, [
            f"queue wait {queue_wait:.3f}s is {qfrac:.0%} of the "
            f"request (baseline mean {base['queueWaitMean']:.3f}s)"])

    # compile-storm: jit misses well over baseline
    if jit_misses > max(2 * base["jitMissesMean"], base["jitMissesMean"]
                        + 2) and jit_misses > 0:
        verdict("compileStorm",
                0.5 + 0.5 * stage_share(_COMPILE_FRAGMENTS), [
                    f"jit-cache misses {jit_misses:.0f} vs baseline "
                    f"mean {base['jitMissesMean']:.1f}"])

    # retry/spill: retries or spill bytes over baseline; the
    # retryBlock stage divergence is the smoking gun
    if retries > base["retriesMean"] + 0.5 or \
            spill > 2 * max(base["spillBytesMean"], 1.0):
        share = stage_share(("retryBlock",))
        ev = [f"retries {retries:.0f} vs baseline mean "
              f"{base['retriesMean']:.1f}; spill "
              f"{spill:.0f}B vs mean {base['spillBytesMean']:.0f}B"]
        for r in diff:
            if r["stage"] == "retryBlock" and r["deltaS"] > 0:
                ev.append(
                    f"retryBlock self-time {r['targetS']:.3f}s vs "
                    f"baseline {r['baselineS']:.3f}s "
                    f"(+{r['deltaS']:.3f}s — the divergent stage)")
        score = 0.5 + 0.5 * share
        poc = target.get("plannedOutOfCore") or {}
        if poc.get("plannedPartitions") and \
                retries <= base["retriesMean"] + 0.5:
            # spill without retries under an engaged budget oracle is
            # PLANNED out-of-core activity, not thrash — rank this
            # verdict below biggerInput (docs/out_of_core.md)
            score *= 0.3
            ev.append(
                f"spill was planned out-of-core activity "
                f"(plannedPartitions="
                f"{poc['plannedPartitions']:.0f}, retries stayed at "
                f"baseline) — not retry thrash")
        elif retries > max(2.0, 2 * base["retriesMean"] + 1.0):
            ev.append(
                "repeated retry storm — set "
                "spark.rapids.sql.memory.deviceBudgetBytes and "
                "spark.rapids.sql.outOfCore.enabled so joins/aggs "
                "partition up front instead of riding the "
                "spill-and-retry loop (docs/out_of_core.md)")
        verdict("retrySpill", score, ev)

    # kernel-fallback: the oracle ride, with the culprit kernel(s)
    # named from the record's per-kernel counters so the operator
    # checks ONE conf instead of the whole kernel tier
    if fallbacks > base["fallbacksMean"] + 0.5:
        ev = [f"kernel fallbacks {fallbacks:.0f} vs baseline mean "
              f"{base['fallbacksMean']:.1f} — check kernel confs / "
              f"tableSlots"]
        by_name = target.get("kernelFallbacksByName") or {}
        for name, n in sorted(by_name.items(),
                              key=lambda kv: (-kv[1], kv[0])):
            ev.append(f"{name}: {n:.0f} fallback(s) — check "
                      f"spark.rapids.sql.kernel.{name}.enabled "
                      f"and its tuning confs")
        verdict("kernelFallback", 0.4, ev)

    # scan-bound: scan-side stages own the regression
    scan_share = stage_share(_SCAN_FRAGMENTS)
    if scan_share > 0.4:
        verdict("scanBound", scan_share, [
            f"scan stages explain {scan_share:.0%} of the wall "
            f"regression"])

    # skewed-shuffle: one exchange partition dwarfs the median in the
    # target's profile artifact — that partition serializes the stage
    # regardless of baseline comparisons (the stats come straight from
    # the _materialize capture, docs/adaptive.md)
    pp = target.get("profilePath")
    skew = _profile_exchange_skew(str(pp)) \
        if pp and os.path.exists(str(pp)) else {}
    if skew.get("ratio", 0.0) >= 4.0:
        ev = [f"{skew['node']}: max partition {skew['maxBytes']}B is "
              f"{skew['ratio']:.1f}x the median "
              f"({skew['medianBytes']}B)"]
        acts = target.get("aqeActions") or {}
        if acts.get("aqeSkewSplits"):
            ev.append(f"AQE already split it "
                      f"(aqeSkewSplits={acts['aqeSkewSplits']}) — "
                      f"the ratio is pre-split")
        elif acts:
            ev.append(f"aqeActions={acts} (no skew split fired — "
                      f"check adaptive.skewFactor)")
        else:
            ev.append("no aqeActions on record — check "
                      "spark.rapids.sql.adaptive.enabled/skewFactor")
        verdict("skewedShuffle",
                min(1.0, 0.3 + skew["ratio"] / 40.0), ev)

    # genuinely-bigger-input: rows well over baseline, stages
    # scaled roughly uniformly (no single stage owns the regression)
    if base["rowsMean"] > 0 and rows > 1.5 * base["rowsMean"]:
        uniform = 1.0
        if diff and regressed:
            top = max((r["deltaS"] for r in diff), default=0.0)
            uniform = 1.0 - min(1.0, max(0.0, top / wall_delta - 0.5))
        ev = [f"output rows {rows:.0f} vs baseline mean "
              f"{base['rowsMean']:.0f}"]
        score = 0.3 + 0.4 * uniform
        poc = target.get("plannedOutOfCore") or {}
        if poc.get("plannedPartitions"):
            # the budget oracle engaged: the run paid a planned
            # partition pass for a working set over budget — direct
            # evidence the input genuinely grew (docs/out_of_core.md)
            score = min(1.0, score + 0.3)
            ev.append(
                f"planned out-of-core engaged (plannedPartitions="
                f"{poc['plannedPartitions']:.0f}, "
                f"budgetPressurePeak="
                f"{poc.get('budgetPressurePeak', 0):.0f}) — the "
                f"working set outgrew the device budget")
        verdict("biggerInput", score, ev)

    verdicts.sort(key=lambda v: -v["score"])
    return {
        "queryId": target.get("queryId"),
        "signature": sig_digest(sig) if sig else None,
        "status": target.get("status"),
        "tenant": target.get("tenant"),
        "wallSeconds": wall,
        "queueWaitSeconds": queue_wait,
        "baseline": {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in base.items() if k != "stages"},
        "slowdown": round(wall / base["wallP50"], 4)
        if base["wallP50"] > 0 else None,
        "regressed": regressed,
        "stageDiff": diff[:12],
        "divergentStage": divergent,
        "exchangeSkew": skew,
        "aqeActions": target.get("aqeActions") or {},
        "traceSelfTimes": _trace_self_times(target["tracePath"])
        if target.get("tracePath")
        and os.path.exists(str(target.get("tracePath"))) else {},
        "verdicts": verdicts,
        "verdict": verdicts[0]["class"] if verdicts else "unknown",
    }


def scan_signatures(history_dir: str, top: int = 10
                    ) -> List[Dict[str, Any]]:
    """Batch doctor (`tools doctor --all`; the TuningController's scan
    loop runs the same walk): diagnose the NEWEST executed finished
    record of every signature in the store against that signature's
    baseline and rank regressed shapes worst-first (regressed before
    not, then by slowdown). One store read covers the whole scan."""
    records = read_records(history_dir)
    newest: Dict[str, Dict[str, Any]] = {}
    for r in records:  # chronological — the last write wins
        sig = r.get("signature")
        if not sig or r.get("status") != STATUS_FINISHED \
                or r.get("resultCacheHit"):
            continue
        newest[sig] = r
    scans: List[Dict[str, Any]] = []
    for sig, rec in newest.items():
        d = diagnose_record(records, rec)
        d["signatureFull"] = sig
        scans.append(d)
    scans.sort(key=lambda d: (not d.get("regressed"),
                              -(d.get("slowdown") or 0.0),
                              d.get("signature") or ""))
    return scans[:max(1, int(top))]


def format_scan(scans: List[Dict[str, Any]]) -> str:
    """The `tools doctor --all` table: one row per scanned signature,
    worst regression first."""
    lines = ["=== TPU Query Doctor (batch scan) ===",
             f"{len(scans)} signature(s) scanned", ""]
    if not scans:
        lines.append("no finished signatured records found")
        return "\n".join(lines)
    lines.append(
        f"  {'signature':14s} {'tenant':10s} {'verdict':14s} "
        f"{'x p50':>7s} {'wall_s':>8s} {'base_p50':>9s}  "
        f"divergent stage")
    for d in scans:
        slow = d.get("slowdown")
        b = d.get("baseline", {})
        mark = " <-- regressed" if d.get("regressed") else ""
        lines.append(
            f"  {d.get('signature') or '-':14s} "
            f"{(d.get('tenant') or '-'):10s} "
            f"{d.get('verdict'):14s} "
            f"{(f'{slow:.2f}' if slow else '-'):>7s} "
            f"{d.get('wallSeconds', 0):8.3f} "
            f"{b.get('wallP50', 0):9.3f}  "
            f"{d.get('divergentStage') or '-'}{mark}")
    return "\n".join(lines)


def format_diagnosis(d: Dict[str, Any]) -> str:
    if d.get("error"):
        return f"doctor: {d['error']}"
    lines = ["=== TPU Query Doctor ===",
             f"query {d.get('queryId')} "
             f"(signature {d.get('signature')}, "
             f"tenant {d.get('tenant') or '-'}): "
             f"status {d.get('status')}, "
             f"{d.get('wallSeconds', 0):.3f}s wall, "
             f"{d.get('queueWaitSeconds', 0):.3f}s queued"]
    b = d.get("baseline", {})
    lines.append(
        f"baseline: {b.get('count', 0)} finished runs, "
        f"p50 {b.get('wallP50', 0):.3f}s, p99 {b.get('wallP99', 0):.3f}s"
        + (f"  (this run: {d['slowdown']:.2f}x p50)"
           if d.get("slowdown") else ""))
    lines.append(f"verdict: {d.get('verdict')} — "
                 f"{VERDICT_CLASSES.get(d.get('verdict'), '')}")
    for v in d.get("verdicts", []):
        lines.append(f"  [{v['score']:.2f}] {v['class']}")
        for ev in v["evidence"]:
            lines.append(f"         {ev}")
    diff = d.get("stageDiff", [])
    if diff:
        lines += ["", "stage-by-stage vs the signature baseline "
                  "(profile self-times, seconds):",
                  f"  {'stage':28s} {'this run':>9s} {'baseline':>9s} "
                  f"{'delta':>9s}"]
        for r in diff:
            mark = "  <-- divergent" \
                if r["stage"] == d.get("divergentStage") else ""
            lines.append(f"  {r['stage']:28s} {r['targetS']:9.3f} "
                         f"{r['baselineS']:9.3f} "
                         f"{r['deltaS']:+9.3f}{mark}")
    return "\n".join(lines)
