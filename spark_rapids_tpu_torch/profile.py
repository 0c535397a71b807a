"""Per-query profile artifacts: EXPLAIN-ANALYZE plan reports with
per-operator HBM accounting and fallback attribution.

The reference exposes two flagship observability surfaces — the
plan-rewrite explain (``spark.rapids.sql.explain``, every
willNotWorkOnGpu reason surfaced) and per-operator GPU metrics in the
SQL UI. This module unifies their equivalents into ONE structured
artifact per executed query, written as ``profile-<pid>-q<n>.json``
under ``spark.rapids.sql.profile.dir``:

- **plan**: the final physical tree, each node annotated with its full
  metric registry (zero values included — the event-log v2 contract),
  device placement, fused-stage constituents, jit-cache hit/miss and
  retry/spill counters;
- **memory**: the DeviceStore pool watermarks plus the owner-attributed
  per-operator HBM ledger (live/peak bytes per registering exec —
  memory.py threads the owner tag through ``TorchExec.register_spillable``);
- **explain**: the finished RewriteReport — device ops, fallbacks with
  expression-level reasons, operator coverage, reason histogram;
- **conf**: the session's explicit settings (enough to re-run the
  query's configuration offline).

``format_profile`` renders the artifact as an annotated plan tree plus
top-memory-consumers and fallback-summary tables, word for word as the
JAX package's does (docs/observability.md "Reading a query profile"). Profile writing never raises — observability must not take
down execution — and costs nothing when disabled (one conf check after
the query completes; the metrics it serializes are maintained anyway).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

from spark_rapids_tpu_torch.conf import PROFILE_DIR, PROFILE_ENABLED  # noqa: F401

PROFILE_VERSION = 1


# ---------------------------------------------------------------------------
# Artifact construction
# ---------------------------------------------------------------------------

def _node_entry(p) -> Dict[str, Any]:
    """One plan node as a JSON-ready dict; recursive over children,
    fused-stage constituents listed SHALLOW under their stage (their
    child links point back into the chain)."""
    from spark_rapids_tpu_torch.exec.base import TorchExec
    entry: Dict[str, Any] = {
        "op": type(p).__name__,
        "simpleString": p.simple_string(),
        "device": isinstance(p, TorchExec),
    }
    m = getattr(p, "metrics", None)
    if m is not None:
        # ALL created metrics, zero-valued included: 0 output rows is
        # distinguishable from a metric that never existed
        entry["metrics"] = {k: v.value for k, v in m.metrics.items()}
    fused = []
    for op in getattr(p, "fused_ops", []):
        fe: Dict[str, Any] = {"op": type(op).__name__,
                              "simpleString": op.simple_string(),
                              "device": True}
        fm = getattr(op, "metrics", None)
        if fm is not None:
            fe["metrics"] = {k: v.value for k, v in fm.metrics.items()}
        fused.append(fe)
    if fused:
        entry["fused"] = fused
    entry["children"] = [_node_entry(c)
                         for c in getattr(p, "children", [])]
    return entry


def _kernel_summary(physical) -> Dict[str, Dict[str, int]]:
    """Top-level kernel-tier attribution (docs/kernels.md): per-kernel
    dispatch and fallback counts summed across the executed plan, so a
    query that silently rode the XLA-op oracle path (fallbacks > 0, or
    zero dispatches with the tier enabled) is visible in the artifact
    header without grepping per-node metrics."""
    out: Dict[str, Dict[str, int]] = {"dispatches": {}, "fallbacks": {}}

    def add(p) -> None:
        m = getattr(p, "metrics", None)
        if m is None:
            return
        for k, metric in m.metrics.items():
            if not metric.value:
                continue
            for prefix, bucket in (("kernelDispatchCount.",
                                    "dispatches"),
                                   ("kernelFallbacks.", "fallbacks")):
                if k.startswith(prefix):
                    name = k[len(prefix):]
                    out[bucket][name] = \
                        out[bucket].get(name, 0) + metric.value

    seen: set = set()

    def walk(p) -> None:
        # a reused broadcast's subtree counts once
        if id(p) in seen:
            return
        seen.add(id(p))
        add(p)
        for op in getattr(p, "fused_ops", []):
            add(op)
        for c in getattr(p, "children", []):
            walk(c)

    walk(physical)
    return out


def build_profile(physical, report, conf_obj, wall_s: float, rows: int,
                  query_id: int) -> Dict[str, Any]:
    """Assemble the artifact dict from an EXECUTED plan (its registries
    carry the run's metrics), the rewrite report, and the process
    store's ledgers."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.jit_cache import cache_stats
    store = memory._STORE
    prof: Dict[str, Any] = {
        "version": PROFILE_VERSION,
        "queryId": query_id,
        "ts": time.time(),
        "wallSeconds": round(wall_s, 6),
        "outputRows": rows,
        "plan": _node_entry(physical),
        "memory": {
            "pool": store.stats() if store is not None else {},
            "operators": (store.owner_stats()
                          if store is not None else {}),
            "tenants": (store.tenant_stats()
                        if store is not None else {}),
        },
        "kernels": _kernel_summary(physical),
        "jitCaches": cache_stats(),
    }
    if conf_obj is not None:
        from spark_rapids_tpu_torch.conf import SERVE_TENANT_ID
        tenant = str(conf_obj.get(SERVE_TENANT_ID))
        if tenant:
            # serving tenancy: the artifact names the tenant the query
            # executed for (matches the event-log line's field)
            prof["tenant"] = tenant
    if report is not None:
        prof["explain"] = report.summary()
    if conf_obj is not None:
        prof["conf"] = {k: str(v) for k, v
                        in sorted(conf_obj.settings.items())}
    return prof


def write_profile(conf_obj, physical, report, wall_s: float,
                  rows: int, query_id: Optional[int] = None
                  ) -> Optional[str]:
    """Write one profile artifact when profiling is enabled; returns
    the path (None when disabled or on failure — a profile write must
    never break the query). ``query_id`` is the caller-allocated
    process query sequence (event_log.next_query_id), so the artifact
    and the event-log line for one query carry the SAME id."""
    try:
        if conf_obj is None or not bool(conf_obj.get(PROFILE_ENABLED)):
            return None
        from spark_rapids_tpu_torch.event_log import next_query_id
        qid = query_id if query_id is not None else next_query_id()
        prof = build_profile(physical, report, conf_obj, wall_s, rows,
                             qid)
        prof_dir = str(conf_obj.get(PROFILE_DIR))
        os.makedirs(prof_dir, exist_ok=True)
        path = os.path.join(
            prof_dir, f"profile-{os.getpid()}-q{qid:05d}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(prof, f, default=str)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def read_profiles(path: str) -> Iterator[Dict[str, Any]]:
    """Load one profile-*.json file, or every one in a directory."""
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("profile-") and f.endswith(".json"))
    else:
        files = [path]
    for fp in files:
        with open(fp) as f:
            prof = json.load(f)
        prof["_file"] = fp
        yield prof


# ---------------------------------------------------------------------------
# Text rendering
# ---------------------------------------------------------------------------

# metrics shown inline on the tree (in this order) — the ones that
# answer "where did the time/memory go" at a glance; everything else
# prints in the per-node detail only when nonzero
_TREE_METRICS = (
    "numOutputRows", "opTime", "computeAggTime", "sortTime", "joinTime",
    "partitionTime", "copyToDeviceTime", "copyFromDeviceTime",
    "pipelineDrainTime", "peakDeviceMemory", "spillBytes", "retryCount",
    "splitRetryCount", "compileCacheHits", "compileCacheMisses",
    "dispatchCount",
)


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n}B"


def _fmt_metric(name: str, v: int) -> str:
    if name.endswith(("Time", "time")):
        return f"{name}={v / 1e9:.3f}s"
    if "Memory" in name or name.endswith(("Bytes", "bytes")):
        return f"{name}={_fmt_bytes(int(v))}"
    return f"{name}={v}"


def _render_node(entry: Dict[str, Any], lines: List[str],
                 indent: int) -> None:
    pad = " " * indent
    mark = "*" if entry.get("device") else " "
    lines.append(f"{pad}{mark} {entry.get('simpleString', entry['op'])}")
    ms = entry.get("metrics") or {}
    shown = [_fmt_metric(k, ms[k]) for k in _TREE_METRICS
             if ms.get(k)]
    # kernel-tier attribution rides in the headline list: a node whose
    # work went through (or fell back from) a Pallas kernel says so at
    # a glance (docs/kernels.md)
    shown += [_fmt_metric(k, v) for k, v in sorted(ms.items())
              if v and k.startswith(("kernelDispatchCount.",
                                     "kernelFallbacks."))]
    extra = [_fmt_metric(k, v) for k, v in sorted(ms.items())
             if v and k not in _TREE_METRICS
             and not k.startswith(("kernelDispatchCount.",
                                   "kernelFallbacks."))]
    for chunk in (shown, extra):
        if chunk:
            lines.append(pad + "    [" + ", ".join(chunk) + "]")
    for fe in entry.get("fused", []):
        lines.append(f"{pad}    : {fe.get('simpleString', fe['op'])}")
        fms = fe.get("metrics") or {}
        fshown = [_fmt_metric(k, fms[k]) for k in _TREE_METRICS
                  if fms.get(k)]
        fshown += [_fmt_metric(k, v) for k, v in sorted(fms.items())
                   if v and k.startswith(("kernelDispatchCount.",
                                          "kernelFallbacks."))]
        if fshown:
            lines.append(pad + "        [" + ", ".join(fshown) + "]")
    for c in entry.get("children", []):
        _render_node(c, lines, indent + 2)


def format_profile(prof: Dict[str, Any], top: int = 10) -> str:
    """Human-readable report: annotated plan tree, top memory
    consumers, fallback summary (docs/observability.md)."""
    lines = ["=== TPU Query Profile ===",
             f"file: {prof.get('_file', '-')}",
             f"query {prof.get('queryId')}: "
             f"{prof.get('wallSeconds', 0):.3f}s wall, "
             f"{prof.get('outputRows', 0)} rows", "",
             "annotated plan (* = on TPU):"]
    _render_node(prof.get("plan", {"op": "?"}), lines, 2)

    mem = prof.get("memory", {})
    pool = mem.get("pool", {})
    ops = mem.get("operators", {})
    lines += ["", "device memory (owner-attributed HBM accounting):",
              f"  pool: peak {_fmt_bytes(pool.get('peakDeviceBytes', 0))}"
              f", live {_fmt_bytes(pool.get('deviceBytes', 0))}, "
              f"{pool.get('spillCount', 0)} spills "
              f"({_fmt_bytes(pool.get('spilledDeviceBytes', 0))} demoted)"]
    ranked = sorted(ops.items(), key=lambda kv: -kv[1].get("peakBytes", 0))
    if ranked:
        lines.append(f"  {'top memory consumers':36s} "
                     f"{'peak':>10s} {'live':>10s}")
        for owner, st in ranked[:top]:
            lines.append(f"  {owner:36s} "
                         f"{_fmt_bytes(st.get('peakBytes', 0)):>10s} "
                         f"{_fmt_bytes(st.get('liveBytes', 0)):>10s}")
    else:
        lines.append("  (no operator registered spillable batches)")

    kern = prof.get("kernels") or {}
    disp = kern.get("dispatches") or {}
    fb = kern.get("fallbacks") or {}
    if disp or fb:
        parts = []
        if disp:
            parts.append("dispatches " + ", ".join(
                f"{k}={v}" for k, v in sorted(disp.items())))
        if fb:
            parts.append("FALLBACKS " + ", ".join(
                f"{k}={v}" for k, v in sorted(fb.items())))
        lines += ["", "kernel tier (docs/kernels.md): "
                  + "; ".join(parts)]
        if fb:
            lines.append("  (fallback calls rode the XLA-op oracle "
                         "composition — check kernel confs / "
                         "tableSlots)")

    ex = prof.get("explain")
    if ex:
        lines += ["", f"explain: {len(ex.get('deviceOps', []))} ops on "
                  f"TPU, {len(ex.get('fallbacks', []))} fallbacks "
                  f"({ex.get('coverage', 1.0):.0%} coverage)"]
        counts = ex.get("reasonCounts", {})
        if counts:
            lines.append("  fallback reasons (by frequency):")
            for r, c in sorted(counts.items(), key=lambda kv: -kv[1])[:top]:
                lines.append(f"    {c:4d}x {r}")
        for fb in ex.get("fallbacks", [])[:top]:
            lines.append(f"  !Exec <{fb['op']}> stayed on CPU")
    return "\n".join(lines)
