"""Prometheus text exposition of the process metric registries and the
QueryServer stats (docs/observability.md "Live telemetry").

Two kinds of families:

- **engine metrics** — every metric key the registries carry, exported
  as ``srt_<snake_case>`` (prefix families like
  ``kernelFallbacks.groupbyHash`` become one family with a ``key``
  label; ``*Time`` metrics convert ns -> seconds with a
  ``_seconds_total`` suffix). HELP text comes from
  ``metrics.describe_metric`` — a key that does not resolve is NOT
  exported (it is counted in ``srt_undescribed_metric_keys``, asserted
  zero by tier-1), so the endpoint cannot drift from the documented
  metric tables.
- **server families** — admission/tenant/cache/store/trigger gauges and
  counters with names and HELP from :data:`SERVER_FAMILY_HELP` (the
  JAX package's table, word for word), so names can't drift either.

Scrapes go through a **registry-delta aggregator**: per-live-registry
snapshots are cached and re-read only when the registry's summed
mutation counter changed, and a registry that is garbage-collected with
its plan folds its last snapshot into a retired base — counters stay
MONOTONE across plan lifetimes (a Prometheus `rate()` works), and a
scrape costs O(changed registries), not O(every metric ever created).
"""

from __future__ import annotations

import re
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

# name -> (prom type, help). Every literal family name emitted below
# MUST be a key here; the observability doc's
# Prometheus table is generated from this dict.
SERVER_FAMILY_HELP: Dict[str, Tuple[str, str]] = {
    "srt_queries_ok_total": ("counter", "queries served successfully"),
    "srt_queries_err_total": ("counter", "queries that failed"),
    "srt_queries_cancelled_total": (
        "counter", "queries that terminated cancelled (cancel verb, "
                   "deadline, disconnect, watchdog, or drain)"),
    "srt_queries_quarantined_total": (
        "counter", "queries failed fast by the poison-query "
                   "quarantine"),
    "srt_uptime_seconds": ("gauge", "server uptime in seconds"),
    "srt_qps": ("gauge", "successful queries per second since server "
                         "start"),
    "srt_admission_in_flight": ("gauge", "queries executing right now"),
    "srt_admission_queued": ("gauge", "queries waiting for admission"),
    "srt_admission_admitted_total": ("counter",
                                     "queries admitted to execute"),
    "srt_admission_rejected_total": ("counter",
                                     "queries rejected (queue full or "
                                     "shutdown)"),
    "srt_admission_throttled_waits_total": (
        "counter", "admissions delayed by the fair-share HBM throttle"),
    "srt_tenant_admitted_total": ("counter",
                                  "queries admitted per tenant"),
    "srt_tenant_rejected_total": ("counter",
                                  "queries rejected per tenant"),
    "srt_tenant_in_flight": ("gauge", "queries executing per tenant"),
    "srt_tenant_queue_wait_ms": ("gauge",
                                 "admission queue wait quantiles per "
                                 "tenant (ms)"),
    "srt_tenant_latency_ms": ("gauge",
                              "end-to-end latency quantiles per "
                              "tenant (ms)"),
    "srt_tenant_hbm_live_bytes": ("gauge",
                                  "live device-store bytes per tenant"),
    "srt_tenant_hbm_peak_bytes": ("gauge",
                                  "peak device-store bytes per tenant"),
    "srt_tenant_hbm_spill_bytes_total": (
        "counter", "device bytes spilled from the tenant's working "
                   "set"),
    "srt_jit_cache_hits_total": ("counter",
                                 "compile-cache hits per cache"),
    "srt_jit_cache_misses_total": ("counter",
                                   "compile-cache misses per cache"),
    "srt_jit_cache_evictions_total": ("counter",
                                      "compile-cache evictions per "
                                      "cache"),
    "srt_jit_cache_contention_total": (
        "counter", "threads that blocked on another thread's "
                   "in-progress compile"),
    "srt_jit_cache_size": ("gauge", "entries live per compile cache"),
    "srt_store_device_bytes": ("gauge",
                               "device-store live HBM bytes"),
    "srt_store_peak_device_bytes": ("gauge",
                                    "device-store peak HBM bytes"),
    "srt_store_host_bytes": ("gauge", "device-store host-tier bytes"),
    "srt_store_spill_count_total": ("counter",
                                    "device->host store demotions"),
    "srt_store_spilled_device_bytes_total": (
        "counter", "HBM bytes demoted device->host"),
    "srt_store_disk_files_live": ("gauge",
                                  "disk-tier spill files believed "
                                  "live"),
    "srt_telemetry_triggers_fired_total": (
        "counter", "telemetry trigger firings per trigger"),
    "srt_telemetry_triggers_rate_limited_total": (
        "counter", "trigger firings suppressed by the per-trigger "
                   "rate limit"),
    "srt_telemetry_bundles_pruned_total": (
        "counter", "telemetry artifacts (bundles + ring dumps) "
                   "pruned by the maxBundles/maxBundleBytes "
                   "retention"),
    "srt_slo_objective_p99_ms": (
        "gauge", "per-tenant SLO p99 objective in ms "
                 "(serve.slo.p99Ms[.<tenant>])"),
    "srt_slo_observed_p99_ms": (
        "gauge", "observed p99 wall in ms over the SLO window per "
                 "tenant (query history)"),
    "srt_slo_window_queries": (
        "gauge", "finished queries inside the SLO window per tenant"),
    "srt_slo_window_violations": (
        "gauge", "queries over the tenant's SLO objective inside the "
                 "window"),
    "srt_slo_burn_ratio": (
        "gauge", "fraction of the tenant's window queries over its "
                 "SLO objective"),
    "srt_tuning_ticks_total": (
        "counter", "TuningController scan ticks run (start-of-server "
                   "scan included; docs/tuning.md)"),
    "srt_tuning_actions_total": (
        "counter", "tuning actions applied, labeled by ACTION_CATALOG "
                   "action name"),
    "srt_tuning_reverts_total": (
        "counter", "tuning actions rolled back (guardrail "
                   "auto-reverts + operator reverts via tools "
                   "tuning)"),
    "srt_tuning_active_actions": (
        "gauge", "actions currently in effect (state applied or "
                 "accepted)"),
    "srt_tuning_pinned_actions": (
        "gauge", "actions pinned by the operator (exempt from the "
                 "guardrail's auto-revert)"),
    "srt_tuning_prewarmed_signatures": (
        "gauge", "signatures in the pre-warm ledger (plan templates "
                 "replayed at server start and protected from LRU "
                 "eviction)"),
    "srt_undescribed_metric_keys": (
        "gauge", "registry metric keys that did not resolve via "
                 "describe_metric and were NOT exported (must be 0)"),
    "srt_aqe_batch_fused_queries_total": (
        "counter", "queries served out of same-signature fused "
                   "batches of size >= 2 (docs/adaptive.md)"),
    "srt_aqe_batch_fusion_batches_total": (
        "counter", "fused batches of size >= 2 executed under one "
                   "admission slot"),
    "srt_cache_result_hits_total": (
        "counter", "queries served verbatim from the result cache "
                   "(zero device work; docs/caching.md)"),
    "srt_cache_result_misses_total": (
        "counter", "result-cache probes that fell through to "
                   "execution"),
    "srt_cache_result_entries": (
        "gauge", "result-cache entries resident"),
    "srt_cache_result_bytes": (
        "gauge", "Arrow IPC payload bytes held by the result cache"),
    "srt_cache_result_invalidations_total": (
        "counter", "result-cache entries dropped because an input "
                   "file fingerprint or the view generation changed"),
    "srt_cache_result_evictions_total": (
        "counter", "result-cache entries evicted by the LRU bounds"),
    "srt_cache_subplan_hits_total": (
        "counter", "join build tables reused from the subplan cache "
                   "(docs/caching.md)"),
    "srt_cache_subplan_misses_total": (
        "counter", "subplan-cache probes that fell through to a "
                   "build"),
    "srt_cache_subplan_entries": (
        "gauge", "device-resident build tables held by the subplan "
                 "cache"),
    "srt_cache_subplan_bytes": (
        "gauge", "HBM bytes held by cached build tables (evict-first "
                 "under pool pressure)"),
    "srt_cache_subplan_invalidations_total": (
        "counter", "cached build tables dropped because an input "
                   "file fingerprint changed"),
    "srt_cache_subplan_evictions_total": (
        "counter", "cached build tables evicted (LRU bounds or "
                   "device-pool pressure drop)"),
}


# ---------------------------------------------------------------------------
# Registry-delta aggregator
# ---------------------------------------------------------------------------

class RegistryAggregator:
    """Monotone totals over every MetricRegistry the process ever
    created: ``metrics.retired_totals()`` (each registry's FINAL
    values, folded in by a metrics.py finalizer when the registry is
    garbage-collected with its plan — a query completing between two
    scrapes still counts) plus the live registries, whose snapshots are
    cached and re-read only when their summed metric-mutation counters
    changed."""

    def __init__(self):
        self._lock = threading.Lock()
        # id(registry) -> [version_sum, snapshot]; dropped at GC (the
        # dead registry's contribution moves to the retired base)
        self._cache: Dict[int, List] = {}
        self._finalized: set = set()

    def _drop(self, rid: int) -> None:
        # finalize path: runs at arbitrary allocation points, so no
        # locks — dict.pop / set.discard are atomic under the GIL
        self._cache.pop(rid, None)
        self._finalized.discard(rid)

    @staticmethod
    def _read(reg) -> Optional[Tuple[int, Dict[str, int]]]:
        """(version sum, snapshot) of one registry; None when a
        concurrent create() mutated the metric dict mid-read (the
        caller reuses the cached snapshot — next scrape catches up)."""
        for _ in range(4):
            try:
                vsum = 0
                snap: Dict[str, int] = {}
                for k, m in reg.metrics.items():
                    vsum += m.version
                    snap[k] = m.value
                return vsum + len(snap), snap
            except RuntimeError:
                continue
        return None

    def scrape(self) -> Tuple[Dict[str, int], int]:
        """(folded totals per metric key — sums for counters, max for
        watermark metrics — and the count of changed registries re-read
        this scrape)."""
        from spark_rapids_tpu_torch.metrics import (fold_metric,
                                                    live_registries,
                                                    retired_totals)
        regs = live_registries()
        changed = 0
        with self._lock:
            totals = retired_totals()
            for reg in regs:
                rid = id(reg)
                entry = self._cache.get(rid)
                if entry is None:
                    entry = [-1, {}]
                    self._cache[rid] = entry
                    if rid not in self._finalized:
                        self._finalized.add(rid)
                        weakref.finalize(reg, self._drop, rid)
                got = self._read(reg)
                if got is not None and got[0] != entry[0]:
                    entry[0], entry[1] = got
                    changed += 1
                for k, v in entry[1].items():
                    fold_metric(totals, k, v)
        return totals, changed


_AGG = RegistryAggregator()


def aggregator() -> RegistryAggregator:
    return _AGG


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

_SNAKE_RE = re.compile(r"([a-z0-9])([A-Z])")


def prom_name(key: str) -> str:
    """camelCase metric base -> srt_snake_case."""
    s = _SNAKE_RE.sub(r"\1_\2", key).lower()
    return "srt_" + re.sub(r"[^a-z0-9_]", "_", s)


def engine_family(key: str) -> Tuple[str, Optional[Tuple[str, str]],
                                     bool, bool]:
    """(family name, optional (label, value), is_seconds, is_gauge)
    for one registry metric key. Prefix-family members
    (``base.member``) share one family with a ``key`` label; watermark
    metrics are gauges (max-folded by the aggregator), everything else
    a ``_total`` counter."""
    from spark_rapids_tpu_torch.metrics import is_watermark_metric
    base, dot, rest = key.partition(".")
    label = ("key", rest) if dot else None
    seconds = base.endswith(("Time", "time"))
    name = prom_name(base)
    if seconds:
        name += "_seconds"
    gauge = is_watermark_metric(base)
    if not gauge:
        name += "_total"
    return name, label, seconds, gauge


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


class _Out:
    """Family-grouped exposition writer: HELP/TYPE once per family,
    samples in emission order."""

    def __init__(self):
        self._fams: "Dict[str, List[str]]" = {}
        self._meta: Dict[str, Tuple[str, str]] = {}

    def family(self, name: str, ftype: str, help_text: str) -> None:
        self._meta.setdefault(name, (ftype, help_text))
        self._fams.setdefault(name, [])

    def sample(self, name: str, value, labels: Dict[str, Any] = None
               ) -> None:
        lab = ""
        if labels:
            lab = "{" + ",".join(
                f'{k}="{_escape(v)}"'
                for k, v in sorted(labels.items())) + "}"
        if isinstance(value, float):
            sval = repr(round(value, 9))
        else:
            sval = str(int(value))
        self._fams.setdefault(name, []).append(f"{name}{lab} {sval}")

    def text(self) -> str:
        lines: List[str] = []
        for name in sorted(self._fams):
            ftype, help_text = self._meta.get(name, ("untyped", ""))
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {ftype}")
            lines.extend(self._fams[name])
        return "\n".join(lines) + "\n"


def _emit_server(out: "_Out", name: str, value,
                 labels: Dict[str, Any] = None) -> None:
    ftype, help_text = SERVER_FAMILY_HELP[name]
    out.family(name, ftype, help_text)
    out.sample(name, value, labels)


def render_prometheus(server_stats: Optional[Dict] = None) -> str:
    """The full exposition: engine registry totals + store/jit-cache/
    trigger process families + (when given) the QueryServer's
    admission/tenant stats."""
    from spark_rapids_tpu_torch import memory
    from spark_rapids_tpu_torch.jit_cache import cache_stats
    from spark_rapids_tpu_torch.metrics import describe_metric
    from spark_rapids_tpu_torch.telemetry import triggers as _triggers
    out = _Out()

    totals, _changed = _AGG.scrape()
    undescribed = 0
    for key in sorted(totals):
        desc = describe_metric(key)
        if desc is None:
            undescribed += 1
            continue
        name, label, seconds, gauge = engine_family(key)
        out.family(name, "gauge" if gauge else "counter", desc)
        value = totals[key] / 1e9 if seconds else totals[key]
        out.sample(name, float(value) if seconds else value,
                   dict([label]) if label else None)
    _emit_server(out, "srt_undescribed_metric_keys", undescribed)

    store = memory._STORE
    if store is not None:
        st = store.stats()
        _emit_server(out, "srt_store_device_bytes", st["deviceBytes"])
        _emit_server(out, "srt_store_peak_device_bytes",
                     st["peakDeviceBytes"])
        _emit_server(out, "srt_store_host_bytes", st["hostBytes"])
        _emit_server(out, "srt_store_spill_count_total",
                     st["spillCount"])
        _emit_server(out, "srt_store_spilled_device_bytes_total",
                     st["spilledDeviceBytes"])
        _emit_server(out, "srt_store_disk_files_live",
                     st["diskFilesLive"])
        for tenant, ts in store.tenant_stats().items():
            lab = {"tenant": tenant}
            _emit_server(out, "srt_tenant_hbm_live_bytes",
                         ts["liveBytes"], lab)
            _emit_server(out, "srt_tenant_hbm_peak_bytes",
                         ts["peakBytes"], lab)
            _emit_server(out, "srt_tenant_hbm_spill_bytes_total",
                         ts["spillBytes"], lab)

    for cache, cs in sorted(cache_stats().items()):
        lab = {"cache": cache}
        _emit_server(out, "srt_jit_cache_hits_total", cs["hits"], lab)
        _emit_server(out, "srt_jit_cache_misses_total", cs["misses"],
                     lab)
        _emit_server(out, "srt_jit_cache_evictions_total",
                     cs["evictions"], lab)
        _emit_server(out, "srt_jit_cache_contention_total",
                     cs["contention"], lab)
        _emit_server(out, "srt_jit_cache_size", cs["size"], lab)

    tstats = _triggers.engine().stats()
    for trig, n in sorted(tstats["fired"].items()):
        _emit_server(out, "srt_telemetry_triggers_fired_total", n,
                     {"trigger": trig})
    for trig, n in sorted(tstats["rateLimited"].items()):
        _emit_server(out, "srt_telemetry_triggers_rate_limited_total",
                     n, {"trigger": trig})
    _emit_server(out, "srt_telemetry_bundles_pruned_total",
                 tstats.get("pruned", 0))

    if server_stats:
        _emit_server(out, "srt_queries_ok_total",
                     server_stats.get("queriesOk", 0))
        _emit_server(out, "srt_queries_err_total",
                     server_stats.get("queriesErr", 0))
        _emit_server(out, "srt_queries_cancelled_total",
                     server_stats.get("queriesCancelled", 0))
        _emit_server(out, "srt_queries_quarantined_total",
                     server_stats.get("lifecycle", {})
                     .get("queriesQuarantined", 0))
        _emit_server(out, "srt_uptime_seconds",
                     float(server_stats.get("uptimeSeconds", 0.0)))
        _emit_server(out, "srt_qps",
                     float(server_stats.get("qps", 0.0)))
        adm = server_stats.get("admission", {})
        _emit_server(out, "srt_admission_in_flight",
                     adm.get("inFlight", 0))
        _emit_server(out, "srt_admission_queued", adm.get("queued", 0))
        _emit_server(out, "srt_admission_admitted_total",
                     adm.get("admitted", 0))
        _emit_server(out, "srt_admission_rejected_total",
                     adm.get("rejected", 0))
        _emit_server(out, "srt_admission_throttled_waits_total",
                     adm.get("throttledWaits", 0))
        for tenant, ts in sorted(adm.get("tenants", {}).items()):
            lab = {"tenant": tenant}
            _emit_server(out, "srt_tenant_admitted_total",
                         ts.get("admitted", 0), lab)
            _emit_server(out, "srt_tenant_rejected_total",
                         ts.get("rejected", 0), lab)
            _emit_server(out, "srt_tenant_in_flight",
                         ts.get("inFlight", 0), lab)
            for q, v in ts.get("queueWaitMs", {}).items():
                _emit_server(out, "srt_tenant_queue_wait_ms",
                             float(v), {**lab, "quantile": q})
            for q, v in ts.get("latencyMs", {}).items():
                if q == "count":
                    continue
                _emit_server(out, "srt_tenant_latency_ms", float(v),
                             {**lab, "quantile": q})
        # same-signature batch fusion (docs/adaptive.md): present only
        # when the server runs with batchFusion.enabled
        bf = server_stats.get("batchFusion")
        if bf:
            _emit_server(out, "srt_aqe_batch_fused_queries_total",
                         bf.get("fusedQueries", 0))
            _emit_server(out, "srt_aqe_batch_fusion_batches_total",
                         bf.get("fusedBatches", 0))
        # result + subplan caches (docs/caching.md): present only when
        # the server runs with resultCache/subplanCache enabled
        cache = server_stats.get("cache") or {}
        rc = cache.get("result")
        if rc:
            _emit_server(out, "srt_cache_result_hits_total",
                         rc.get("hits", 0))
            _emit_server(out, "srt_cache_result_misses_total",
                         rc.get("misses", 0))
            _emit_server(out, "srt_cache_result_entries",
                         rc.get("entries", 0))
            _emit_server(out, "srt_cache_result_bytes",
                         rc.get("bytes", 0))
            _emit_server(out, "srt_cache_result_invalidations_total",
                         rc.get("invalidations", 0))
            _emit_server(out, "srt_cache_result_evictions_total",
                         rc.get("evictions", 0))
        sp = cache.get("subplan")
        if sp:
            _emit_server(out, "srt_cache_subplan_hits_total",
                         sp.get("hits", 0))
            _emit_server(out, "srt_cache_subplan_misses_total",
                         sp.get("misses", 0))
            _emit_server(out, "srt_cache_subplan_entries",
                         sp.get("entries", 0))
            _emit_server(out, "srt_cache_subplan_bytes",
                         sp.get("bytes", 0))
            _emit_server(out, "srt_cache_subplan_invalidations_total",
                         sp.get("invalidations", 0))
            _emit_server(out, "srt_cache_subplan_evictions_total",
                         sp.get("evictions", 0))
        # SLO burn tracking over the query history (docs/
        # observability.md "SLO tracking"): per-tenant objective vs
        # observed p99 over the window, gauges because the window
        # slides
        for tenant, slo in sorted(
                (server_stats.get("slo") or {}).items()):
            lab = {"tenant": tenant}
            _emit_server(out, "srt_slo_objective_p99_ms",
                         float(slo.get("objectiveP99Ms", 0)), lab)
            _emit_server(out, "srt_slo_observed_p99_ms",
                         float(slo.get("observedP99Ms", 0.0)), lab)
            _emit_server(out, "srt_slo_window_queries",
                         slo.get("windowQueries", 0), lab)
            _emit_server(out, "srt_slo_window_violations",
                         slo.get("violations", 0), lab)
            _emit_server(out, "srt_slo_burn_ratio",
                         float(slo.get("burnRatio", 0.0)), lab)
        # feedback control (docs/tuning.md): present only when the
        # server runs with serve.tuning.enabled
        tun = server_stats.get("tuning")
        if tun:
            _emit_server(out, "srt_tuning_ticks_total",
                         tun.get("ticks", 0))
            for action, n in sorted(
                    (tun.get("actionsByName") or {}).items()):
                _emit_server(out, "srt_tuning_actions_total", n,
                             {"action": action})
            _emit_server(out, "srt_tuning_reverts_total",
                         tun.get("actionsReverted", 0))
            _emit_server(out, "srt_tuning_active_actions",
                         tun.get("activeActions", 0))
            _emit_server(out, "srt_tuning_pinned_actions",
                         tun.get("pinnedActions", 0))
            _emit_server(out, "srt_tuning_prewarmed_signatures",
                         tun.get("prewarmedSignatures", 0))
    return out.text()


# ---------------------------------------------------------------------------
# HTTP twin (QueryServer.start_metrics_http)
# ---------------------------------------------------------------------------

def serve_http_metrics(render_fn, port: int, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text via ``render_fn``) on a
    daemon thread; returns the httpd (``.shutdown()`` +
    ``.server_close()`` to stop). ``render_fn`` is called per request
    so scrapes always see current state."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            path = self.path.split("?", 1)[0].rstrip("/") or "/metrics"
            if path in ("/metrics", "/"):
                try:
                    body = render_fn().encode("utf-8")
                    ctype = "text/plain; version=0.0.4"
                    code = 200
                except Exception as e:  # pragma: no cover - defensive
                    body = _json.dumps({"error": str(e)}).encode()
                    ctype = "application/json"
                    code = 500
            else:
                body = b"not found (try /metrics)\n"
                ctype = "text/plain"
                code = 404
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-request stderr
            pass

    httpd = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=httpd.serve_forever,
                         name="srt-metrics-http", daemon=True)
    t.start()
    return httpd
