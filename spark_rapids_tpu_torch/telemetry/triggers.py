"""Declarative dump/snapshot triggers over the live telemetry state
(docs/observability.md "Live telemetry").

The flight recorder answers "what just happened" only if something
dumps it at the right moment. This engine watches four conditions at
the places they become true —

- **slowQuery**    query wall over ``telemetry.slowQueryMs``
                   (evaluated at query end, session.execute_plan);
- **retryCount** / **kernelFallbacks**  per-query metric deltas over
                   their thresholds (same evaluation point — the
                   executed plan's registries ARE the delta);
- **retryStorm**   more than ``telemetry.retryStormThreshold`` OOM
                   retries in a 60 s window (evaluated at retry time,
                   retry.py);
- **hbmWatermark** device-store occupancy over
                   ``telemetry.hbmWatermark`` x budget (evaluated at
                   every store transition, memory.py);
- **queueSaturation**  admission-queue depth over
                   ``telemetry.queueWatermark`` x maxQueued (evaluated
                   at every enqueue, serve/scheduler.py)

(The lifecycle watchdog's ``stuckQuery`` and the SLO tracker's
``sloBurn`` firings ride the same engine — lifecycle.py and
telemetry/history.py call ``_maybe_fire`` with their own conditions.)

— and emits a *slow-query bundle* per firing: one JSON under
``spark.rapids.sql.telemetry.dir`` tying together the flight-recorder
dump (a standard Chrome-trace file ``load_trace`` reads), the query's
profile artifact path when profiling is on, a server stats snapshot
when a QueryServer registered itself, the device-store stats, and the
triggering condition. Firing is rate-limited PER TRIGGER
(``telemetry.triggerMinIntervalS``) so a storm cannot flood the disk,
and bundle IO runs on a dedicated daemon thread so no query/store/
admission path ever blocks on a file write.

Hot-path cost when disabled: the store/admission/retry hooks are one
module-global boolean check; the query-end hook reads three conf
values per query.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from spark_rapids_tpu_torch.conf import (TELEMETRY_DIR,
                                         TELEMETRY_HBM_WATERMARK,
                                         TELEMETRY_KERNEL_FALLBACK_THRESHOLD,
                                         TELEMETRY_MAX_BUNDLE_BYTES,
                                         TELEMETRY_MAX_BUNDLES,
                                         TELEMETRY_MIN_INTERVAL_S,
                                         TELEMETRY_QUEUE_WATERMARK,
                                         TELEMETRY_RETRY_COUNT_THRESHOLD,
                                         TELEMETRY_RETRY_STORM_THRESHOLD,
                                         TELEMETRY_SLOW_QUERY_MS)

BUNDLE_VERSION = 1
_RETRY_WINDOW_S = 60.0


class TriggerEngine:
    """Process-wide trigger state. One instance (module singleton);
    every mutation is under ``_lock`` except the armed fast-path
    check."""

    def __init__(self):
        self._lock = threading.Lock()
        # armed = any session explicitly configured a telemetry conf;
        # the store/admission/retry hooks read this WITHOUT the lock
        # (stale reads only delay arming by one event)
        self.armed = False
        self._dir = str(TELEMETRY_DIR.default)
        self._min_interval = float(TELEMETRY_MIN_INTERVAL_S.default)
        self._hbm_watermark = 0.0
        self._queue_watermark = 0.0
        self._retry_storm = 0
        self._retry_times: deque = deque()
        self._last_fire: Dict[str, float] = {}
        self.fired: Dict[str, int] = {}
        self.rate_limited: Dict[str, int] = {}
        self.bundle_paths: list = []
        # artifact retention (satellite of the query-history PR):
        # bundles + ring dumps in telemetry.dir are pruned oldest-first
        # by the bundle WORKER after each write — never under a
        # hot-path lock
        self._max_bundles = int(TELEMETRY_MAX_BUNDLES.default)
        self._max_bundle_bytes = int(TELEMETRY_MAX_BUNDLE_BYTES.default)
        self.pruned = 0
        self._seq = 0
        self._pending = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stats_provider: Optional[Callable[[], Dict]] = None

    # -- configuration -----------------------------------------------------

    def configure(self, conf_obj) -> None:
        """Arm the conf-less hooks (store occupancy, admission depth,
        retry storm) from a session's settings. Only a session that
        EXPLICITLY sets a ``spark.rapids.sql.telemetry.*`` key arms or
        re-arms the engine — default sessions never disarm a configured
        one."""
        if conf_obj is None or not any(
                str(k).startswith("spark.rapids.sql.telemetry.")
                for k in conf_obj.settings):
            return
        with self._lock:
            self._dir = str(conf_obj.get(TELEMETRY_DIR))
            self._min_interval = float(
                conf_obj.get(TELEMETRY_MIN_INTERVAL_S))
            self._hbm_watermark = float(
                conf_obj.get(TELEMETRY_HBM_WATERMARK))
            self._queue_watermark = float(
                conf_obj.get(TELEMETRY_QUEUE_WATERMARK))
            self._retry_storm = int(
                conf_obj.get(TELEMETRY_RETRY_STORM_THRESHOLD))
            self._max_bundles = int(
                conf_obj.get(TELEMETRY_MAX_BUNDLES))
            self._max_bundle_bytes = int(
                conf_obj.get(TELEMETRY_MAX_BUNDLE_BYTES))
            self.armed = True
        # arming implies firings may come from under the store /
        # admission locks, where the worker must already exist
        self._ensure_worker()

    def _ensure_worker(self) -> None:
        """Start the bundle-writer thread if it is not running. Called
        only from contexts that hold no engine-external locks."""
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._drain_queue, name="srt-telemetry",
                    daemon=True)
                self._worker.start()

    def set_stats_provider(self, fn: Optional[Callable[[], Dict]]
                           ) -> None:
        with self._lock:
            self._stats_provider = fn

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "armed": self.armed,
                "fired": dict(self.fired),
                "rateLimited": dict(self.rate_limited),
                "pruned": self.pruned,
                "bundles": list(self.bundle_paths),
            }

    def reset(self) -> None:
        """Test hook: drop counters, rate-limit state and arming."""
        self.drain(timeout=5.0)
        with self._lock:
            self.armed = False
            self._hbm_watermark = self._queue_watermark = 0.0
            self._retry_storm = 0
            self._retry_times.clear()
            self._last_fire.clear()
            self.fired.clear()
            self.rate_limited.clear()
            self.bundle_paths.clear()
            self.pruned = 0
            self._max_bundles = int(TELEMETRY_MAX_BUNDLES.default)
            self._max_bundle_bytes = int(
                TELEMETRY_MAX_BUNDLE_BYTES.default)
            self._stats_provider = None

    # -- firing ------------------------------------------------------------

    def _maybe_fire(self, trigger: str, condition: Dict[str, Any],
                    out_dir: Optional[str] = None,
                    min_interval: Optional[float] = None,
                    profile_path: Optional[str] = None) -> bool:
        """Rate-limit check + enqueue for the bundle worker; returns
        True when the firing was accepted (a bundle WILL be written)."""
        now = time.monotonic()
        with self._lock:
            interval = (min_interval if min_interval is not None
                        else self._min_interval)
            last = self._last_fire.get(trigger)
            if last is not None and now - last < interval:
                self.rate_limited[trigger] = \
                    self.rate_limited.get(trigger, 0) + 1
                return False
            self._last_fire[trigger] = now
            self.fired[trigger] = self.fired.get(trigger, 0) + 1
            self._seq += 1
            seq = self._seq
            self._pending += 1
            d = out_dir if out_dir is not None else self._dir
        # NOTE: no thread start here — the store/admission hooks call
        # this under DeviceStore._lock / AdmissionController._cv, and
        # Thread.start() blocks until the child is scheduled. The
        # worker is started by configure()/on_query_end()/drain(),
        # which always run before (or can flush) any armed firing.
        from spark_rapids_tpu_torch import trace as _trace
        _trace.instant("telemetryTrigger", trigger=trigger)
        self._queue.put({"trigger": trigger, "condition": condition,
                         "dir": d, "seq": seq,
                         "profile": profile_path,
                         "wallTs": time.time()})
        return True

    def _drain_queue(self) -> None:
        while True:
            item = self._queue.get()
            try:
                self._write_bundle(item)
            except Exception:
                pass  # observability must not take down execution
            finally:
                with self._lock:
                    self._pending -= 1

    def _write_bundle(self, item: Dict[str, Any]) -> None:
        from spark_rapids_tpu_torch import memory
        from spark_rapids_tpu_torch.telemetry.ring import dump_ring
        out_dir = item["dir"]
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            provider = self._stats_provider
        server_stats = None
        if provider is not None:
            try:
                server_stats = provider()
            except Exception:
                server_stats = {"error": "stats provider failed"}
        store = memory._STORE
        bundle = {
            "version": BUNDLE_VERSION,
            "trigger": item["trigger"],
            "condition": item["condition"],
            "ts": item["wallTs"],
            "pid": os.getpid(),
            "ringDump": dump_ring(out_dir),
            "profile": item.get("profile"),
            "serverStats": server_stats,
            "storeStats": store.stats() if store is not None else None,
        }
        path = os.path.join(
            out_dir,
            f"bundle-{os.getpid()}-{item['seq']:05d}-"
            f"{item['trigger']}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)
        with self._lock:
            self.bundle_paths.append(path)
            del self.bundle_paths[:-64]
        # retention sweep (telemetry.maxBundles / maxBundleBytes):
        # runs HERE on the worker thread, after the write, so the
        # hot-path hooks never pay for directory listing or unlinks
        self._prune_artifacts(out_dir)

    def _prune_artifacts(self, out_dir: str) -> None:
        """Prune telemetry artifacts (trigger bundles + flight-recorder
        dumps) oldest-first until the directory fits the configured
        count/byte bounds. Never raises."""
        with self._lock:
            max_bundles = self._max_bundles
            max_bytes = self._max_bundle_bytes
        if max_bundles <= 0 and max_bytes <= 0:
            return
        try:
            files = [
                os.path.join(out_dir, f) for f in os.listdir(out_dir)
                if f.endswith(".json")
                and (f.startswith("bundle-")
                     or f.startswith("trace-ring-"))]
            stats = []
            for p in files:
                try:
                    st = os.stat(p)
                    stats.append((st.st_mtime, p, st.st_size))
                except OSError:
                    continue
            stats.sort()
            total = sum(s for _, _, s in stats)
            pruned = 0
            while stats and (
                    (max_bundles > 0 and len(stats) > max_bundles)
                    or (max_bytes > 0 and total > max_bytes)):
                _, p, size = stats.pop(0)
                try:
                    os.unlink(p)
                    pruned += 1
                    total -= size
                except OSError:
                    total -= size
            if pruned:
                with self._lock:
                    self.pruned += pruned
                    self.bundle_paths[:] = [
                        p for p in self.bundle_paths
                        if os.path.exists(p)]
        except Exception:
            pass  # observability must not take down execution

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every accepted firing has its bundle on disk
        (tests/bench call this before reading telemetry.dir)."""
        self._ensure_worker()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._pending == 0:
                    return True
            time.sleep(0.005)
        return False

    # -- evaluation points -------------------------------------------------

    def on_query_end(self, conf_obj, wall_s: float, plan=None,
                     tenant: Optional[str] = None,
                     query_id: Optional[int] = None,
                     profile_path: Optional[str] = None) -> None:
        """Query-close evaluation: latency + per-query metric deltas
        (the executed plan's registries are this query's deltas by
        construction)."""
        if conf_obj is None:
            return
        slow_ms = int(conf_obj.get(TELEMETRY_SLOW_QUERY_MS))
        retry_thr = int(conf_obj.get(TELEMETRY_RETRY_COUNT_THRESHOLD))
        fb_thr = int(conf_obj.get(TELEMETRY_KERNEL_FALLBACK_THRESHOLD))
        if slow_ms <= 0 and retry_thr <= 0 and fb_thr <= 0:
            return
        self._ensure_worker()
        out_dir = str(conf_obj.get(TELEMETRY_DIR))
        interval = float(conf_obj.get(TELEMETRY_MIN_INTERVAL_S))
        base = {"tenant": tenant, "queryId": query_id,
                "wallMs": round(wall_s * 1e3, 3)}
        if slow_ms > 0 and wall_s * 1e3 > slow_ms:
            self._maybe_fire(
                "slowQuery", {**base, "slowQueryMs": slow_ms},
                out_dir=out_dir, min_interval=interval,
                profile_path=profile_path)
        if plan is not None and (retry_thr > 0 or fb_thr > 0):
            from spark_rapids_tpu_torch.metrics import registry_snapshot
            vals = registry_snapshot(plans=[plan])["metrics"]
            retries = vals.get("retryCount", 0) \
                + vals.get("splitRetryCount", 0)
            if retry_thr > 0 and retries > retry_thr:
                self._maybe_fire(
                    "retryCount",
                    {**base, "retryCount": retries,
                     "threshold": retry_thr},
                    out_dir=out_dir, min_interval=interval,
                    profile_path=profile_path)
            fallbacks = sum(v for k, v in vals.items()
                            if k.startswith("kernelFallbacks."))
            if fb_thr > 0 and fallbacks > fb_thr:
                self._maybe_fire(
                    "kernelFallbacks",
                    {**base, "kernelFallbacks": fallbacks,
                     "threshold": fb_thr},
                    out_dir=out_dir, min_interval=interval,
                    profile_path=profile_path)

    def on_store_sample(self, device_bytes: int, budget: int) -> None:
        """Store-transition evaluation (called by the DeviceStore under
        its lock — this method only enqueues, never does IO)."""
        wm = self._hbm_watermark
        if wm <= 0 or budget <= 0:
            return
        frac = device_bytes / budget
        if frac > wm:
            self._maybe_fire("hbmWatermark",
                             {"deviceBytes": device_bytes,
                              "budget": budget,
                              "occupancy": round(frac, 4),
                              "watermark": wm})

    def on_admission(self, queued: int, max_queued: int) -> None:
        """Enqueue-time evaluation (called by the admission controller
        under its condition lock — enqueue only, no IO)."""
        wm = self._queue_watermark
        if wm <= 0 or max_queued <= 0:
            return
        frac = queued / max_queued
        if frac > wm:
            self._maybe_fire("queueSaturation",
                             {"queued": queued,
                              "maxQueued": max_queued,
                              "saturation": round(frac, 4),
                              "watermark": wm})

    def on_retry(self) -> None:
        """Retry-time evaluation: a sliding 60 s window of OOM-retry
        events; over the threshold, the storm is visible WHILE it is
        happening, not at the next query end."""
        thr = self._retry_storm
        if thr <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._retry_times.append(now)
            while self._retry_times and \
                    self._retry_times[0] < now - _RETRY_WINDOW_S:
                self._retry_times.popleft()
            n = len(self._retry_times)
        if n > thr:
            self._maybe_fire("retryStorm",
                             {"retriesInWindow": n,
                              "windowSeconds": _RETRY_WINDOW_S,
                              "threshold": thr})


_ENGINE = TriggerEngine()


def engine() -> TriggerEngine:
    return _ENGINE


def configure(conf_obj) -> None:
    _ENGINE.configure(conf_obj)


def set_stats_provider(fn) -> None:
    _ENGINE.set_stats_provider(fn)


def on_query_end(conf_obj, wall_s: float, plan=None, tenant=None,
                 query_id=None, profile_path=None) -> None:
    _ENGINE.on_query_end(conf_obj, wall_s, plan=plan, tenant=tenant,
                         query_id=query_id, profile_path=profile_path)


def on_store_sample(device_bytes: int, budget: int) -> None:
    if _ENGINE.armed:
        _ENGINE.on_store_sample(device_bytes, budget)


def on_admission(queued: int, max_queued: int) -> None:
    if _ENGINE.armed:
        _ENGINE.on_admission(queued, max_queued)


def on_retry() -> None:
    if _ENGINE.armed:
        _ENGINE.on_retry()
