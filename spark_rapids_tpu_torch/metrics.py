"""Operator metrics (the counterpart of ``spark_rapids_tpu.metrics``).

Every ``TorchExec`` owns a ``MetricRegistry`` as ``self.metrics``: named
integer metrics, created on first use. Three verbosity levels
(ESSENTIAL, MODERATE, DEBUG) are gated by ``spark.rapids.sql.metrics.level``:
a metric above the registry's level is never kept. A name's level is the
JAX package's (``ESSENTIAL_METRICS`` lists the names it creates at
ESSENTIAL; every other name is MODERATE). Timers are host wall-clock
nanoseconds.

Every ``timed``/``timed_wall`` scope also mirrors its interval into the
active span tracer (``trace.py``) as a span named ``<owner>.<metric>``,
so the trace, the event log and the profile read the same measurement.
When tracing is off the mirror is one module-global None check. A
registry is registered weakly for ``live_registries`` and, once
garbage-collected with its plan, folds its final values into
``retired_totals`` (the Prometheus exporter's monotone base).
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import trace as _trace

ESSENTIAL = 0
MODERATE = 1
DEBUG = 2

_LEVELS = {"ESSENTIAL": ESSENTIAL, "MODERATE": MODERATE, "DEBUG": DEBUG}

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
COPY_TO_DEVICE_TIME = "copyToDeviceTime"
COPY_FROM_DEVICE_TIME = "copyFromDeviceTime"
PACK_TIME = "packBatchTime"  # host-side staging half of an upload
CONCAT_TIME = "concatTime"
OP_TIME = "opTime"  # an operator's host wall, no synchronise
SORT_TIME = "sortTime"  # a sort's host wall, no synchronise
JOIN_TIME = "joinTime"  # a join's host wall, no synchronise
AGG_TIME = "computeAggTime"  # an aggregate program's host enqueue wall
SCAN_PREFETCH_TIME = "scanPrefetchTime"
UPLOAD_AHEAD_BATCHES = "uploadAheadBatches"
# uploads copied from a pinned staging slot on the ring's own copy stream
PINNED_STREAM_COPIES = "pinnedStreamCopies"
# stage fusion (TorchFusedStageExec and prelude-absorbing aggregates)
DISPATCH_COUNT = "dispatchCount"        # stage programs run
STAGE_COMPILE_TIME = "stageCompileTime"  # a new program's warm-up + capture
FUSED_OPS = "fusedOps"                  # operators collapsed into a stage
COMPILE_CACHE_HITS = "compileCacheHits"
COMPILE_CACHE_MISSES = "compileCacheMisses"
# memory store and retry protocol (retry.py, memory.py)
SEMAPHORE_WAIT_TIME = "semaphoreWaitTime"
PEAK_DEVICE_MEMORY = "peakDeviceMemory"   # this exec's live store bytes
SPILL_BYTES = "spillBytes"                # this exec's batches spilled
RETRY_COUNT = "retryCount"                # OOM retries that re-attempted
SPLIT_RETRY_COUNT = "splitRetryCount"     # input batches split in half
RETRY_BLOCK_TIME = "retryBlockTime"       # recovery + backoff wall
SPILL_BYTES_ON_RETRY = "spillBytesOnRetry"  # bytes freed by recovery
IO_RETRY_COUNT = "ioRetryCount"           # transient reader IO retries
DEVICE_DECODE_OOM_FALLBACKS = "deviceDecodeOomFallbacks"  # encoded
#   uploads that took the host decode for that batch after an OOM
PARTITION_TIME = "partitionTime"
DEGRADED_CHIPS = "degradedChips"          # mesh chips demoted after failure
# planned out-of-core (the budget oracle's decisions)
PLANNED_PARTITIONS = "plannedPartitions"  # spill-backed partitions planned
BUDGET_PRESSURE_PEAK = "budgetPressurePeak"  # worst estimate/share, %
PLANNED_WORKING_SET = "plannedWorkingSetBytes"  # largest estimate seen
PLANNED_OOC_ESCALATIONS = "plannedOutOfCoreEscalations"  # re-plans
# adaptive execution (adaptive.py): run-time replans and exchange stats
AQE_BROADCAST_FLIP = "aqeBroadcastFlip"    # shuffled joins demoted
AQE_REPLANS = "aqeReplans"                 # replans of any kind
AQE_SKEW_SPLITS = "aqeSkewSplits"          # skewed partitions split
AQE_COALESCED_PARTITIONS = "aqeCoalescedPartitions"  # partitions merged
EXCHANGE_TOTAL_BYTES = "exchangeTotalBytes"
EXCHANGE_MAX_PARTITION_BYTES = "exchangeMaxPartitionBytes"
EXCHANGE_MEDIAN_PARTITION_BYTES = "exchangeMedianPartitionBytes"


# ---------------------------------------------------------------------------
# Central metric description table (docs/tools/profile single source of
# truth). EVERY metric any exec registers — constants above AND the
# ad-hoc keys created inline — must have an entry here (exact key) or
# match a prefix in METRIC_PREFIX_DESCRIPTIONS (dynamic families like
# per-chip counters). tests/test_torch_profile.py checks this against the
# registries of executed plans, so profile/docs/bench can never
# disagree on names.
# ---------------------------------------------------------------------------

METRIC_DESCRIPTIONS: Dict[str, str] = {
    NUM_OUTPUT_ROWS: "rows emitted by the operator",
    NUM_OUTPUT_BATCHES: "device batches emitted",
    "numInputRows": "rows consumed",
    "numInputBatches": "batches consumed",
    OP_TIME: "operator wall time (ns)",
    SEMAPHORE_WAIT_TIME: "wall blocked on the device semaphore (ns)",
    PEAK_DEVICE_MEMORY: "peak HBM bytes this operator held live in the "
                        "device store (owner-attributed accounting)",
    SPILL_BYTES: "HBM bytes of this operator's batches demoted "
                 "device->host by the store",
    SORT_TIME: "device sort wall (ns)",
    AGG_TIME: "aggregation update/merge wall (ns)",
    JOIN_TIME: "join probe/gather wall (ns)",
    CONCAT_TIME: "device batch concat wall (ns)",
    PARTITION_TIME: "exchange partition-split wall (ns)",
    COPY_TO_DEVICE_TIME: "host->HBM upload wall (ns)",
    PACK_TIME: "host-side upload staging wall (ns; overlaps transfer)",
    COPY_FROM_DEVICE_TIME: "HBM->host download wall (ns)",
    DISPATCH_COUNT: "device programs dispatched",
    STAGE_COMPILE_TIME: "first-call trace+XLA-compile wall (ns)",
    FUSED_OPS: "operators collapsed into this fused stage",
    COMPILE_CACHE_HITS: "jit-cache hits for this exec's programs",
    COMPILE_CACHE_MISSES: "jit-cache misses (compiles) for this exec",
    RETRY_COUNT: "OOM retries that re-attempted the operation",
    SPLIT_RETRY_COUNT: "input batches split in half after OOM",
    RETRY_BLOCK_TIME: "spill+backoff wall inside OOM retries (ns; also "
                      "counted inside the enclosing operator timer)",
    SPILL_BYTES_ON_RETRY: "HBM freed by retry spills",
    "degradedChips": "mesh chips demoted after persistent failure",
    IO_RETRY_COUNT: "transient reader IO retries",
    DEVICE_DECODE_OOM_FALLBACKS: "encoded uploads that fell back to the "
                                 "pyarrow host decode after OOM",
    PLANNED_PARTITIONS: "spill-backed partitions the out-of-core "
                        "budget oracle planned up front "
                        "(docs/out_of_core.md)",
    BUDGET_PRESSURE_PEAK: "worst working-set estimate observed at "
                          "planning, as bytes per 100 bytes of budget "
                          "share (>100 = the planned out-of-core tier "
                          "engaged)",
    PLANNED_OOC_ESCALATIONS: "planned out-of-core partition plans "
                             "escalated (re-partitioned at a doubled "
                             "modulus) after a partition still "
                             "overflowed its budget share",
    # ad-hoc keys registered inline by individual operators
    "pipelineDrainTime": "wall where the partial agg drained the async "
                         "upstream pipeline (interval union)",
    "pythonEvalTime": "python worker-pool UDF evaluation wall (ns)",
    "externalShuffleWriteTime": "external-shuffle serialize+write wall",
    "externalShuffleReadTime": "external-shuffle read+re-upload wall",
    "externalShuffleBytes": "bytes shipped through the external shuffle",
    "broadcastBuilds": "broadcast build-side materializations",
    "subplanCacheHits": "join build tables reused from the subplan "
                        "cache instead of rebuilt (docs/caching.md)",
    "numIciExchanges": "all-to-all exchanges run over the ICI mesh",
    "aqeCoalescedPartitions": "tiny exchange partitions coalesced by AQE",
    "aqeBroadcastFlip": "shuffled joins flipped to broadcast at runtime",
    "aqeReplans": "adaptive runtime replans applied over measured "
                  "exchange stats (docs/adaptive.md)",
    "aqeSkewSplits": "skewed exchange partitions split by the adaptive "
                     "skew-join rewrite",
    "exchangeTotalBytes": "materialized exchange output bytes (all "
                          "partitions)",
    "exchangeMaxPartitionBytes": "largest materialized exchange "
                                 "partition",
    "exchangeMedianPartitionBytes": "median non-empty materialized "
                                    "exchange partition",
    "fkFastPathJoins": "joins taking the unique-build-key fast path",
    "meshPadWaste": "staged-minus-active rows padded by mesh stacking",
    # scan-side keys (CpuFileScanExec; kept here so the profile tree and
    # docs can annotate the whole plan, not only Tpu* nodes)
    "decodeTime": "host parquet/file decode wall (interval union)",
    "convertTime": "arrow->HostBatch conversion wall",
    "deviceDecodeTime": "host-side half of the device decode path "
                        "(IO, page headers, decode plans)",
    "deviceDecodedBatches": "scan batches decoded on device",
    "deviceDecodePrograms": "logical decode-stage programs billed per "
                            "device-decoded batch (1 when the fused "
                            "kernel ran; the XLA chain's stage count "
                            "otherwise — docs/kernels.md)",
    "deviceFallbackUnits": "scan units that fell back to host decode",
    "deviceFallbackColumns": "columns that fell back to host decode",
    # scan pipeline (docs/scan.md): producer-thread prefetch + bounded
    # upload-ahead ring in TorchRowToColumnarExec
    "scanPrefetchTime": "scan producer-thread read+pack wall "
                        "(interval union; overlaps device compute)",
    "uploadAheadBatches": "scan batches whose raw-chunk upload was "
                          "issued ahead of the consuming stage",
    "prefetchRingShrinks": "upload-ahead rings drained after OOM on a "
                           "prefetched upload",
    # the port's own keys (the JAX package records no counterpart)
    PINNED_STREAM_COPIES: "uploads copied from a pinned staging slot on "
                          "the upload ring's own copy stream",
    PLANNED_WORKING_SET: "largest working-set estimate the out-of-core "
                         "budget oracle saw at planning (bytes)",
}

# dynamic metric families: any key starting with one of these prefixes
# is described by the entry (per-chip counters, per-encoding counts)
METRIC_PREFIX_DESCRIPTIONS: Dict[str, str] = {
    "dispatchCount.chip": "device programs dispatched on chip <N>",
    "meshScanUnits.chip": "scan units assigned to chip <N>'s stream",
    "deviceDecodedValues.": "values decoded on device per encoding",
    "kernelDispatchCount.": "launches of the named hand-written CUDA "
                            "kernel, direct or replayed inside a stage's "
                            "CUDA graph (docs/kernels.md)",
    "kernelFallbacks.": "kernel-path calls that fell back to the "
                        "XLA-op oracle composition (lowering/compile "
                        "failure or hash-table overflow)",
    "hostDecodedValues.": "values host-decoded (fallback columns) per "
                          "encoding",
}


def describe_metric(name: str) -> Optional[str]:
    """Description for a metric key, resolving dynamic per-chip /
    per-encoding families by prefix; None for an unknown key (the lint
    test fails on those)."""
    d = METRIC_DESCRIPTIONS.get(name)
    if d is not None:
        return d
    for prefix, desc in METRIC_PREFIX_DESCRIPTIONS.items():
        if name.startswith(prefix):
            return desc
    return None


# names the JAX package creates at ESSENTIAL; every other name (and
# every name of a family below) is MODERATE
ESSENTIAL_METRICS = frozenset({
    NUM_OUTPUT_ROWS, NUM_OUTPUT_BATCHES, DISPATCH_COUNT, FUSED_OPS,
    STAGE_COMPILE_TIME, PEAK_DEVICE_MEMORY, SPILL_BYTES, RETRY_COUNT,
    SPLIT_RETRY_COUNT, SPILL_BYTES_ON_RETRY, "degradedChips",
    IO_RETRY_COUNT, DEVICE_DECODE_OOM_FALLBACKS, PLANNED_PARTITIONS,
    BUDGET_PRESSURE_PEAK, PLANNED_OOC_ESCALATIONS, AQE_BROADCAST_FLIP,
    AQE_REPLANS, AQE_SKEW_SPLITS, AQE_COALESCED_PARTITIONS,
    EXCHANGE_TOTAL_BYTES, EXCHANGE_MAX_PARTITION_BYTES,
    EXCHANGE_MEDIAN_PARTITION_BYTES, "broadcastBuilds",
    "externalShuffleBytes", "numIciExchanges", "fkFastPathJoins",
    "subplanCacheHits",
})
_ESSENTIAL_PREFIXES = ("kernelFallbacks.",)


def default_level(name: str) -> int:
    """The level the JAX package creates ``name`` at."""
    if name in ESSENTIAL_METRICS or name.startswith(_ESSENTIAL_PREFIXES):
        return ESSENTIAL
    return MODERATE


def describe_metric(name: str) -> Optional[str]:
    """Description for a metric key, resolving dynamic per-chip /
    per-encoding families by prefix; None for an unknown key."""
    d = METRIC_DESCRIPTIONS.get(name)
    if d is not None:
        return d
    for prefix, desc in METRIC_PREFIX_DESCRIPTIONS.items():
        if name.startswith(prefix):
            return desc
    return None


class Metric:
    """A thread-safe integer: the upload's producer thread and the task
    thread update one operator's metrics concurrently. ``add`` also
    takes a 0-d device tensor (a batch's row count still on the card),
    read back only when ``value`` is read, so counting never waits for
    the card. ``version`` counts mutations (the Prometheus aggregator
    re-reads only registries that changed)."""

    def __init__(self, name: str, level: int = MODERATE):
        self.name = name
        self.level = level
        self.version = 0
        self._value = 0
        self._pending: List[torch.Tensor] = []
        self._lock = threading.Lock()
        # wall-union timer state (timed_wall)
        self._active = 0
        self._wall_start = 0

    def add(self, v) -> None:
        with self._lock:
            if isinstance(v, torch.Tensor):
                self._pending.append(v)
            else:
                self._value += int(v)
            self.version += 1

    def set_max(self, v: int) -> None:
        """Raise the value to ``v`` if it is larger (a high-watermark)."""
        with self._lock:
            self._value = max(self._value, int(v))
            self.version += 1

    def enter_wall(self) -> None:
        with self._lock:
            if self._active == 0:
                self._wall_start = time.perf_counter_ns()
            self._active += 1

    def exit_wall(self) -> None:
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._value += time.perf_counter_ns() - self._wall_start
                self.version += 1

    @property
    def value(self) -> int:
        with self._lock:
            if self._pending:
                self._value += int(torch.stack(self._pending).sum())
                self._pending = []
            return self._value


# every live registry, for registry_snapshot(); weak so plans release
# their metrics with themselves
_REGISTRIES: "weakref.WeakSet[MetricRegistry]" = weakref.WeakSet()

# process-lifetime totals: a garbage-collected registry's final values
# fold in here, so the exporter's counters stay monotone across plan
# lifetimes. Finalizers run at arbitrary allocation points, so they
# only append to a deque that readers drain under the lock.
_RETIRED_LOCK = threading.Lock()
_RETIRED_TOTALS: Dict[str, int] = {}
_RETIRED_QUEUE: deque = deque()


def _retire_metrics(metrics_dict: Dict[str, "Metric"]) -> None:
    _RETIRED_QUEUE.append(metrics_dict)


def is_watermark_metric(name: str) -> bool:
    """True for high-watermark metrics: they fold across registries by
    max, not sum."""
    return "peak" in name.lower()


def fold_metric(totals: Dict[str, int], name: str, value: int) -> None:
    """Fold one registry's value into cross-registry totals (max for
    watermarks, sum otherwise)."""
    if is_watermark_metric(name):
        totals[name] = max(totals.get(name, 0), value)
    else:
        totals[name] = totals.get(name, 0) + value


def retired_totals() -> Dict[str, int]:
    """Folded final values of every garbage-collected registry."""
    with _RETIRED_LOCK:
        while True:
            try:
                md = _RETIRED_QUEUE.popleft()
            except IndexError:
                break
            for k, m in list(md.items()):
                fold_metric(_RETIRED_TOTALS, k, m.value)
        return dict(_RETIRED_TOTALS)


# registry epoch: begin_epoch() + registry_snapshot(epoch=...) scope a
# process-wide snapshot to registries created since
_EPOCH = 0


def begin_epoch() -> int:
    """Start a new registry epoch and return it."""
    global _EPOCH
    _EPOCH += 1
    return _EPOCH


def current_epoch() -> int:
    return _EPOCH


class MetricRegistry:
    """One exec's metric map. Creation is gated by the configured level,
    so a metric above it costs a throwaway object and is never kept.
    ``owner`` labels this registry's spans in the trace (the exec class
    name)."""

    def __init__(self, conf_level: str = "MODERATE", owner: str = ""):
        self.enabled_level = _LEVELS.get(str(conf_level).upper(), MODERATE)
        self.metrics: Dict[str, Metric] = {}
        self.owner = owner
        self.epoch = _EPOCH
        self._lock = threading.Lock()
        _REGISTRIES.add(self)
        weakref.finalize(self, _retire_metrics, self.metrics)

    def create(self, name: str, level: Optional[int] = None) -> Metric:
        if level is None:
            level = default_level(name)
        with self._lock:
            m = self.metrics.get(name)
            if m is None:
                m = Metric(name, level)
                if level <= self.enabled_level:
                    self.metrics[name] = m
            return m

    def value(self, name: str) -> int:
        m = self.metrics.get(name)
        return m.value if m else 0

    def _span_kind(self, name: str) -> str:
        return f"{self.owner}.{name}" if self.owner else name

    @contextlib.contextmanager
    def timed(self, name: str, level: Optional[int] = None,
              **attrs) -> Iterator[None]:
        """Add the host wall time of the block, in nanoseconds, and mirror
        the interval into the active trace. It never calls
        ``torch.cuda.synchronize()``: a synchronise inside a timer would
        serialise the upload ring, so a timer around device work measures
        its enqueue, not its run on the card."""
        m = self.create(name, level)
        qt = _trace._ACTIVE
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            m.add(t1 - t0)
            if qt is not None:
                qt.add(self._span_kind(name), t0, t1, **attrs)

    @contextlib.contextmanager
    def timed_wall(self, name: str, level: Optional[int] = None,
                   **attrs) -> Iterator[None]:
        """Union-of-intervals timer: when several threads run the same
        phase at once, the metric advances by wall time, not by their
        summed thread times. The mirrored span is this thread's
        interval."""
        m = self.create(name, level)
        qt = _trace._ACTIVE
        t0 = time.perf_counter_ns()
        m.enter_wall()
        try:
            yield
        finally:
            m.exit_wall()
            if qt is not None:
                qt.add(self._span_kind(name), t0,
                       time.perf_counter_ns(), **attrs)

    def snapshot(self) -> Dict[str, int]:
        return {k: m.value for k, m in list(self.metrics.items())}

    def clone_empty(self) -> "MetricRegistry":
        """A fresh registry of the same class, level and owner holding
        this one's metrics at their values: a plan-cache clone's
        registry. The cached template is never executed, so its values
        are the ones its operators set when they were built (a fused
        stage's ``fusedOps``), which a freshly planned operator holds
        too. (The JAX package's copy keeps the names at 0.)"""
        r = type(self).__new__(type(self))
        r.enabled_level = self.enabled_level
        r.metrics = {}
        r.owner = self.owner
        r.epoch = _EPOCH
        r._lock = threading.Lock()
        _REGISTRIES.add(r)
        weakref.finalize(r, _retire_metrics, r.metrics)
        for k, m in list(self.metrics.items()):
            r.create(k, m.level).add(m.value)
        return r


def live_registries() -> list:
    """Every live MetricRegistry in the process (a list copy of the weak
    set): the Prometheus aggregator's iteration surface."""
    return list(_REGISTRIES)


def _walk_registries(plan, out: list, seen: set) -> None:
    # a reused broadcast is one node under several joins: its subtree's
    # registries count once
    if id(plan) in seen:
        return
    seen.add(id(plan))
    ms = getattr(plan, "metrics", None)
    if isinstance(ms, MetricRegistry):
        out.append(ms)
    for op in getattr(plan, "fused_ops", []):
        fm = getattr(op, "metrics", None)
        if isinstance(fm, MetricRegistry):
            out.append(fm)
    for c in getattr(plan, "children", []):
        _walk_registries(c, out, seen)


def plan_registries(plan) -> list:
    """Every registry of an executed plan, fused-stage constituents
    included, each node's once."""
    out: list = []
    _walk_registries(plan, out, set())
    return out


def registry_snapshot(plans=None, epoch: Optional[int] = None
                      ) -> Dict[str, Any]:
    """Every metric as one dict: ``{"metrics": {name: summed value},
    "jitCaches": {cache: stats}}``. With ``plans`` given only their
    registries contribute; with None every live registry does (created
    at or after ``epoch`` when given)."""
    vals: Dict[str, int] = {}
    if plans is None:
        regs = [r for r in list(_REGISTRIES)
                if epoch is None or getattr(r, "epoch", 0) >= epoch]
    else:
        regs = [r for p in plans or [] for r in plan_registries(p)]
    for r in regs:
        for k, v in r.snapshot().items():
            vals[k] = vals.get(k, 0) + v
    from spark_rapids_tpu_torch.jit_cache import cache_stats
    return {"metrics": vals, "jitCaches": cache_stats()}


def plan_metrics(plan) -> Dict[str, int]:
    """Every exec registry of an executed plan summed by name, fused-stage
    constituents included (the JAX package's
    ``registry_snapshot(plans)["metrics"]``)."""
    out: Dict[str, int] = {}
    for r in plan_registries(plan):
        for k, v in r.snapshot().items():
            out[k] = out.get(k, 0) + v
    return out
