"""Operator metrics (the counterpart of ``spark_rapids_tpu.metrics``,
trimmed to what the port records).

Every ``TorchExec`` owns a ``MetricRegistry`` as ``self.metrics``: named
integer metrics, created on first use. Timers are host wall-clock
nanoseconds. The JAX package's verbosity levels, trace spans, epochs,
retired totals and live-registry walk are not ported yet: the port
keeps every metric it records.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List

import torch

NUM_OUTPUT_ROWS = "numOutputRows"
NUM_OUTPUT_BATCHES = "numOutputBatches"
COPY_TO_DEVICE_TIME = "copyToDeviceTime"
COPY_FROM_DEVICE_TIME = "copyFromDeviceTime"
PACK_TIME = "packBatchTime"  # host-side staging half of an upload
CONCAT_TIME = "concatTime"
OP_TIME = "opTime"  # an operator's host wall, no synchronise (window, expand)
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


class Metric:
    """A thread-safe integer: the upload's producer thread and the task
    thread update one operator's metrics concurrently. ``add`` also
    takes a 0-d device tensor (a batch's row count still on the card),
    read back only when ``value`` is read, so counting never waits for
    the card."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._pending: List[torch.Tensor] = []
        self._lock = threading.Lock()

    def add(self, v) -> None:
        with self._lock:
            if isinstance(v, torch.Tensor):
                self._pending.append(v)
            else:
                self._value += int(v)

    def set_max(self, v: int) -> None:
        """Raise the value to ``v`` if it is larger (a high-watermark)."""
        with self._lock:
            self._value = max(self._value, int(v))

    @property
    def value(self) -> int:
        with self._lock:
            if self._pending:
                self._value += int(torch.stack(self._pending).sum())
                self._pending = []
            return self._value


class MetricRegistry:
    """One exec's metric map."""

    def __init__(self):
        self.metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()

    def create(self, name: str) -> Metric:
        with self._lock:
            m = self.metrics.get(name)
            if m is None:
                m = self.metrics[name] = Metric(name)
            return m

    def value(self, name: str) -> int:
        m = self.metrics.get(name)
        return m.value if m else 0

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        """Add the host wall time of the block, in nanoseconds. It never
        calls ``torch.cuda.synchronize()``: a synchronise inside a timer
        would serialise the upload ring, so a timer around device work
        measures its enqueue, not its run on the card."""
        m = self.create(name)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            m.add(time.perf_counter_ns() - t0)

    def snapshot(self) -> Dict[str, int]:
        return {k: m.value for k, m in list(self.metrics.items())}


def plan_metrics(plan) -> Dict[str, int]:
    """Every exec registry of an executed plan summed by name, fused-stage
    constituents included (the JAX package's
    ``registry_snapshot(plans)["metrics"]``)."""
    out: Dict[str, int] = {}
    for node in [plan] + list(getattr(plan, "fused_ops", [])):
        ms = getattr(node, "metrics", None)
        if isinstance(ms, MetricRegistry):
            for k, v in ms.snapshot().items():
                out[k] = out.get(k, 0) + v
    for c in getattr(plan, "children", []):
        for k, v in plan_metrics(c).items():
            out[k] = out.get(k, 0) + v
    return out
