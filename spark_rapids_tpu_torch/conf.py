"""Typed configuration registry (the RapidsConf role), trimmed to the keys
the ported slice reads.

Entries are declared once with a key, a doc string and a typed default;
``TorchConf`` is the bound view over one session's settings dict.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass
class ConfEntry:
    """One typed config entry."""

    key: str
    doc: str
    default: Any
    converter: Callable[[str], Any]

    def get(self, conf: Dict[str, Any]) -> Any:
        raw = conf.get(self.key)
        if raw is None:
            return self.default
        if isinstance(raw, str):
            return self.converter(raw)
        return raw


_REGISTRY: Dict[str, ConfEntry] = {}


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes")


def _entry(key: str, doc: str, default: Any,
           converter: Callable[[str], Any]) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf key {key}")
    e = ConfEntry(key, doc, default, converter)
    _REGISTRY[key] = e
    return e


HAS_NANS = _entry(
    "spark.rapids.sql.hasNans",
    "Assume floating point data may contain NaN. False drops the is-NaN "
    "word from float grouping and ordering keys (one fewer sort word "
    "per float key); the session applies it per query.",
    True, _to_bool)

ENABLE_FLOAT_AGG = _entry(
    "spark.rapids.sql.variableFloatAgg.enabled",
    "Allow float sums, averages and stddev/variance on the device, "
    "whose results can differ from the CPU's in the last bits because "
    "the additions run in another order. False raises at plan rewrite "
    "with the reason the JAX package tags such an aggregate with.",
    False, _to_bool)

INCOMPATIBLE_OPS = _entry(
    "spark.rapids.sql.incompatibleOps.enabled",
    "Allow expressions that are not exactly Spark's on every input: the "
    "byte-level string operators (exact for ASCII) and float arithmetic "
    "on a device whose float results are not correctly rounded (the "
    "capability probes of device_caps.py).",
    False, _to_bool)

ANSI_ENABLED = _entry(
    "spark.sql.ansi.enabled",
    "ANSI SQL mode (Spark SQLConf); exposed as TorchConf.ansi_enabled. "
    "A cast built with ansi=True raises ArithmeticError on overflow.",
    False, _to_bool)

SHUFFLE_PARTITIONS = _entry(
    "spark.sql.shuffle.partitions",
    "Partition count for hash and range exchanges (Spark SQLConf).",
    8, int)

DEVICE_SHUFFLE_PARTITIONS = _entry(
    "spark.rapids.sql.shuffle.devicePartitions",
    "Partition count for device hash and range exchanges that the "
    "planner inserted; 0 = auto, which is 1 on one card (the port has "
    "no mesh). One card runs every partition's work one after another, "
    "so extra in-process partitions only add splits and launches. A "
    "user's repartition(n, ...) keeps its n.",
    0, int)

BATCH_SIZE_ROWS = _entry(
    "spark.rapids.sql.batchSizeRows",
    "Target row count of a device columnar batch; the row-to-columnar "
    "upload coalesces or splits host batches toward it.",
    1 << 20, int)

CASE_SENSITIVE = _entry(
    "spark.sql.caseSensitive",
    "Case sensitivity of column resolution (Spark SQLConf).",
    False, _to_bool)

KERNEL_GROUPBY_TABLE_SLOTS = _entry(
    "spark.rapids.sql.kernel.groupbyHash.tableSlots",
    "Hash-table capacity (slots, rounded up to a power of two) of the "
    "partial group-by kernel. A batch with more distinct groups than "
    "the table holds overflows and re-runs on the sort-based partial "
    "aggregate (counted as overflowReruns).",
    1024, int)


def parse_bytes(s: str) -> int:
    """'512m', '16g', '-1' style byte sizes (ConfHelper byteFromString)."""
    s = s.strip().lower()
    mult = 1
    for suffix, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30),
                      ("t", 1 << 40), ("b", 1)):
        if s.endswith(suffix):
            mult = m
            s = s[:-1]
            break
    return int(float(s) * mult)


AUTO_BROADCAST_JOIN_THRESHOLD = _entry(
    "spark.rapids.sql.autoBroadcastJoinThreshold",
    "Maximum estimated build-side size in bytes for a join to use a "
    "broadcast exchange instead of a shuffled hash join; -1 disables "
    "broadcast selection (spark.sql.autoBroadcastJoinThreshold "
    "semantics).",
    10 << 20, parse_bytes)

AQE_ENABLED = _entry(
    "spark.sql.adaptive.enabled",
    "Adaptive query execution: replan at exchange materialization from "
    "the measured output sizes (a shuffled hash join whose build side "
    "lands under the broadcast threshold becomes a broadcast-style join "
    "at run time; small exchange partitions coalesce toward the "
    "advisory size). Both this key and "
    "spark.rapids.sql.adaptive.enabled must be on.",
    True, _to_bool)

AQE_ADVISORY_PARTITION_BYTES = _entry(
    "spark.sql.adaptive.advisoryPartitionSizeInBytes",
    "Target post-shuffle partition size for adaptive partition "
    "coalescing (Spark's advisoryPartitionSizeInBytes).",
    64 << 20, parse_bytes)

ADAPTIVE_ENABLED = _entry(
    "spark.rapids.sql.adaptive.enabled",
    "Adaptive execution over measured exchange statistics: every "
    "exchange records its exact per-partition bytes and rows, and "
    "before the probe side runs a shuffled hash join may become a "
    "broadcast (adaptive.autoBroadcastBytes), undersized partitions "
    "coalesce toward adaptive.targetPartitionBytes, and stream "
    "partitions above adaptive.skewFactor x the median split. Rows are "
    "identical to the unadaptive plan's. Both this key and "
    "spark.sql.adaptive.enabled must be on.",
    True, _to_bool)

ADAPTIVE_AUTO_BROADCAST_BYTES = _entry(
    "spark.rapids.sql.adaptive.autoBroadcastBytes",
    "Run-time broadcast demotion threshold: a shuffled hash join whose "
    "measured build-side bytes (active-row refined) are at or under it "
    "becomes a broadcast-style join and drops the stream side's "
    "co-partitioning exchange. -1 inherits "
    "spark.rapids.sql.autoBroadcastJoinThreshold.",
    -1, parse_bytes)

ADAPTIVE_TARGET_PARTITION_BYTES = _entry(
    "spark.rapids.sql.adaptive.targetPartitionBytes",
    "Size adaptive execution coalesces undersized exchange partitions "
    "toward. 0 inherits spark.sql.adaptive.advisoryPartitionSizeInBytes.",
    0, parse_bytes)

ADAPTIVE_SKEW_FACTOR = _entry(
    "spark.rapids.sql.adaptive.skewFactor",
    "A stream-side join partition larger than this factor times the "
    "median non-empty partition splits into sub-partitions, each joined "
    "against the same build partition. 0 disables skew splitting.",
    4.0, float)


TASK_PARALLELISM = _entry(
    "spark.rapids.sql.taskParallelism",
    "Partition-execution threads the scan plans its splits for: the "
    "file scan sizes partitions so its bytes spread over this many "
    "tasks (Spark's FilePartition.maxSplitBytes). A plan with no device "
    "operator (the engine off, or every operator on the host) also "
    "drains its partitions on this many threads; a plan with a device "
    "operator drains them on the collecting thread.",
    1, int)

MAX_READER_BATCH_SIZE_ROWS = _entry(
    "spark.rapids.sql.reader.batchSizeRows",
    "Soft cap on rows per batch produced by file readers; a row group "
    "larger than this host-decodes instead of staging for the device "
    "decode.",
    1 << 20, int)

PARQUET_READER_TYPE = _entry(
    "spark.rapids.sql.format.parquet.reader.type",
    "The file scan's reader strategy, for every format. PERFILE: the "
    "task thread reads its units one by one. MULTITHREADED: a shared "
    "pool of multiThreadedRead.numThreads threads reads and converts "
    "a sliding window of numThreads + 2 units ahead of the task thread "
    "(a Parquet unit still stages for the device decode). COALESCING: "
    "the partition's units are read and stitched into one table, "
    "decoded on the host (no device decode) and emitted in "
    "reader.batchSizeRows slices. The JAX package defaults to "
    "MULTITHREADED; the port keeps PERFILE, since a thread pool "
    "measured slower than the task thread on q1's host planner, which "
    "holds the GIL.",
    "PERFILE", str)

MULTITHREADED_READ_NUM_THREADS = _entry(
    "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads",
    "Thread pool size for the multithreaded reader "
    "(GpuMultiFileReader.scala:300).",
    8, int)

PARQUET_DEVICE_DECODE_MAX_IN_FLIGHT = _entry(
    "spark.rapids.sql.format.parquet.deviceDecode.maxInFlight",
    "Upload pipeline depth of the row-to-columnar transition: how many "
    "staged batches may have their host-to-device copy in flight (the "
    "copy issued on the copy stream, the decode not yet run) ahead of "
    "the consuming operator, per partition. A producer thread reads, "
    "coalesces and packs batch k+1 into a pinned staging slot while "
    "batch k's bytes move and batch k-1 computes. 1 = a producer thread "
    "without upload-ahead; 0 = fully synchronous uploads on the task "
    "thread. Left unset, the ring runs at the default depth only over "
    "a file scan partition of several units (row groups), where there "
    "is reading to overlap; data already in host memory uploads "
    "synchronously. Set, the depth applies to every source.",
    2, int)

STAGE_FUSION_ENABLED = _entry(
    "spark.rapids.sql.stageFusion.enabled",
    "Fuse maximal linear chains of per-batch device operators "
    "(filter -> project -> partial hash-aggregate update) into ONE "
    "stage program per batch (TorchFusedStageExec) — the whole-"
    "stage-codegen / GpuTieredProject analogue. On a CUDA device each "
    "stage program is captured once as a CUDA graph per input shape "
    "and replayed for every batch; on the CPU it runs eagerly. Results "
    "are bit-identical to the unfused plan. Per-operator metrics still "
    "report: fused nodes fan updates back to their constituent execs.",
    True, _to_bool)

STAGE_FUSION_MAX_IN_FLIGHT = _entry(
    "spark.rapids.sql.stageFusion.maxInFlight",
    "Pipeline window of a fused stage: how many batches may be in "
    "flight (dispatched to the device but not yet yielded downstream) "
    "at once. Batch k+1's dispatch overlaps batch k's device compute; "
    "the value bounds device memory held by outstanding batches. 1 = "
    "sequential per-batch draining.",
    2, int)


# -- memory store, spill, retry and planned out-of-core (the JAX package's
#    names and defaults) -----------------------------------------------------

DEVICE_MEMORY_LIMIT = _entry(
    "spark.rapids.memory.tpu.poolSize",
    "Device bytes the spill store lets registered batches hold before it "
    "demotes the least recently used to host memory; 0 = 80% of the "
    "card's memory (torch.cuda.mem_get_info).",
    0, parse_bytes)

HOST_SPILL_STORAGE_SIZE = _entry(
    "spark.rapids.memory.host.spillStorageSize",
    "Host bytes the spill store keeps before it writes the least "
    "recently used spilled batches to the disk tier.",
    1 << 30, parse_bytes)

SPILL_DIR = _entry(
    "spark.rapids.memory.spillDirectory",
    "Directory of the disk spill tier's files (columnar/serde.py "
    "format); every file is removed when its store closes. Default: "
    "srt_spill under the temporary directory ($TMPDIR, else /tmp).",
    os.path.join(tempfile.gettempdir(), "srt_spill"), str)

MEMORY_DEBUG = _entry(
    "spark.rapids.memory.tpu.debug",
    "Log every spill store transition (register, spill, promote).",
    False, _to_bool)

DEVICE_BUDGET_BYTES = _entry(
    "spark.rapids.sql.memory.deviceBudgetBytes",
    "Planned out-of-core budget in bytes: the working-set ceiling the "
    "budget oracle hands operators before they materialize, so a join "
    "build side or an aggregation estimated over its share partitions "
    "up front instead of riding the OOM-retry protocol. 0 = 80% of the "
    "card's memory.",
    0, parse_bytes)

OUT_OF_CORE_ENABLED = _entry(
    "spark.rapids.sql.outOfCore.enabled",
    "Planned out-of-core execution: operators consult the budget oracle "
    "before materializing and partition their working set (hash join, "
    "final aggregate) when it is over their share; rows are identical "
    "to the in-memory paths.",
    True, _to_bool)

OUT_OF_CORE_BUDGET_SHARE = _entry(
    "spark.rapids.sql.outOfCore.budgetShare",
    "Fraction of the device budget's headroom one operator's working "
    "set may claim before the planned out-of-core tier engages.",
    0.5, float)

OUT_OF_CORE_MAX_PARTITIONS = _entry(
    "spark.rapids.sql.outOfCore.maxPartitions",
    "Ceiling on the partition count the budget oracle plans up front "
    "(estimate / share, rounded up to a power of two); a partition that "
    "still overflows re-partitions recursively.",
    64, int)

OUT_OF_CORE_MAX_RECURSION = _entry(
    "spark.rapids.sql.outOfCore.maxRecursion",
    "Bound on recursive re-partitioning (each level doubles the hash "
    "modulus); past it the partition rides the OOM-retry protocol.",
    3, int)

RETRY_MAX_RETRIES = _entry(
    "spark.rapids.sql.retry.maxRetries",
    "OOM retries of one device operation before the failure escalates "
    "(split-and-retry where the operator splits its input, else the "
    "error is raised). Each retry releases cached stage graphs, spills "
    "the store down and backs off.",
    3, int)

RETRY_BACKOFF_MS = _entry(
    "spark.rapids.sql.retry.backoffMs",
    "Base backoff in milliseconds between OOM retries; doubles per "
    "attempt up to retry.maxBackoffMs (reported as retryBlockTime).",
    1, int)

RETRY_MAX_BACKOFF_MS = _entry(
    "spark.rapids.sql.retry.maxBackoffMs",
    "Upper bound in milliseconds on the OOM-retry backoff.",
    100, int)

READER_MAX_RETRIES = _entry(
    "spark.rapids.sql.reader.maxRetries",
    "Retries of a transient IO error in the file reader; the original "
    "error is raised after them.",
    3, int)

READER_RETRY_BACKOFF_MS = _entry(
    "spark.rapids.sql.reader.retryBackoffMs",
    "Base backoff in milliseconds between reader IO retries; doubles per "
    "attempt (bounded at 1 s).",
    5, int)

CONCURRENT_GPU_TASKS = _entry(
    "spark.rapids.sql.concurrentGpuTasks",
    "Tasks that may use the card at once (the device semaphore's "
    "permits). The port runs one task thread, so the semaphore is "
    "uncontended; it keeps its contract that a failed query returns "
    "every permit.",
    2, int)

SHUFFLE_COMPRESSION_CODEC = _entry(
    "spark.rapids.shuffle.compression.codec",
    "Codec of serialized batch payloads in the disk spill tier: none, "
    "zlib or zstd.",
    "none", str)

INJECT_OOM = _entry(
    "spark.rapids.sql.test.injectOOM",
    "Testing: deterministic synthetic-OOM schedule for the retry "
    "protocol. 'N' = every Nth wrapped allocation throws TorchRetryOOM; "
    "'N:K' = K consecutive failures at every Nth; 'split:N' = "
    "TorchSplitAndRetryOOM every Nth; 'seed:S:P' = seeded random with "
    "probability P; 'site:NAME:SPEC' scopes any form to the named site "
    "(site:upload = the upload's copy to the card); site:budget makes "
    "every Nth budget-oracle query report half the real headroom.",
    "", str)

INJECT_IO_ERROR = _entry(
    "spark.rapids.sql.test.injectIOError",
    "Testing: deterministic synthetic IO-error schedule for the Parquet "
    "reader; the same 'N' / 'N:K' / 'seed:S:P' grammar as injectOOM.",
    "", str)


UDF_COMPILER_ENABLED = _entry(
    "spark.rapids.sql.udfCompiler.enabled",
    "Compile Python lambda UDFs (F.udf) into expressions that run on the "
    "device (udf_compiler.py); a lambda outside the compiler's subset "
    "stays a Python UDF.",
    False, _to_bool)

CONCURRENT_PYTHON_WORKERS = _entry(
    "spark.rapids.python.concurrentPythonWorkers",
    "Most Python worker processes that evaluate pandas UDFs and "
    "mapInPandas at once; the pool is the throttle (a task borrowing a "
    "worker waits for a free one).",
    2, int)

SQL_ENABLED = _entry(
    "spark.rapids.sql.enabled",
    "Enable (true) or disable (false) GPU acceleration of SQL plans. Off, "
    "the CPU plan runs on the host engine with no rewrite.",
    True, _to_bool)

EXPLAIN = _entry(
    "spark.rapids.sql.explain",
    "Explain why parts of a query were or were not placed on the GPU: "
    "NONE (silent), NOT_ON_GPU (print one line per operator fallback "
    "with the reason and the offending expression subtree), or ALL (also "
    "list every operator that will run on the GPU). NOT_ON_TPU is "
    "accepted as an alias of NOT_ON_GPU.",
    "NONE", str)

CBO_ENABLED = _entry(
    "spark.rapids.sql.optimizer.enabled",
    "Cost-based optimizer: revert a device island between two "
    "transitions to the CPU when its transition cost outweighs its "
    "estimated CPU work. Off by default, as in the reference.",
    False, _to_bool)

TEST_FORCE_DEVICE = _entry(
    "spark.rapids.sql.test.forceDevice",
    "Testing: fail instead of falling back to the CPU when an operator "
    "is unsupported.",
    False, _to_bool)


class TorchConf:
    """Bound view over a conf dict."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self.settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry) -> Any:
        return entry.get(self.settings)

    def get_key(self, key: str, default: Any = None) -> Any:
        e = _REGISTRY.get(key)
        if e is not None:
            return e.get(self.settings)
        return self.settings.get(key, default)

    def is_set(self, entry: ConfEntry) -> bool:
        return self.settings.get(entry.key) is not None

    def set(self, key: str, value: Any) -> None:
        self.settings[key] = value

    def is_op_enabled(self, conf_key: str, default: bool = True) -> bool:
        """``spark.rapids.sql.exec.<Op>`` and
        ``spark.rapids.sql.expression.<Expr>``: an operator or expression
        is enabled unless its key says false."""
        raw = self.settings.get(conf_key)
        if raw is None:
            return default
        return raw if isinstance(raw, bool) else _to_bool(str(raw))

    @property
    def sql_enabled(self) -> bool:
        return bool(self.get(SQL_ENABLED))

    @property
    def explain(self) -> str:
        return str(self.get(EXPLAIN)).upper()

    @property
    def batch_size_rows(self) -> int:
        return int(self.get(BATCH_SIZE_ROWS))

    @property
    def ansi_enabled(self) -> bool:
        return bool(self.get(ANSI_ENABLED))

    @property
    def shuffle_partitions(self) -> int:
        return int(self.get(SHUFFLE_PARTITIONS))
