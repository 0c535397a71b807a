"""Typed configuration registry (the RapidsConf role), trimmed to the keys
the ported slice reads.

Entries are declared once with a key, a doc string and a typed default;
``TorchConf`` is the bound view over one session's settings dict.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


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
    "planner inserted; 0 = auto, which is the mesh size while a mesh is "
    "active (spark.rapids.shuffle.mode=ici), else 1. One chip runs "
    "every partition's work one after another, so extra in-process "
    "partitions only add splits and launches. A user's repartition(n, "
    "...) keeps its n.",
    0, int)

SHUFFLE_MODE = _entry(
    "spark.rapids.shuffle.mode",
    "Exchange transport: 'inprocess' (materialized partition lists), "
    "'ici' (the mesh all-to-all: a mesh of chips activated at session "
    "start, every hash exchange moving each row's block to the chip "
    "that owns its partition, parallel/ici.py), or 'external' (SRTB-"
    "serialized partitions over a shared directory, the cross-process "
    "host-staged transport skeleton, parallel/external_shuffle.py).",
    "inprocess", str)

SHUFFLE_ICI_DEVICES = _entry(
    "spark.rapids.shuffle.ici.devices",
    "Number of chips in the shuffle mesh (0 = all visible chips: one "
    "per CUDA card, or the chips parallel.mesh.emulate_chips set).",
    0, int)

MULTICHIP_SCAN_ENABLED = _entry(
    "spark.rapids.sql.multichip.scan.enabled",
    "Shard the scan itself across the active shuffle mesh: scan units "
    "(Parquet row groups, ORC stripes, files) go round-robin-by-bytes to "
    "one reader stream per chip, and each stream's batches upload to "
    "that chip; the per-batch stages then run on each chip's resident "
    "batches and the mesh exchange takes them where they are. Effective "
    "only while a mesh of two or more chips is active; rows are "
    "identical either way.",
    True, _to_bool)

MULTICHIP_SERIALIZE_SERVED = _entry(
    "spark.rapids.sql.multichip.serializeServedQueries",
    "Serialize the mesh exchange sections of concurrently served queries "
    "behind a per-process mesh mutex (the JAX package's guard against "
    "two collectives meeting at one rendezvous). Other queries keep "
    "running their other stages, and a waiting query stays cancellable "
    "(the meshMutex checkpoint). Non-served sessions never take it.",
    True, _to_bool)

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

KERNEL_AUTOTUNE_ENABLED = _entry(
    "spark.rapids.sql.kernel.autotune.enabled",
    "Per-kernel launch-parameter autotuner (kernels/autotune.py): the "
    "first launch of groupbyHash or decodeFused at a new (kernel, "
    "capacity bucket, card) sweeps a small bounded grid of launch "
    "parameters (table-size multiplier, rows a block walks, local-table "
    "divisor; rows a thread decodes), validates every candidate against "
    "its oracle and persists the winner under kernel.autotune.dir. Off "
    "(the default) = read-only: recorded winners still apply, but no "
    "sweep runs.",
    False, _to_bool)

KERNEL_AUTOTUNE_DIR = _entry(
    "spark.rapids.sql.kernel.autotune.dir",
    "Directory of the autotuner's persistent winner table "
    "(kernel-autotune.jsonl, append-only JSON lines, fsynced): loaded "
    "once per process at first use, so a second session against the "
    "same directory runs zero sweeps. Torn lines are skipped and "
    "counted; the last entry for a key wins. Empty = the table lives "
    "in memory only, for this process.",
    "", str)

KERNEL_AUTOTUNE_BUDGET_MS = _entry(
    "spark.rapids.sql.kernel.autotune.budgetMs",
    "Wall budget in milliseconds for one autotune sweep (one kernel at "
    "one capacity bucket): candidates stop once it is spent and the "
    "best validated candidate so far wins; the default candidate "
    "always runs.",
    2000, int)


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
    "Driver-side partition-execution threads (the executor-cores "
    "analogue): a plan's partitions, and a hash or single-partition "
    "exchange's drain of its child, run on this many threads, so the "
    "host work of one task overlaps another's work on the card; "
    "concurrentGpuTasks still bounds simultaneous device use. The file "
    "scan also sizes its partitions so their bytes spread over this "
    "many tasks (Spark's FilePartition.maxSplitBytes). Default 1 "
    "(sequential).",
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
    "permits). Under the query server (serve/) several queries run at "
    "once, each on its connection thread, and contend for these "
    "permits; a waiting task is a lifecycle checkpoint (a cancel or a "
    "deadline interrupts the wait), and a failed or cancelled query "
    "returns every permit.",
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

INJECT_CHIP_FAILURE = _entry(
    "spark.rapids.sql.test.injectChipFailure",
    "Testing: comma-separated mesh chip ids whose dispatches fail "
    "persistently; the mesh degrades to the surviving chips, down to "
    "the single-chip path (retry.degrade_on_chip_failure).",
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


# -- serving (serve/, lifecycle.py, plan_cache.py) ----------------------------

PLAN_CACHE_ENABLED = _entry(
    "spark.rapids.sql.planCache.enabled",
    "Cross-query plan-rewrite cache: the finished physical plan (Planner "
    "+ the overrides rewrite + stage fusion) is cached per normalized "
    "logical-plan signature, and repeated query shapes clone the cached "
    "template instead of re-running the rewrite. Results are identical "
    "(each execution gets fresh operator instances and metric "
    "registries); the cache is the bounded LRU 'planRewrite' in the "
    "jit-cache registry. Off by default; the query server enables it for "
    "its sessions.",
    False, _to_bool)

RESULT_CACHE_ENABLED = _entry(
    "spark.rapids.sql.resultCache.enabled",
    "Serve-tier result cache: the final Arrow IPC payload of a finished "
    "query is kept in a bounded LRU keyed on (plan-signature digest, "
    "extracted literal bindings, input-file fingerprint set). A hit is "
    "detected before admission and served straight from memory (no "
    "device work, no queue wait, no admission slot), and any input-file "
    "fingerprint mismatch (path/size/mtime) invalidates the entry and "
    "falls through to normal execution, so served bytes are always "
    "identical to a fresh run. Off by default.",
    False, _to_bool)

RESULT_CACHE_MAX_ENTRIES = _entry(
    "spark.rapids.sql.resultCache.maxEntries",
    "Bound on distinct cached results; least-recently-served entries "
    "are evicted past it.",
    256, int)

RESULT_CACHE_MAX_BYTES = _entry(
    "spark.rapids.sql.resultCache.maxBytes",
    "Bound on total cached Arrow IPC payload bytes held by the result "
    "cache; LRU eviction keeps the sum under it.",
    256 << 20, int)

SUBPLAN_CACHE_ENABLED = _entry(
    "spark.rapids.sql.subplanCache.enabled",
    "Cross-query broadcast build-table cache: the device-resident build "
    "side of a broadcast hash join is kept keyed on the build subtree's "
    "structural signature + its input-file fingerprint set and reused "
    "across queries and tenants. Entries register in the device store "
    "as evict-first: pool pressure drops cached build tables before any "
    "live query's batches spill. Fingerprints are re-checked on every "
    "reuse; a mismatch drops the entry and rebuilds. Off by default.",
    False, _to_bool)

SUBPLAN_CACHE_MAX_ENTRIES = _entry(
    "spark.rapids.sql.subplanCache.maxEntries",
    "Bound on distinct cached build tables; least-recently-reused "
    "entries are dropped past it.",
    32, int)

SUBPLAN_CACHE_MAX_BYTES = _entry(
    "spark.rapids.sql.subplanCache.maxBytes",
    "Bound on total device bytes the subplan cache may pin; LRU drops "
    "keep the sum under it. The device store may additionally drop "
    "entries at any moment under pool pressure.",
    64 << 20, int)

SERVE_MAX_CONCURRENT = _entry(
    "spark.rapids.sql.serve.maxConcurrentQueries",
    "Queries the server executes simultaneously across all tenants; "
    "admitted queries still contend on concurrentGpuTasks for actual "
    "device access: this bounds whole-query concurrency the way the "
    "semaphore bounds task concurrency.",
    4, int)

SERVE_MAX_QUEUED = _entry(
    "spark.rapids.sql.serve.maxQueued",
    "Bound on queries waiting for admission; a request arriving with the "
    "queue full is REJECTED immediately (backpressure: the client sees "
    "status=rejected and retries with its own policy) instead of growing "
    "an unbounded queue.",
    32, int)

SERVE_MAX_PER_TENANT = _entry(
    "spark.rapids.sql.serve.maxConcurrentPerTenant",
    "Per-tenant in-flight query limit: one tenant cannot occupy every "
    "execution slot no matter how fast it submits.",
    2, int)

SERVE_FAIR_SHARE_FACTOR = _entry(
    "spark.rapids.sql.serve.fairShareFactor",
    "Fair-share device-memory arbitration: a tenant whose live "
    "device-store bytes exceed factor * (pool budget / live tenants) is "
    "over share: its batches spill FIRST under pool pressure (billing "
    "the spill to the offender, not an LRU victim) and its queued "
    "queries are passed over while other tenants wait.",
    1.5, float)

SERVE_BATCH_FUSION_ENABLED = _entry(
    "spark.rapids.sql.serve.batchFusion.enabled",
    "Same-signature batch fusion: concurrent queries whose SQL differs "
    "only in literal bindings are collected within batchFusion.windowMs "
    "and executed under ONE admission slot; identical texts share a "
    "single execution, distinct bindings ride the same cached plan "
    "template and stage programs back-to-back. Per-tenant results stay "
    "identical and each member bills its own tenant ledger and queue "
    "wait; the window engages only while the server is saturated, so an "
    "idle server adds no latency.",
    True, _to_bool)

SERVE_BATCH_FUSION_WINDOW_MS = _entry(
    "spark.rapids.sql.serve.batchFusion.windowMs",
    "Collection window for batch fusion: the first query of a shape "
    "holds its batch open this long (only while the server is saturated) "
    "so same-shape peers can join before execution.",
    10, int)

SERVE_BATCH_FUSION_MAX_BATCH = _entry(
    "spark.rapids.sql.serve.batchFusion.maxBatch",
    "Maximum member queries one fused batch accepts; the next arrival "
    "opens a fresh batch.",
    16, int)

SERVE_HOST = _entry(
    "spark.rapids.sql.serve.host",
    "Interface the query server binds (local serving).",
    "127.0.0.1", str)

SERVE_PORT = _entry(
    "spark.rapids.sql.serve.port",
    "Port the query server binds (0 = ephemeral; the bound port is "
    "returned for clients).",
    0, int)

SERVE_QUERY_TIMEOUT_MS = _entry(
    "spark.rapids.sql.serve.queryTimeoutMs",
    "Per-query deadline in milliseconds, enforced from request admission "
    "(queue wait counts against the budget): a query that exceeds it is "
    "cooperatively cancelled at the engine's lifecycle checkpoints and "
    "returns status=cancelled (reason=deadline) on the wire. 0 disables. "
    "Per-tenant override: set spark.rapids.sql.serve.queryTimeoutMs."
    "<tenant>; a client may TIGHTEN the deadline (or set one where the "
    "operator set none) per request via the sql header's timeoutMs "
    "field: it can never loosen or disable an operator-enforced bound.",
    0, int)

SERVE_WATCHDOG_FACTOR = _entry(
    "spark.rapids.sql.serve.watchdogFactor",
    "Stuck-query watchdog: a running query whose elapsed wall exceeds "
    "this factor times its plan-cache signature's observed p99 wall is "
    "flagged (and, with serve.watchdogCancel, cooperatively cancelled). "
    "Signatures with fewer than 5 observed walls are never flagged. 0 "
    "disables.",
    0.0, float)

SERVE_WATCHDOG_CANCEL = _entry(
    "spark.rapids.sql.serve.watchdogCancel",
    "When the stuck-query watchdog flags a query, also CANCEL it "
    "(reason=watchdog) instead of only counting it. Off by default: "
    "observation first, enforcement opt-in.",
    False, _to_bool)

SERVE_QUARANTINE_THRESHOLD = _entry(
    "spark.rapids.sql.serve.quarantineThreshold",
    "Poison-query quarantine: a plan-cache signature that fails this "
    "many CONSECUTIVE times with a runtime-fatal error (cancellations "
    "and deadline timeouts never count) is blacklisted: further "
    "submissions fail fast with status=quarantined before touching the "
    "device, instead of re-wedging the runtime. One success clears the "
    "streak; a restart clears the blacklist. 0 disables.",
    0, int)

SERVE_DRAIN_TIMEOUT_MS = _entry(
    "spark.rapids.sql.serve.drainTimeoutMs",
    "Graceful-drain deadline of a server shutdown: admission stops "
    "immediately, in-flight queries get this long to finish, then "
    "stragglers are cooperatively cancelled (reason=shutdown) so the "
    "process ends with the store empty and all permits restored.",
    60000, int)

SERVE_TENANT_ID = _entry(
    "spark.rapids.sql.serve.tenantId",
    "Session-scoped tenant id the server sets on each tenant's session; "
    "it bills the store's per-tenant device-memory ledger.",
    "", str)

# The observability slice: span traces and the flight recorder
# (trace.py, telemetry/ring.py), query profiles (profile.py), the
# event log (event_log.py), metric verbosity (metrics.py), the
# telemetry triggers, query history and SLO burn (telemetry/), and
# the serving tier's tuning controller (telemetry/tuning.py). Keys,
# defaults and docs are the JAX package's.

EVENT_LOG_DIR = _entry(
    'spark.rapids.sql.eventLog.dir',
    'Directory for per-query JSON event logs (empty = disabled); the '
    'offline qualification/profiling tools read these '
    '(Qualification.scala:34 / Profiler.scala:31 data source).',
    '', str)

METRICS_LEVEL = _entry(
    'spark.rapids.sql.metrics.level',
    'ESSENTIAL, MODERATE or DEBUG op metric verbosity '
    '(RapidsConf.scala:491, GpuExec.scala:17-103).',
    'MODERATE', str)

TELEMETRY_DIR = _entry(
    'spark.rapids.sql.telemetry.dir',
    'Directory for slow-query bundles emitted by the telemetry '
    'trigger engine (bundle-<pid>-<n>-<trigger>.json + the '
    'flight-recorder dump trace-ring-<pid>-<n>.json it references; '
    "docs/observability.md 'Live telemetry').",
    os.path.join(tempfile.gettempdir(), 'srt_telemetry'), str)

TELEMETRY_SLOW_QUERY_MS = _entry(
    'spark.rapids.sql.telemetry.slowQueryMs',
    'Slow-query trigger: a query whose wall exceeds this many '
    'milliseconds emits a slow-query bundle (flight-recorder dump + '
    'profile artifact path + server stats + the condition) into '
    'spark.rapids.sql.telemetry.dir. 0 disables the trigger.',
    0, int)

TELEMETRY_RETRY_COUNT_THRESHOLD = _entry(
    'spark.rapids.sql.telemetry.retryCountThreshold',
    'Per-query retry trigger: a query whose plan accumulates MORE '
    'than this many retryCount (OOM retries) emits a slow-query '
    'bundle. 0 disables the trigger.',
    0, int)

TELEMETRY_KERNEL_FALLBACK_THRESHOLD = _entry(
    'spark.rapids.sql.telemetry.kernelFallbackThreshold',
    'Per-query kernel-fallback trigger: a query whose plan '
    'accumulates MORE than this many kernelFallbacks.* (kernel calls '
    'that fell back to an oracle composition) emits a slow-query '
    'bundle. 0 disables the trigger. The port has no oracle fallback, '
    'so kernelFallbacks.* stay 0 and this trigger never fires on its '
    'own queries.',
    0, int)

TELEMETRY_RETRY_STORM_THRESHOLD = _entry(
    'spark.rapids.sql.telemetry.retryStormThreshold',
    'Process-wide retry-storm trigger: MORE than this many OOM '
    'retries inside one 60-second window emits a retryStorm bundle '
    '(evaluated at retry time, not query end — a storm is visible '
    'while the storm is happening). 0 disables the trigger.',
    0, int)

TELEMETRY_HBM_WATERMARK = _entry(
    'spark.rapids.sql.telemetry.hbmWatermark',
    'HBM-occupancy trigger: a device-store sample whose live bytes '
    'exceed this fraction of the pool budget emits an hbmWatermark '
    'bundle (evaluated at every store transition). 0 disables the '
    'trigger. Arm it via any session that sets a telemetry conf '
    '(triggers.configure).',
    0.0, float)

TELEMETRY_QUEUE_WATERMARK = _entry(
    'spark.rapids.sql.telemetry.queueWatermark',
    'Admission-saturation trigger: an admission queue whose depth '
    'exceeds this fraction of serve.maxQueued emits a queueSaturation'
    ' bundle (evaluated at every enqueue). 0 disables the trigger.',
    0.0, float)

TELEMETRY_MIN_INTERVAL_S = _entry(
    'spark.rapids.sql.telemetry.triggerMinIntervalS',
    'Per-trigger rate limit: after a trigger fires, further firings '
    'of the SAME trigger inside this many seconds are counted '
    '(rateLimited in the engine stats, '
    'srt_telemetry_triggers_rate_limited_total on the endpoint) but '
    'emit no bundle — a storm cannot flood the disk.',
    60.0, float)

TELEMETRY_MAX_BUNDLES = _entry(
    'spark.rapids.sql.telemetry.maxBundles',
    'Retention bound on telemetry artifacts in '
    'spark.rapids.sql.telemetry.dir: trigger bundles (bundle-*.json) '
    'and flight-recorder dumps (trace-ring-*.json) beyond this count '
    'are pruned OLDEST-FIRST by the bundle-worker thread after each '
    'write (never under a hot-path lock). Pruned counts show in the '
    'engine stats, the server stats telemetry section, and '
    'srt_telemetry_bundles_pruned_total. 0 disables count-based '
    'retention.',
    256, int)

TELEMETRY_MAX_BUNDLE_BYTES = _entry(
    'spark.rapids.sql.telemetry.maxBundleBytes',
    'Retention bound on the TOTAL bytes of telemetry artifacts '
    '(bundles + ring dumps) in spark.rapids.sql.telemetry.dir, pruned'
    ' oldest-first alongside spark.rapids.sql.telemetry.maxBundles. 0'
    ' disables byte-based retention.',
    0, parse_bytes)

TELEMETRY_HISTORY_DIR = _entry(
    'spark.rapids.sql.telemetry.history.dir',
    'Directory of the persistent query-history store: one compact '
    'JSONL record per finished query (signature, tenant, terminal '
    'status/reason, wall/queue-wait, retry/spill/kernel/jit counters,'
    ' fallback coverage, peak HBM, artifact paths), appended at query'
    ' close by session.execute_plan and the query server, rotated '
    'into bounded segments and compacted by '
    'telemetry.history.maxBytes / maxAgeDays. The store is the '
    'cross-run performance memory behind server warm-start, SLO '
    'tracking, `tools history`, and `tools doctor` '
    "(docs/observability.md 'Query history'). Empty = disabled.",
    '', str)

TELEMETRY_HISTORY_MAX_BYTES = _entry(
    'spark.rapids.sql.telemetry.history.maxBytes',
    'Size bound on the query-history store: segments are rotated at a'
    ' fraction of this and the OLDEST whole segments are deleted once'
    " the store's total size exceeds it (each record is one JSON "
    'line, so compaction never truncates a record mid-line).',
    67108864, parse_bytes)

TELEMETRY_HISTORY_MAX_AGE_DAYS = _entry(
    'spark.rapids.sql.telemetry.history.maxAgeDays',
    'Age bound on the query-history store: a rotated segment whose '
    'newest record is older than this many days is deleted at '
    'compaction. 0 disables age-based compaction.',
    14.0, float)

TELEMETRY_HISTORY_WARM_START = _entry(
    'spark.rapids.sql.telemetry.history.warmStart',
    "Seed the serving tier's lifecycle state from the query-history "
    'store at server start: per-signature wall reservoirs (so the '
    'stuck-query watchdog has a p99 from query one after a restart) '
    'and consecutive-failure streaks / quarantine blacklisting (so a '
    'poison signature stays fail-fast across restarts). Effective '
    'only when spark.rapids.sql.telemetry.history.dir is set '
    "(docs/observability.md 'Query history').",
    True, _to_bool)

SERVE_SLO_P99_MS = _entry(
    'spark.rapids.sql.serve.slo.p99Ms',
    "Per-tenant latency objective: the tenant's observed p99 wall "
    'over the spark.rapids.sql.serve.slo.window seconds of query '
    'history must stay under this many milliseconds. Evaluated over '
    'the persistent history store (telemetry.history.dir must be '
    'set), exported as the srt_slo_* Prometheus families, and — when '
    'the observed p99 exceeds the objective — fires a rate-limited '
    'sloBurn bundle through the telemetry trigger engine. Per-tenant '
    'override: spark.rapids.sql.serve.slo.p99Ms.<tenant>. 0 disables '
    "(docs/observability.md 'SLO tracking').",
    0, int)

SERVE_SLO_WINDOW = _entry(
    'spark.rapids.sql.serve.slo.window',
    'SLO evaluation window in seconds: objectives under '
    'spark.rapids.sql.serve.slo.p99Ms are checked against the query '
    "history's finished records newer than this.",
    3600.0, float)

SERVE_TUNING_ENABLED = _entry(
    'spark.rapids.sql.serve.tuning.enabled',
    'History-driven feedback control (docs/tuning.md): the server '
    'embeds a TuningController that scores the query history through '
    'the signature-aggregate + doctor verdict pipeline at start and '
    'on a periodic tick, and applies bounded, logged, reversible '
    'per-signature actions from the declared ACTION_CATALOG — cache '
    'pre-warm for compile storms, admission narrowing / out-of-core '
    'seeding for retry-spill shapes, and per-tenant admission weight shifts for SLO burn. Every '
    'action lands in the history store as a tuning record, exports as'
    ' srt_tuning_* Prometheus families, and auto-reverts when the '
    'post-action baseline regresses (tools tuning '
    'inspects/pins/reverts). Requires telemetry.history.dir; off by '
    'default.',
    False, _to_bool)

SERVE_TUNING_INTERVAL_S = _entry(
    'spark.rapids.sql.serve.tuning.intervalS',
    'Seconds between TuningController scan ticks (history scoring + '
    'action application + guardrail evaluation). The start-of-server '
    'scan always runs regardless (docs/tuning.md).',
    30.0, float)

SERVE_TUNING_MAX_ACTIONS = _entry(
    'spark.rapids.sql.serve.tuning.maxActionsPerTick',
    'Ceiling on NEW tuning actions one scan tick may apply — the '
    'controller converges knob by knob instead of rewriting the whole'
    " server's posture from one noisy window (docs/tuning.md).",
    4, int)

SERVE_TUNING_GUARD_WINDOW = _entry(
    'spark.rapids.sql.serve.tuning.guardWindowQueries',
    'Guardrail sample window: an applied action is judged once this '
    'many post-action finished records exist for its scope — p50/p99 '
    'over the window diffed against the pre-action baseline captured '
    "in the action's evidence; a regression past "
    'serve.tuning.revertThreshold auto-reverts the action '
    '(docs/tuning.md).',
    5, int)

SERVE_TUNING_REVERT_THRESHOLD = _entry(
    'spark.rapids.sql.serve.tuning.revertThreshold',
    'Relative p50/p99 regression past which the guardrail reverts an '
    'applied action — the same relative-change discipline tools '
    'bench-diff gates on ((baseline - candidate) / baseline for '
    'lower-is-better metrics; docs/tuning.md).',
    0.25, float)

SERVE_TUNING_MAX_PREWARM = _entry(
    'spark.rapids.sql.serve.tuning.maxPrewarm',
    'Ceiling on the signatures the compile-storm pre-warm action may '
    'hold in its replay ledger (and therefore on the planning replays'
    ' a server start performs) — startup cost stays bounded no matter'
    ' how storm-prone the history looks (docs/tuning.md).',
    8, int)

TRACE_ENABLED = _entry(
    'spark.rapids.sql.trace.enabled',
    'Record per-query span traces (reader IO/decode, host pack, '
    'upload, per-chip device dispatch, exchange, JIT compiles, '
    'semaphore waits, spills, retries) and write one Chrome-trace '
    'JSON file per query under spark.rapids.sql.trace.dir. Open the '
    'files in Perfetto (https://ui.perfetto.dev) or analyze offline '
    'with `python -m spark_rapids_tpu.tools trace <file>` '
    '(docs/observability.md).',
    False, _to_bool)

TRACE_DIR = _entry(
    'spark.rapids.sql.trace.dir',
    'Directory for per-query Chrome-trace files '
    '(trace-<pid>-q<n>.json).',
    os.path.join(tempfile.gettempdir(), 'srt_traces'), str)

TRACE_SAMPLE_RATE = _entry(
    'spark.rapids.sql.trace.sampleRate',
    'Fraction of queries to trace (1.0 = every query). Sampling is '
    'deterministic for a fixed spark.rapids.sql.trace.sampleSeed: the'
    ' Nth traced-candidate query of the process is sampled iff the '
    'Nth draw of the seeded stream is below the rate — production use'
    ' traces a stable subset at bounded overhead.',
    1.0, float)

TRACE_SAMPLE_SEED = _entry(
    'spark.rapids.sql.trace.sampleSeed',
    'Seed of the deterministic query-sampling stream used by '
    'spark.rapids.sql.trace.sampleRate.',
    0, int)

TRACE_MODE = _entry(
    'spark.rapids.sql.trace.mode',
    "Trace sink: 'file' writes one Chrome-trace JSON per sampled "
    "query (the per-query exporter); 'ring' is the FLIGHT RECORDER — "
    'an always-on, fixed-size, lock-free per-thread ring buffer that '
    'survives across queries with bounded memory (the last '
    'spark.rapids.sql.trace.ringSpans records per thread) and dumps '
    'on demand — slow-query triggers (spark.rapids.sql.telemetry.*) '
    'or telemetry.dump_ring() — as the SAME Chrome-trace JSON, so '
    '`tools trace`/`tools hotspots` work unchanged on dumps. Query '
    "server sessions default to 'ring' (docs/observability.md 'Live "
    "telemetry').",
    'file', str)

TRACE_RING_SPANS = _entry(
    'spark.rapids.sql.trace.ringSpans',
    'Flight-recorder capacity in trace.mode=ring: spans (and instants'
    ' / counter samples) retained PER THREAD before the oldest are '
    'overwritten. Bounds recorder memory on a long-lived server; a '
    'dump reconstructs the most recent window of work.',
    4096, int)

PROFILE_ENABLED = _entry(
    'spark.rapids.sql.profile.enabled',
    'Write one structured profile artifact per executed query '
    '(profile-<pid>-q<n>.json under spark.rapids.sql.profile.dir): '
    "the annotated physical plan with every operator's metrics, the "
    'owner-attributed HBM accounting (per-operator live/peak bytes '
    'against the device-store pool watermarks), and the plan-rewrite '
    'explain (fallbacks with reasons, operator coverage). Render with'
    ' `python -m spark_rapids_tpu.tools profile <file-or-dir>` '
    '(docs/observability.md).',
    False, _to_bool)

PROFILE_DIR = _entry(
    'spark.rapids.sql.profile.dir',
    'Directory for per-query profile artifacts '
    '(profile-<pid>-q<n>.json).',
    os.path.join(tempfile.gettempdir(), 'srt_profiles'), str)


def registered_entries() -> List[ConfEntry]:
    return list(_REGISTRY.values())


def generate_docs() -> str:
    """The Markdown table of every registered key (``docs/torch/
    configs.md``, written by ``python -m spark_rapids_tpu_torch.tools
    docs``)."""
    lines = ["# spark-rapids-tpu PyTorch/CUDA port configuration", "",
             "| Key | Default | Description |", "|---|---|---|"]
    for e in sorted(_REGISTRY.values(), key=lambda e: e.key):
        lines.append(f"| {e.key} | {doc_default(e)} | {e.doc} |")
    return "\n".join(lines) + "\n"


def doc_default(e: ConfEntry) -> str:
    """An entry's default as the generated docs print it: a directory
    under the process's temporary directory reads ``$TMPDIR/...``, so
    the docs do not depend on the machine that wrote them."""
    d = e.default
    tmp = tempfile.gettempdir() + os.sep
    if isinstance(d, str) and d.startswith(tmp):
        return "$TMPDIR/" + d[len(tmp):]
    return str(d)


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
