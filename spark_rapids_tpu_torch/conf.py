"""Typed configuration registry (the RapidsConf role), trimmed to the keys
the ported slice reads.

Entries are declared once with a key, a doc string and a typed default;
``TorchConf`` is the bound view over one session's settings dict.
"""

from __future__ import annotations

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


TASK_PARALLELISM = _entry(
    "spark.rapids.sql.taskParallelism",
    "Partition-execution threads the scan plans its splits for: the "
    "file scan sizes partitions so its bytes spread over this many "
    "tasks (Spark's FilePartition.maxSplitBytes).",
    1, int)

MAX_READER_BATCH_SIZE_ROWS = _entry(
    "spark.rapids.sql.reader.batchSizeRows",
    "Soft cap on rows per batch produced by file readers; a row group "
    "larger than this host-decodes instead of staging for the device "
    "decode.",
    1 << 20, int)

PARQUET_READER_TYPE = _entry(
    "spark.rapids.sql.format.parquet.reader.type",
    "PERFILE: the task thread reads and plans its units one by one. "
    "MULTITHREADED and COALESCING are not ported yet (a thread pool "
    "measured slower than the task thread on q1's host planner, which "
    "holds the GIL).",
    "PERFILE", str)

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

    @property
    def batch_size_rows(self) -> int:
        return int(self.get(BATCH_SIZE_ROWS))

    @property
    def shuffle_partitions(self) -> int:
        return int(self.get(SHUFFLE_PARTITIONS))
