"""Adaptive query execution over measured exchange statistics (the
counterpart of ``spark_rapids_tpu.adaptive``, without the serving
layer's batch-fusion key).

Every ``TorchShuffleExchangeExec`` records exact per-partition byte and
row counts when it materializes (``ExchangeStats``). This module is the
decision layer over those numbers, read by ``exec/join.py`` (broadcast
demotion, skew splits) and ``exec/exchange.py`` (partition coalescing).

A decision changes how a result is computed, never what it is: the
adaptive-off plan is the oracle for the adaptive plan. ``adaptive_enabled``
needs both ``spark.sql.adaptive.enabled`` and
``spark.rapids.sql.adaptive.enabled``, so either key disables every
run-time replan.
"""

from __future__ import annotations

import re

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from spark_rapids_tpu_torch.conf import (ADAPTIVE_AUTO_BROADCAST_BYTES,
                                         ADAPTIVE_ENABLED,
                                         ADAPTIVE_SKEW_FACTOR,
                                         ADAPTIVE_TARGET_PARTITION_BYTES,
                                         AQE_ADVISORY_PARTITION_BYTES,
                                         AQE_ENABLED,
                                         AUTO_BROADCAST_JOIN_THRESHOLD,
                                         TorchConf)


@dataclass(frozen=True)
class ExchangeStats:
    """Realized per-partition sizes of one materialized exchange.

    Bytes are refined by the active-row fraction where the handle knows
    its rows (a filter only flips the active mask, so capacity-based
    sizes over-count); spilled handles keep their full size. A partition
    whose row counts were never read contributes 0 rows (its bytes still
    count)."""

    partition_bytes: Tuple[int, ...]
    partition_rows: Tuple[int, ...]

    @property
    def num_partitions(self) -> int:
        return len(self.partition_bytes)

    @property
    def total_bytes(self) -> int:
        return sum(self.partition_bytes)

    @property
    def max_bytes(self) -> int:
        return max(self.partition_bytes, default=0)

    @property
    def median_bytes(self) -> int:
        """Median over the non-empty partitions: empty partitions are the
        normal hash-shuffle tail and would drag the median toward zero,
        making every real partition look skewed."""
        live = sorted(b for b in self.partition_bytes if b > 0)
        if not live:
            return 0
        mid = len(live) // 2
        if len(live) % 2:
            return live[mid]
        return (live[mid - 1] + live[mid]) // 2

    @property
    def skew_ratio(self) -> float:
        med = self.median_bytes
        return (self.max_bytes / med) if med > 0 else 0.0


def _item_stats(item) -> Tuple[int, int]:
    """(bytes, rows) of one retained partition item (a ``SpillableBatch``
    handle, or a bare ``DeviceBatch``). Never synchronises: it reads the
    handle's row count only where it is already known, and an unknown
    count reads 0."""
    from spark_rapids_tpu_torch.memory import SpillableBatch
    if isinstance(item, SpillableBatch):
        size = item.sizeof()
        cap = item.capacity_hint
        st = item._state
        rows = st.rows if st.rows is not None else 0
        if cap and st.rows is not None:
            size = int(size * (st.rows / cap))
        return size, int(rows)
    size = int(item.sizeof()) if hasattr(item, "sizeof") else 0
    rows = getattr(item, "_num_rows", None)
    return size, int(rows) if rows is not None else 0


def capture_stats(cache: Sequence[Sequence]) -> ExchangeStats:
    """The ``ExchangeStats`` of a materialized exchange (a list of
    partitions, each a list of retained items)."""
    pbytes: List[int] = []
    prows: List[int] = []
    for part in cache:
        b = r = 0
        for item in part:
            ib, ir = _item_stats(item)
            b += ib
            r += ir
        pbytes.append(b)
        prows.append(r)
    return ExchangeStats(tuple(pbytes), tuple(prows))


# ---------------------------------------------------------------------------
# Conf resolution (the -1 / 0 "inherit" sentinels)
# ---------------------------------------------------------------------------


def adaptive_enabled(conf: TorchConf) -> bool:
    """Both adaptive switches on: the gate of every run-time replan."""
    return bool(conf.get(AQE_ENABLED)) and bool(conf.get(ADAPTIVE_ENABLED))


def auto_broadcast_bytes(conf: TorchConf) -> int:
    """Run-time broadcast demotion threshold; -1 (the default) inherits
    autoBroadcastJoinThreshold. A negative result disables demotion."""
    v = int(conf.get(ADAPTIVE_AUTO_BROADCAST_BYTES))
    if v >= 0:
        return v
    return int(conf.get(AUTO_BROADCAST_JOIN_THRESHOLD))


def target_partition_bytes(conf: TorchConf) -> int:
    """Coalescing target; 0 (the default) inherits the advisory
    partition size."""
    v = int(conf.get(ADAPTIVE_TARGET_PARTITION_BYTES))
    if v > 0:
        return v
    return int(conf.get(AQE_ADVISORY_PARTITION_BYTES))


def skew_factor(conf: TorchConf) -> float:
    return float(conf.get(ADAPTIVE_SKEW_FACTOR))


# ---------------------------------------------------------------------------
# Decision helpers
# ---------------------------------------------------------------------------


def coalesce_groups(sizes: Sequence[int], target: int) -> List[List[int]]:
    """Merge adjacent partitions up to ``target`` bytes (adjacency keeps
    a range partitioning's order); the partition-index groups, in
    order."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, sz in enumerate(sizes):
        if cur and cur_bytes + sz > target:
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sz
    if cur:
        groups.append(cur)
    return groups


# one pathological partition must not explode the count of probe thunks
MAX_SKEW_SPLITS = 16


def skew_splits(stats: ExchangeStats, factor: float) -> Dict[int, int]:
    """Partition index -> sub-partition count (>= 2) for every partition
    whose bytes exceed ``factor`` x the median non-empty partition; the
    count aims each piece back at the median, at most
    ``MAX_SKEW_SPLITS``. ``{}`` means no replan."""
    if factor <= 0:
        return {}
    med = stats.median_bytes
    if med <= 0:
        return {}
    out: Dict[int, int] = {}
    for i, b in enumerate(stats.partition_bytes):
        if b > factor * med:
            out[i] = min(MAX_SKEW_SPLITS, max(2, (b + med - 1) // med))
    return out


def slice_groups(weights: Sequence[int], k: int) -> List[List[int]]:
    """Greedy contiguous slicing of ``len(weights)`` items into at most
    ``k`` groups of about equal weight (contiguity keeps batch order, so
    the joined output's concatenation stays deterministic)."""
    n = len(weights)
    k = max(1, min(k, n))
    total = sum(weights)
    if k == 1 or total <= 0:
        return [list(range(n))]
    goal = total / k
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_w = 0
    remaining = k
    for i, w in enumerate(weights):
        if cur and cur_w + w > goal and len(groups) < remaining - 1:
            groups.append(cur)
            cur, cur_w = [], 0
        cur.append(i)
        cur_w += w
    if cur:
        groups.append(cur)
    return groups


# ---------------------------------------------------------------------------
# Same-signature batch fusion key (serve/scheduler.py)
# ---------------------------------------------------------------------------

_SQL_STRING = re.compile(r"'(?:[^']|'')*'")
_SQL_NUMBER = re.compile(
    r"(?<![A-Za-z0-9_.'\"])\d+(?:\.\d+)?(?![A-Za-z0-9_])")


def fusion_key(sql: str) -> Tuple[str, Tuple[str, ...]]:
    """(normalized text, literal vector) for one SQL string: string and
    numeric literals become ``?`` placeholders and whitespace collapses,
    so queries differing only in literal bindings share a key. The
    literal vector is the binding that distinguishes members inside one
    fused batch (identical SQL => identical vector => one execution).
    The serving layer's proxy for "same plan-cache signature modulo
    literals"; the result cache probes on the pair."""
    literals: List[str] = []

    def keep(m: "re.Match[str]") -> str:
        literals.append(m.group(0))
        return "?"

    s = _SQL_STRING.sub(keep, sql)
    s = _SQL_NUMBER.sub(keep, s)
    return " ".join(s.split()), tuple(literals)
