"""TorchShuffledHashJoinExec / TorchBroadcastHashJoinExec (the
counterparts of ``spark_rapids_tpu.exec.join``'s TpuShuffledHashJoinExec
and TpuBroadcastHashJoinExec) over ``ops/join.device_join``.

Each exec counts the route its joins took in ``route_counts``:
``joinProbe`` (joins dispatched to the joinProbe kernel) and
``fkFastPathJoins`` (broadcasts whose build keys were certified unique).

Memory, as in the JAX package: every join runs under ``with_retry``; a
shuffled join's stream side waits in the spill store while the build
side is read. When the budget oracle says the build side's bytes are
over the operator's share, the shuffled join runs out of core
(``_ooc_join``): both sides split by ``pmod(murmur3(keys), modulus)``
into spill-backed buckets (the murmur3 kernel on the card), and each
bucket pair joins through the usual route (joinProbe or the sort path);
a bucket still over the share re-partitions at a doubled modulus.

A residual (non-equi) condition of an inner join is bound against the
pair's columns and applied as a device filter on the joined pairs,
inside the retried attempt (``_join_one``), on every route: the
broadcast stream and its chunks, a shuffled co-partition and its chunks,
and each out-of-core bucket pair. A join with a condition never takes
the FK fast path, as in the JAX package. A conditional outer join gets
the JAX package's reason from ``is_device_join`` and runs on the host
(``sql/physical.py``), as there.

Adaptive execution (``adaptive.py``), in the JAX package's order:
a shuffled join first materializes its build-side exchange, and when the
measured bytes are at or under ``adaptive.autoBroadcastBytes`` it runs
as a broadcast-style join (``aqeBroadcastFlip``): the build side
concatenated once, the stream side's co-partitioning exchange dropped
and the surviving subtree cloned, re-fused and put in its place
(``_replan_stream_side``), so ``last_plan`` shows what ran. Otherwise,
a stream-side partition above ``adaptive.skewFactor`` x the median
splits into sub-partitions, each joined against the same build
partition (``aqeSkewSplits``).

The cross-query build cache (``spark.rapids.sql.subplanCache.enabled``,
``serve/result_cache.py``): a broadcast join's built table, and a
demoted join's, is kept in the device store's cache tier keyed on the
build subtree's structural signature and checked against its input
files' fingerprints at every reuse; a hit skips the build subtree
(``subplanCacheHits``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    concat_device)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops.join import (MASK_JOINS, PAIR_JOINS,
                                             build_key_max_multiplicity,
                                             device_join,
                                             right_extras_batch)
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T


def is_device_join(join_type: str, left_keys: List[E.Expression],
                   right_keys: List[E.Expression],
                   condition: Optional[E.Expression] = None, conf=None,
                   device=None) -> Optional[str]:
    """Tagging helper: None when the join runs on the device; else the
    JAX package's reason (``spark_rapids_tpu.exec.join.is_device_join``)."""
    if join_type not in PAIR_JOINS + MASK_JOINS:
        return f"join type {join_type} is not supported on TPU"
    if condition is not None and join_type not in ("inner", "cross"):
        return (f"conditional {join_type} join runs on CPU (residual "
                "conditions are device-filtered for inner joins only)")
    if condition is not None:
        r = X.unsupported_reason(condition, conf, device)
        if r:
            return r
        if X.contains_ansi_cast(condition):
            return "ANSI casts in join conditions run on CPU"
    for lk, rk in zip(left_keys, right_keys):
        for e in (lk, rk):
            if isinstance(e.data_type, (T.ArrayType, T.MapType,
                                        T.StructType)):
                return "nested join keys are not supported on TPU"
            r = X.unsupported_reason(e, conf, device)
            if r:
                return r
            if X.contains_ansi_cast(e):
                return "ANSI casts in join keys run on CPU"
        if type(lk.data_type) is not type(rk.data_type):
            return (f"mismatched join key types {lk.data_type} vs "
                    f"{rk.data_type} run on CPU")
    return None


class TorchShuffledHashJoinExec(TorchExec):
    # join types whose per-left-row results are independent of other
    # left rows: the stream (left) side may be joined in chunks against
    # the whole build side. Right/full outer chunk too: each chunk joins
    # as inner/leftouter while a matched-right mask accumulates, and the
    # unmatched right rows emit once at the end.
    _LEFT_STREAM_TYPES = ("inner", "cross", "left", "leftouter",
                          "leftsemi", "leftanti")
    _CHUNKED_OUTER = {"right": "inner", "rightouter": "inner",
                      "full": "leftouter", "fullouter": "leftouter"}

    def __init__(self, left_keys: List[E.Expression],
                 right_keys: List[E.Expression], join_type: str,
                 condition: Optional[E.Expression], left: TorchExec,
                 right: TorchExec, output: List[E.AttributeReference],
                 conf: TorchConf, device: torch.device,
                 null_safe: Optional[List[bool]] = None):
        super().__init__(conf, device)
        self.children = [left, right]
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.join_type = join_type
        self.condition = condition
        self._output = output
        self.null_safe = list(null_safe or [False] * len(left_keys))
        self.route_counts: Dict[str, int] = {"joinProbe": 0,
                                             "fkFastPathJoins": 0}

    @property
    def left(self) -> TorchExec:
        return self.children[0]

    @property
    def right(self) -> TorchExec:
        return self.children[1]

    @property
    def output(self):
        return self._output

    def _pair_attrs(self):
        return list(self.left.output) + list(self.right.output)

    def _pair_schema(self) -> T.StructType:
        return T.StructType(
            [T.StructField(a.name, a.data_type, a.nullable)
             for a in self._pair_attrs()])

    def _bound_keys(self):
        return (P.bind_list(self.left_keys, self.left.output),
                P.bind_list(self.right_keys, self.right.output))

    @staticmethod
    def _whole(batches: List[DeviceBatch], schema: T.StructType,
               device: torch.device) -> DeviceBatch:
        return (concat_device(batches) if batches else
                DeviceBatch.empty(schema, device))

    def _join_one(self, lbatches: List[DeviceBatch],
                  rbatches: List[DeviceBatch],
                  fk_hint: bool = False) -> Iterator[DeviceBatch]:
        lwhole = self._whole(lbatches, self.left.schema, self.device)
        rwhole = self._whole(rbatches, self.right.schema, self.device)
        lk, rk = self._bound_keys()
        out_schema = (self.left.schema if self.join_type in MASK_JOINS
                      else self._pair_schema())
        cond = (None if self.condition is None else
                E.bind_references(self.condition, self._pair_attrs()))

        def attempt() -> DeviceBatch:
            out = device_join(lwhole, rwhole, lk, rk, self.join_type,
                              out_schema, null_safe=self.null_safe,
                              fk_hint=fk_hint, counts=self.route_counts)
            if cond is not None:
                out = X.run_filter(cond, out)
            return out

        out = R.with_retry(attempt, self.conf, self.metrics)
        # the exec's declared output may prune/reorder pair columns
        if self.join_type not in MASK_JOINS:
            out = self._project_output(out)
        yield out

    def _project_output(self, pair: DeviceBatch) -> DeviceBatch:
        attrs = self._pair_attrs()
        want = [a.expr_id for a in self._output]
        if want == [a.expr_id for a in attrs]:
            return pair
        have = {a.expr_id: i for i, a in enumerate(attrs)}
        return DeviceBatch(self.schema,
                           [pair.columns[have[w]] for w in want],
                           pair.active, pair._num_rows)

    @staticmethod
    def _chunks(items: List, goal: int, rows: Callable[[Any], int]):
        """Consecutive items (batches or spillable handles) grouped up to
        ``goal`` rows each, ``rows`` giving an item's row count."""
        i = 0
        while i < len(items):
            chunk = [items[i]]
            total = rows(items[i])
            i += 1
            while i < len(items) and total + rows(items[i]) <= goal:
                total += rows(items[i])
                chunk.append(items[i])
                i += 1
            yield chunk

    def _broadcast_stream_thunks(self, left_src: TorchExec,
                                 rwhole: DeviceBatch
                                 ) -> List[DevicePartitionThunk]:
        """Broadcast execution: the resident build side is shared by every
        stream partition, and each stream partition joins goal-rows at a
        time. One sizing probe covers the whole broadcast: unique build
        keys (the dimension-table norm) certify every stream chunk for
        the FK fast path; it is read at the first joined chunk."""
        goal = self.conf.batch_size_rows
        chunkable = self.join_type in self._LEFT_STREAM_TYPES
        fk_state: dict = {}

        def fk_hint() -> bool:
            # no FK fast path under a residual condition, as in the JAX
            # package (which sizes none when a condition is present)
            if self.join_type not in ("inner", "left", "leftouter") \
                    or self.condition is not None:
                return False
            if "v" not in fk_state:
                _lk, rk = self._bound_keys()
                fk_state["v"] = build_key_max_multiplicity(
                    rwhole, rk, self.null_safe) <= 1
                if fk_state["v"]:
                    self.route_counts["fkFastPathJoins"] += 1
            return fk_state["v"]

        def make(lt: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                lb = [b for b in lt() if b._num_rows != 0]
                if not chunkable or \
                        sum(b.row_count() for b in lb) <= goal:
                    yield from self._join_one(lb, [rwhole],
                                              fk_hint=fk_hint())
                    return
                for chunk in self._chunks(lb, goal, DeviceBatch.row_count):
                    yield from self._join_one(chunk, [rwhole],
                                              fk_hint=fk_hint())
            return run
        return [make(t) for t in device_channel(left_src)]

    def device_partitions(self) -> List[DevicePartitionThunk]:
        flipped = self._aqe_try_broadcast()
        if flipped is not None:
            return flipped
        skewed = self._aqe_try_skew_split()
        if skewed is not None:
            return skewed
        lparts = device_channel(self.left)
        rparts = device_channel(self.right)
        assert len(lparts) == len(rparts), \
            "join children must be co-partitioned"
        return [self._partition_join_thunk(lt, rt, len(lparts))
                for lt, rt in zip(lparts, rparts)]

    # -- adaptive execution ------------------------------------------------
    # -- cross-query subplan cache (serve/result_cache.py) -----------------
    def _subplan_cache_key(self) -> Optional[tuple]:
        """``(cache, key)`` for this join's build side when the
        cross-query subplan cache is on, else None. The key is the build
        subtree's structural signature: identical build sides across
        queries, sessions and tenants share one device-resident table."""
        from spark_rapids_tpu_torch.serve import result_cache as RC
        if not RC.subplan_cache_enabled(self.conf):
            return None
        key = RC.subplan_signature(self.right, self.conf)
        return (RC.get_subplan_cache(self.conf), key)

    def _subplan_cache_put(self, probe, captured, rwhole) -> None:
        """Publish a freshly built broadcast table for cross-query reuse
        (a refused entry, with no fingerprints or too large, is
        skipped)."""
        if probe is None or captured is None:
            return
        from spark_rapids_tpu_torch.memory import get_device_store
        cache, key = probe
        cache.put(key, captured, rwhole, get_device_store(self.conf))

    def _aqe_try_broadcast(self) -> Optional[List[DevicePartitionThunk]]:
        """Materialize the build-side exchange; when its measured bytes
        are at or under ``adaptive.autoBroadcastBytes``, run as a
        broadcast-style join: the build side concatenated once and
        shared by every stream partition, and the stream side's
        co-partitioning exchange dropped. The capacity-based bytes
        over-count filtered batches, so a total over the threshold is
        refined by each handle's active-row fraction first (the one
        row-count read adaptive execution makes; a spilled handle keeps
        its full size)."""
        from spark_rapids_tpu_torch import adaptive as A
        from spark_rapids_tpu_torch.exec.exchange import \
            TorchShuffleExchangeExec
        if not A.adaptive_enabled(self.conf):
            return None
        threshold = A.auto_broadcast_bytes(self.conf)
        if threshold < 0 or self.join_type not in self._LEFT_STREAM_TYPES:
            return None
        rexch = self.right
        if not isinstance(rexch, TorchShuffleExchangeExec):
            return None
        handles = [h for part in rexch._materialize() for h in part]
        total = sum(h.sizeof() for h in handles)
        if total > threshold:
            total = 0
            for h in handles:
                cap = h.capacity_hint
                frac = (h.rows / cap) if cap else 1.0
                total += int(h.sizeof() * frac)
                if total > threshold:
                    return None
        self.metrics.create(M.AQE_BROADCAST_FLIP).add(1)
        self.metrics.create(M.AQE_REPLANS).add(1)
        from spark_rapids_tpu_torch.serve import result_cache as RC
        probe = self._subplan_cache_key()
        rwhole = probe[0].lookup(probe[1]) if probe is not None else None
        if rwhole is not None:
            self.metrics.create("subplanCacheHits").add(1)
        else:
            # the exchange keeps its handles: release_plan_handles closes
            # them with the plan (the exchange stays the join's right
            # child)
            rwhole = self._whole([h.get() for h in handles],
                                 self.right.schema, self.device)
            # the build ran during the exchange's materialization above,
            # so the pre-execution capture (a superset of this subtree's
            # inputs) is the only fingerprint honest for this data
            self._subplan_cache_put(
                probe, RC.current_execution_fingerprints(), rwhole)
        left_src = self.left
        if isinstance(left_src, TorchShuffleExchangeExec) and not getattr(
                left_src.partitioning, "user_specified", False):
            # the exchange existed only for this join's co-partitioning
            left_src = self._replan_stream_side(left_src)
        return self._broadcast_stream_thunks(left_src, rwhole)

    def _replan_stream_side(self, exch) -> TorchExec:
        """Drop the stream side's co-partitioning exchange. The surviving
        subtree has not run yet and nothing else holds it (every collect
        plans anew), so it re-enters the fusion pass as it is, since the
        removed boundary can expose a filter/project chain. The join's
        child is rewired, so the executed plan shows the subtree that
        ran."""
        from spark_rapids_tpu_torch.overrides import \
            refuse_replanned_subtree
        new_left = refuse_replanned_subtree(exch.child, self.conf)
        self.children[0] = new_left
        return new_left

    def _aqe_try_skew_split(self) -> Optional[List[DevicePartitionThunk]]:
        """When the stream-side exchange's measured partitions show one
        above ``adaptive.skewFactor`` x the median, that partition's
        retained batches split into sub-partitions, each joined against
        the same build partition. Only for join types whose per-left-row
        results are independent; the planner re-partitions before the
        next keyed operator, so losing the key colocation is harmless."""
        from spark_rapids_tpu_torch import adaptive as A
        from spark_rapids_tpu_torch.exec.exchange import \
            TorchShuffleExchangeExec
        if not A.adaptive_enabled(self.conf) \
                or self.join_type not in self._LEFT_STREAM_TYPES:
            return None
        factor = A.skew_factor(self.conf)
        if factor <= 0:
            return None
        lexch, rexch = self.left, self.right
        for e in (lexch, rexch):
            if not isinstance(e, TorchShuffleExchangeExec):
                return None
        mat = lexch._materialize()
        stats = lexch.exchange_stats
        if stats is None:
            return None
        plan = A.skew_splits(stats, factor)
        if not plan:
            return None
        self.metrics.create(M.AQE_SKEW_SPLITS).add(len(plan))
        self.metrics.create(M.AQE_REPLANS).add(1)
        rparts = device_channel(rexch)
        assert len(mat) == len(rparts), \
            "join children must be co-partitioned"
        thunks: List[DevicePartitionThunk] = []
        for pid, rt in enumerate(rparts):
            pieces = (self._split_partition(mat[pid], plan[pid])
                      if pid in plan else [mat[pid]])
            for items in pieces:
                thunks.append(self._partition_join_thunk(
                    self._items_thunk(items), rt, len(rparts)))
        return thunks

    @staticmethod
    def _items_thunk(items: List) -> DevicePartitionThunk:
        """A stream-partition thunk over already materialized exchange
        handles: promote, never close (the exchange owns them)."""
        def run() -> Iterator[DeviceBatch]:
            for item in items:
                yield item.get()
        return run

    def _split_partition(self, items: List, k: int) -> List[List]:
        """Up to ``k`` sub-partitions of one skewed partition's handles:
        contiguous byte-balanced slices of the list; when the list is
        shorter than ``k``, its largest batch first splits by round-robin
        partition ids (``split_by_pid`` under ``with_retry``). The pieces
        are the join's own spillables; the exchange's handles stay as
        they are."""
        from spark_rapids_tpu_torch import adaptive as A
        if len(items) < k:
            from spark_rapids_tpu_torch.exec.exchange import (
                round_robin_pids, split_by_pid)
            from spark_rapids_tpu_torch.memory import get_device_store
            store = get_device_store(self.conf)
            weights = [A._item_stats(it)[0] for it in items]
            big = max(range(len(items)), key=lambda i: weights[i])
            pieces = k - len(items) + 1
            b = items[big].get()
            pids = round_robin_pids(b.active, 0, pieces)
            parts = R.with_retry(lambda: split_by_pid(b, pids, pieces),
                                 self.conf, self.metrics)
            subs = [self.register_spillable(store, p)
                    for p in parts if p is not None]
            items = items[:big] + subs + items[big + 1:]
        weights = [A._item_stats(it)[0] for it in items]
        return [[items[i] for i in g]
                for g in A.slice_groups(weights, k)]

    def _partition_join_thunk(self, lt: DevicePartitionThunk,
                              rt: DevicePartitionThunk, co_parts: int
                              ) -> DevicePartitionThunk:
        def run() -> Iterator[DeviceBatch]:
            from spark_rapids_tpu_torch.memory import (get_budget_oracle,
                                                       get_device_store)
            store = get_device_store(self.conf)
            # the stream side waits in the store, so a skewed partition
            # never pins both sides at once
            lhandles = [self.register_spillable(store, b)
                        for b in lt() if b._num_rows != 0]
            rb = [b for b in rt() if b._num_rows != 0]
            # planned out-of-core: a build side over the operator's share
            # partitions both sides up front
            oracle = get_budget_oracle(self.conf)
            if rb and oracle.enabled and self._ooc_eligible():
                n = oracle.plan_partitions(sum(b.sizeof() for b in rb),
                                           self.metrics)
                if n > 1:
                    rhandles = [self.register_spillable(store, b)
                                for b in rb]
                    rb = []  # only the store holds the build side now
                    yield from self._ooc_join(store, lhandles, rhandles,
                                              n * max(1, co_parts), oracle,
                                              depth=0)
                    return
            yield from self._join_items(lhandles, rb)
        return run

    def _ooc_eligible(self) -> bool:
        """A partitioned join needs equi-keys to hash (a cross join has
        none: every row would land in one bucket)."""
        return bool(self.left_keys)

    def _ooc_join(self, store, lhandles: List, rhandles: List, modulus: int,
                  oracle, depth: int) -> Iterator[DeviceBatch]:
        """Planned partitioned hash join: both sides split by
        pmod(murmur3(keys), modulus), then each bucket pair joins on its
        own through ``_join_items``. A bucket whose build bytes still
        exceed the share re-partitions at a doubled modulus
        (pmod(h, 2N) refines pmod(h, N)), up to
        ``outOfCore.maxRecursion``; past it the retry protocol is the
        backstop."""
        from spark_rapids_tpu_torch.exec.exchange import hash_buckets
        # equal keys land in the same bucket on both sides
        lk, rk = self._bound_keys()
        lbuckets = hash_buckets(self, store, lhandles, lk, modulus)
        rbuckets = hash_buckets(self, store, rhandles, rk, modulus)
        share = oracle.operator_share()
        for pid in range(modulus):
            lhs, rhs = lbuckets[pid], rbuckets[pid]
            if not lhs and not rhs:
                continue
            if sum(h.sizeof() for h in rhs) > share \
                    and depth < oracle.max_recursion:
                self.metrics.create(M.PLANNED_OOC_ESCALATIONS).add(1)
                yield from self._ooc_join(store, lhs, rhs, modulus * 2,
                                          oracle, depth + 1)
                continue
            rb = [h.get() for h in rhs]
            rwhole = R.with_retry(
                lambda rb=rb: self._whole(rb, self.right.schema,
                                          self.device),
                self.conf, self.metrics)
            for h in rhs:
                h.close()
            yield from self._join_items(lhs, [rwhole])

    def _join_items(self, lhandles: List,
                    rb: List[DeviceBatch]) -> Iterator[DeviceBatch]:
        """One co-partition's join, the stream side as spillable
        handles (the in-memory path and each out-of-core bucket). A
        stream side above the goal row count joins in chunks against the
        build side concatenated once, each chunk re-promoted as it is
        joined; right/full outer chunks accumulate the matched-right mask
        and emit the unmatched right rows at the end."""
        goal = self.conf.batch_size_rows
        chunkable = (self.join_type in self._LEFT_STREAM_TYPES
                     or self.join_type in self._CHUNKED_OUTER)
        if not chunkable or sum(h.rows for h in lhandles) <= goal:
            lb = [h.get() for h in lhandles]
            for h in lhandles:
                h.close()
            yield from self._join_one(lb, rb)
            return
        rwhole = self._whole(rb, self.right.schema, self.device)
        chunk_type = self._CHUNKED_OUTER.get(self.join_type)
        lk, rk = self._bound_keys()
        pair_schema = self._pair_schema()
        matched_any = None
        for chunk in self._chunks(lhandles, goal, lambda h: h.rows):
            lb = [h.get() for h in chunk]
            for h in chunk:
                h.close()
            if chunk_type is None:
                yield from self._join_one(lb, [rwhole])
                continue
            lwhole = concat_device(lb)
            out, matched = R.with_retry(
                lambda: device_join(
                    lwhole, rwhole, lk, rk, chunk_type, pair_schema,
                    collect_matched_r=True, null_safe=self.null_safe,
                    counts=self.route_counts),
                self.conf, self.metrics)
            matched_any = matched if matched_any is None \
                else matched_any | matched
            yield self._project_output(out)
        if chunk_type is None:
            return
        left_fields = [T.StructField(a.name, a.data_type, a.nullable)
                       for a in self.left.output]
        yield self._project_output(right_extras_batch(
            rwhole, matched_any, left_fields, pair_schema))

    def simple_string(self):
        return (f"TorchShuffledHashJoin {self.join_type} "
                f"l={self.left_keys} r={self.right_keys} "
                f"cond={self.condition!r}")


class TorchBroadcastHashJoinExec(TorchShuffledHashJoinExec):
    """Build side (right) materialized once on the card and shared across
    all stream partitions."""

    def device_partitions(self) -> List[DevicePartitionThunk]:
        from spark_rapids_tpu_torch.serve import result_cache as RC
        probe = self._subplan_cache_key()
        captured = None
        if probe is not None:
            cached = probe[0].lookup(probe[1])
            if cached is not None:
                # cross-query build reuse: the build subtree never runs
                self.metrics.create("subplanCacheHits").add(1)
                return self._broadcast_stream_thunks(self.left, cached)
            # fingerprint the build inputs before the build reads them:
            # a file changed mid-build mismatches at reuse time
            captured = RC.capture_fingerprints(self.right)
        rbatches: List[DeviceBatch] = []
        for t in device_channel(self.right):
            rbatches.extend(b for b in t() if b._num_rows != 0)
        # a TorchBroadcastExchangeExec child yields its one built batch
        rwhole = self._whole(rbatches, self.right.schema, self.device)
        self._subplan_cache_put(probe, captured, rwhole)
        return self._broadcast_stream_thunks(self.left, rwhole)

    def simple_string(self):
        return (f"TorchBroadcastHashJoin {self.join_type} "
                f"l={self.left_keys} r={self.right_keys} "
                f"cond={self.condition!r}")
