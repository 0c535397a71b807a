"""Physical plans and the CPU engine: the plan nodes the planner emits,
which the port's overrides rewrite onto torch device operators, and the
host execution of each (the counterpart of
``spark_rapids_tpu.sql.physical``).

Execution model mirrors RDD[ColumnarBatch]: each operator exposes
``partitions()`` -> list of thunks yielding HostBatch. A CPU operator
runs here when the rewrite leaves it on the host, exactly where the JAX
package's rewrite places it on its CPU (``overrides.py``), and for the
whole plan under ``spark.rapids.sql.enabled=false``. The host evaluation
of every expression is ``sql/expressions.py``'s ``eval``.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql import expressions as E

PartitionThunk = Callable[[], Iterator[HostBatch]]


class Partitioning:
    num_partitions: int
    # set by the planner for df.repartition(n, ...): an explicit user ask
    # that the device rewrite keeps, unlike a planner-inserted exchange
    user_specified = False


class SinglePartitioning(Partitioning):
    num_partitions = 1

    def __repr__(self):
        return "SinglePartition"


class HashPartitioning(Partitioning):
    """Spark HashPartitioning: pmod(murmur3(keys, 42), n)."""

    def __init__(self, exprs: List[E.Expression], num_partitions: int):
        self.exprs = exprs
        self.num_partitions = num_partitions

    def partition_ids(self, batch: HostBatch,
                      bound_exprs: List[E.Expression]) -> np.ndarray:
        h = E.Murmur3Hash(bound_exprs).eval(batch).data.astype(np.int64)
        return np.mod(h, self.num_partitions).astype(np.int32)

    def __repr__(self):
        return f"HashPartitioning({self.exprs}, {self.num_partitions})"


class RoundRobinPartitioning(Partitioning):
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def __repr__(self):
        return f"RoundRobinPartitioning({self.num_partitions})"


class RangePartitioning(Partitioning):
    def __init__(self, order: List[E.SortOrder], num_partitions: int):
        self.order = order
        self.num_partitions = num_partitions

    def __repr__(self):
        return f"RangePartitioning({self.order}, {self.num_partitions})"


class PhysicalPlan:
    children: List["PhysicalPlan"]

    @property
    def output(self) -> List[E.AttributeReference]:
        raise NotImplementedError

    @property
    def schema(self) -> T.StructType:
        return T.StructType([T.StructField(a.name, a.data_type, a.nullable)
                             for a in self.output])

    def partitions(self) -> List[PartitionThunk]:
        raise NotImplementedError(
            f"{type(self).__name__} has no CPU execution")

    def execute_collect(self, parallelism: int = 1) -> HostBatch:
        """Drain all partitions, in partition order, on this thread or on
        a pool of ``parallelism`` task threads. Each task returns the
        device permit its thread holds when it ends or fails, and so does
        this thread. The query's cancel token follows the work onto the
        task threads, and every drained batch is a cancellation
        checkpoint."""
        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch.resource import release_current_thread
        token = LC.current_token()

        def drain(t) -> list:
            try:
                with LC.token_scope(token):
                    out = []
                    for b in t():
                        LC.checkpoint("batch")
                        out.append(b)
                    return out
            finally:
                release_current_thread()

        try:
            thunks = self.partitions()
            if parallelism > 1 and len(thunks) > 1:
                from concurrent.futures import ThreadPoolExecutor
                # partitions() may have drained a device subtree on this
                # thread (a broadcast build side): its permit goes back
                # before this thread waits on the pool
                release_current_thread()
                with ThreadPoolExecutor(
                        min(parallelism, len(thunks)),
                        thread_name_prefix="torch-task") as pool:
                    per_part = list(pool.map(drain, thunks))
                batches = [b for part in per_part for b in part]
            else:
                batches = []
                for thunk in thunks:
                    batches.extend(drain(thunk))
        finally:
            release_current_thread()
        if not batches:
            return HostBatch.empty(self.schema)
        return HostBatch.concat(batches)

    def with_new_children(self, children: List["PhysicalPlan"]
                          ) -> "PhysicalPlan":
        node = copy.copy(self)
        node.children = list(children)
        return node

    def simple_string(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        s = " " * indent + self.simple_string()
        for c in self.children:
            s += "\n" + c.tree_string(indent + 2)
        return s

    def __repr__(self) -> str:
        return self.tree_string()


def bind_list(exprs: Sequence[E.Expression],
              inputs: Sequence[E.AttributeReference]) -> List[E.Expression]:
    return [E.bind_references(e, inputs) for e in exprs]


class _UnaryPlan(PhysicalPlan):
    @property
    def child(self) -> PhysicalPlan:
        return self.children[0]

    @property
    def output(self):
        return self.child.output


def _struct_of(attrs) -> T.StructType:
    return T.StructType([T.StructField(a.name, a.data_type, a.nullable)
                         for a in attrs])


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

class CpuLocalScanExec(PhysicalPlan):
    def __init__(self, output: List[E.AttributeReference],
                 batches: List[HostBatch], num_partitions: int = 1):
        self.children = []
        self._output = output
        self.batches = batches
        self.num_partitions = max(1, num_partitions)

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[PartitionThunk]:
        parts: List[List[HostBatch]] = [[] for _ in
                                        range(self.num_partitions)]
        for i, b in enumerate(self.batches):
            parts[i % self.num_partitions].append(b)
        return [(lambda bs=bs: iter(bs)) for bs in parts]

    def simple_string(self):
        n = sum(b.num_rows for b in self.batches)
        return f"LocalScan [{n} rows x {len(self._output)} cols]"


class CpuRangeExec(PhysicalPlan):
    """``spark.range``: ``start + i * step`` for ``i`` in
    ``[0, count)``, split into ``num_partitions`` contiguous runs. The
    overrides convert it to ``TorchRangeExec``, which generates the
    values on the device."""

    def __init__(self, output: List[E.AttributeReference], start: int,
                 end: int, step: int, num_partitions: int):
        self.children = []
        self._output = output
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[PartitionThunk]:
        total = max(0, (self.end - self.start + self.step
                        - (1 if self.step > 0 else -1)) // self.step)
        per = (total + self.num_partitions - 1) // self.num_partitions \
            if total else 0

        def make(pidx: int) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                lo = pidx * per
                hi = min(total, lo + per)
                if hi <= lo:
                    return
                vals = (self.start
                        + np.arange(lo, hi, dtype=np.int64) * self.step)
                col = HostColumn.all_valid(vals, T.LongT)
                yield HostBatch(self.schema, [col], len(vals))
            return run
        return [make(i) for i in range(self.num_partitions)]

    def simple_string(self):
        return f"Range ({self.start}, {self.end}, step={self.step})"


# ---------------------------------------------------------------------------
# Row-level operators
# ---------------------------------------------------------------------------

class CpuUnionExec(PhysicalPlan):
    """UNION ALL: every child's partitions, in child order, under this
    node's output attributes."""

    def __init__(self, children: List[PhysicalPlan],
                 output: List[E.AttributeReference]):
        self.children = list(children)
        self._output = output

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[PartitionThunk]:
        out: List[PartitionThunk] = []
        schema = self.schema

        def retag(thunk: PartitionThunk) -> PartitionThunk:
            def run():
                for b in thunk():
                    yield HostBatch(schema, b.columns, b.num_rows)
            return run
        for c in self.children:
            out.extend(retag(t) for t in c.partitions())
        return out

    def simple_string(self):
        return "Union"


class CpuExpandExec(_UnaryPlan):
    """Grouping-sets expansion (rollup, cube): each input row once per
    projection, the projections sharing this node's output."""

    def __init__(self, projections: List[List[E.Expression]],
                 output: List[E.AttributeReference], child: PhysicalPlan):
        self.children = [child]
        self.projections = projections
        self._output = output

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[PartitionThunk]:
        bound = [bind_list(p, self.child.output) for p in self.projections]
        schema = self.schema

        def make(thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in thunk():
                    outs = []
                    for proj in bound:
                        cols = [e.eval(b) for e in proj]
                        outs.append(HostBatch(schema, cols, b.num_rows))
                    if outs:
                        yield HostBatch.concat(outs)
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"Expand [{len(self.projections)} sets]"


class CpuProjectExec(_UnaryPlan):
    def __init__(self, project_list: List[E.Expression], child: PhysicalPlan):
        self.children = [child]
        self.project_list = project_list

    @property
    def output(self):
        return [E.named_output(e) for e in self.project_list]

    def partitions(self) -> List[PartitionThunk]:
        bound = bind_list(self.project_list, self.child.output)
        schema = self.schema

        def make(pid: int, thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                rows_seen = 0
                it = iter(thunk())
                while True:
                    # input_file resets before each pull: a scan feeding
                    # this batch sets it again while it yields; any other
                    # producer leaves it "" (Spark's input_file_name()
                    # after a shuffle)
                    E._PART_CTX.input_file = ""
                    b = next(it, None)
                    if b is None:
                        break
                    # partition id and row start right before each eval:
                    # interleaved generators on one thread must not see
                    # each other's context
                    E._PART_CTX.pid = pid
                    E._PART_CTX.row_start = rows_seen
                    cols = [e.eval(b) for e in bound]
                    rows_seen += b.num_rows
                    yield HostBatch(schema, cols, b.num_rows)
            return run
        return [make(i, t)
                for i, t in enumerate(self.child.partitions())]

    def simple_string(self):
        return f"Project {self.project_list}"


class CpuGenerateExec(PhysicalPlan):
    """Explode/posexplode (+outer): child rows repeated per array
    element, with the position and element columns."""

    def __init__(self, generator: E.Expression,
                 gen_output: List[E.AttributeReference],
                 child: PhysicalPlan):
        self.children = [child]
        self.generator = generator
        self.gen_output = gen_output

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + list(self.gen_output)

    def partitions(self) -> List[PartitionThunk]:
        gen = self.generator
        bound = E.bind_references(gen.children[0], self.child.output)
        schema = self.schema
        elem_t = gen.data_type
        np_elem = T.numpy_dtype(elem_t)

        def explode_batch(b: HostBatch) -> HostBatch:
            arr_col = bound.eval(b)
            counts = np.zeros(b.num_rows, dtype=np.int64)
            for i in range(b.num_rows):
                if arr_col.validity[i]:
                    counts[i] = len(arr_col.data[i])
            if gen.outer:
                counts = np.maximum(counts, 1)
            parent = np.repeat(np.arange(b.num_rows), counts)
            total = int(counts.sum())
            pos = np.zeros(total, dtype=np.int32)
            # outer's pad rows carry NULL in every generated column,
            # pos included (Spark's Generate outer semantics)
            is_real = np.zeros(total, dtype=bool)
            if np_elem == np.dtype(object):
                elems = np.full(total, "", dtype=object)
            else:
                elems = np.zeros(total, dtype=np_elem)
            evalid = np.zeros(total, dtype=bool)
            o = 0
            for i in range(b.num_rows):
                n = int(counts[i])
                if n == 0:
                    continue
                row = (arr_col.data[i] if arr_col.validity[i] else ())
                for j in range(len(row)):
                    pos[o + j] = j
                    is_real[o + j] = True
                    if row[j] is not None:
                        elems[o + j] = row[j]
                        evalid[o + j] = True
                o += n
            cols = [c.take(parent) for c in b.columns]
            if gen.position:
                cols.append(HostColumn(T.IntegerT, pos, is_real.copy()))
            cols.append(HostColumn(elem_t, elems, evalid).normalized())
            return HostBatch(schema, cols, total)

        def make(thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in thunk():
                    yield explode_batch(b)
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"Generate {self.generator!r}"


class CpuFilterExec(_UnaryPlan):
    def __init__(self, condition: E.Expression, child: PhysicalPlan):
        self.children = [child]
        self.condition = condition

    def partitions(self) -> List[PartitionThunk]:
        bound = E.bind_references(self.condition, self.child.output)

        def make(pid: int, thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                rows_seen = 0
                it = iter(thunk())
                while True:
                    E._PART_CTX.input_file = ""
                    b = next(it, None)
                    if b is None:
                        break
                    E._PART_CTX.pid = pid
                    E._PART_CTX.row_start = rows_seen
                    rows_seen += b.num_rows
                    p = bound.eval(b)
                    keep = p.validity & p.data.astype(bool)
                    yield b.take(np.nonzero(keep)[0])
            return run
        return [make(i, t)
                for i, t in enumerate(self.child.partitions())]

    def simple_string(self):
        return f"Filter {self.condition!r}"


class CpuLocalLimitExec(_UnaryPlan):
    def __init__(self, n: int, child: PhysicalPlan):
        self.children = [child]
        self.n = n

    def partitions(self) -> List[PartitionThunk]:
        n = self.n

        def make(thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                remaining = n
                for b in thunk():
                    if remaining <= 0:
                        break
                    if b.num_rows > remaining:
                        yield b.slice(0, remaining)
                        remaining = 0
                    else:
                        yield b
                        remaining -= b.num_rows
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"LocalLimit {self.n}"


class CpuGlobalLimitExec(CpuLocalLimitExec):
    """Requires single-partition input (the planner inserts the
    exchange)."""

    def simple_string(self):
        return f"GlobalLimit {self.n}"


# ---------------------------------------------------------------------------
# Exchange
# ---------------------------------------------------------------------------

class CpuShuffleExchangeExec(_UnaryPlan):
    """Materializes the child once and redistributes its rows: hash
    partitioning through the host murmur3 (``Murmur3Hash.eval``), round
    robin, range (equal-depth buckets over the sorted ranks) and single."""

    def __init__(self, partitioning: Partitioning, child: PhysicalPlan):
        self.children = [child]
        self.partitioning = partitioning
        self._cache: Optional[List[List[HostBatch]]] = None
        self._lock = threading.Lock()

    def with_new_children(self, children):
        node = super().with_new_children(children)
        node._cache, node._lock = None, threading.Lock()
        return node

    def _materialize(self) -> List[List[HostBatch]]:
        # a thread parked on the lock must not pin a device permit the
        # materializing thread may need
        from spark_rapids_tpu_torch.resource import release_current_thread
        release_current_thread()
        with self._lock:
            if self._cache is not None:
                return self._cache
            self._cache = out = self._materialize_inner()
            return out

    def _materialize_inner(self) -> List[List[HostBatch]]:
        p = self.partitioning
        n = p.num_partitions
        out: List[List[HostBatch]] = [[] for _ in range(n)]
        if isinstance(p, HashPartitioning):
            bound = bind_list(p.exprs, self.child.output)
            for thunk in self.child.partitions():
                for b in thunk():
                    if b.num_rows == 0:
                        continue
                    pids = p.partition_ids(b, bound)
                    for pid in range(n):
                        idx = np.nonzero(pids == pid)[0]
                        if len(idx):
                            out[pid].append(b.take(idx))
        elif isinstance(p, SinglePartitioning):
            for thunk in self.child.partitions():
                out[0].extend(list(thunk()))
        elif isinstance(p, RoundRobinPartitioning):
            i = 0
            for thunk in self.child.partitions():
                for b in thunk():
                    for pid in range(n):
                        idx = np.arange(pid, b.num_rows, n)
                        if len(idx):
                            out[(i + pid) % n].append(b.take(idx))
                    i += 1
        elif isinstance(p, RangePartitioning):
            out = self._range_partition(p, n)
        else:
            raise NotImplementedError(repr(p))
        return out

    def _range_partition(self, p: RangePartitioning, n: int
                         ) -> List[List[HostBatch]]:
        all_batches: List[HostBatch] = []
        for thunk in self.child.partitions():
            all_batches.extend(b for b in thunk() if b.num_rows)
        out: List[List[HostBatch]] = [[] for _ in range(n)]
        if not all_batches:
            return out
        whole = HostBatch.concat(all_batches)
        order_idx = sort_indices(
            whole, bind_list([o.child for o in p.order], self.child.output),
            p.order)
        ranks = np.empty(len(order_idx), dtype=np.int64)
        ranks[order_idx] = np.arange(len(order_idx))
        # equal-depth bounds over the sorted rank space
        bucket = np.minimum((ranks * n) // max(1, whole.num_rows), n - 1)
        for pid in range(n):
            idx = np.nonzero(bucket == pid)[0]
            if len(idx):
                out[pid].append(whole.take(idx))
        return out

    def partitions(self) -> List[PartitionThunk]:
        nparts = self.partitioning.num_partitions

        def make(pid: int) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                return iter(self._materialize()[pid])
            return run
        return [make(i) for i in range(nparts)]

    def simple_string(self):
        return f"Exchange {self.partitioning!r}"


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------

def _composite_key(c: HostColumn, o: E.SortOrder) -> np.ndarray:
    """One float64 key per row with nulls at +/-inf and the direction
    applied: ranks for decimal128, strings, int64 and floats (exact past
    float64's 53-bit mantissa), the value itself for narrower ints."""
    if T.is_limb_decimal(c.dtype):
        from spark_rapids_tpu_torch.ops import int128 as I
        ints = I.to_pyints(*E._dec_limbs(c))
        uniq = np.sort(np.unique(ints[c.validity])) if c.validity.any() \
            else np.array([], dtype=object)
        r = np.searchsorted(uniq, ints).astype(np.float64)
        base = np.where(c.validity, r, np.nan)
    elif c.data.dtype == np.dtype(object):
        vals = c.to_pylist()
        uniq = sorted({v for v in vals if v is not None})
        ranks = {v: i + 1 for i, v in enumerate(uniq)}
        base = np.array([np.nan if v is None else float(ranks[v])
                         for v in vals], dtype=np.float64)
    elif np.issubdtype(c.data.dtype, np.floating) \
            or c.data.dtype == np.int64:
        raw = (E._float_total_order(c.data)
               if np.issubdtype(c.data.dtype, np.floating) else c.data)
        su = np.unique(raw)
        r = np.searchsorted(su, raw).astype(np.float64)
        base = np.where(c.validity, r, np.nan)
    else:
        base = np.where(c.validity, c.data.astype(np.float64), np.nan)
    if not o.ascending:
        base = -base
    null_key = -np.inf if o.nulls_first else np.inf
    return np.where(np.isnan(base), null_key, base)


def sort_indices(batch: HostBatch, bound_children: List[E.Expression],
                 order: List[E.SortOrder]) -> np.ndarray:
    keys = [_composite_key(e.eval(batch), o)
            for e, o in zip(bound_children, order)]
    return np.lexsort(keys[::-1])


class CpuSortExec(_UnaryPlan):
    def __init__(self, order: List[E.SortOrder], is_global: bool,
                 child: PhysicalPlan):
        self.children = [child]
        self.order = order
        self.is_global = is_global

    def partitions(self) -> List[PartitionThunk]:
        bound = bind_list([o.child for o in self.order], self.child.output)

        def make(thunk: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                batches = [b for b in thunk() if b.num_rows]
                if not batches:
                    return
                whole = HostBatch.concat(batches)
                idx = sort_indices(whole, bound, self.order)
                yield whole.take(idx)
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"Sort {self.order} global={self.is_global}"


# ---------------------------------------------------------------------------
# Hash aggregate (the partial/final split of Spark's aggregate)
# ---------------------------------------------------------------------------

def group_ids(key_cols: List[HostColumn], n: int
              ) -> Tuple[np.ndarray, int, np.ndarray]:
    """(group id per row, number of groups, representative row per
    group), the groups numbered in the order of their first row. Nulls
    form groups; NaN is one key; -0.0 == 0.0. Each key column is coded
    with numpy (an object column through a dict of its values), the codes
    combined and numbered once; a key column of another layout takes the
    row-by-row walk."""
    if n == 0:
        return (np.empty(0, dtype=np.int64), 0,
                np.empty(0, dtype=np.int64))
    if any(c.data.ndim != 1 for c in key_cols):
        return _group_ids_rows(key_cols, n)
    combined = np.zeros(n, dtype=np.int64)
    card = 1
    for c in key_cols:
        codes, k = _key_codes(c)
        if card * k >= (1 << 62):
            # renumber the combination so far before it overflows
            _u, combined = np.unique(combined, return_inverse=True)
            card = len(_u)
        combined = combined * k + codes
        card *= k
    _u, first, inverse = np.unique(combined, return_index=True,
                                   return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return (rank[inverse.reshape(-1)], len(order),
            first[order].astype(np.int64))


def _key_codes(c: HostColumn) -> Tuple[np.ndarray, int]:
    """Per-row codes of one key column, equal exactly where the keys are
    equal (null the code 0), and how many codes there can be."""
    valid = c.validity.astype(bool)
    data = c.data
    if data.dtype == np.dtype(object):
        coded = _string_codes(data, valid)
        if coded is not None:
            return coded
        seen: Dict = {}
        codes = np.fromiter(
            (seen.setdefault(v, len(seen)) if ok else -1
             for v, ok in zip(data.tolist(), valid.tolist())),
            dtype=np.int64, count=len(data))
        return codes + 1, len(seen) + 1
    if np.issubdtype(data.dtype, np.floating):
        norm = np.where(data == 0, 0.0, data).astype(np.float64)
        nan = np.isnan(norm)
        _u, inv = np.unique(np.where(nan, 0.0, norm), return_inverse=True)
        inv = inv.reshape(-1) + 2
        inv = np.where(nan, 1, inv)
        return np.where(valid, inv, 0).astype(np.int64), len(_u) + 2
    _u, inv = np.unique(data, return_inverse=True)
    return (np.where(valid, inv.reshape(-1) + 1, 0).astype(np.int64),
            len(_u) + 1)


def _string_codes(data: np.ndarray, valid: np.ndarray
                  ) -> Optional[Tuple[np.ndarray, int]]:
    """``_key_codes`` of a string column through Arrow's dictionary
    encoding (byte equality is string equality), or None where pyarrow is
    missing or a value is not a string."""
    try:
        import pyarrow as pa
        arr = pa.array(data, type=pa.string(), mask=~valid)
    except Exception:
        return None
    enc = arr.dictionary_encode()
    codes = enc.indices.fill_null(-1).to_numpy(zero_copy_only=False)
    return codes.astype(np.int64) + 1, len(enc.dictionary) + 1


def _group_ids_rows(key_cols: List[HostColumn], n: int
                    ) -> Tuple[np.ndarray, int, np.ndarray]:
    """``group_ids`` row by row, with a tuple of Python values a key."""
    gids = np.empty(n, dtype=np.int64)
    table: Dict[Tuple, int] = {}
    reps: List[int] = []
    key_lists = []
    for c in key_cols:
        if np.issubdtype(c.data.dtype, np.floating):
            key_lists.append([None if not c.validity[i]
                              else ("NaN" if np.isnan(c.data[i])
                                    else float(c.data[i]) + 0.0)
                              for i in range(n)])
        elif c.data.dtype == np.dtype(object):
            key_lists.append([c.data[i] if c.validity[i] else None
                              for i in range(n)])
        else:
            key_lists.append([c.data[i].item() if c.validity[i] else None
                              for i in range(n)])
    for i in range(n):
        k = tuple(kl[i] for kl in key_lists)
        gid = table.get(k)
        if gid is None:
            gid = len(table)
            table[k] = gid
            reps.append(i)
        gids[i] = gid
    return gids, len(table), np.array(reps, dtype=np.int64)


def _limb_update_prim(prim: str, col: HostColumn, gids: np.ndarray,
                      ngroups: int, out_type: T.DataType) -> HostColumn:
    """Group primitives over decimal128 limb columns. Sums accumulate
    four 32-bit parts with np.add.at (each part's sum fits int64 below
    2^31 rows) and recombine exactly per group."""
    from spark_rapids_tpu_torch.ops import int128 as I
    valid = col.validity
    if prim in (E.PRIM_SUM, E.PRIM_SUM_NONNULL):
        every = bool(valid.all())
        gv = gids if every else gids[valid]
        if col.data.ndim == 1:
            # an int64 column: its signed top and unsigned low halves
            v = col.data.astype(np.int64)
            v = v if every else v[valid]
            parts = [v & np.int64(0xFFFFFFFF), v >> np.int64(32)]
        else:
            hi, lo = E._dec_limbs(col)
            hi, lo = (hi, lo) if every else (hi[valid], lo[valid])
            ulo = lo.view(np.uint64)
            parts = [
                (ulo & np.uint64(0xFFFFFFFF)).view(np.int64),
                (ulo >> np.uint64(32)).view(np.int64),
                hi & np.int64(0xFFFFFFFF),
                hi >> np.int64(32),  # signed top part
            ]
        accs = [_group_sum_32(gv, part, ngroups) for part in parts]
        has = np.bincount(gv, minlength=ngroups) > 0
        bound = 10 ** out_type.precision
        totals = []
        for g in range(ngroups):
            t = 0
            for acc in reversed(accs):
                t = (t << 32) + int(acc[g])
            totals.append(0 if abs(t) >= bound else t)
            if abs(t) >= bound:
                has[g] = False  # overflow -> null (non-ANSI Sum)
        rhi, rlo = I.from_pyints(totals)
        data = np.stack([rhi, rlo], axis=1)
        if prim == E.PRIM_SUM_NONNULL:
            return HostColumn.all_valid(data, out_type)
        return HostColumn(out_type, data, has).normalized()
    # first/last/min/max: exact ints, one row at a time
    hi, lo = E._dec_limbs(col)
    ints = I.to_pyints(hi, lo)
    best = [None] * ngroups
    has = np.zeros(ngroups, dtype=bool)
    touched = np.zeros(ngroups, dtype=bool)
    for i in range(len(ints)):
        g = gids[i]
        if prim in (E.PRIM_FIRST_ANY, E.PRIM_LAST_ANY):
            if prim == E.PRIM_FIRST_ANY and touched[g]:
                continue
            touched[g] = True
            has[g] = valid[i]
            best[g] = int(ints[i]) if valid[i] else None
            continue
        if not valid[i]:
            continue
        v = int(ints[i])
        if not has[g]:
            has[g], best[g] = True, v
        elif prim == E.PRIM_LAST:
            best[g] = v
        elif prim == E.PRIM_MIN and v < best[g]:
            best[g] = v
        elif prim == E.PRIM_MAX and v > best[g]:
            best[g] = v
    rhi, rlo = I.from_pyints([0 if b is None else b for b in best])
    return HostColumn(out_type, np.stack([rhi, rlo], axis=1), has
                      ).normalized()


def _group_sum_32(gids: np.ndarray, part: np.ndarray,
                  ngroups: int) -> np.ndarray:
    """Exact int64 sums per group of values below 2^32 in magnitude:
    float64 bincounts over runs of 2^20 rows (a run's sum stays below
    2^52, so each is exact), added up in int64."""
    acc = np.zeros(ngroups, dtype=np.int64)
    run = 1 << 20
    for i in range(0, len(part), run):
        acc += np.rint(np.bincount(
            gids[i:i + run], weights=part[i:i + run].astype(np.float64),
            minlength=ngroups)).astype(np.int64)
    return acc


def apply_update_prim(prim: str, col: HostColumn, gids: np.ndarray,
                      ngroups: int, out_type: T.DataType) -> HostColumn:
    if T.is_limb_decimal(out_type) and prim != E.PRIM_COUNT:
        return _limb_update_prim(prim, col, gids, ngroups, out_type)
    np_dt = T.numpy_dtype(out_type)
    valid = col.validity
    if prim == E.PRIM_COUNT:
        counts = np.bincount(gids[valid], minlength=ngroups) \
            .astype(np.int64)
        return HostColumn.all_valid(counts, T.LongT)
    if prim in (E.PRIM_SUM, E.PRIM_SUM_NONNULL):
        if np_dt == np.dtype(object):
            raise TypeError("sum of non-numeric")
        acc = np.zeros(ngroups, dtype=np_dt)
        with np.errstate(all="ignore"):
            np.add.at(acc, gids[valid], col.data[valid].astype(np_dt))
        has = np.zeros(ngroups, dtype=bool)
        has[gids[valid]] = True
        if prim == E.PRIM_SUM_NONNULL:
            return HostColumn.all_valid(acc, out_type)
        return HostColumn(out_type, acc, has).normalized()
    if prim in (E.PRIM_FIRST_ANY, E.PRIM_LAST_ANY):
        # first/last row per group, nulls included (ignoreNulls=false)
        if np_dt == np.dtype(object):
            data = np.full(ngroups, "", dtype=object)
        else:
            data = np.zeros(ngroups, dtype=np_dt)
        validity = np.zeros(ngroups, dtype=bool)
        touched = np.zeros(ngroups, dtype=bool)
        for i in range(len(col.data)):
            g = gids[i]
            if prim == E.PRIM_FIRST_ANY and touched[g]:
                continue
            touched[g] = True
            validity[g] = valid[i]
            if valid[i]:
                data[g] = col.data[i]
        return HostColumn(out_type, data, validity).normalized()
    if prim in (E.PRIM_COLLECT, E.PRIM_COLLECT_MERGE):
        # gather valid values (or concatenate gathered tuples) per group;
        # buffer rows are always valid: an empty group holds ()
        limb_ints = None
        if prim == E.PRIM_COLLECT and T.is_limb_decimal(col.dtype):
            from spark_rapids_tpu_torch.ops import int128 as I
            # an array element's storage form is the unscaled int
            limb_ints = I.to_pyints(col.data[:, 0], col.data[:, 1])
        lists: List[list] = [[] for _ in range(ngroups)]
        for i in range(len(col.data)):
            if not valid[i]:
                continue
            g = gids[i]
            if prim == E.PRIM_COLLECT:
                v = int(limb_ints[i]) if limb_ints is not None \
                    else col.data[i]
                if isinstance(v, np.generic):
                    v = v.item()
                lists[g].append(v)
            else:
                lists[g].extend(col.data[i])
        data = np.empty(ngroups, dtype=object)
        for g in range(ngroups):
            data[g] = tuple(lists[g])
        return HostColumn.all_valid(data, out_type)
    if prim in (E.PRIM_MIN, E.PRIM_MAX, E.PRIM_FIRST, E.PRIM_LAST):
        if np_dt == np.dtype(object):
            data = np.full(ngroups, "", dtype=object)
        else:
            data = np.zeros(ngroups, dtype=np_dt)
        has = np.zeros(ngroups, dtype=bool)
        is_float = np.issubdtype(col.data.dtype, np.floating) \
            and np_dt != np.dtype(object)
        fk = E._float_total_order(col.data) if is_float else None
        best_key = {}
        for i in range(len(col.data)):
            if not valid[i]:
                continue
            g = gids[i]
            v = col.data[i]
            if not has[g]:
                has[g] = True
                data[g] = v
                if is_float:
                    best_key[g] = fk[i]
                continue
            if prim == E.PRIM_FIRST:
                continue
            if prim == E.PRIM_LAST:
                data[g] = v
            elif is_float:
                if (prim == E.PRIM_MIN and fk[i] < best_key[g]) or \
                        (prim == E.PRIM_MAX and fk[i] > best_key[g]):
                    best_key[g] = fk[i]
                    data[g] = v
            else:
                if (prim == E.PRIM_MIN and v < data[g]) or \
                        (prim == E.PRIM_MAX and v > data[g]):
                    data[g] = v
        return HostColumn(out_type, data, has).normalized()
    raise NotImplementedError(prim)


class AggSlot:
    """One buffer slot of one aggregate function, with its attribute."""

    def __init__(self, name: str, dtype: T.DataType, update_prim: str,
                 update_expr: E.Expression, merge_prim: str):
        self.name = name
        self.dtype = dtype
        self.update_prim = update_prim
        self.update_expr = update_expr
        self.merge_prim = merge_prim
        self.attr = E.AttributeReference(name, dtype, True)


def plan_agg_slots(aggregates: List[E.Expression]) -> Dict[int, List[AggSlot]]:
    """aggregate Alias expr_id -> its slots."""
    out: Dict[int, List[AggSlot]] = {}
    for e in aggregates:
        if isinstance(e, E.Alias) and isinstance(e.child,
                                                 E.AggregateExpression):
            if e.child.is_distinct:
                raise NotImplementedError(
                    "DISTINCT aggregates are not supported yet; rewrite "
                    "with dropDuplicates + aggregate")
            func = e.child.func
            out[e.expr_id] = [AggSlot(f"{e.name}_{s[0]}", s[1], s[2], s[3],
                                      s[4])
                              for s in func.buffer_slots()]
    return out


def agg_output(grouping: List[E.AttributeReference],
               aggregates: List[E.Expression], mode: str,
               slots: Dict[int, List[AggSlot]]) -> List[E.AttributeReference]:
    """Output attributes of an aggregate: keys + buffer slots in partial
    mode, the named results otherwise."""
    if mode == "partial":
        out = list(grouping)
        for e in aggregates:
            if isinstance(e, E.Alias) and isinstance(
                    e.child, E.AggregateExpression):
                out.extend(s.attr for s in slots[e.expr_id])
        return out
    return [E.named_output(e) for e in aggregates]


class CpuHashAggregateExec(_UnaryPlan):
    """mode: 'partial' emits keys+buffers; 'final' merges buffers and
    projects results; 'complete' does both in one node. The collect
    aggregates (``collect_list``, ``collect_set``) run only here: the
    rewrite never places them on the device, as in the JAX package."""

    def __init__(self, grouping: List[E.AttributeReference],
                 aggregates: List[E.Expression], mode: str,
                 child: PhysicalPlan,
                 slots: Optional[Dict[int, List[AggSlot]]] = None):
        self.children = [child]
        self.grouping = grouping
        self.aggregates = aggregates
        self.mode = mode
        self.slots = slots if slots is not None else \
            plan_agg_slots(aggregates)

    @property
    def output(self):
        return agg_output(self.grouping, self.aggregates, self.mode,
                          self.slots)

    def partitions(self) -> List[PartitionThunk]:
        return [self._make(t) for t in self.child.partitions()]

    def _make(self, thunk: PartitionThunk) -> PartitionThunk:
        def run() -> Iterator[HostBatch]:
            batches = [b for b in thunk() if b.num_rows]
            grouped = len(self.grouping) > 0
            if not batches:
                if not grouped and self.mode in ("final", "complete"):
                    yield self._empty_global_result()
                return
            whole = HostBatch.concat(batches)
            yield self._aggregate(whole)
        return run

    def _aggregate(self, whole: HostBatch) -> HostBatch:
        child_out = self.child.output
        key_bound = bind_list(list(self.grouping), child_out)
        key_cols = [e.eval(whole) for e in key_bound]
        if self.grouping:
            gids, ngroups, reps = group_ids(key_cols, whole.num_rows)
        else:
            gids = np.zeros(whole.num_rows, dtype=np.int64)
            ngroups, reps = 1, np.array([0], dtype=np.int64)

        out_cols: List[HostColumn] = []
        if self.mode == "partial":
            for kc in key_cols:
                out_cols.append(kc.take(reps))
            for e in self.aggregates:
                if isinstance(e, E.Alias) and isinstance(
                        e.child, E.AggregateExpression):
                    for s in self.slots[e.expr_id]:
                        bound = E.bind_references(s.update_expr, child_out)
                        col = bound.eval(whole)
                        out_cols.append(apply_update_prim(
                            s.update_prim, col, gids, ngroups, s.dtype))
            return HostBatch(self.schema, out_cols, ngroups)

        # final / complete: the merged buffers of each group
        merged: Dict[int, List[HostColumn]] = {}
        for e in self.aggregates:
            if isinstance(e, E.Alias) and isinstance(e.child,
                                                     E.AggregateExpression):
                cols = []
                for s in self.slots[e.expr_id]:
                    if self.mode == "complete":
                        prim, src = s.update_prim, s.update_expr
                    else:
                        prim, src = s.merge_prim, s.attr
                    bound = E.bind_references(src, child_out)
                    col = bound.eval(whole)
                    cols.append(apply_update_prim(
                        prim, col, gids, ngroups, s.dtype))
                merged[e.expr_id] = cols

        key_by_attr = {a.expr_id: kc.take(reps)
                       for a, kc in zip(self.grouping, key_cols)}
        for e in self.aggregates:
            if isinstance(e, E.Alias) and isinstance(e.child,
                                                     E.AggregateExpression):
                out_cols.append(e.child.func.evaluate(merged[e.expr_id]))
            elif isinstance(e, E.AttributeReference):
                out_cols.append(key_by_attr[e.expr_id])
            elif isinstance(e, E.Alias) and isinstance(e.child,
                                                       E.AttributeReference):
                out_cols.append(key_by_attr[e.child.expr_id])
            else:
                raise NotImplementedError(f"agg result expr {e!r}")
        return HostBatch(self.schema, out_cols, ngroups)

    def _empty_global_result(self) -> HostBatch:
        """A global aggregate over no rows yields one row (sum null,
        count 0)."""
        cols = []
        for e in self.aggregates:
            assert isinstance(e, E.Alias)
            func = e.child.func
            buffers = [HostColumn.nulls(1, s.dtype)
                       for s in self.slots[e.expr_id]]
            cols.append(func.evaluate(buffers))
        return HostBatch(self.schema, cols, 1)

    def simple_string(self):
        return (f"HashAggregate mode={self.mode} keys={self.grouping} "
                f"aggs={self.aggregates}")


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

class CpuShuffledHashJoinExec(PhysicalPlan):
    """Hash join of co-partitioned children, built on the right; the
    residual condition filters the key-matched pairs before the outer
    joins add their unmatched rows, for every join type."""

    _NULL_KEY = "\x00<null-safe-null>\x00"  # stands for a <=> null key

    def __init__(self, left_keys: List[E.Expression],
                 right_keys: List[E.Expression], join_type: str,
                 condition: Optional[E.Expression],
                 left: PhysicalPlan, right: PhysicalPlan,
                 output: List[E.AttributeReference],
                 null_safe: Optional[List[bool]] = None):
        self.children = [left, right]
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.join_type = join_type
        self.condition = condition
        self._output = output
        # per-key <=> flags: a null-safe key matches null to null
        # instead of excluding the row (Spark EqualNullSafe join keys)
        self.null_safe = list(null_safe or [False] * len(left_keys))

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[PartitionThunk]:
        lp = self.left.partitions()
        rp = self.right.partitions()
        assert len(lp) == len(rp), "join children must be co-partitioned"
        return [self._make(lt, rt) for lt, rt in zip(lp, rp)]

    def _key_tuples(self, batch: HostBatch, keys: List[E.Expression],
                    inputs) -> List[Optional[Tuple]]:
        cols = [E.bind_references(k, inputs).eval(batch) for k in keys]
        ns = self.null_safe
        out: List[Optional[Tuple]] = []
        for i in range(batch.num_rows):
            parts = []
            null = False
            for ki, c in enumerate(cols):
                if not c.validity[i]:
                    if ns[ki]:  # <=>: null groups with null
                        parts.append(self._NULL_KEY)
                        continue
                    null = True
                    break
                v = c.data[i]
                if isinstance(v, np.generic):
                    v = v.item()
                if isinstance(v, float):
                    v = "NaN" if v != v else v + 0.0
                parts.append(v)
            out.append(None if null else tuple(parts))
        return out

    def _make(self, lt: PartitionThunk, rt: PartitionThunk) -> PartitionThunk:
        def run() -> Iterator[HostBatch]:
            lb = [b for b in lt() if b.num_rows]
            rb = [b for b in rt() if b.num_rows]
            lwhole = HostBatch.concat(lb) if lb else \
                HostBatch.empty(_struct_of(self.left.output))
            rwhole = HostBatch.concat(rb) if rb else \
                HostBatch.empty(_struct_of(self.right.output))
            yield self._join(lwhole, rwhole)
        return run

    def _pairs(self, lwhole: HostBatch, rwhole: HostBatch
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The key-matched (left row, right row) pairs, left rows in order
        and each one's matches in right row order. The keys are coded
        with numpy, both sides' columns together (``_key_codes``); keys of
        another layout, or of two storage types, take the row walk."""
        lcols = [E.bind_references(k, self.left.output).eval(lwhole)
                 for k in self.left_keys]
        rcols = [E.bind_references(k, self.right.output).eval(rwhole)
                 for k in self.right_keys]
        if any(lc.data.ndim != 1 or rc.data.ndim != 1
               or lc.data.dtype != rc.data.dtype
               for lc, rc in zip(lcols, rcols)):
            return self._pairs_by_rows(lwhole, rwhole)
        nl, nr = lwhole.num_rows, rwhole.num_rows
        code = np.zeros(nl + nr, dtype=np.int64)
        keep = np.ones(nl + nr, dtype=bool)
        card = 1
        for lc, rc, ns in zip(lcols, rcols, self.null_safe):
            both_sides = HostColumn(lc.dtype,
                                    np.concatenate([lc.data, rc.data]),
                                    np.concatenate([lc.validity,
                                                    rc.validity]))
            codes, k = _key_codes(both_sides)
            if not ns:  # a null key matches nothing
                keep &= codes != 0
            if card * k >= (1 << 62):
                _u, code = np.unique(code, return_inverse=True)
                code = code.reshape(-1)
                card = len(_u)
            code = code * k + codes
            card *= k
        lcode, rcode = code[:nl], code[nl:]
        lrows = np.nonzero(keep[:nl])[0]
        rrows = np.nonzero(keep[nl:])[0]
        order = rrows[np.argsort(rcode[rrows], kind="stable")]
        sorted_codes = rcode[order]
        lo = np.searchsorted(sorted_codes, lcode[lrows], "left")
        hi = np.searchsorted(sorted_codes, lcode[lrows], "right")
        counts = hi - lo
        total = int(counts.sum())
        li = np.repeat(lrows, counts).astype(np.int64)
        first = np.repeat(lo - (np.cumsum(counts) - counts), counts)
        ri = order[first + np.arange(total)].astype(np.int64)
        return li, ri

    def _pairs_by_rows(self, lwhole: HostBatch, rwhole: HostBatch
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """``_pairs`` row by row, with a tuple of Python values a key."""
        build_map: Dict[Tuple, List[int]] = {}
        rkeys = self._key_tuples(rwhole, self.right_keys, self.right.output)
        for i, k in enumerate(rkeys):
            if k is not None:
                build_map.setdefault(k, []).append(i)
        lkeys = self._key_tuples(lwhole, self.left_keys, self.left.output)
        li: List[int] = []
        ri: List[int] = []
        for i, k in enumerate(lkeys):
            if k is None:
                continue
            for j in build_map.get(k, ()):
                li.append(i)
                ri.append(j)
        return np.array(li, dtype=np.int64), np.array(ri, dtype=np.int64)

    def _join(self, lwhole: HostBatch, rwhole: HostBatch) -> HostBatch:
        jt = self.join_type
        cond = None
        if self.condition is not None:
            cond = E.bind_references(
                self.condition, list(self.left.output)
                + list(self.right.output))
        lmatched = np.zeros(lwhole.num_rows, dtype=bool)
        rmatched = np.zeros(rwhole.num_rows, dtype=bool)
        li_a, ri_a = self._pairs(lwhole, rwhole)
        if cond is not None and len(li_a):
            pairs = _gather_pair(lwhole, rwhole, li_a, ri_a,
                                 _struct_of(list(self.left.output)
                                            + list(self.right.output)))
            p = cond.eval(pairs)
            keep = p.validity & p.data.astype(bool)
            li_a, ri_a = li_a[keep], ri_a[keep]
        lmatched[li_a] = True
        rmatched[ri_a] = True

        if jt in ("inner", "cross"):
            return _gather_pair(lwhole, rwhole, li_a, ri_a, self.schema)
        if jt in ("left", "leftouter"):
            extra = np.nonzero(~lmatched)[0]
            li_a = np.concatenate([li_a, extra])
            ri_a = np.concatenate([ri_a, np.full(len(extra), -1,
                                                 dtype=np.int64)])
            return _gather_pair(lwhole, rwhole, li_a, ri_a, self.schema)
        if jt in ("right", "rightouter"):
            extra = np.nonzero(~rmatched)[0]
            li_a = np.concatenate([li_a, np.full(len(extra), -1,
                                                 dtype=np.int64)])
            ri_a = np.concatenate([ri_a, extra])
            return _gather_pair(lwhole, rwhole, li_a, ri_a, self.schema)
        if jt in ("full", "fullouter"):
            lex = np.nonzero(~lmatched)[0]
            rex = np.nonzero(~rmatched)[0]
            li_a = np.concatenate([li_a, lex,
                                   np.full(len(rex), -1, dtype=np.int64)])
            ri_a = np.concatenate([ri_a,
                                   np.full(len(lex), -1, dtype=np.int64),
                                   rex])
            return _gather_pair(lwhole, rwhole, li_a, ri_a, self.schema)
        if jt == "leftsemi":
            return lwhole.take(np.nonzero(lmatched)[0])
        if jt == "leftanti":
            # anti keeps rows with no match; null-keyed rows never match
            return lwhole.take(np.nonzero(~lmatched)[0])
        raise NotImplementedError(jt)

    def simple_string(self):
        return (f"ShuffledHashJoin {self.join_type} "
                f"l={self.left_keys} r={self.right_keys} "
                f"cond={self.condition!r}")


def _gather_pair(lwhole: HostBatch, rwhole: HostBatch, li: np.ndarray,
                 ri: np.ndarray, schema: T.StructType) -> HostBatch:
    """Gather rows from both sides; index -1 = null row (outer joins)."""
    cols = [_gather_nullable(c, li) for c in lwhole.columns]
    cols += [_gather_nullable(c, ri) for c in rwhole.columns]
    return HostBatch(schema, cols, len(li))


def _gather_nullable(c: HostColumn, idx: np.ndarray) -> HostColumn:
    if len(c.data) == 0:
        # the empty side of an outer join: every gathered row is null
        return HostColumn.nulls(len(idx), c.dtype)
    safe = np.where(idx >= 0, idx, 0)
    data = c.data[safe]
    validity = np.where(idx >= 0, c.validity[safe], False)
    return HostColumn(c.dtype, data.copy(), validity.astype(bool)
                      ).normalized()


class CpuBroadcastExchangeExec(_UnaryPlan):
    """Reusable broadcast exchange: the build side materializes once,
    behind a lock, and every stream partition shares it."""

    def __init__(self, child: PhysicalPlan):
        self.children = [child]
        self._lock = threading.Lock()
        self._built: Optional[HostBatch] = None
        self.build_count = 0

    def with_new_children(self, children):
        node = super().with_new_children(children)
        node._lock, node._built, node.build_count = \
            threading.Lock(), None, 0
        return node

    def materialize(self) -> HostBatch:
        with self._lock:
            if self._built is None:
                self.build_count += 1
                batches = [b for t in self.child.partitions()
                           for b in t() if b.num_rows]
                self._built = (HostBatch.concat(batches) if batches
                               else HostBatch.empty(self.schema))
            return self._built

    def partitions(self) -> List[PartitionThunk]:
        return [lambda: iter([self.materialize()])]

    def simple_string(self):
        return "BroadcastExchange"


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """Build side (right) fully materialized and shared across stream
    partitions."""

    def partitions(self) -> List[PartitionThunk]:
        if isinstance(self.right, CpuBroadcastExchangeExec):
            rwhole = self.right.materialize()
        else:
            rbatches = [b for t in self.right.partitions()
                        for b in t() if b.num_rows]
            rwhole = (HostBatch.concat(rbatches) if rbatches
                      else HostBatch.empty(_struct_of(self.right.output)))

        def make(lt: PartitionThunk) -> PartitionThunk:
            def run() -> Iterator[HostBatch]:
                lb = [b for b in lt() if b.num_rows]
                lwhole = (HostBatch.concat(lb) if lb else
                          HostBatch.empty(_struct_of(self.left.output)))
                yield self._join(lwhole, rwhole)
            return run
        return [make(t) for t in self.left.partitions()]

    def simple_string(self):
        return (f"BroadcastHashJoin {self.join_type} l={self.left_keys} "
                f"r={self.right_keys}")
