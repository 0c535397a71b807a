"""Physical plans: the CPU plan nodes the planner emits and the port's
overrides rewrite onto torch device operators.

Execution model mirrors RDD[ColumnarBatch]: each operator exposes
``partitions()`` -> list of thunks yielding HostBatch. Of the CPU
operators only the in-memory scan executes here; the others are plan
nodes that the overrides convert (a per-operator CPU engine is not
ported yet).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch.columnar.host import HostBatch
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
            f"{type(self).__name__} has no CPU execution in "
            "spark_rapids_tpu_torch (not ported yet)")

    def execute_collect(self) -> HostBatch:
        """Drain all partitions in order, one after another."""
        batches = [b for thunk in self.partitions() for b in thunk()]
        if not batches:
            return HostBatch.empty(self.schema)
        return HostBatch.concat(batches)

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
    ``[0, count)``, split into ``num_partitions`` contiguous runs. A
    plan node only: the overrides convert it to ``TorchRangeExec``,
    which generates the values on the device."""

    def __init__(self, output: List[E.AttributeReference], start: int,
                 end: int, step: int, num_partitions: int):
        self.children = []
        self._output = output
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)

    @property
    def output(self):
        return self._output

    def simple_string(self):
        return f"Range ({self.start}, {self.end}, step={self.step})"


# ---------------------------------------------------------------------------
# Plan-only CPU operators (converted by the overrides)
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

    def simple_string(self):
        return f"Expand [{len(self.projections)} sets]"


class CpuProjectExec(_UnaryPlan):
    def __init__(self, project_list: List[E.Expression], child: PhysicalPlan):
        self.children = [child]
        self.project_list = project_list

    @property
    def output(self):
        return [E.named_output(e) for e in self.project_list]

    def simple_string(self):
        return f"Project {self.project_list}"


class CpuGenerateExec(PhysicalPlan):
    """Explode/posexplode (+outer): child rows repeated per array
    element, with the position and element columns (a plan node the
    overrides convert to ``TorchGenerateExec``)."""

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

    def simple_string(self):
        return f"Generate {self.generator!r}"


class CpuFilterExec(_UnaryPlan):
    def __init__(self, condition: E.Expression, child: PhysicalPlan):
        self.children = [child]
        self.condition = condition

    def simple_string(self):
        return f"Filter {self.condition!r}"


class CpuShuffleExchangeExec(_UnaryPlan):
    def __init__(self, partitioning: Partitioning, child: PhysicalPlan):
        self.children = [child]
        self.partitioning = partitioning

    def simple_string(self):
        return f"Exchange {self.partitioning!r}"


class CpuSortExec(_UnaryPlan):
    def __init__(self, order: List[E.SortOrder], is_global: bool,
                 child: PhysicalPlan):
        self.children = [child]
        self.order = order
        self.is_global = is_global

    def simple_string(self):
        return f"Sort {self.order} global={self.is_global}"


class CpuLocalLimitExec(_UnaryPlan):
    def __init__(self, n: int, child: PhysicalPlan):
        self.children = [child]
        self.n = n

    def simple_string(self):
        return f"LocalLimit {self.n}"


class CpuGlobalLimitExec(CpuLocalLimitExec):
    """Requires single-partition input (the planner inserts the
    exchange)."""

    def simple_string(self):
        return f"GlobalLimit {self.n}"


class CpuShuffledHashJoinExec(PhysicalPlan):
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

    def simple_string(self):
        return (f"ShuffledHashJoin {self.join_type} l={self.left_keys} "
                f"r={self.right_keys}")


class CpuBroadcastExchangeExec(_UnaryPlan):
    """Reusable broadcast exchange: the build side materializes once and
    every stream partition shares it."""

    def __init__(self, child: PhysicalPlan):
        self.children = [child]

    def simple_string(self):
        return "BroadcastExchange"


class CpuBroadcastHashJoinExec(CpuShuffledHashJoinExec):
    """Build side (right) fully materialized and shared across stream
    partitions."""

    def simple_string(self):
        return (f"BroadcastHashJoin {self.join_type} l={self.left_keys} "
                f"r={self.right_keys}")


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
    projects results."""

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

    def simple_string(self):
        return (f"HashAggregate mode={self.mode} keys={self.grouping} "
                f"aggs={self.aggregates}")
