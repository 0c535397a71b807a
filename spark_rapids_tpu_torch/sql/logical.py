"""Logical plans (the Catalyst layer Spark provides in the reference).

Name resolution happens eagerly in the DataFrame API (resolve() below)
rather than in a separate analyzer phase; after construction every
expression in a plan refers to AttributeReferences with unique ids.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.expressions import (
    AggregateExpression, Alias, AttributeReference, Cast, Expression,
    Literal, SortOrder, UnresolvedAttribute, named_output)


class LogicalPlan:
    children: List["LogicalPlan"]

    @property
    def output(self) -> List[AttributeReference]:
        raise NotImplementedError

    @property
    def schema(self) -> T.StructType:
        return T.StructType([
            T.StructField(a.name, a.data_type, a.nullable)
            for a in self.output])

    def __repr__(self) -> str:
        return self._tree_string(0)

    def _tree_string(self, indent: int) -> str:
        s = " " * indent + self.simple_string()
        for c in self.children:
            s += "\n" + c._tree_string(indent + 2)
        return s

    def simple_string(self) -> str:
        return type(self).__name__


def resolve(expr: Expression, inputs: Sequence[AttributeReference],
            case_sensitive: bool = False) -> Expression:
    """Replace UnresolvedAttribute with matching AttributeReference."""

    def norm(s: Optional[str]) -> Optional[str]:
        return s if case_sensitive or s is None else s.lower()

    def base_matches(parts: List[str], k: int) -> List[AttributeReference]:
        """Attributes matching the first k name parts: as a bare (dotted)
        column name, or as qualifier + column (Catalyst's order)."""
        nm = norm(".".join(parts[:k]))
        ms = [a for a in inputs if norm(a.name) == nm]
        if not ms and k >= 2:
            qual, col = norm(parts[0]), norm(".".join(parts[1:k]))
            ms = [a for a in inputs
                  if norm(a.name) == col and norm(a.qualifier) == qual]
        return ms

    def rule(e: Expression) -> Optional[Expression]:
        if isinstance(e, UnresolvedAttribute):
            parts = e.name.split(".")
            # longest base first: `a.s.y` prefers column a.s (or
            # qualifier a + column s) before treating y as a field
            for k in range(len(parts), 0, -1):
                ms = base_matches(parts, k)
                if len(ms) > 1:
                    raise KeyError(f"ambiguous column '{e.name}'")
                if not ms:
                    continue
                out: Expression = ms[0]
                ok = True
                for p in parts[k:]:  # remaining parts walk struct fields
                    dt = out.data_type
                    fld = next(
                        (f.name for f in dt.fields
                         if norm(f.name) == norm(p)), None) \
                        if isinstance(dt, T.StructType) else None
                    if fld is None:
                        ok = False
                        break
                    from spark_rapids_tpu_torch.sql.expressions import \
                        GetStructField
                    out = GetStructField(out, name=fld)
                if ok:
                    return out
            raise KeyError(
                f"cannot resolve '{e.name}' among "
                f"{[a.name for a in inputs]}")
        return None

    return expr.transform(rule)


class MapInPandas(LogicalPlan):
    """DataFrame.mapInPandas(func, schema) (sql/core MapInPandas)."""

    def __init__(self, fn, schema: T.StructType, child: LogicalPlan):
        self.children = [child]
        self.fn = fn
        self._schema = schema
        self._output = [AttributeReference(f.name, f.data_type, f.nullable)
                        for f in schema.fields]

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def simple_string(self) -> str:
        return f"MapInPandas {getattr(self.fn, '__name__', '<fn>')}"


class SubqueryAlias(LogicalPlan):
    """Relation alias (Catalyst SubqueryAlias): same expr_ids, outputs
    re-qualified so ``alias.col`` references resolve. Physically
    transparent — the planner plans straight through it."""

    def __init__(self, alias: str, child: LogicalPlan):
        self.children = [child]
        self.alias = alias

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return [a.with_qualifier(self.alias) for a in self.child.output]

    def simple_string(self) -> str:
        return f"SubqueryAlias {self.alias}"


class LocalRelation(LogicalPlan):
    """In-memory data; plays LocalTableScan / the test-side gen_df source."""

    def __init__(self, schema: T.StructType, batches: List,
                 num_partitions: int = 1):
        from spark_rapids_tpu_torch.columnar.host import HostBatch
        self.children = []
        self._output = [AttributeReference(f.name, f.data_type, f.nullable)
                        for f in schema.fields]
        self._schema = schema
        self.batches: List[HostBatch] = batches
        self.num_partitions = num_partitions

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def simple_string(self) -> str:
        n = sum(b.num_rows for b in self.batches)
        return f"LocalRelation [{n} rows, {len(self._output)} cols]"


class FileScan(LogicalPlan):
    """Parquet/CSV/ORC scan (GpuFileSourceScanExec's logical ancestor)."""

    def __init__(self, fmt: str, paths: List[str], schema: T.StructType,
                 options: Optional[dict] = None):
        self.children = []
        self.fmt = fmt
        self.paths = paths
        self._schema = schema
        self.options = options or {}
        self._output = [AttributeReference(f.name, f.data_type, f.nullable)
                        for f in schema.fields]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output

    def simple_string(self) -> str:
        return f"FileScan {self.fmt} {self.paths}"


class Range(LogicalPlan):
    """spark.range(); GpuRangeExec analogue upstream."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1):
        self.children = []
        self.start, self.end, self.step = start, end, step
        self.num_partitions = num_partitions
        self._output = [AttributeReference("id", T.LongT, nullable=False)]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class Project(LogicalPlan):
    def __init__(self, project_list: List[Expression], child: LogicalPlan):
        self.children = [child]
        self.project_list = project_list

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return [named_output(e) for e in self.project_list]

    def simple_string(self) -> str:
        return f"Project {self.project_list}"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        self.children = [child]
        self.condition = condition

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output

    def simple_string(self) -> str:
        return f"Filter {self.condition!r}"


class Aggregate(LogicalPlan):
    """grouping expressions + result expressions (group attrs and
    Alias(AggregateExpression) items)."""

    def __init__(self, grouping: List[Expression],
                 aggregates: List[Expression], child: LogicalPlan):
        self.children = [child]
        self.grouping = grouping
        self.aggregates = aggregates

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return [named_output(e) for e in self.aggregates]

    def simple_string(self) -> str:
        return f"Aggregate {self.grouping} {self.aggregates}"


class Join(LogicalPlan):
    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 join_type: str, condition: Optional[Expression]):
        self.children = [left, right]
        self.join_type = join_type  # inner/left/right/full/leftsemi/leftanti/cross
        self.condition = condition

    @property
    def left(self) -> LogicalPlan:
        return self.children[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children[1]

    @property
    def output(self) -> List[AttributeReference]:
        jt = self.join_type
        if jt in ("leftsemi", "leftanti"):
            return self.left.output
        left_out = list(self.left.output)
        right_out = list(self.right.output)
        if jt in ("left", "full", "leftouter", "fullouter"):
            right_out = [AttributeReference(a.name, a.data_type, True,
                                            a.expr_id, a.qualifier)
                         for a in right_out]
        if jt in ("right", "full", "rightouter", "fullouter"):
            left_out = [AttributeReference(a.name, a.data_type, True,
                                           a.expr_id, a.qualifier)
                        for a in left_out]
        return left_out + right_out

    def simple_string(self) -> str:
        return f"Join {self.join_type} {self.condition!r}"


class Sort(LogicalPlan):
    def __init__(self, order: List[SortOrder], is_global: bool,
                 child: LogicalPlan):
        self.children = [child]
        self.order = order
        self.is_global = is_global

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output

    def simple_string(self) -> str:
        return f"Sort {self.order} global={self.is_global}"


class Limit(LogicalPlan):
    def __init__(self, n: int, child: LogicalPlan):
        self.children = [child]
        self.n = n

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output


class Union(LogicalPlan):
    def __init__(self, plans: List[LogicalPlan]):
        self.children = list(plans)
        first = plans[0].output
        self._output = [AttributeReference(a.name, a.data_type,
                                           any(p.output[i].nullable
                                               for p in plans))
                        for i, a in enumerate(first)]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class Repartition(LogicalPlan):
    def __init__(self, num_partitions: int, shuffle: bool,
                 child: LogicalPlan, by: Optional[List[Expression]] = None):
        self.children = [child]
        self.num_partitions = num_partitions
        self.shuffle = shuffle
        self.by = by  # None = round robin

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output


class Generate(LogicalPlan):
    """Generator application: child rows x generator output
    (Spark Generate / GpuGenerateExec.scala:440 logical twin). Output =
    child output + the generator's attributes (pre-allocated so
    downstream references bind by expr_id)."""

    def __init__(self, generator: Expression,
                 gen_output: List[AttributeReference], child: LogicalPlan):
        self.children = [child]
        self.generator = generator
        self.gen_output = gen_output

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return list(self.child.output) + list(self.gen_output)

    def simple_string(self) -> str:
        return f"Generate {self.generator!r}"


class Expand(LogicalPlan):
    """Grouping-sets expansion (GpuExpandExec's logical twin)."""

    def __init__(self, projections: List[List[Expression]],
                 output: List[AttributeReference], child: LogicalPlan):
        self.children = [child]
        self.projections = projections
        self._output = output

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self._output


class Window(LogicalPlan):
    def __init__(self, window_exprs: List[Expression],
                 partition_spec: List[Expression],
                 order_spec: List[SortOrder], child: LogicalPlan):
        self.children = [child]
        self.window_exprs = window_exprs  # Alias(WindowExpression) items
        self.partition_spec = partition_spec
        self.order_spec = order_spec

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    @property
    def output(self) -> List[AttributeReference]:
        return self.child.output + [named_output(e)
                                    for e in self.window_exprs]
