"""DataFrame API (pyspark.sql.DataFrame shape) over logical plans."""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Union

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.functions import Column, _to_expr


class Row(tuple):
    """Lightweight named row."""

    def __new__(cls, values, names):
        r = super().__new__(cls, values)
        r._names = list(names)
        return r

    @classmethod
    def of(cls, names) -> type:
        """A Row type whose rows all carry ``names``: each of its rows
        costs one tuple (a collect builds one such type)."""
        return type("Row", (cls,), {"_names": list(names),
                                    "__new__": tuple.__new__})

    def __getattr__(self, name):
        try:
            return self[self._names.index(name)]
        except ValueError:
            raise AttributeError(name)

    def asDict(self):
        return dict(zip(self._names, self))

    def __repr__(self):
        inner = ", ".join(f"{n}={v!r}" for n, v in zip(self._names, self))
        return f"Row({inner})"


class DataFrame:
    def __init__(self, plan: L.LogicalPlan, session):
        self.plan = plan
        self.session = session

    # -- schema ------------------------------------------------------------
    @property
    def schema(self) -> T.StructType:
        return self.plan.schema

    @property
    def columns(self) -> List[str]:
        return [a.name for a in self.plan.output]

    def _resolve(self, c: Union[Column, str, E.Expression]) -> E.Expression:
        if isinstance(c, str):
            if c == "*":
                raise ValueError("* only valid inside select()")
            expr: E.Expression = E.UnresolvedAttribute(c)
        else:
            expr = _to_expr(c)
        case_sensitive = self.session.conf_obj.get_key(
            "spark.sql.caseSensitive", False)
        resolved = L.resolve(expr, self.plan.output,
                             bool(case_sensitive))
        return _coerce_resolved(resolved)

    # -- transformations ---------------------------------------------------
    def alias(self, name: str) -> "DataFrame":
        """pyspark DataFrame.alias: re-qualify this relation's columns so
        ``name.col`` references resolve (SubqueryAlias node)."""
        return DataFrame(L.SubqueryAlias(name, self.plan), self.session)

    def mapInPandas(self, func, schema) -> "DataFrame":
        """pyspark DataFrame.mapInPandas: ``func(iter_of_pdf) ->
        iter_of_pdf`` runs in the python worker pool over Arrow IPC
        (GpuMapInPandasExec role)."""
        if isinstance(schema, str):
            from spark_rapids_tpu_torch.sql.session import _parse_ddl_schema
            schema = _parse_ddl_schema(schema)
        return DataFrame(L.MapInPandas(func, schema, self.plan),
                         self.session)

    def select(self, *cols) -> "DataFrame":
        items: List[E.Expression] = []
        for c in cols:
            if isinstance(c, str) and c == "*":
                items.extend(self.plan.output)
                continue
            e = self._resolve(c)
            if not isinstance(e, (E.AttributeReference, E.Alias)) and \
                    not getattr(e, "is_generator", False):
                e = E.Alias(e, _auto_name(e))
            items.append(e)
        return DataFrame(self._project_plan(items), self.session)

    def _project_plan(self, items: List[E.Expression]) -> L.LogicalPlan:
        """Project, extracting window expressions into L.Window nodes
        grouped by (partition, order) spec — the analyzer's
        ExtractWindowExpressions role — and generators (explode/
        posexplode) into L.Generate (ExtractGenerator role)."""
        gens = [e for e in items
                if e.collect(lambda x: getattr(x, "is_generator", False))]
        if gens:
            assert len(gens) == 1, \
                "only one generator per select clause is allowed"
            item = gens[0]
            gen = (item.child if isinstance(item, E.Alias) else item)
            assert getattr(gen, "is_generator", False), \
                "generators must be top-level select items"
            col_name = item.name if isinstance(item, E.Alias) else "col"
            gen_out = gen.generator_output(col_name)
            child = L.Generate(gen, gen_out, self.plan)
            new_items: List[E.Expression] = []
            for e in items:
                if e is item:
                    new_items.extend(gen_out)
                else:
                    new_items.append(e)
            return L.Project(new_items, child)
        if not any(e.collect(lambda x: isinstance(x, E.WindowExpression))
                   for e in items):
            return L.Project(items, self.plan)
        groups: dict = {}
        counter = [0]

        def extract(item: E.Expression) -> E.Expression:
            def rule(x):
                if isinstance(x, E.WindowExpression):
                    name = (item.name if isinstance(item, E.Alias)
                            and item.child is x
                            else f"_we{counter[0]}")
                    counter[0] += 1
                    alias = E.Alias(x, name)
                    key = (tuple(map(repr, x.partition_spec)),
                           tuple(map(repr, x.order_spec)))
                    groups.setdefault(
                        key, (x.partition_spec, x.order_spec, []))[2] \
                        .append(alias)
                    return alias.to_attribute()
                return None
            return item.transform(rule)

        new_items = [extract(e) for e in items]
        child = self.plan
        for part, order, aliases in groups.values():
            child = L.Window(aliases, list(part), list(order), child)
        return L.Project(new_items, child)

    def selectExpr(self, *exprs: str) -> "DataFrame":
        from spark_rapids_tpu_torch.sql.parser import parse_expression
        cols = [parse_expression(s) for s in exprs]
        return self.select(*[Column(c) for c in cols])

    def withColumn(self, name: str, col: Column) -> "DataFrame":
        e = self._resolve(col)
        items: List[E.Expression] = []
        replaced = False
        for a in self.plan.output:
            if a.name == name:
                items.append(E.Alias(e, name))
                replaced = True
            else:
                items.append(a)
        if not replaced:
            items.append(E.Alias(e, name))
        return DataFrame(self._project_plan(items), self.session)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        items = [a.renamed(new) if a.name == old else a
                 for a in self.plan.output]
        return DataFrame(L.Project(items, self.plan), self.session)

    def drop(self, *names: str) -> "DataFrame":
        keep = [a for a in self.plan.output if a.name not in names]
        return DataFrame(L.Project(keep, self.plan), self.session)

    def filter(self, condition: Union[Column, str]) -> "DataFrame":
        if isinstance(condition, str):
            from spark_rapids_tpu_torch.sql.parser import parse_expression
            condition = Column(parse_expression(condition))
        cond = self._resolve(condition)
        return DataFrame(L.Filter(cond, self.plan), self.session)

    where = filter

    def groupBy(self, *cols) -> "GroupedData":
        grouping = [self._resolve(c) for c in cols]
        return GroupedData(self, grouping)

    def rollup(self, *cols) -> "GroupedData":
        """Hierarchical grouping sets: (a,b,c), (a,b), (a), () — the
        Aggregate-over-Expand shape Spark's analyzer produces."""
        grouping = [self._resolve(c) for c in cols]
        return GroupedData(self, grouping, sets_mode="rollup")

    def cube(self, *cols) -> "GroupedData":
        """All 2^n grouping-set combinations."""
        grouping = [self._resolve(c) for c in cols]
        return GroupedData(self, grouping, sets_mode="cube")

    def agg(self, *cols) -> "DataFrame":
        return self.groupBy().agg(*cols)

    def join(self, other: "DataFrame", on=None, how: str = "inner"
             ) -> "DataFrame":
        how = {"left_outer": "leftouter", "right_outer": "rightouter",
               "full_outer": "fullouter", "semi": "leftsemi",
               "anti": "leftanti", "left_semi": "leftsemi",
               "left_anti": "leftanti", "outer": "fullouter"}.get(how, how)
        # Self-join disambiguation (Spark's dedupRight): re-alias the right
        # side with fresh expr_ids when the two sides share attribute ids.
        left_ids = {a.expr_id for a in self.plan.output}
        if any(a.expr_id in left_ids for a in other.plan.output):
            # fresh expr_ids, same names AND same qualifiers — `b.col`
            # still resolves after a self-join re-alias, however deep
            # the alias sits under filters/projections
            other = DataFrame(
                L.Project([E.Alias(a, a.name, qualifier=a.qualifier)
                           for a in other.plan.output], other.plan),
                other.session)
        cond: Optional[E.Expression] = None
        using: List[str] = []
        if on is not None:
            if isinstance(on, str):
                using = [on]
            elif isinstance(on, (list, tuple)) and on and isinstance(
                    on[0], str):
                using = list(on)
            elif isinstance(on, Column):
                combined = list(self.plan.output) + list(other.plan.output)
                cond = L.resolve(on.expr, combined)
                cond = _coerce_resolved(cond)
        if using:
            conds = []
            for name in using:
                lc = L.resolve(E.UnresolvedAttribute(name),
                               self.plan.output)
                rc = L.resolve(E.UnresolvedAttribute(name),
                               other.plan.output)
                conds.append(E.EqualTo(lc, rc))
            for c in conds:
                cond = c if cond is None else E.And(cond, c)
        joined = L.Join(self.plan, other.plan, how, cond)
        df = DataFrame(joined, self.session)
        if using and how not in ("leftsemi", "leftanti"):
            # USING join: single key column, drop duplicate right-side keys
            keep: List[E.Expression] = []
            right_ids = set()
            for name in using:
                r = L.resolve(E.UnresolvedAttribute(name),
                              other.plan.output)
                right_ids.add(r.expr_id)
            for a in joined.output:
                if a.expr_id not in right_ids:
                    keep.append(a)
            df = DataFrame(L.Project(keep, joined), self.session)
        return df

    def crossJoin(self, other: "DataFrame") -> "DataFrame":
        left_ids = {a.expr_id for a in self.plan.output}
        if any(a.expr_id in left_ids for a in other.plan.output):
            # fresh expr_ids, same names AND same qualifiers — `b.col`
            # still resolves after a self-join re-alias, however deep
            # the alias sits under filters/projections
            other = DataFrame(
                L.Project([E.Alias(a, a.name, qualifier=a.qualifier)
                           for a in other.plan.output], other.plan),
                other.session)
        return DataFrame(L.Join(self.plan, other.plan, "cross", None),
                         self.session)

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(L.Union([self.plan, other.plan]), self.session)

    unionAll = union

    def distinct(self) -> "DataFrame":
        return DataFrame(
            L.Aggregate(list(self.plan.output), list(self.plan.output),
                        self.plan), self.session)

    def dropDuplicates(self, subset: Optional[List[str]] = None
                       ) -> "DataFrame":
        if subset is None:
            return self.distinct()
        keys = [self._resolve(s) for s in subset]
        aggs: List[E.Expression] = []
        key_ids = {k.expr_id for k in keys
                   if isinstance(k, E.AttributeReference)}
        for a in self.plan.output:
            if a.expr_id in key_ids:
                aggs.append(a)
            else:
                aggs.append(E.Alias(
                    E.AggregateExpression(E.First(a)), a.name))
        return DataFrame(L.Aggregate(keys, aggs, self.plan), self.session)

    def orderBy(self, *cols) -> "DataFrame":
        order = self._sort_orders(cols)
        return DataFrame(L.Sort(order, True, self.plan), self.session)

    sort = orderBy

    def sortWithinPartitions(self, *cols) -> "DataFrame":
        order = self._sort_orders(cols)
        return DataFrame(L.Sort(order, False, self.plan), self.session)

    def _sort_orders(self, cols) -> List[E.SortOrder]:
        order: List[E.SortOrder] = []
        for c in cols:
            e = self._resolve(c)
            if isinstance(e, E.SortOrder):
                order.append(e)
            else:
                order.append(E.SortOrder(e, ascending=True))
        return order

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self.plan), self.session)

    def repartition(self, num: int, *cols) -> "DataFrame":
        by = [self._resolve(c) for c in cols] if cols else None
        return DataFrame(L.Repartition(num, True, self.plan, by),
                         self.session)

    def coalesce(self, num: int) -> "DataFrame":
        return DataFrame(L.Repartition(num, False, self.plan), self.session)

    # -- actions -----------------------------------------------------------
    def _execute(self) -> HostBatch:
        return self.session.execute_plan(self.plan)

    def collect(self) -> List[Row]:
        batch = self._execute()
        return list(map(Row.of([f.name for f in batch.schema.fields]),
                        batch.rows()))

    def count(self) -> int:
        return int(self._execute().num_rows)

    def toPandas(self):
        import pandas as pd
        return pd.DataFrame(self._execute().to_pydict())

    def show(self, n: int = 20) -> None:
        rows = self.limit(n).collect()
        names = self.columns
        widths = [max(len(str(x)) for x in [nm] + [r[i] for r in rows])
                  for i, nm in enumerate(names)]
        line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(line)
        print("|" + "|".join(f" {nm:<{w}} "
                             for nm, w in zip(names, widths)) + "|")
        print(line)
        for r in rows:
            print("|" + "|".join(f" {str(v):<{w}} "
                                 for v, w in zip(r, widths)) + "|")
        print(line)

    def explain(self, extended: bool = False) -> None:
        print(self.session.explain_string(self.plan))

    def createOrReplaceTempView(self, name: str) -> None:
        self.session.catalog_views[name.lower()] = self.plan

    @property
    def write(self):
        from spark_rapids_tpu_torch.io.writers import DataFrameWriter
        return DataFrameWriter(self)

    def cache(self) -> "DataFrame":
        from spark_rapids_tpu_torch.io.cache import cache_plan
        return DataFrame(cache_plan(self), self.session)

    def __getitem__(self, name: str) -> Column:
        return Column(self._resolve(name))

    def __getattr__(self, name: str) -> Column:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self.columns:
            return Column(self._resolve(name))
        raise AttributeError(name)


class GroupedData:
    def __init__(self, df: DataFrame, grouping: List[E.Expression],
                 sets_mode: Optional[str] = None):
        self.df = df
        self.grouping = grouping
        self.sets_mode = sets_mode  # None | "rollup" | "cube"

    def _expand_sets(self, agg_cols) -> DataFrame:
        """rollup/cube -> Aggregate over Expand with a grouping-id column
        (Spark's ResolveGroupingAnalytics shape; device twin:
        GpuExpandExec). The gid keeps 'key absent from this set' groups
        apart from genuine null-key groups."""
        df = self.df
        # 1. make every key an attribute (pre-project aliased exprs)
        base_items = list(df.plan.output)
        key_attrs: List[E.AttributeReference] = []
        need_proj = False
        for g in self.grouping:
            if isinstance(g, E.AttributeReference):
                key_attrs.append(g)
            else:
                alias = g if isinstance(g, E.Alias) else \
                    E.Alias(g, _auto_name(g))
                base_items.append(alias)
                key_attrs.append(alias.to_attribute())
                need_proj = True
        plan = (L.Project(base_items, df.plan) if need_proj else df.plan)
        child_out = list(plan.output)
        # 2. grouping sets
        n = len(key_attrs)
        if self.sets_mode == "rollup":
            sets = [frozenset(range(k)) for k in range(n, -1, -1)]
        else:  # cube
            sets = [frozenset(i for i in range(n) if mask & (1 << i))
                    for mask in range((1 << n) - 1, -1, -1)]
        # 3. expanded output: child cols + one fresh attr per key + gid
        out_keys = [E.AttributeReference(a.name, a.data_type, True)
                    for a in key_attrs]
        gid = E.AttributeReference("spark_grouping_id", T.LongT, False)
        expand_out = child_out + out_keys + [gid]
        projections: List[List[E.Expression]] = []
        for si, s in enumerate(sets):
            proj: List[E.Expression] = list(child_out)
            for i, a in enumerate(key_attrs):
                proj.append(a if i in s
                            else E.Literal(None, a.data_type))
            proj.append(E.Literal(si, T.LongT))
            projections.append(proj)
        expanded = DataFrame(
            L.Expand(projections, expand_out, plan), df.session)
        # 4. aggregate over (expanded keys, gid); gid stays internal.
        # Aggregates referencing a grouping column resolve to the
        # EXPANDED (nulled) key, like Spark — so resolve against the
        # non-key child columns + the fresh key attrs only.
        key_ids = {a.expr_id for a in key_attrs}
        resolve_attrs = [a for a in child_out
                         if a.expr_id not in key_ids] + out_keys
        case_sensitive = df.session.conf.get(
            "spark.sql.caseSensitive", False)
        aggs: List[E.Expression] = list(out_keys)
        for c in agg_cols:
            e = _coerce_resolved(L.resolve(
                c.expr if isinstance(c, Column) else c,
                resolve_attrs, bool(case_sensitive)))
            if not isinstance(e, (E.Alias, E.AttributeReference)):
                e = E.Alias(e, _auto_name(e))
            aggs.append(e)
        return DataFrame(
            L.Aggregate(out_keys + [gid], aggs, expanded.plan),
            df.session)

    def agg(self, *cols) -> DataFrame:
        if self.sets_mode is not None:
            return self._expand_sets(cols)
        # Non-attribute grouping keys get a single shared Alias so the
        # planner's pre-projection and the result column refer to the same
        # attribute id (Spark aliases grouping expressions the same way).
        grouping: List[E.Expression] = []
        aggs: List[E.Expression] = []
        for g in self.grouping:
            if isinstance(g, E.AttributeReference):
                grouping.append(g)
                aggs.append(g)
            else:
                alias = g if isinstance(g, E.Alias) else \
                    E.Alias(g, _auto_name(g))
                grouping.append(alias)
                aggs.append(alias.to_attribute())
        for c in cols:
            e = self.df._resolve(c)
            if not isinstance(e, (E.Alias, E.AttributeReference)):
                e = E.Alias(e, _auto_name(e))
            aggs.append(e)
        return DataFrame(L.Aggregate(grouping, aggs, self.df.plan),
                         self.df.session)

    def count(self) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self.agg(F.count("*").alias("count"))

    def pivot(self, col: str, values: Optional[list] = None
              ) -> "PivotedData":
        """groupBy(...).pivot(c, [v...]).agg(f): rewritten to one
        conditional aggregate per pivot value — sum(when(c = v, x)) —
        so the whole pivot rides the existing device aggregation path
        (Spark's PivotFirst lowered to its CASE WHEN equivalent; the
        reference device-codegens the same shape via GpuPivotFirst,
        aggregate.scala:1059). Without explicit values the distinct
        values are collected first (Spark does the same extra job)."""
        from spark_rapids_tpu_torch.sql import functions as F
        if values is None:
            rows = (self.df.select(F.col(col)).distinct()
                    .orderBy(F.col(col)).collect())
            values = [r[0] for r in rows if r[0] is not None]
        return PivotedData(self, col, list(values))

    def _simple(self, fn, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        targets = cols or [a.name for a in self.df.plan.output
                           if T.is_numeric(a.data_type)]
        return self.agg(*[fn(F.col(c)).alias(f"{fn.__name__}({c})")
                          for c in targets])


class PivotedData:
    """groupBy().pivot() staging: agg() fans each aggregate out across
    the pivot values as conditional aggregates."""

    def __init__(self, grouped: GroupedData, col: str, values: list):
        self._grouped = grouped
        self._col = col
        self._values = values

    def agg(self, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        out = []
        for c in cols:
            e = self._grouped.df._resolve(c)
            base_name = e.name if isinstance(e, E.Alias) else None
            agg_expr = e.child if isinstance(e, E.Alias) else e
            assert isinstance(agg_expr, E.AggregateExpression), (
                "pivot agg expects aggregate expressions")
            func = agg_expr.func
            for v in self._values:
                # sum(x) FILTER (WHERE p = v) == sum(when(p = v, x))
                src = func.children[0] if func.children else E.Literal(1)
                gated = E.CaseWhen(
                    [(E.EqualTo(E.UnresolvedAttribute(self._col),
                                E.Literal(v)), src)], None)
                if isinstance(func, E.Count):
                    fn2: E.AggregateFunction = E.Count([gated])
                elif isinstance(func, (E.First, E.Last)):
                    fn2 = type(func)(gated, func.ignore_nulls)
                else:
                    fn2 = type(func)(gated)
                if len(cols) == 1:
                    name = str(v)
                else:
                    suffix = base_name or _auto_name(agg_expr)
                    name = f"{v}_{suffix}"
                out.append(Column(E.Alias(
                    E.AggregateExpression(fn2, agg_expr.is_distinct),
                    name)))
        return self._grouped.agg(*out)

    def sum(self, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self._simple(F.sum, *cols)

    def avg(self, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self._simple(F.avg, *cols)

    def min(self, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self._simple(F.min, *cols)

    def max(self, *cols) -> DataFrame:
        from spark_rapids_tpu_torch.sql import functions as F
        return self._simple(F.max, *cols)


def _auto_name(e: E.Expression) -> str:
    if isinstance(e, E.AggregateExpression):
        inner = ", ".join(_auto_name(c) for c in e.func.children)
        return f"{e.func.pretty_name}({inner})"
    if isinstance(e, E.AttributeReference):
        return e.name
    if isinstance(e, E.Literal):
        return str(e.value)
    if isinstance(e, E.Cast):
        return _auto_name(e.child)
    if isinstance(e, E.GetStructField):
        return e.pretty_name  # `SELECT s.x` names the output column x
    return repr(e)


def _coerce_resolved(e: E.Expression) -> E.Expression:
    """Post-resolution type coercion: insert casts on mismatched binary
    ops (the TypeCoercion role)."""
    from spark_rapids_tpu_torch.sql.functions import _coerce_pair

    def rule(node: E.Expression) -> Optional[E.Expression]:
        if isinstance(node, (E.BinaryArithmetic, E.BinaryComparison)) and \
                not isinstance(node, E.Divide):
            try:
                lt, rt = node.left.data_type, node.right.data_type
            except Exception:
                return None
            if lt != rt:
                # +,-,* take DecimalPrecision's no-widen rule; %/pmod
                # and comparisons widen to a common decimal
                a, b = _coerce_pair(
                    node.left, node.right,
                    arith=isinstance(node, (E.Add, E.Subtract,
                                            E.Multiply)))
                return type(node)(a, b)
        if isinstance(node, E.Divide):
            try:
                lt, rt = node.left.data_type, node.right.data_type
            except Exception:
                return None
            if isinstance(lt, T.DecimalType) or \
                    isinstance(rt, T.DecimalType):
                # decimal division unless a fractional side forces double
                if isinstance(lt, (T.FloatType, T.DoubleType)) or \
                        isinstance(rt, (T.FloatType, T.DoubleType)):
                    return E.Divide(
                        node.left if isinstance(lt, T.DoubleType)
                        else E.Cast(node.left, T.DoubleT),
                        node.right if isinstance(rt, T.DoubleType)
                        else E.Cast(node.right, T.DoubleT))
                a, b = _coerce_pair(node.left, node.right, arith=True)
                if a is not node.left or b is not node.right:
                    return E.Divide(a, b)
                return None
            if not isinstance(lt, T.DoubleType) or \
                    not isinstance(rt, T.DoubleType):
                a = node.left if isinstance(lt, T.DoubleType) \
                    else E.Cast(node.left, T.DoubleT)
                b = node.right if isinstance(rt, T.DoubleType) \
                    else E.Cast(node.right, T.DoubleT)
                return E.Divide(a, b)
        return None

    return e.transform(rule)
