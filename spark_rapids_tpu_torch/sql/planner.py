"""Logical -> physical planning (the role Spark's SparkPlanner +
EnsureRequirements plays in the reference). Produces the CPU physical plan
that the port's overrides then rewrite onto torch device operators.

Planning decisions mirrored from Spark:
- A file scan plans as ``CpuFileScanExec``; attribute-vs-literal
  conjuncts of a Filter directly above it are pushed into it for
  row-group pruning by footer statistics (the Filter stays). A
  project with ``input_file_name()`` reads a COALESCING scan below it
  as PERFILE.
- Aggregate splits into partial -> hash exchange on keys -> final.
- Equi-joins become exchange(left) + exchange(right) + shuffled hash join,
  or a broadcast hash join when the build side's estimated bytes are at
  most ``autoBroadcastJoinThreshold``.
- Global sort inserts a range-partitioning exchange; a limit plans as
  local limit -> single-partition exchange -> global limit.
- A window gets a hash exchange on its partition spec (a
  single-partition exchange when the spec is empty); range, union and
  expand plan one to one.
- A cached relation plans as ``CpuCachedScanExec``; mixed DISTINCT and
  plain aggregates become two aggregates over one cached child, joined
  on null-safe key equality (a cross join without grouping keys).
- An inner or cross join without equi-keys plans as
  ``CpuBroadcastNestedLoopJoinExec``, which runs on the host; another
  join type without equi-keys raises, as in the JAX package.
- Pandas UDFs are pulled out of a projection into an
  ``CpuArrowEvalPythonExec`` below it (Spark's ExtractPythonUDFs);
  ``mapInPandas`` plans as ``CpuMapInPandasExec``.

Only the logical nodes of the ported slices are planned; every other
node raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import (AUTO_BROADCAST_JOIN_THRESHOLD,
                                         TorchConf)
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import physical as P


def host_sizeof(b: HostBatch) -> int:
    """Host bytes of a batch: fixed-width data and validity as stored,
    strings by their text length plus one byte each."""
    total = 0
    for c in b.columns:
        if c.data.dtype == object:
            total += sum(map(len, map(str, c.data.tolist()))) + len(c.data)
        else:
            total += c.data.nbytes
        total += c.validity.nbytes
    return total


def estimate_plan_bytes(p: L.LogicalPlan) -> Optional[int]:
    """Size estimate of a logical subtree's output for broadcast
    selection (the sizeInBytes statistic Spark's JoinSelection reads):
    local relations measure their host batches, file scans their bytes
    on disk; row-preserving or row-reducing unary nodes pass the child's
    estimate through (an upper bound). None = unknown (never
    broadcast)."""
    if isinstance(p, L.LocalRelation):
        return sum(host_sizeof(b) for b in p.batches)
    if isinstance(p, L.FileScan):
        total = 0
        for path in p.paths:
            if os.path.isdir(path):
                for root, _dirs, files in os.walk(path):
                    total += sum(os.path.getsize(os.path.join(root, f))
                                 for f in files)
            elif os.path.exists(path):
                total += os.path.getsize(path)
        return total
    if isinstance(p, (L.Project, L.Filter, L.Limit, L.Sort,
                      L.SubqueryAlias)):
        return estimate_plan_bytes(p.child)
    return None


def _has_input_file_name(e: E.Expression) -> bool:
    return isinstance(e, E.InputFileName) or any(
        _has_input_file_name(c) for c in e.children)


class Planner:
    def __init__(self, conf: TorchConf, session=None):
        self.conf = conf
        self.session = session
        self.shuffle_partitions = conf.shuffle_partitions

    def plan(self, plan: L.LogicalPlan) -> P.PhysicalPlan:
        m = getattr(self, f"_plan_{type(plan).__name__.lower()}", None)
        if m is None:
            raise NotImplementedError(
                f"physical planning for {type(plan).__name__} is not "
                "ported yet to spark_rapids_tpu_torch")
        return m(plan)

    def _plan_subqueryalias(self, p) -> P.PhysicalPlan:
        # physically transparent: the alias only re-qualifies attributes
        # (same expr_ids), so the child's plan IS the plan
        return self.plan(p.child)

    # -- sources -----------------------------------------------------------
    def _plan_localrelation(self, p: L.LocalRelation) -> P.PhysicalPlan:
        return P.CpuLocalScanExec(p.output, p.batches, p.num_partitions)

    def _plan_filescan(self, p: L.FileScan) -> P.PhysicalPlan:
        from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
        return CpuFileScanExec(p.output, p.fmt, p.paths, p.options,
                               self.conf)

    def _plan_cachedrelation(self, p) -> P.PhysicalPlan:
        from spark_rapids_tpu_torch.io.cache import CpuCachedScanExec
        return CpuCachedScanExec(p)

    def _plan_range(self, p: L.Range) -> P.PhysicalPlan:
        return P.CpuRangeExec(p.output, p.start, p.end, p.step,
                              p.num_partitions)

    def _plan_mapinpandas(self, p) -> P.PhysicalPlan:
        from spark_rapids_tpu_torch.exec.python_exec import \
            CpuMapInPandasExec
        # the logical node's output attrs pass through (downstream
        # operators already resolved against those expr_ids)
        return CpuMapInPandasExec(p.fn, p._schema, self.plan(p.child),
                                  self.conf, output=p.output)

    def _extract_pandas_udfs(self, project_list, child):
        """ExtractPythonUDFs: pull every PandasUDF subtree into an
        ArrowEvalPython node below the projection and substitute
        attribute references. UDF arguments that are not plain attributes
        are pre-projected. Pure: the logical expressions are never
        mutated (a DataFrame plans once per execution; explain and
        collect must both see the UDFs)."""
        extra: List[E.Alias] = []
        udfs: dict = {}  # semantic key -> Alias(PandasUDF copy)

        def sub(e):
            if not isinstance(e, E.PandasUDF):
                return None
            # the whole argument subtree must be free of already
            # extracted UDF outputs (the bottom-up transform replaced
            # inner UDFs with their _pudfN attributes): one eval node
            # cannot feed itself
            udf_ids = {al.expr_id for al in udfs.values()}
            for a in e.children:
                if a.collect(lambda x: isinstance(
                        x, E.AttributeReference)
                        and x.expr_id in udf_ids):
                    raise NotImplementedError(
                        "nested pandas UDF calls are not supported")
            # dedup on the original argument subtrees, so identical calls
            # with expression arguments also evaluate once
            key = (id(e.fn), repr(e.children), repr(e.data_type))
            al = udfs.get(key)
            if al is None:
                new_args = []
                for a in e.children:
                    if isinstance(a, E.AttributeReference):
                        new_args.append(a)
                    else:
                        arg_al = E.Alias(a, f"_pudf_arg{len(extra)}")
                        extra.append(arg_al)
                        new_args.append(arg_al.to_attribute())
                al = E.Alias(
                    E.PandasUDF(e.fn, e.name, e.data_type, new_args),
                    f"_pudf{len(udfs)}")
                udfs[key] = al
            return al.to_attribute()

        new_list = [e.transform(sub) for e in project_list]
        if not udfs:
            return project_list, child
        from spark_rapids_tpu_torch.exec.python_exec import \
            CpuArrowEvalPythonExec
        if extra:
            child = P.CpuProjectExec(list(child.output) + extra, child)
        return new_list, CpuArrowEvalPythonExec(
            list(udfs.values()), child, self.conf)

    # -- simple unary ------------------------------------------------------
    def _plan_project(self, p: L.Project) -> P.PhysicalPlan:
        child = self.plan(p.child)
        plist, child = self._extract_pandas_udfs(p.project_list, child)
        # input_file_name() needs batches of one file each: a COALESCING
        # scan under this project reads as PERFILE (the reference's
        # InputFileBlockRule)
        if any(_has_input_file_name(e) for e in plist):
            from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
            node = child
            while node is not None:
                if isinstance(node, CpuFileScanExec):
                    node.force_perfile = True
                    break
                node = node.children[0] if len(node.children) == 1 \
                    else None
        return P.CpuProjectExec(plist, child)

    def _plan_filter(self, p: L.Filter) -> P.PhysicalPlan:
        child = self.plan(p.child)
        from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
        if isinstance(child, CpuFileScanExec):
            preds = _pushable_predicates(p.condition)
            if preds:
                child.set_pushdown(preds)
        return P.CpuFilterExec(p.condition, child)

    def _plan_union(self, p: L.Union) -> P.PhysicalPlan:
        return P.CpuUnionExec([self.plan(c) for c in p.children], p.output)

    def _plan_limit(self, p: L.Limit) -> P.PhysicalPlan:
        child = self.plan(p.child)
        local = P.CpuLocalLimitExec(p.n, child)
        single = P.CpuShuffleExchangeExec(P.SinglePartitioning(), local)
        return P.CpuGlobalLimitExec(p.n, single)

    def _plan_sort(self, p: L.Sort) -> P.PhysicalPlan:
        child = self.plan(p.child)
        if p.is_global:
            child = P.CpuShuffleExchangeExec(
                P.RangePartitioning(p.order, max(1, self.shuffle_partitions)),
                child)
        return P.CpuSortExec(p.order, p.is_global, child)

    def _plan_repartition(self, p: L.Repartition) -> P.PhysicalPlan:
        child = self.plan(p.child)
        if p.by is not None:
            part: P.Partitioning = P.HashPartitioning(p.by, p.num_partitions)
        else:
            part = P.RoundRobinPartitioning(p.num_partitions)
        part.user_specified = True
        return P.CpuShuffleExchangeExec(part, child)

    def _plan_expand(self, p: L.Expand) -> P.PhysicalPlan:
        return P.CpuExpandExec(p.projections, p.output, self.plan(p.child))

    def _plan_generate(self, p: L.Generate) -> P.PhysicalPlan:
        return P.CpuGenerateExec(p.generator, p.gen_output,
                                 self.plan(p.child))

    def _plan_window(self, p: L.Window) -> P.PhysicalPlan:
        from spark_rapids_tpu_torch.sql.window_exec import CpuWindowExec
        child = self.plan(p.child)
        if p.partition_spec:
            child = P.CpuShuffleExchangeExec(
                P.HashPartitioning(p.partition_spec,
                                   self.shuffle_partitions), child)
        else:
            child = P.CpuShuffleExchangeExec(P.SinglePartitioning(), child)
        return CpuWindowExec(p.window_exprs, p.partition_spec, p.order_spec,
                             child)

    # -- aggregate ---------------------------------------------------------
    def _plan_aggregate(self, p: L.Aggregate) -> P.PhysicalPlan:
        rewritten = self._rewrite_distinct(p)
        if rewritten is not None:
            return self.plan(rewritten)
        child = self.plan(p.child)
        # grouping must be attributes; project aliased keys first, reusing
        # the Alias' own id so result expressions bind to the same attr
        grouping_attrs: List[E.AttributeReference] = []
        pre_proj: List[E.Expression] = list(child.output)
        need_proj = False
        for g in p.grouping:
            if isinstance(g, E.AttributeReference):
                grouping_attrs.append(g)
            elif isinstance(g, E.Alias):
                pre_proj.append(g)
                grouping_attrs.append(g.to_attribute())
                need_proj = True
            else:
                alias = E.Alias(g, f"_groupingexpr_{len(grouping_attrs)}")
                pre_proj.append(alias)
                grouping_attrs.append(alias.to_attribute())
                need_proj = True
        if need_proj:
            child = P.CpuProjectExec(pre_proj, child)

        aggregates = list(p.aggregates)
        slots = P.plan_agg_slots(aggregates)
        partial = P.CpuHashAggregateExec(grouping_attrs, aggregates,
                                         "partial", child, slots)
        if grouping_attrs:
            part: P.Partitioning = P.HashPartitioning(
                list(grouping_attrs), self.shuffle_partitions)
        else:
            part = P.SinglePartitioning()
        exchange = P.CpuShuffleExchangeExec(part, partial)
        return P.CpuHashAggregateExec(grouping_attrs, aggregates, "final",
                                      exchange, slots)

    def _rewrite_distinct(self, p: L.Aggregate) -> Optional[L.LogicalPlan]:
        """DISTINCT aggregates -> dedup-then-aggregate (Spark's
        RewriteDistinctAggregates single-distinct-group shape); mixed
        distinct and plain aggregates -> ``_rewrite_mixed_distinct``."""
        aliases = [e for e in p.aggregates
                   if isinstance(e, E.Alias)
                   and isinstance(e.child, E.AggregateExpression)]
        distinct = [a for a in aliases if a.child.is_distinct]
        if not distinct:
            return None
        if len(distinct) != len(aliases):
            return self._rewrite_mixed_distinct(p, aliases, distinct)
        child_sets = {tuple(sorted(repr(c) for c in a.child.func.children))
                      for a in distinct}
        if len(child_sets) > 1:
            raise NotImplementedError(
                "multiple DISTINCT aggregates over different columns need "
                "the Expand rewrite; split the query instead")
        inner_items: List[E.Expression] = list(p.grouping)
        child_attr: dict = {}
        for a in distinct:
            for c in a.child.func.children:
                key = repr(c)
                if key in child_attr:
                    continue
                if isinstance(c, E.AttributeReference):
                    child_attr[key] = c
                    inner_items.append(c)
                else:
                    al = E.Alias(c, f"_d{len(child_attr)}")
                    child_attr[key] = al.to_attribute()
                    inner_items.append(al)
        inner_aggs = [g if isinstance(g, E.AttributeReference)
                      else g.to_attribute() for g in inner_items]
        inner = L.Aggregate(list(inner_items), inner_aggs, p.child)
        grouping_attr = {id(g): (g if isinstance(g, E.AttributeReference)
                                 else g.to_attribute())
                         for g in p.grouping}
        outer_grouping = [grouping_attr[id(g)] for g in p.grouping]
        grouping_ids = {a.expr_id for a in outer_grouping}
        outer_aggs: List[E.Expression] = []
        for e in p.aggregates:
            if e in distinct:
                func = e.child.func
                new_func = func.with_children(
                    [child_attr[repr(c)] for c in func.children])
                outer_aggs.append(E.Alias(
                    E.AggregateExpression(new_func, is_distinct=False),
                    e.name, expr_id=e.expr_id))
            elif isinstance(e, E.Alias) and e.expr_id in grouping_ids:
                outer_aggs.append(e.to_attribute())
            else:
                outer_aggs.append(e)
        return L.Aggregate(outer_grouping, outer_aggs, inner)

    def _rewrite_mixed_distinct(self, p: L.Aggregate, aliases,
                                distinct) -> L.LogicalPlan:
        """Mixed DISTINCT and plain aggregates (``count(DISTINCT a),
        sum(b)``): a distinct-only aggregate and a plain aggregate over
        the same child, joined on null-safe key equality. Both sides hold
        one row a group (the null-key group too, hence ``<=>``), so the
        join is 1:1; the role Spark's RewriteDistinctAggregates Expand
        plays. The shared child is wrapped in a CachedRelation, so the
        two aggregates read it once. Without grouping keys the two
        one-row sides meet in a cross join, a nested-loop join on the
        host."""
        distinct_ids = {id(a) for a in distinct}
        plain = [a for a in aliases if id(a) not in distinct_ids]
        grouping_attr = {id(g): (g if isinstance(g, E.AttributeReference)
                                 else g.to_attribute())
                         for g in p.grouping}
        g_attrs = [grouping_attr[id(g)] for g in p.grouping]
        g_ids = {a.expr_id for a in g_attrs}
        child = p.child
        if self.session is not None:
            from spark_rapids_tpu_torch.io.cache import CachedRelation
            child = CachedRelation(child, self.session)
        # left: grouping + distinct aggs (recursion hits the pure-distinct
        # rewrite); right: grouping re-aliased to fresh ids + plain aggs
        left = L.Aggregate(
            list(p.grouping),
            list(g_attrs) + [a for a in p.aggregates
                             if id(a) in distinct_ids],
            child)
        rk_aliases = [E.Alias(a, f"_mdk{i}")
                      for i, a in enumerate(g_attrs)]
        right = L.Aggregate(list(p.grouping), rk_aliases + plain, child)
        cond = None
        for la, ra in zip(g_attrs, rk_aliases):
            eq = E.EqualNullSafe(la, ra.to_attribute())
            cond = eq if cond is None else E.And(cond, eq)
        if cond is None:
            joined = L.Join(left, right, "cross", None)
        else:
            joined = L.Join(left, right, "inner", cond)
        # the final projection restores the requested output order
        plain_ids = {id(x) for x in plain}
        out: List[E.Expression] = []
        for e in p.aggregates:
            if isinstance(e, E.Alias) and (
                    e.expr_id in g_ids or id(e) in plain_ids or isinstance(
                        e.child, E.AggregateExpression)):
                out.append(e.to_attribute())
            else:
                out.append(e)
        return L.Project(out, joined)

    # -- join --------------------------------------------------------------
    def _plan_join(self, p: L.Join) -> P.PhysicalPlan:
        left = self.plan(p.left)
        right = self.plan(p.right)
        left_keys, right_keys, null_safe, residual = split_equi_join(
            p.condition, p.left.output, p.right.output)
        if not left_keys:
            if p.join_type in ("inner", "cross"):
                return self._nested_loop(p, left, right)
            raise NotImplementedError(
                f"non-equi {p.join_type} join not supported yet")
        threshold = int(self.conf.get(AUTO_BROADCAST_JOIN_THRESHOLD))
        est = estimate_plan_bytes(p.right)
        small_right = (threshold >= 0 and est is not None
                       and est <= threshold)
        if small_right and p.join_type in ("inner", "left", "leftouter",
                                           "leftsemi", "leftanti", "cross"):
            return P.CpuBroadcastHashJoinExec(
                left_keys, right_keys, p.join_type, residual, left,
                P.CpuBroadcastExchangeExec(right),
                p.output, null_safe=null_safe)
        n = self.shuffle_partitions
        lex = P.CpuShuffleExchangeExec(P.HashPartitioning(left_keys, n),
                                       left)
        rex = P.CpuShuffleExchangeExec(P.HashPartitioning(right_keys, n),
                                       right)
        return P.CpuShuffledHashJoinExec(left_keys, right_keys, p.join_type,
                                         residual, lex, rex, p.output,
                                         null_safe=null_safe)

    def _nested_loop(self, p: L.Join, left: P.PhysicalPlan,
                     right: P.PhysicalPlan) -> P.PhysicalPlan:
        from spark_rapids_tpu_torch.sql.nested_loop import \
            CpuBroadcastNestedLoopJoinExec
        return CpuBroadcastNestedLoopJoinExec(p.join_type, p.condition,
                                              left, right, p.output)


def split_equi_join(condition: Optional[E.Expression],
                    left_out, right_out
                    ) -> Tuple[List[E.Expression], List[E.Expression],
                               List[bool], Optional[E.Expression]]:
    """Split a join condition into equi-key pairs (+ per-pair null-safe
    flags for ``<=>``) and residual conjuncts (Spark
    ExtractEquiJoinKeys)."""
    if condition is None:
        return [], [], [], None
    left_ids = {a.expr_id for a in left_out}
    right_ids = {a.expr_id for a in right_out}

    def side(e: E.Expression) -> Optional[str]:
        ids = {a.expr_id for a in e.references()}
        if not ids:
            return "none"
        if ids <= left_ids:
            return "left"
        if ids <= right_ids:
            return "right"
        return None

    lk: List[E.Expression] = []
    rk: List[E.Expression] = []
    ns: List[bool] = []
    residual: List[E.Expression] = []
    for c in split_conjuncts(condition):
        if isinstance(c, (E.EqualTo, E.EqualNullSafe)):
            sl, sr = side(c.left), side(c.right)
            if sl == "left" and sr == "right":
                lk.append(c.left)
                rk.append(c.right)
                ns.append(isinstance(c, E.EqualNullSafe))
                continue
            if sl == "right" and sr == "left":
                lk.append(c.right)
                rk.append(c.left)
                ns.append(isinstance(c, E.EqualNullSafe))
                continue
        residual.append(c)
    res = None
    for r in residual:
        res = r if res is None else E.And(res, r)
    return lk, rk, ns, res


def split_conjuncts(e: E.Expression) -> List[E.Expression]:
    if isinstance(e, E.And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


_PUSH_OPS = {E.EqualTo: "eq", E.LessThan: "lt", E.LessThanOrEqual: "le",
             E.GreaterThan: "gt", E.GreaterThanOrEqual: "ge"}
_PUSH_SWAP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}


def _fold_literal(e: E.Expression):
    """Storage value of a literal-only subtree (e.g. Cast('1998-09-02'
    as date)), or None when it references columns or fails to fold."""
    def has_attr(x) -> bool:
        if isinstance(x, (E.AttributeReference, E.BoundReference)):
            return True
        return any(has_attr(c) for c in x.children)
    if has_attr(e):
        return None
    from spark_rapids_tpu_torch.sql import types as T
    try:
        col = e.eval(HostBatch(T.StructType([]), [], 1))
    except Exception:
        return None  # not foldable on the host: simply not pushed
    if not col.validity[0]:
        return None
    v = col.data[0]
    if hasattr(v, "item"):
        v = v.item()
    return v if isinstance(v, (int, float, str)) else None


def _pushable_predicates(condition: E.Expression) -> List[tuple]:
    """(column, op, storage-value) conjuncts a Parquet footer can rule
    on: attribute vs foldable literal comparisons, IsNull and IsNotNull
    (ParquetFilters.createFilter's pushable subset)."""
    out: List[tuple] = []
    for conj in split_conjuncts(condition):
        if isinstance(conj, (E.IsNotNull, E.IsNull)) and isinstance(
                conj.child, E.AttributeReference):
            out.append((conj.child.name,
                        "notnull" if isinstance(conj, E.IsNotNull)
                        else "isnull", None))
            continue
        op = _PUSH_OPS.get(type(conj))
        if op is None:
            continue
        left, right = conj.left, conj.right
        if isinstance(left, E.AttributeReference):
            v = _fold_literal(right)
            if v is not None:
                out.append((left.name, op, v))
        elif isinstance(right, E.AttributeReference):
            v = _fold_literal(left)
            if v is not None:
                out.append((right.name, _PUSH_SWAP[op], v))
    return out
