"""Logical -> physical planning (the role Spark's SparkPlanner +
EnsureRequirements plays in the reference). Produces the CPU physical plan
that the port's overrides then rewrite onto torch device operators.

Planning decisions mirrored from Spark:
- Aggregate splits into partial -> hash exchange on keys -> final.
- Global sort inserts a range-partitioning exchange.

Only the logical nodes of the ported slice are planned; every other node
raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import physical as P


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

    # -- simple unary ------------------------------------------------------
    def _plan_project(self, p: L.Project) -> P.PhysicalPlan:
        return P.CpuProjectExec(p.project_list, self.plan(p.child))

    def _plan_filter(self, p: L.Filter) -> P.PhysicalPlan:
        return P.CpuFilterExec(p.condition, self.plan(p.child))

    def _plan_sort(self, p: L.Sort) -> P.PhysicalPlan:
        child = self.plan(p.child)
        if p.is_global:
            child = P.CpuShuffleExchangeExec(
                P.RangePartitioning(p.order, max(1, self.shuffle_partitions)),
                child)
        return P.CpuSortExec(p.order, p.is_global, child)

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

    def _rewrite_distinct(self, p: L.Aggregate) -> Optional[L.Aggregate]:
        """DISTINCT aggregates -> dedup-then-aggregate (Spark's
        RewriteDistinctAggregates single-distinct-group shape). Mixed
        distinct + plain aggregates need a join, which is not ported."""
        aliases = [e for e in p.aggregates
                   if isinstance(e, E.Alias)
                   and isinstance(e.child, E.AggregateExpression)]
        distinct = [a for a in aliases if a.child.is_distinct]
        if not distinct:
            return None
        if len(distinct) != len(aliases):
            raise NotImplementedError(
                "mixed DISTINCT and plain aggregates are not ported yet "
                "to spark_rapids_tpu_torch")
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
