"""Plan rewrite onto torch device operators: the wrap -> tag -> convert
core of ``spark_rapids_tpu.overrides.apply_overrides``.

Each CPU physical node is wrapped in an ``ExecMeta``, tagged by its rule
(types and expressions the port can run), and converted bottom-up; a
``TorchRowToColumnarExec`` goes under the first device operator above a
CPU source and a ``TorchColumnarToRowExec`` on top. The port has rules
for Range, Union, Expand, Window, Project, Filter, Generate (explode),
HashAggregate, ShuffleExchange (hash, range, single;
planner-inserted hash and range exchanges coalesce to
``spark.rapids.sql.shuffle.devicePartitions``, 1 on one card),
Sort, LocalLimit (over a Sort it becomes TopN), GlobalLimit,
BroadcastExchange, the shuffled and broadcast hash joins (an inner
join's residual condition filters the joined pairs on the device),
ArrowEvalPython and MapInPandas (pandas UDFs in the Python worker
pool); a cached scan is a host source, as the in-memory and file scans
are. An
aggregate's or a sort's exchange child may coalesce its partitions at
run time (``allow_aqe_coalesce``, adaptive execution), and so may a
window's; a join's children never do. Last,
under ``spark.rapids.sql.stageFusion.enabled`` (default true),
``fuse_stages`` collapses each filter/project chain, with the partial
aggregate above it, into a ``TorchFusedStageExec``. Each rule carries the JAX rule
table's type signature (``ops.exprs.FLAT``, ``STRUCT``, ``NESTED``) for
what it outputs and what its children give it. Anything
else — another node kind, or an expression or type a
rule cannot take — raises ``NotImplementedError`` naming what is not
ported yet; where the JAX package places the operator on its CPU, the
message says so (``CPU_FALLBACK``): a per-operator CPU fallback is a
later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

import torch

from spark_rapids_tpu_torch.conf import (ENABLE_FLOAT_AGG, INCOMPATIBLE_OPS,
                                         STAGE_FUSION_ENABLED, TorchConf)
from spark_rapids_tpu_torch.exec.base import (TorchColumnarToRowExec,
                                              TorchExec,
                                              TorchRowToColumnarExec)
from spark_rapids_tpu_torch.exec.python_exec import (
    CpuArrowEvalPythonExec, CpuMapInPandasExec, TorchArrowEvalPythonExec,
    TorchMapInPandasExec)
from spark_rapids_tpu_torch.io.cache import CpuCachedScanExec
from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.window_exec import CpuWindowExec

# CPU sources that stay on the host; the rewrite uploads their output (a
# file scan hands still-encoded Parquet pages to the upload, which
# decodes them on the device)
HOST_SOURCES = (P.CpuLocalScanExec, CpuFileScanExec, CpuCachedScanExec)

# the end of every tagging refusal: the JAX package places such an
# operator on its CPU
CPU_FALLBACK = ("; the JAX package runs it on the CPU, and the "
                "per-operator CPU fallback is not ported yet")


# expressions the JAX package's rule table marks not 100% compatible
# (``spark_rapids_tpu/overrides.py`` ``expr_rule(..., incompat=...)``):
# they run only under spark.rapids.sql.incompatibleOps.enabled
INCOMPAT = {
    E.Substring: "byte-positioned substring is exact only for ASCII "
                 "strings",
    E.Upper: "case conversion is ASCII-only",
    E.Lower: "case conversion is ASCII-only",
    E.InitCap: "case conversion is ASCII-only",
    E.StringInstr: "byte positions are exact only for ASCII strings",
    E.StringLocate: "byte positions are exact only for ASCII strings",
    E.StringLPad: "byte-counted padding is exact only for ASCII strings",
    E.StringRPad: "byte-counted padding is exact only for ASCII strings",
    E.StringReverse: "byte reversal is exact only for ASCII strings",
}


def incompat_reason(e, conf: TorchConf) -> Optional[str]:
    """The rule table's incompat refusal for the first such expression in
    the tree (the folded, column-free subtrees excepted)."""
    if conf.get(INCOMPATIBLE_OPS) or X._is_literal_input(e):
        return None
    why = INCOMPAT.get(type(e))
    if why is not None:
        return (f"expression {type(e).__name__} is not 100% compatible: "
                f"{why}. Set spark.rapids.sql.incompatibleOps.enabled=true "
                "to allow")
    for c in e.children:
        r = incompat_reason(c, conf)
        if r:
            return r
    return None


def _tag_exprs(exprs, conf: TorchConf, device) -> Optional[str]:
    for e in exprs:
        r = X.unsupported_reason(e, conf, device) or \
            incompat_reason(e, conf)
        if r:
            return r
    return None


def _no_ansi(exprs, what: str) -> Optional[str]:
    """Operators without the ANSI error channel refuse ANSI casts, as the
    JAX package's taggers do."""
    if any(X.contains_ansi_cast(e) for e in exprs):
        return f"ANSI casts in {what} run on CPU"
    return None


def _tag_types(node: P.PhysicalPlan, sig: str) -> Optional[str]:
    """The rule's output and input type checks."""
    for a in node.output:
        r = X.type_reason(a.data_type, sig)
        if r:
            return f"column {a.name}: {r}"
    for c in node.children:
        for a in c.output:
            r = X.type_reason(a.data_type, sig)
            if r:
                return f"input: column {a.name}: {r}"
    return None


def _no_nested(exprs, what: str) -> Optional[str]:
    """Sort keys are word-encoded scalars: a nested key stays on the CPU
    (the JAX package's ``is_device_sort``)."""
    for e in exprs:
        if isinstance(e.data_type, (T.ArrayType, T.MapType, T.StructType)):
            return f"nested {what} are not supported on TPU"
    return None


def _tag_project(node, conf, device) -> Optional[str]:
    return _tag_exprs(node.project_list, conf, device)


def _tag_filter(node, conf, device) -> Optional[str]:
    return _tag_exprs([node.condition], conf, device)


def _tag_exchange(node, conf, device) -> Optional[str]:
    p = node.partitioning
    if isinstance(p, P.HashPartitioning):
        for e in p.exprs:
            dt = e.data_type
            if isinstance(dt, (T.ArrayType, T.MapType)):
                return "nested hash partition keys run on CPU"
            if isinstance(dt, T.StructType):
                r = X.type_reason(dt, X.STRUCT)
                if r:
                    return f"hash partition key: {r}"
                if any(T.is_limb_decimal(f.data_type) for f in dt.fields):
                    # the variable-length big-decimal byte hash has no
                    # device twin (the same gate as a decimal128 key)
                    return ("decimal128 struct fields in hash partition "
                            "keys run on CPU")
            r = _tag_exprs([e], conf, device) or \
                _no_ansi([e], "partition keys")
            if r:
                return r
            if isinstance(dt, T.DecimalType) and dt.precision > 18:
                return "decimal128 hash partitioning runs on CPU"
        return None
    if isinstance(p, P.RangePartitioning):
        keys = [o.child for o in p.order]
        return _no_nested(keys, "sort keys") or \
            _tag_exprs(keys, conf, device) or _no_ansi(keys, "sort keys")
    if isinstance(p, (P.SinglePartitioning, P.RoundRobinPartitioning)):
        return None
    return f"{type(p).__name__} is not ported yet"


def _tag_sort(node, conf, device) -> Optional[str]:
    keys = [o.child for o in node.order]
    return _no_nested(keys, "sort keys") or \
        _tag_exprs(keys, conf, device) or _no_ansi(keys, "sort keys")


def _tag_generate(node, conf, device) -> Optional[str]:
    from spark_rapids_tpu_torch.exec.generate import is_device_generate
    return is_device_generate(node.generator, conf, device)


def _tag_aggregate(node, conf, device) -> Optional[str]:
    """The JAX package's aggregate tagging: ``is_device_agg``, then the
    float-aggregate gate under spark.rapids.sql.variableFloatAgg.enabled
    (float sums, averages and stddev/variance depend on the order of
    their additions)."""
    from spark_rapids_tpu_torch.exec.agg import unsupported_agg_reason
    r = unsupported_agg_reason(node.grouping, node.aggregates, conf, device)
    if r or conf.get(ENABLE_FLOAT_AGG):
        return r
    for e in node.aggregates:
        if isinstance(e, E.Alias) and isinstance(e.child,
                                                 E.AggregateExpression):
            func = e.child.func
            if isinstance(func, (E.Sum, E.Average)) and T.is_floating(
                    func.children[0].data_type):
                return ("device float sum/average may differ from CPU due "
                        "to addition ordering "
                        "(spark.rapids.sql.variableFloatAgg.enabled=false)")
            if isinstance(func, E.CentralMomentAgg):
                return ("device stddev/variance may differ from CPU due "
                        "to addition ordering "
                        "(spark.rapids.sql.variableFloatAgg.enabled=false)")
    return None


def _tag_expand(node, conf, device) -> Optional[str]:
    for proj in node.projections:
        r = _tag_exprs(proj, conf, device)
        if r:
            return r
    return None


def _tag_window(node, conf, device) -> Optional[str]:
    from spark_rapids_tpu_torch.exec.window import is_device_window
    return is_device_window(node.window_exprs, node.partition_spec,
                            node.order_spec, conf, device)


def _tag_join(node, conf, device) -> Optional[str]:
    from spark_rapids_tpu_torch.exec.join import is_device_join
    return is_device_join(node.join_type, node.left_keys, node.right_keys,
                          node.condition, conf, device)


def _tag_none(node, conf, device) -> Optional[str]:
    return None


def _coalesced(kid, conf, device):
    """A TorchCoalesceBatchesExec over a device exchange, so that a
    per-batch operator sees goal-sized batches instead of the exchange's
    per-input splits (operators that concatenate whole partitions anyway
    skip it)."""
    from spark_rapids_tpu_torch.exec.base import TorchCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchShuffleExchangeExec
    if isinstance(kid, TorchShuffleExchangeExec):
        return TorchCoalesceBatchesExec(kid, conf, device)
    return kid


def _conv_project(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchProjectExec
    return TorchProjectExec(node.project_list,
                            _coalesced(kids[0], conf, device), conf, device)


def _conv_filter(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchFilterExec
    return TorchFilterExec(node.condition,
                           _coalesced(kids[0], conf, device), conf, device)


def device_shuffle_partitions(conf: TorchConf, n: int) -> int:
    """Partition count of a planner-inserted device hash or range
    exchange: ``spark.rapids.sql.shuffle.devicePartitions``, where auto
    (0) is 1 on one card, never above the planner's ``n``."""
    from spark_rapids_tpu_torch.conf import DEVICE_SHUFFLE_PARTITIONS
    want = int(conf.get(DEVICE_SHUFFLE_PARTITIONS))
    if want <= 0:
        want = 1
    return max(1, min(n, want))


def _conv_exchange(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchShuffleExchangeExec
    p = node.partitioning
    # a planner-inserted distribution is met by any partition count, so
    # it coalesces; a user's repartition(n, ...) keeps its n
    if not p.user_specified:
        if isinstance(p, P.HashPartitioning):
            n = device_shuffle_partitions(conf, p.num_partitions)
            if n != p.num_partitions:
                p = P.HashPartitioning(p.exprs, n)
        elif isinstance(p, P.RangePartitioning):
            n = device_shuffle_partitions(conf, p.num_partitions)
            if n != p.num_partitions:
                p = P.RangePartitioning(p.order, n)
    return TorchShuffleExchangeExec(p, kids[0], conf, device)


def _allow_aqe_coalesce(kid):
    """Aggregate, sort and window consumers take any partition count, so their
    exchange child may coalesce small partitions at run time; a join's
    inputs must stay co-partitioned and never opt in."""
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchShuffleExchangeExec
    if isinstance(kid, TorchShuffleExchangeExec):
        kid.allow_aqe_coalesce = True
    return kid


def _conv_sort(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.sort import TorchSortExec
    return TorchSortExec(node.order, node.is_global,
                         _allow_aqe_coalesce(kids[0]), conf, device)


def _conv_aggregate(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    return TorchHashAggregateExec(node.grouping, node.aggregates,
                                  node.mode, _allow_aqe_coalesce(kids[0]),
                                  node.slots, conf, device)


def _conv_generate(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.generate import TorchGenerateExec
    return TorchGenerateExec(node.generator, node.gen_output, kids[0], conf,
                             device)


def _conv_range(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchRangeExec
    return TorchRangeExec(node.output, node.start, node.end, node.step,
                          node.num_partitions, conf, device)


def _conv_union(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchUnionExec
    return TorchUnionExec(kids, node.output, conf, device)


def _conv_expand(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchExpandExec
    return TorchExpandExec(node.projections, node.output, kids[0], conf,
                           device)


def _conv_window(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.window import TorchWindowExec
    return TorchWindowExec(node.window_exprs, node.partition_spec,
                           node.order_spec, _allow_aqe_coalesce(kids[0]),
                           conf, device)


def _conv_local_limit(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchLocalLimitExec
    from spark_rapids_tpu_torch.exec.sort import TorchSortExec, TorchTopNExec
    kid = kids[0]
    # LocalLimit over Sort fuses into TopN (TakeOrderedAndProject)
    if type(kid) is TorchSortExec:
        return TorchTopNExec(node.n, kid.order, kid.child, conf, device)
    return TorchLocalLimitExec(node.n, kid, conf, device)


def _conv_global_limit(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.basic import TorchGlobalLimitExec
    return TorchGlobalLimitExec(node.n, kids[0], conf, device)


def _conv_broadcast_exchange(node, kids, conf, device):
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchBroadcastExchangeExec
    return TorchBroadcastExchangeExec(kids[0], conf, device)


def _conv_join(cls_name: str):
    def conv(node, kids, conf, device):
        from spark_rapids_tpu_torch.exec import join as J
        return getattr(J, cls_name)(
            node.left_keys, node.right_keys, node.join_type,
            node.condition, kids[0], kids[1], node.output, conf, device,
            null_safe=node.null_safe)
    return conv


class ExecRule:
    def __init__(self, tag: Callable, convert: Callable, sig: str = X.FLAT):
        self.tag = tag
        self.convert = convert
        self.sig = sig


_EXEC_RULES: Dict[Type, ExecRule] = {
    P.CpuProjectExec: ExecRule(_tag_project, _conv_project, X.NESTED),
    P.CpuFilterExec: ExecRule(_tag_filter, _conv_filter, X.NESTED),
    P.CpuGenerateExec: ExecRule(_tag_generate, _conv_generate, X.NESTED),
    P.CpuShuffleExchangeExec: ExecRule(_tag_exchange, _conv_exchange,
                                       X.STRUCT),
    P.CpuSortExec: ExecRule(_tag_sort, _conv_sort, X.STRUCT),
    P.CpuHashAggregateExec: ExecRule(_tag_aggregate, _conv_aggregate,
                                     X.STRUCT),
    P.CpuLocalLimitExec: ExecRule(_tag_none, _conv_local_limit),
    P.CpuGlobalLimitExec: ExecRule(_tag_none, _conv_global_limit),
    P.CpuBroadcastExchangeExec: ExecRule(_tag_none,
                                         _conv_broadcast_exchange),
    P.CpuShuffledHashJoinExec: ExecRule(
        _tag_join, _conv_join("TorchShuffledHashJoinExec")),
    P.CpuBroadcastHashJoinExec: ExecRule(
        _tag_join, _conv_join("TorchBroadcastHashJoinExec")),
    P.CpuRangeExec: ExecRule(_tag_none, _conv_range),
    P.CpuUnionExec: ExecRule(_tag_none, _conv_union),
    P.CpuExpandExec: ExecRule(_tag_expand, _conv_expand),
    CpuWindowExec: ExecRule(_tag_window, _conv_window),
    # the surrounding plan stays on the device around the Python worker
    CpuArrowEvalPythonExec: ExecRule(
        _tag_none, lambda node, kids, conf, device:
        TorchArrowEvalPythonExec(node, kids[0], conf, device)),
    CpuMapInPandasExec: ExecRule(
        _tag_none, lambda node, kids, conf, device:
        TorchMapInPandasExec(node, kids[0], conf, device)),
}


class ExecMeta:
    """Wrapper over one CPU physical node (SparkPlanMeta role)."""

    def __init__(self, wrapped: P.PhysicalPlan):
        self.wrapped = wrapped
        self.rule = _EXEC_RULES.get(type(wrapped))
        self.children = [ExecMeta(c) for c in wrapped.children]

    def tag(self, conf: TorchConf, device) -> None:
        """Raise for the first node the port cannot run on the device."""
        for c in self.children:
            c.tag(conf, device)
        if isinstance(self.wrapped, HOST_SOURCES):
            return
        name = type(self.wrapped).__name__
        if self.rule is None:
            raise NotImplementedError(
                f"{name} is not ported yet to spark_rapids_tpu_torch")
        reason = _tag_types(self.wrapped, self.rule.sig) or self.rule.tag(
            self.wrapped, conf, device)
        if reason:
            raise NotImplementedError(
                f"{name} in spark_rapids_tpu_torch: {reason}"
                + CPU_FALLBACK)

    def convert(self, conf: TorchConf,
                device: torch.device) -> P.PhysicalPlan:
        if isinstance(self.wrapped, HOST_SOURCES):
            return self.wrapped
        kids: List[P.PhysicalPlan] = []
        for c in self.children:
            plan = c.convert(conf, device)
            if not isinstance(plan, TorchExec):
                plan = TorchRowToColumnarExec(plan, conf, device)
            kids.append(plan)
        return self.rule.convert(self.wrapped, kids, conf, device)


def apply_overrides(physical: P.PhysicalPlan, conf: TorchConf,
                    device: torch.device) -> P.PhysicalPlan:
    """CPU physical plan -> device plan with explicit transitions."""
    meta = ExecMeta(physical)
    meta.tag(conf, device)
    plan = meta.convert(conf, device)
    if not isinstance(plan, TorchExec):  # a bare scan still round-trips
        plan = TorchRowToColumnarExec(plan, conf, device)
    plan = TorchColumnarToRowExec(plan, conf)
    # whole-stage fusion last: a fused stage never crosses the boundaries
    # the conversion inserted (transitions, exchanges, coalesce)
    if conf.get(STAGE_FUSION_ENABLED):
        from spark_rapids_tpu_torch.exec.fused import fuse_stages
        plan = fuse_stages(plan, conf)
    return plan


def refuse_replanned_subtree(plan: P.PhysicalPlan,
                             conf: TorchConf) -> P.PhysicalPlan:
    """Adaptive execution's re-entry into the fusion pass: a run-time
    replan that removes an exchange boundary (a join's broadcast
    demotion) hands the surviving subtree back through
    ``fuse_stages`` under the same conf gate, so it gets the
    filter/project chains the boundary blocked. No-op with fusion off."""
    if conf.get(STAGE_FUSION_ENABLED):
        from spark_rapids_tpu_torch.exec.fused import fuse_stages
        return fuse_stages(plan, conf)
    return plan
