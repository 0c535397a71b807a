"""Plan rewrite onto torch device operators: the wrap -> tag -> convert
flow of ``spark_rapids_tpu.overrides.apply_overrides``, with the
per-operator CPU fallback.

1. **wrap**: every CPU physical node is wrapped in an ``ExecMeta``
   carrying its rule.
2. **tag**: each meta collects the reasons the JAX package's tagging
   gives for keeping the node on its CPU, in its order and its words:
   the per-op and per-expression enable keys
   (``spark.rapids.sql.exec.<Op>``, ``spark.rapids.sql.expression.<Expr>``),
   the rule's type signature over the node's output and inputs
   (``ops.exprs.type_reason`` over ``FLAT``, ``STRUCT``, ``NESTED``), the
   expression tree (``check_expr_tree``) and the operator's own checks.
   A node without reasons goes to the device. Where the JAX package runs
   a node on its device and this port cannot (``ExecRule.gap``), the
   rewrite raises ``NotImplementedError``: a node is placed on the host
   exactly where the JAX package places it on its CPU, never to hide a
   gap of the port.
3. **convert**: a device node's CPU children come up through a
   ``TorchRowToColumnarExec``; a CPU node's device children come down
   through a ``TorchColumnarToRowExec``, and a device root gets one on
   top. A plan that is only a host source round-trips through the card.

The port has rules for Range, Union, Expand, Window, Project, Filter,
Generate (explode), HashAggregate, ShuffleExchange (hash, range, single,
round robin; planner-inserted hash and range exchanges coalesce to
``spark.rapids.sql.shuffle.devicePartitions``: the mesh size while a
mesh is active, else 1), Sort,
LocalLimit (over a Sort it becomes TopN), GlobalLimit,
BroadcastExchange, the shuffled and broadcast hash joins, ArrowEvalPython
and MapInPandas. An aggregate's, a sort's or a window's exchange child
may coalesce its partitions at run time (``allow_aqe_coalesce``); a
join's children never do, and neither do a host operator's. Under
``spark.rapids.sql.optimizer.enabled`` the cost model reverts small
device islands to the CPU (``_revert_small_islands``); last, under
``spark.rapids.sql.stageFusion.enabled`` (default true), ``fuse_stages``
collapses each filter/project chain, with the partial aggregate above
it, into a ``TorchFusedStageExec``, never across a transition.

``RewriteReport`` records every fallback with its reasons: the
``spark.rapids.sql.explain`` output and the session's
``last_rewrite_report``. ``spark.rapids.sql.test.forceDevice`` turns
any fallback into an ``AssertionError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Type

import torch

from spark_rapids_tpu_torch.conf import (CBO_ENABLED, ENABLE_FLOAT_AGG,
                                         INCOMPATIBLE_OPS,
                                         STAGE_FUSION_ENABLED,
                                         TEST_FORCE_DEVICE, TorchConf)
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
# decodes them on the device). They are not fallbacks.
HOST_SOURCES = (P.CpuLocalScanExec, CpuFileScanExec, CpuCachedScanExec)


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

# the JAX rule table's expression signatures (output, inputs): arrays are
# read by the array consumers and made by the nested producers
_EXPR_SIGS = {
    **{c: (X.FLAT, X.NESTED) for c in (E.Size, E.ElementAt, E.GetArrayItem,
                                       E.ArrayContains, E.GetStructField)},
    **{c: (X.NESTED, X.FLAT) for c in (E.CreateArray, E.CreateNamedStruct,
                                       E.TimeWindow)},
}


def _expr_desc(e: E.Expression, limit: int = 64) -> str:
    """Short rendering of the offending subtree for the explain output,
    truncated so one large tree cannot flood the report."""
    try:
        s = repr(e)
    except Exception:
        s = type(e).__name__
    s = " ".join(s.split())
    return s if len(s) <= limit else s[:limit - 3] + "..."


def check_expr_tree(e: E.Expression, conf: TorchConf,
                    device=None) -> Optional[str]:
    """The JAX package's reason for keeping an (unbound) expression tree
    off the device, or None; each reason names the offending subtree."""
    if isinstance(e, E.Alias):
        return check_expr_tree(e.child, conf, device)
    if isinstance(e, E.AttributeReference):
        return X.leaf_support(e)
    name = type(e).__name__
    if type(e) not in X._HANDLERS and not isinstance(e, E.Literal):
        return f"expression {name} <{_expr_desc(e)}> is not supported on TPU"
    r = X._limb_decimal_gate(e)
    if r:
        return r
    key = f"spark.rapids.sql.expression.{name}"
    if not conf.is_op_enabled(key):
        return (f"expression {name} <{_expr_desc(e)}> has been disabled "
                f"({key}=false)")
    why = INCOMPAT.get(type(e))
    if why and not conf.get(INCOMPATIBLE_OPS):
        return (f"expression {name} <{_expr_desc(e)}> is not 100% "
                f"compatible: {why}. Set "
                "spark.rapids.sql.incompatibleOps.enabled=true to allow")
    if not conf.get(INCOMPATIBLE_OPS):
        r = X.platform_gate(e, device)
        if r:
            return f"expression {name} <{_expr_desc(e)}>: {r}"
    out_sig, in_sig = _EXPR_SIGS.get(type(e), (X.FLAT, X.FLAT))
    r = X.type_reason(e.data_type, out_sig)
    if r:
        return f"expression {name} <{_expr_desc(e)}>: output: {r}"
    for c in e.children:
        dt = getattr(c, "data_type", None)
        rc = X.type_reason(dt, in_sig) if dt is not None else None
        if rc:
            return (f"expression {name} <{_expr_desc(e)}>: input "
                    f"{type(c).__name__}: {rc}")
    extra = X._EXTRA_CHECKS.get(type(e))
    if extra is not None:
        r = extra(e)
        if r:
            return f"expression {name} <{_expr_desc(e)}>: {r}"
    for i, c in enumerate(e.children):
        if i in X._ARRAY_ARG_OK.get(type(e), ()) and \
                isinstance(c, E.AttributeReference) and \
                isinstance(c.data_type, T.ArrayType):
            r = X._array_leaf_ok(c)
            if r:
                return f"expression {name}: {r}"
            continue
        r = check_expr_tree(c, conf, device)
        if r:
            return r
    return None


# ---------------------------------------------------------------------------
# The JAX package's tagging, operator by operator: each returns the
# reasons for keeping the node on the CPU, in the JAX package's order
# ---------------------------------------------------------------------------

def _jax_project(node, conf, device) -> List[str]:
    return [r for r in (check_expr_tree(e, conf, device)
                        for e in node.project_list) if r]


def _jax_filter(node, conf, device) -> List[str]:
    r = check_expr_tree(node.condition, conf, device)
    return [r] if r else []


def _device_sort_reason(order, conf, device) -> Optional[str]:
    """``is_device_sort``: every sort key a flat device expression."""
    for o in order:
        if isinstance(o.child.data_type, (T.ArrayType, T.MapType,
                                          T.StructType)):
            return "nested sort keys are not supported on TPU"
        r = X.unsupported_reason(o.child, conf, device)
        if r:
            return r
        if X.contains_ansi_cast(o.child):
            return "ANSI casts in sort keys run on CPU"
    return None


def _jax_exchange(node, conf, device) -> List[str]:
    out: List[str] = []
    p = node.partitioning
    if isinstance(p, P.HashPartitioning):
        for e in p.exprs:
            dt = e.data_type
            if isinstance(dt, (T.ArrayType, T.MapType)):
                out.append("nested hash partition keys run on CPU")
            elif isinstance(dt, T.StructType):
                r = X.type_reason(dt, X.STRUCT)
                if r:
                    out.append(f"hash partition key: {r}")
                elif any(T.is_limb_decimal(f.data_type)
                         for f in dt.fields):
                    # the variable-length big-decimal byte hash has no
                    # device twin (the same gate as a decimal128 key)
                    out.append("decimal128 struct fields in hash partition "
                               "keys run on CPU")
            r = check_expr_tree(e, conf, device)
            if r:
                out.append(r)
            if X.contains_ansi_cast(e):
                out.append("ANSI casts in partition keys run on CPU")
            if isinstance(dt, T.DecimalType) and dt.precision > 18:
                out.append("decimal128 hash partitioning runs on CPU")
    elif isinstance(p, P.RangePartitioning):
        r = _device_sort_reason(p.order, conf, device)
        if r:
            out.append(f"range partitioning: {r}")
    elif not isinstance(p, (P.SinglePartitioning, P.RoundRobinPartitioning)):
        out.append(f"{type(p).__name__} is not supported on TPU yet")
    return out


def _jax_expand(node, conf, device) -> List[str]:
    for proj in node.projections:
        for e in proj:
            r = check_expr_tree(e, conf, device)
            if r:
                return [r]
    return []


def _jax_sort(node, conf, device) -> List[str]:
    r = _device_sort_reason(node.order, conf, device)
    return [r] if r else []


def _jax_window(node, conf, device) -> List[str]:
    from spark_rapids_tpu_torch.exec.window import is_device_window
    r = is_device_window(node.window_exprs, node.partition_spec,
                         node.order_spec, conf, device)
    return [r] if r else []


def _jax_join(node, conf, device) -> List[str]:
    from spark_rapids_tpu_torch.exec.join import is_device_join
    r = is_device_join(node.join_type, node.left_keys, node.right_keys,
                       node.condition, conf, device)
    return [r] if r else []


def _jax_generate(node, conf, device) -> List[str]:
    from spark_rapids_tpu_torch.exec.generate import is_device_generate
    r = is_device_generate(node.generator, conf, device)
    return [r] if r else []


def _jax_aggregate(node, conf, device) -> List[str]:
    """``is_device_agg``, the grouping keys' struct signature, then the
    float-aggregate gate under spark.rapids.sql.variableFloatAgg.enabled
    (float sums, averages and stddev/variance depend on the order of
    their additions)."""
    from spark_rapids_tpu_torch.exec.agg import is_device_agg
    r = is_device_agg(node.grouping, node.aggregates, conf, device)
    if r:
        return [r]
    out: List[str] = []
    for g in node.grouping:
        rr = X.type_reason(g.data_type, X.STRUCT)
        if rr:
            out.append(f"grouping key {g.name}: {rr}")
    if not conf.get(ENABLE_FLOAT_AGG):
        for e in node.aggregates:
            if isinstance(e, E.Alias) and isinstance(
                    e.child, E.AggregateExpression):
                func = e.child.func
                if isinstance(func, (E.Sum, E.Average)) and T.is_floating(
                        func.children[0].data_type):
                    out.append(
                        "device float sum/average may differ from CPU due "
                        "to addition ordering "
                        "(spark.rapids.sql.variableFloatAgg.enabled=false)")
                if isinstance(func, E.CentralMomentAgg):
                    out.append(
                        "device stddev/variance may differ from CPU due "
                        "to addition ordering "
                        "(spark.rapids.sql.variableFloatAgg.enabled=false)")
    return list(dict.fromkeys(out))


def _jax_none(node, conf, device) -> List[str]:
    return []


# ---------------------------------------------------------------------------
# What this port has not ported of what the JAX package runs on its
# device: a node the JAX tagging keeps on the device must pass this too,
# or the rewrite raises (never a host placement)
# ---------------------------------------------------------------------------

def _gap_aggregate(node, conf, device) -> Optional[str]:
    """An aggregate's grouping keys and its result list beyond an
    aggregate or a grouping key (``unsupported_agg_reason``)."""
    from spark_rapids_tpu_torch.exec.agg import unsupported_agg_reason
    return unsupported_agg_reason(node.grouping, node.aggregates, conf,
                                  device)


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

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
    (0) is the mesh size while a mesh is active, else 1, never above the
    planner's ``n``."""
    from spark_rapids_tpu_torch.conf import DEVICE_SHUFFLE_PARTITIONS
    want = int(conf.get(DEVICE_SHUFFLE_PARTITIONS))
    if want <= 0:
        from spark_rapids_tpu_torch.parallel.mesh import (get_active_mesh,
                                                          mesh_size)
        want = mesh_size() if get_active_mesh() is not None else 1
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
    """Aggregate, sort and window consumers take any partition count, so
    their exchange child may coalesce small partitions at run time; a
    join's inputs must stay co-partitioned and never opt in, and a host
    operator's exchange children never do."""
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
    """One node kind's rule: the JAX package's tagging (``jax``), the
    converter, the type signature of what the node outputs and its
    children give it, and this port's own gap beyond the JAX tagging
    (``gap``, where it has one)."""

    def __init__(self, name: str, jax: Callable, convert: Callable,
                 sig: str = X.FLAT, gap: Optional[Callable] = None,
                 desc: str = ""):
        self.name = name
        self.desc = desc
        self.jax = jax
        self.gap = gap
        self.convert = convert
        self.sig = sig

    @property
    def conf_key(self) -> str:
        return f"spark.rapids.sql.exec.{self.name}"


def _rule(cls: Type, desc: str, jax: Callable, convert: Callable,
          sig: str = X.FLAT, gap: Optional[Callable] = None):
    return cls, ExecRule(cls.__name__.replace("Cpu", ""), jax, convert,
                         sig, gap, desc)


# the descriptions are the JAX rule table's, so the two support matrices
# (docs/supported_ops.md, docs/torch/supported_ops.md) agree row for row
_EXEC_RULES: Dict[Type, ExecRule] = dict([
    _rule(P.CpuProjectExec, "projection onto device columns",
          _jax_project, _conv_project, X.NESTED),
    _rule(P.CpuFilterExec, "device predicate filter (mask update)",
          _jax_filter, _conv_filter, X.NESTED),
    _rule(P.CpuGenerateExec, "device explode over segmented arrays",
          _jax_generate, _conv_generate, X.NESTED),
    _rule(P.CpuRangeExec, "device iota range source", _jax_none,
          _conv_range),
    _rule(P.CpuUnionExec, "union of device partitions", _jax_none,
          _conv_union),
    _rule(P.CpuLocalLimitExec, "per-partition limit by mask", _jax_none,
          _conv_local_limit),
    _rule(P.CpuGlobalLimitExec, "global limit by mask", _jax_none,
          _conv_global_limit),
    _rule(P.CpuShuffleExchangeExec, "device-partitioned exchange",
          _jax_exchange, _conv_exchange, X.STRUCT),
    _rule(P.CpuBroadcastExchangeExec,
          "device-resident reusable broadcast "
          "(GpuBroadcastExchangeExec.scala:280)", _jax_none,
          _conv_broadcast_exchange),
    _rule(P.CpuHashAggregateExec, "sort-segmented device aggregation",
          _jax_aggregate, _conv_aggregate, X.STRUCT, gap=_gap_aggregate),
    _rule(P.CpuExpandExec, "device grouping-sets expansion", _jax_expand,
          _conv_expand),
    _rule(P.CpuSortExec, "device lexsort over encoded sort keys",
          _jax_sort, _conv_sort, X.STRUCT),
    _rule(CpuWindowExec, "segment-scan device window functions",
          _jax_window, _conv_window),
    _rule(P.CpuShuffledHashJoinExec, "count-then-gather device equi-join",
          _jax_join, _conv_join("TorchShuffledHashJoinExec")),
    _rule(P.CpuBroadcastHashJoinExec,
          "device equi-join with HBM-resident build side", _jax_join,
          _conv_join("TorchBroadcastHashJoinExec")),
    # the surrounding plan stays on the device around the Python worker
    _rule(CpuArrowEvalPythonExec,
          "scalar pandas UDFs via the python worker pool; the "
          "surrounding plan stays on device "
          "(GpuArrowEvalPythonExec.scala:487)", _jax_none,
          lambda node, kids, conf, device:
          TorchArrowEvalPythonExec(node, kids[0], conf, device)),
    _rule(CpuMapInPandasExec,
          "mapInPandas via the python worker pool "
          "(GpuMapInPandasExec role)", _jax_none,
          lambda node, kids, conf, device:
          TorchMapInPandasExec(node, kids[0], conf, device)),
])


class ExecMeta:
    """Wrapper over one CPU physical node (SparkPlanMeta role)."""

    def __init__(self, wrapped: P.PhysicalPlan):
        self.wrapped = wrapped
        self.rule = _EXEC_RULES.get(type(wrapped))
        self.children = [ExecMeta(c) for c in wrapped.children]
        self.reasons: List[str] = []

    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_replace(self) -> bool:
        return self.rule is not None and not self.reasons

    def tag(self, conf: TorchConf, device) -> None:
        """Collect the JAX package's reasons for keeping each node on the
        CPU; raise where the JAX package runs a node on its device and
        this port cannot."""
        for c in self.children:
            c.tag(conf, device)
        if isinstance(self.wrapped, HOST_SOURCES):
            return
        name = type(self.wrapped).__name__
        if self.rule is None:
            self.will_not_work(f"{name} has no GPU replacement")
            return
        rule = self.rule
        if not conf.is_op_enabled(rule.conf_key):
            self.will_not_work(
                f"the exec has been disabled ({rule.conf_key}=false)")
        for a in self.wrapped.output:
            r = X.type_reason(a.data_type, rule.sig)
            if r:
                self.will_not_work(r)
                break
        for c in self.wrapped.children:
            for a in c.output:
                r = X.type_reason(a.data_type, rule.sig)
                if r:
                    self.will_not_work(f"input: {r}")
                    break
        for r in rule.jax(self.wrapped, conf, device):
            self.will_not_work(r)
        if self.reasons:
            return
        gap = rule.gap and rule.gap(self.wrapped, conf, device)
        if gap:
            raise NotImplementedError(
                f"{name} in spark_rapids_tpu_torch: {gap}; the JAX package "
                "runs it on its device, and this port does not yet")

    def convert(self, conf: TorchConf,
                device: torch.device) -> P.PhysicalPlan:
        converted = [c.convert(conf, device) for c in self.children]
        if self.can_replace:
            kids = [k if isinstance(k, TorchExec)
                    else TorchRowToColumnarExec(k, conf, device)
                    for k in converted]
            return self.rule.convert(self.wrapped, kids, conf, device)
        # stays on the CPU: device children come back through C2R
        if not converted:
            return self.wrapped
        kids = [TorchColumnarToRowExec(k, conf, release_when_drained=True)
                if isinstance(k, TorchExec) else k for k in converted]
        return self.wrapped.with_new_children(kids)

    def collect_fallbacks(self, out: List) -> None:
        if self.reasons:
            out.append((type(self.wrapped).__name__, list(self.reasons)))
        for c in self.children:
            c.collect_fallbacks(out)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@dataclass
class RewriteReport:
    """Explain and fallback record of one query's rewrite: the
    ``spark.rapids.sql.explain`` output and ``last_rewrite_report``."""

    fallbacks: List = field(default_factory=list)  # (exec name, [reasons])
    device_ops: List[str] = field(default_factory=list)  # placed on GPU
    replaced_any: bool = False

    def format(self, mode: str = "NOT_ON_GPU") -> str:
        """NOT_ON_GPU: one line per fallback reason; ALL also lists every
        operator that will run on the GPU."""
        lines = []
        if mode == "ALL":
            for name in self.device_ops:
                lines.append(f"*Exec <{name}> will run on GPU")
        for name, reasons in self.fallbacks:
            for r in reasons:
                lines.append(f"!Exec <{name}> cannot run on GPU because {r}")
        return "\n".join(lines)

    @property
    def coverage(self) -> float:
        """Fraction of rated operators placed on the device (transitions
        are not rated)."""
        total = len(self.device_ops) + len(self.fallbacks)
        return (len(self.device_ops) / total) if total else 1.0

    def reason_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _name, reasons in self.fallbacks:
            for r in reasons:
                out[r] = out.get(r, 0) + 1
        return out

    def print_explain(self, conf: TorchConf) -> None:
        """Print the lines the configured mode asks for (NOT_ON_TPU
        honoured as an alias of NOT_ON_GPU); ``apply_overrides`` calls
        this once a rewrite."""
        mode = conf.explain
        if mode == "NOT_ON_TPU":
            mode = "NOT_ON_GPU"
        if mode == "ALL" or (mode == "NOT_ON_GPU" and self.fallbacks):
            text = self.format(mode)
            if text:
                print(text)

    def summary(self) -> Dict:
        return {
            "replacedAny": self.replaced_any,
            "deviceOps": list(self.device_ops),
            "coverage": round(self.coverage, 4),
            "fallbacks": [{"op": n, "reasons": list(rs)}
                          for n, rs in self.fallbacks],
            "reasonCounts": self.reason_counts(),
        }


def _record_device_ops(plan: P.PhysicalPlan, report: RewriteReport) -> None:
    """report.device_ops from the final plan: every Torch* operator,
    fused stages' constituents included, the transitions excluded."""
    report.device_ops = []

    def walk(p) -> None:
        if isinstance(p, TorchExec) and not isinstance(
                p, TorchRowToColumnarExec):
            ops = getattr(p, "fused_ops", None) or [p]
            report.device_ops.extend(op.simple_string().split()[0]
                                     for op in ops)
        for c in p.children:
            walk(c)

    walk(plan)


def has_device_op(plan: P.PhysicalPlan) -> bool:
    if isinstance(plan, TorchExec):
        return True
    return any(has_device_op(c) for c in plan.children)


def apply_overrides(physical: P.PhysicalPlan, conf: TorchConf,
                    device: torch.device,
                    report: Optional[RewriteReport] = None,
                    announce: bool = True) -> P.PhysicalPlan:
    """CPU physical plan -> mixed plan with explicit transitions; fills
    ``report`` and, when ``announce``, prints the explain lines."""
    meta = ExecMeta(physical)
    meta.tag(conf, device)
    if report is None:
        report = RewriteReport()
    meta.collect_fallbacks(report.fallbacks)
    if conf.get(TEST_FORCE_DEVICE) and report.fallbacks:
        raise AssertionError(
            "Part of the plan is not columnar (test.forceDevice):\n"
            + report.format())
    plan = meta.convert(conf, device)
    if isinstance(plan, HOST_SOURCES):  # a bare scan still round-trips
        plan = TorchRowToColumnarExec(plan, conf, device)
    if isinstance(plan, TorchExec):
        plan = TorchColumnarToRowExec(plan, conf)
    if conf.get(CBO_ENABLED) and not conf.get(TEST_FORCE_DEVICE):
        plan = _revert_small_islands(plan, report)
    report.replaced_any = has_device_op(plan)
    # whole-stage fusion last: it sees the final placement, and a fused
    # stage never crosses the boundaries the passes above inserted
    # (transitions, exchanges, coalesce)
    if conf.get(STAGE_FUSION_ENABLED):
        from spark_rapids_tpu_torch.exec.fused import fuse_stages
        plan = fuse_stages(plan, conf)
    _record_device_ops(plan, report)
    if announce:
        report.print_explain(conf)
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


# -- the cost model (the reference's CostBasedOptimizer) ---------------------
#
# The card's own transition costs, measured by ``chip_smoke.py``'s
# ``cbo_constants`` phase on an NVIDIA H100 80GB HBM3 at 700.00 W: the
# bytes a second of one upload and download pair through the pinned
# staging ring, as the model counts bytes (``_row_width_bytes``, both
# ways; TPC-H q1's lineitem at SF1, 6,001,215 rows, round trip 1.914 s),
# and the flat seconds of one one-row island's round trip. The host
# costs per row are the host engine's, as in the JAX package.
_WIRE_BYTES_PER_S = 5.72e8
_ISLAND_FLAT_S = 4.15e-3
_DEFAULT_ROW_COUNT = 1 << 20  # the reference optimizer's default row count

_NS_ELEMENTWISE = 3.0      # one vectorized numpy pass per expression node
_NS_STRING_OP = 25.0       # object-array string kernels
_NS_REGEX = 2000.0         # a Python re loop per row (LIKE, regexp, split)


def _expr_cost_ns(e) -> float:
    """Estimated host nanoseconds a row to evaluate this expression tree
    with the host engine."""
    name = type(e).__name__
    if name in ("Like", "RLike", "RegExpExtract", "RegExpReplace",
                "StringSplit", "PythonUDF", "PandasUDF"):
        ns = _NS_REGEX
    elif isinstance(getattr(e, "data_type", None), T.StringType) \
            and e.children:
        ns = _NS_STRING_OP
    elif not e.children:
        ns = 0.0  # attribute or literal: no pass of its own
    else:
        ns = _NS_ELEMENTWISE
    return ns + sum(_expr_cost_ns(c) for c in e.children)


def _row_width_bytes(schema: T.StructType) -> int:
    w = 0
    for f in schema.fields:
        dt = f.data_type
        if isinstance(dt, (T.StringType, T.BinaryType)):
            w += 24
        elif T.is_limb_decimal(dt):
            w += 16
        else:
            try:
                w += T.numpy_dtype(dt).itemsize
            except Exception:
                w += 8
        w += 1  # validity
    return max(1, w)


def _estimate_rows(p: P.PhysicalPlan) -> int:
    """Row-count estimate of a CPU source subtree: local data is exact, a
    Parquet scan reads its footers' row counts (else its bytes), anything
    else passes through its first child."""
    if isinstance(p, P.CpuLocalScanExec):
        return sum(b.num_rows for b in p.batches) \
            if getattr(p, "batches", None) else _DEFAULT_ROW_COUNT
    if isinstance(p, CpuFileScanExec):
        rows = 0
        exact = True
        for u in p._units:
            nr = None
            if u.stats:
                for st in u.stats.values():
                    nr = st[3]
                    break
            if nr is None:
                exact = False
                break
            rows += int(nr)
        if exact and rows:
            return rows
        total = sum(u.size_bytes for u in p._units)
        return max(1, int(total * 2) // _row_width_bytes(p.schema))
    if p.children:
        return _estimate_rows(p.children[0])
    return _DEFAULT_ROW_COUNT


def _revert_small_islands(plan: P.PhysicalPlan, report: RewriteReport
                          ) -> P.PhysicalPlan:
    """Revert a device island between an upload and a download (a
    Project/Filter/Coalesce chain) to the CPU when the estimated host
    cost of its expressions is less than the cost of moving its rows to
    the card and back."""
    from spark_rapids_tpu_torch.exec.base import TorchCoalesceBatchesExec
    from spark_rapids_tpu_torch.exec.basic import (TorchFilterExec,
                                                   TorchProjectExec)
    new_children = [_revert_small_islands(c, report)
                    for c in plan.children]
    if any(a is not b for a, b in zip(new_children, plan.children)):
        plan = plan.with_new_children(new_children)
    if not isinstance(plan, TorchColumnarToRowExec):
        return plan
    island: List[P.PhysicalPlan] = []
    cur = plan.child
    while isinstance(cur, (TorchProjectExec, TorchFilterExec,
                           TorchCoalesceBatchesExec)):
        island.append(cur)
        cur = cur.children[0]
    if not isinstance(cur, TorchRowToColumnarExec):
        return plan
    compute = [n for n in island
               if not isinstance(n, TorchCoalesceBatchesExec)]
    cpu_src = cur.children[0]
    rows = _estimate_rows(cpu_src)
    cpu_ns_per_row = 0.0
    for n in compute:
        if isinstance(n, TorchProjectExec):
            cpu_ns_per_row += sum(_expr_cost_ns(e)
                                  for e in n.project_list)
        elif isinstance(n, TorchFilterExec):
            cpu_ns_per_row += _expr_cost_ns(n.condition)
    cpu_cost_s = rows * cpu_ns_per_row * 1e-9
    in_bytes = rows * _row_width_bytes(cpu_src.schema)
    out_bytes = rows * _row_width_bytes(plan.child.schema)
    transition_cost_s = (in_bytes + out_bytes) / _WIRE_BYTES_PER_S \
        + _ISLAND_FLAT_S
    if cpu_cost_s >= transition_cost_s:
        return plan  # the island repays its transitions
    cpu = cpu_src
    for n in reversed(island):
        if isinstance(n, TorchProjectExec):
            cpu = P.CpuProjectExec(n.project_list, cpu)
        elif isinstance(n, TorchFilterExec):
            cpu = P.CpuFilterExec(n.condition, cpu)
        # a coalesce has no meaning on the CPU: dropped
    report.fallbacks.append((
        type(compute[0]).__name__ if compute else "TorchRowToColumnar",
        [f"the transition cost (~{transition_cost_s:.2f}s for ~{rows} "
         f"rows) outweighs the estimated device speedup "
         f"(~{cpu_cost_s:.2f}s of CPU work) "
         "(spark.rapids.sql.optimizer.enabled)"]))
    return cpu

