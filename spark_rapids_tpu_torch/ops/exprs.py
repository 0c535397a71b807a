"""Device expression evaluation on torch tensors: the ported subset of
``spark_rapids_tpu.ops.exprs``.

The slice covers column references, literals, comparisons (numbers,
dates, strings, decimals), three-valued logic, null tests, ``+ - *``
(decimals under DecimalPrecision, and plain numbers) and casts between
numeric and decimal types. A subtree that references no column (``cast('1998-09-02' as date)``, ``cast(1 as
decimal(10,0))``) is folded once on the host by the CPU expression
evaluator and broadcast. Any other expression raises
``NotImplementedError`` when the plan is rewritten.

Semantics are the CPU engine's (sql/expressions.py): every column
carries a validity mask; invalid slots hold zeros ("normalized"), and
operators combine child validities.

Whole-stage fusion (``exec/fused.py``) runs a chain of filter and
project steps, and an aggregate's update, as one stage program per
batch: ``trace_stage_steps`` and ``build_stage_fn`` compose it, and
``stage_structural_key`` keys it. Every literal, and every column-free
subtree the host folds, is an input tensor of such a program
(``literal_values``), not a constant inside it: a CUDA graph captured
for one literal value then serves every other, as one XLA program does
in the JAX package, and no host-to-device copy happens while a graph is
captured. Numeric literal values are left out of the structural key
(``expr_key(e, program=True)``); string, boolean, 128-bit decimal and
null literals stay in it, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceColumn, DeviceDecimal128Column,
    DeviceStringColumn, bucket_char_cap, mask_col, torch_dtype)
from spark_rapids_tpu_torch.ops import decimal_ops as D
from spark_rapids_tpu_torch.ops import int128 as I
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T


def expr_key(e: E.Expression, program: bool = False) -> Tuple:
    """Structural identity of an expression (ignores expr_ids and alias
    names); equal keys evaluate to equal columns. With ``program`` the
    key identifies a stage program instead: a literal or folded subtree
    keys by its type alone where its value is an input of the program
    (``_traced``)."""
    if program and _is_literal_input(e):
        v = _host_literal(e)
        if _traced(e.data_type, v):
            return ("lit", repr(e.data_type))
        return ("lit", repr(e.data_type), repr(v))
    parts: List[Any] = [type(e).__name__]
    if isinstance(e, E.BoundReference):
        parts.append(("ord", e.ordinal, repr(e.data_type)))
    elif isinstance(e, E.Literal):
        parts.append(("lit", repr(e.value), repr(e.data_type)))
    elif isinstance(e, E.Cast):
        parts.append(("to", repr(e.data_type), e.ansi))
    elif isinstance(e, E.SortOrder):
        parts.append(("dir", e.ascending, e.nulls_first))
    parts.append(tuple(expr_key(c, program) for c in e.children))
    return tuple(parts)


class Ctx:
    """Evaluation context: the batch's columns, its capacity and device,
    and for a stage program the tensors of its literal inputs
    (``lit_vals``, in ``collect_literals`` order over ``exprs``)."""

    def __init__(self, inputs: Sequence[AnyDeviceColumn], capacity: int,
                 device: torch.device,
                 exprs: Sequence[E.Expression] = (),
                 lit_vals: Optional[Sequence[Tuple[torch.Tensor, ...]]]
                 = None):
        self.inputs = list(inputs)
        self.capacity = capacity
        self.device = device
        self.lit_vals = lit_vals
        self.lit_index: Dict[int, int] = {}
        if lit_vals is not None:
            for i, node in enumerate(collect_literals(exprs)):
                self.lit_index[id(node)] = i

    def ones(self) -> torch.Tensor:
        return torch.ones(self.capacity, dtype=torch.bool,
                          device=self.device)


_HANDLERS: Dict[type, Callable] = {}


def handles(*expr_types):
    def deco(fn):
        for t in expr_types:
            _HANDLERS[t] = fn
        return fn
    return deco


def _foldable(e: E.Expression) -> bool:
    """No column reference anywhere below: the value is one constant."""
    if isinstance(e, (E.BoundReference, E.AttributeReference)):
        return False
    if isinstance(e, E.AggregateExpression):
        return False
    return all(_foldable(c) for c in e.children)


def unsupported_reason(e: E.Expression) -> Optional[str]:
    """None when the tree evaluates on the device, else what is missing."""
    if isinstance(e, (E.AttributeReference, E.BoundReference)):
        return _dtype_reason(e.data_type)
    if _is_literal_input(e):
        return _dtype_reason(e.data_type)
    if type(e) not in _HANDLERS:
        return f"expression {type(e).__name__} is not ported yet"
    r = _dtype_reason(e.data_type)
    if r:
        return r
    if isinstance(e, (E.Add, E.Subtract, E.Multiply)) and \
            isinstance(e.data_type, T.DecimalType):
        lt, rt = e.children[0].data_type, e.children[1].data_type
        if not (isinstance(lt, T.DecimalType)
                and isinstance(rt, T.DecimalType)):
            return "mixed decimal arithmetic operands are not ported yet"
        ok = {E.Add: D.add_sub_supported, E.Subtract: D.add_sub_supported,
              E.Multiply: D.mul_supported}[type(e)](lt, rt)
        if not ok:
            return "decimal arithmetic beyond the 128-bit envelope"
    if isinstance(e, E.Cast):
        frm, to = e.child.data_type, e.data_type
        if e.ansi:
            return "ANSI casts are not ported yet"
        num = lambda t: T.is_numeric(t) or isinstance(t, T.BooleanType)
        if not (frm == to or (num(frm) and num(to))):
            return (f"cast {frm.simple_string} -> {to.simple_string} is "
                    "not ported yet")
        if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType)\
                and not D.cast_supported(frm, to):
            return "deep decimal down-rescale"
    for c in e.children:
        r = unsupported_reason(c)
        if r:
            return r
    return None


def _dtype_reason(dt: T.DataType) -> Optional[str]:
    if isinstance(dt, (T.ArrayType, T.MapType, T.StructType, T.NullType)):
        return f"type {dt.simple_string} is not ported yet"
    return None


def dev_eval(e: E.Expression, ctx: Ctx) -> AnyDeviceColumn:
    i = ctx.lit_index.get(id(e))
    if i is not None:
        return _input_literal(e.data_type, ctx.lit_vals[i], ctx)
    if _is_literal_input(e):
        return _input_literal(e.data_type, _literal_tensors(
            _host_literal(e), e.data_type, ctx.device), ctx)
    h = _HANDLERS.get(type(e))
    if h is None:
        raise NotImplementedError(
            f"expression {type(e).__name__} is not ported yet to "
            "spark_rapids_tpu_torch")
    return h(e, ctx)


def _host_literal(e: E.Expression):
    """The storage value of a literal or column-free subtree, evaluated on
    the host; None for null."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch, _to_storage
    if isinstance(e, E.Literal):
        return None if e.value is None else _to_storage(e.value,
                                                        e.data_type)
    hc = e.eval(HostBatch(T.StructType([]), [], 1))
    if not bool(hc.validity[0]):
        return None
    if T.is_limb_decimal(e.data_type):
        return I.to_pyints(hc.data[:1, 0], hc.data[:1, 1])[0]
    return hc.data[0]


# ---------------------------------------------------------------------------
# Literals: host value, then tensors, then a broadcast column (a stage
# program takes the tensors as inputs)
# ---------------------------------------------------------------------------

def _is_literal_input(e: E.Expression) -> bool:
    """A leaf that a stage program takes as input tensors: a literal, or
    a column-free subtree the host folds to one value."""
    return isinstance(e, E.Literal) or (_foldable(e)
                                        and not isinstance(e, E.Alias))


def _traced(dt: T.DataType, v) -> bool:
    """A literal whose value is left out of the structural key: numeric
    and non-null, within 64 bits (the JAX package's rule)."""
    return (v is not None and not T.is_limb_decimal(dt)
            and not isinstance(dt, (T.StringType, T.BinaryType,
                                    T.BooleanType, T.NullType)))


def collect_literals(exprs: Sequence[E.Expression]) -> List[E.Expression]:
    """Pre-order walk gathering every literal input; defines the order
    shared between a stage program and its callers."""
    out: List[E.Expression] = []

    def walk(e: E.Expression):
        if _is_literal_input(e):
            out.append(e)
            return
        for c in e.children:
            walk(c)
    for e in exprs:
        walk(e)
    return out


def _literal_tensors(v, dt: T.DataType, device: torch.device
                     ) -> Tuple[torch.Tensor, ...]:
    """The tensors of one literal's storage value ``v``: one 0-d tensor in
    the storage dtype; two int64 limbs for a 128-bit decimal; a char row
    and a length for a string; none for null."""
    if v is None:
        return ()
    if T.is_limb_decimal(dt):
        hi, lo = I.from_pyints([int(v)])
        return (torch.full((), int(hi[0]), dtype=torch.int64, device=device),
                torch.full((), int(lo[0]), dtype=torch.int64, device=device))
    if isinstance(dt, (T.StringType, T.BinaryType)):
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        row = np.zeros(bucket_char_cap(max(1, len(raw))), dtype=np.uint8)
        row[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        return (torch.from_numpy(row).to(device),
                torch.full((), len(raw), dtype=torch.int32, device=device))
    if isinstance(v, np.generic):
        v = v.item()
    return (torch.full((), v, dtype=torch_dtype(dt), device=device),)


def literal_values(exprs: Sequence[E.Expression], device: torch.device
                   ) -> List[Tuple[torch.Tensor, ...]]:
    """The input tensors of every literal of ``exprs`` on ``device``, in
    ``collect_literals`` order."""
    return [_literal_tensors(_host_literal(node), node.data_type, device)
            for node in collect_literals(exprs)]


def _input_literal(dt: T.DataType, ts: Tuple[torch.Tensor, ...],
                   ctx: Ctx) -> AnyDeviceColumn:
    """A literal column broadcast to the batch's capacity from its
    tensors (``_literal_tensors``)."""
    cap = ctx.capacity
    if not ts:
        return _null_column(dt, ctx)
    if T.is_limb_decimal(dt):
        return DeviceDecimal128Column(
            dt, ts[0].expand(cap).contiguous(),
            ts[1].expand(cap).contiguous(), ctx.ones())
    if isinstance(dt, (T.StringType, T.BinaryType)):
        return DeviceStringColumn(dt, ts[0].expand(cap, ts[0].shape[0]),
                                  ts[1].expand(cap).contiguous(),
                                  ctx.ones())
    return DeviceColumn(dt, ts[0].expand(cap).contiguous(), ctx.ones())


def _null_column(dt: T.DataType, ctx: Ctx) -> AnyDeviceColumn:
    cap, dev = ctx.capacity, ctx.device
    off = torch.zeros(cap, dtype=torch.bool, device=dev)
    if isinstance(dt, (T.StringType, T.BinaryType)):
        return DeviceStringColumn(
            dt, torch.zeros((cap, 8), dtype=torch.uint8, device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev), off)
    if T.is_limb_decimal(dt):
        z = torch.zeros(cap, dtype=torch.int64, device=dev)
        return DeviceDecimal128Column(dt, z, z, off)
    return DeviceColumn(dt, torch.zeros(cap, dtype=torch_dtype(dt),
                                        device=dev), off)


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

@handles(E.BoundReference)
def _h_bound(e: E.BoundReference, ctx: Ctx) -> AnyDeviceColumn:
    return ctx.inputs[e.ordinal]


@handles(E.Alias)
def _h_alias(e: E.Alias, ctx: Ctx) -> AnyDeviceColumn:
    return dev_eval(e.child, ctx)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _valid_and(cols: Sequence[AnyDeviceColumn]) -> torch.Tensor:
    v = cols[0].validity
    for c in cols[1:]:
        v = v & c.validity
    return v


def _normalized(dt: T.DataType, data: torch.Tensor, validity: torch.Tensor
                ) -> DeviceColumn:
    return mask_col(DeviceColumn(dt, data, validity), validity)


def dec_limbs(c: AnyDeviceColumn):
    """Decimal device column -> (hi, lo) int64 limb tensors."""
    if isinstance(c, DeviceDecimal128Column):
        return c.hi, c.lo
    return I.from_i64(torch, c.data.to(torch.int64))


def limbs_to_devcol(hi, lo, validity, dt: T.DataType) -> AnyDeviceColumn:
    hi = torch.where(validity, hi, 0)
    lo = torch.where(validity, lo, 0)
    if T.is_limb_decimal(dt):
        return DeviceDecimal128Column(dt, hi, lo, validity)
    return DeviceColumn(dt, lo, validity)  # <=18 digits: lo IS the value


def _binary_cols(e: E.Expression, ctx: Ctx):
    return dev_eval(e.children[0], ctx), dev_eval(e.children[1], ctx)


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

@handles(E.Add, E.Subtract, E.Multiply)
def _h_addmul(e, ctx: Ctx) -> AnyDeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    validity = _valid_and([lc, rc])
    res = e.data_type
    if isinstance(res, T.DecimalType):
        ahi, alo = dec_limbs(lc)
        bhi, blo = dec_limbs(rc)
        if isinstance(e, E.Multiply):
            hi, lo, ok = D.mul(torch, ahi, alo, bhi, blo, lc.dtype,
                               rc.dtype, res)
        else:
            sym = "+" if isinstance(e, E.Add) else "-"
            hi, lo, ok = D.add_sub(torch, sym, ahi, alo, bhi, blo,
                                   lc.dtype, rc.dtype, res)
        return limbs_to_devcol(hi, lo, validity & ok, res)
    op = {E.Add: torch.add, E.Subtract: torch.sub,
          E.Multiply: torch.mul}[type(e)]
    data = op(lc.data, rc.data).to(torch_dtype(res))
    return _normalized(res, data, validity)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

_CMP_OPS = {
    E.EqualTo: "eq", E.LessThan: "lt", E.LessThanOrEqual: "le",
    E.GreaterThan: "gt", E.GreaterThanOrEqual: "ge",
}


def _pad_chars(c: DeviceStringColumn, char_cap: int) -> torch.Tensor:
    if c.char_cap >= char_cap:
        return c.chars
    return torch.nn.functional.pad(c.chars, (0, char_cap - c.char_cap))


def _str_compare(a: DeviceStringColumn, b: DeviceStringColumn):
    """(lt, eq) by UTF-8 byte order; the length breaks ties that zero
    padding leaves (embedded NULs)."""
    cap = max(a.char_cap, b.char_cap)
    ac, bc = _pad_chars(a, cap), _pad_chars(b, cap)
    diff = ac != bc
    any_diff = diff.any(dim=1)
    first = diff.to(torch.int8).argmax(dim=1, keepdim=True)
    ab = torch.gather(ac, 1, first)[:, 0]
    bb = torch.gather(bc, 1, first)[:, 0]
    lt = torch.where(any_diff, ab < bb, a.lengths < b.lengths)
    eq = (~any_diff) & (a.lengths == b.lengths)
    return lt, eq


def _compare(op: str, lc: AnyDeviceColumn, rc: AnyDeviceColumn
             ) -> torch.Tensor:
    if isinstance(lc, DeviceStringColumn):
        lt, eq = _str_compare(lc, rc)
    elif isinstance(lc, DeviceDecimal128Column) or \
            isinstance(rc, DeviceDecimal128Column):
        ahi, alo = dec_limbs(lc)
        bhi, blo = dec_limbs(rc)
        lt = I.cmp_lt(torch, ahi, alo, bhi, blo)
        eq = I.eq(torch, ahi, alo, bhi, blo)
    elif lc.data.is_floating_point():
        # Spark total order: NaN is greatest and equal to itself
        a, b = lc.data, rc.data
        an, bn = torch.isnan(a), torch.isnan(b)
        eq = (a == b) | (an & bn)
        lt = (~an) & (bn | (a < b))
    else:
        a, b = lc.data, rc.data
        lt, eq = a < b, a == b
    gt = ~(lt | eq)
    return {"eq": eq, "lt": lt, "le": lt | eq, "gt": gt,
            "ge": gt | eq}[op]


@handles(E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
         E.GreaterThanOrEqual)
def _h_cmp(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    return _normalized(T.BooleanT, _compare(_CMP_OPS[type(e)], lc, rc),
                       _valid_and([lc, rc]))


# ---------------------------------------------------------------------------
# 3-valued logic and null tests
# ---------------------------------------------------------------------------

def _as_bool(c: DeviceColumn) -> torch.Tensor:
    return c.data.to(torch.bool)


@handles(E.And)
def _h_and(e: E.And, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    lt = lc.validity & _as_bool(lc)
    lf = lc.validity & ~_as_bool(lc)
    rt = rc.validity & _as_bool(rc)
    rf = rc.validity & ~_as_bool(rc)
    return _normalized(T.BooleanT, lt & rt, lf | rf | (lt & rt))


@handles(E.Or)
def _h_or(e: E.Or, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    lt = lc.validity & _as_bool(lc)
    rt = rc.validity & _as_bool(rc)
    lf = lc.validity & ~_as_bool(lc)
    rf = rc.validity & ~_as_bool(rc)
    return _normalized(T.BooleanT, lt | rt, lt | rt | (lf & rf))


@handles(E.Not)
def _h_not(e: E.Not, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.child, ctx)
    return _normalized(T.BooleanT, ~_as_bool(c), c.validity)


@handles(E.IsNull)
def _h_isnull(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return DeviceColumn(T.BooleanT, ~c.validity, ctx.ones())


@handles(E.IsNotNull)
def _h_isnotnull(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return DeviceColumn(T.BooleanT, c.validity.clone(), ctx.ones())


# ---------------------------------------------------------------------------
# Casts (numeric and decimal legs)
# ---------------------------------------------------------------------------

@handles(E.Cast)
def _h_cast(e: E.Cast, ctx: Ctx) -> AnyDeviceColumn:
    return cast_device_column(dev_eval(e.child, ctx), e.data_type)


def _java_double_to_long(x: torch.Tensor) -> torch.Tensor:
    """Java (long) of a truncated double: NaN -> 0, saturating."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big = x >= 9.223372036854775807e18
    small = x <= -9.223372036854775808e18
    safe = torch.where(big | small, torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(big, (1 << 63) - 1, out)
    return torch.where(small, -(1 << 63), out)


def cast_device_column(c: AnyDeviceColumn, to: T.DataType
                       ) -> AnyDeviceColumn:
    frm = c.dtype
    if frm == to:
        return c
    if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
        return _cast_decimal(c, to)
    if isinstance(to, T.BooleanType):
        return DeviceColumn(to, c.data != 0, c.validity)
    src = c.data
    dt = torch_dtype(to)
    if src.is_floating_point() and not T.is_floating(to):
        info = torch.iinfo(dt)
        data = _java_double_to_long(torch.trunc(src.to(torch.float64)))
        data = data.clamp(info.min, info.max).to(dt)
    else:
        data = src.to(dt)
    return DeviceColumn(to, data, c.validity)


def _cast_decimal(c: AnyDeviceColumn, to: T.DataType) -> AnyDeviceColumn:
    frm = c.dtype
    if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType):
        hi, lo, ok = D.cast_decimal(torch, *dec_limbs(c), frm, to)
        return limbs_to_devcol(hi, lo, c.validity & ok, to)
    if isinstance(to, T.DecimalType):  # integral/boolean source
        hi, lo = I.from_i64(torch, c.data.to(torch.int64))
        hi, lo, over = D.rescale_up(torch, hi, lo, to.scale)
        ok = ~over & I.fits_precision(torch, hi, lo, to.precision)
        return limbs_to_devcol(hi, lo, c.validity & ok, to)
    hi, lo = dec_limbs(c)
    if T.is_floating(to):
        v64, small = I.to_i64(torch, hi, lo)
        # uint64 -> float64 with one rounding: both halves are exact
        ulo = (I._srl(lo, 32).to(torch.float64) * (2.0 ** 32)
               + (lo & 0xFFFFFFFF).to(torch.float64))
        wide = hi.to(torch.float64) * (2.0 ** 64) + ulo
        data = torch.where(small, v64.to(torch.float64), wide) \
            * (1.0 / 10.0 ** frm.scale)
        return DeviceColumn(to, data.to(torch_dtype(to)), c.validity)
    # integral target: truncate toward zero
    mhi, mlo = I.abs_(torch, hi, lo)
    qh, ql, _r = I.divmod_u128_by_u64(
        torch, mhi, mlo, torch.full_like(hi, 10 ** min(frm.scale, 18)))
    if frm.scale > 18:
        qh, ql, _r = I.divmod_u128_by_u64(
            torch, qh, ql, torch.full_like(hi, 10 ** (frm.scale - 18)))
    neg = I.is_neg(torch, hi, lo)
    nh, nl = I.neg(torch, qh, ql)
    v, fits = I.to_i64(torch, torch.where(neg, nh, qh),
                       torch.where(neg, nl, ql))
    dt = torch_dtype(to)
    info = torch.iinfo(dt)
    validity = c.validity & fits & (v >= info.min) & (v <= info.max)
    return DeviceColumn(to, torch.where(validity, v, 0).to(dt), validity)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def run_project(exprs: Sequence[E.Expression], batch: DeviceBatch
                ) -> List[AnyDeviceColumn]:
    """Evaluate bound expressions over a device batch; padding rows stay
    normalized."""
    ctx = Ctx(batch.columns, batch.capacity, batch.device)
    return [mask_col(dev_eval(e, ctx), batch.active) for e in exprs]


def run_filter(cond: E.Expression, batch: DeviceBatch) -> DeviceBatch:
    """Filter = mask update only; compaction happens at exchanges."""
    ctx = Ctx(batch.columns, batch.capacity, batch.device)
    p = dev_eval(cond, ctx)
    new_active = batch.active & p.validity & _as_bool(p)
    return DeviceBatch(batch.schema, batch.columns, new_active, None)


def _needs_part_ctx(exprs) -> bool:
    """Partition-context expressions carry per-partition state a stage
    program does not thread through."""
    def walk(e):
        if isinstance(e, (E.SparkPartitionID, E.MonotonicallyIncreasingID)):
            return True
        return any(walk(c) for c in e.children)
    return any(walk(e) for e in exprs)


# ---------------------------------------------------------------------------
# Whole-stage fusion: a chain of filter/project steps as ONE program
# (exec/fused.py owns the plan-level pass and runs the program)
# ---------------------------------------------------------------------------

# A step is ("filter", (bound_cond,)) or ("project", (bound_exprs...)).
StageSteps = Tuple[Tuple[str, Tuple[E.Expression, ...]], ...]


def stage_structural_key(steps: StageSteps) -> Tuple:
    """Structural identity of a fused chain (the per-step twin of
    ``expr_key(e, program=True)``)."""
    return tuple((kind, tuple(expr_key(e, program=True) for e in exprs))
                 for kind, exprs in steps)


def stage_literal_values(steps: StageSteps, device: torch.device
                         ) -> Tuple[list, ...]:
    """Per-step literal input tensors, in step order."""
    return tuple(literal_values(list(exprs), device)
                 for _kind, exprs in steps)


def trace_stage_steps(steps: StageSteps, cols, active, lits_per_step,
                      device: torch.device):
    """Run every step of a fused chain over ``(cols, active)``. Returns
    ``(cols, active, counts)``: filters only update the mask (the same
    no-data-movement discipline as ``run_filter``), projects rebuild the
    column list masked to the current active rows (what the unfused
    operators produce, bit for bit), and ``counts`` holds each step's
    output row count as a 0-d device tensor."""
    counts: List[torch.Tensor] = []
    for (kind, exprs), lv in zip(steps, lits_per_step):
        ctx = Ctx(cols, active.shape[0], device, exprs, lv)
        if kind == "filter":
            p = dev_eval(exprs[0], ctx)
            active = active & p.validity & _as_bool(p)
        else:
            cols = [mask_col(dev_eval(e, ctx), active) for e in exprs]
        counts.append(active.sum())
    return cols, active, counts


def build_stage_fn(steps: StageSteps, device: torch.device) -> Callable:
    """Compose a fused chain into one function:
    ``fn(cols, active, lits_per_step) -> (out_cols, out_active,
    counts)``. It makes no host synchronisation, so on a CUDA device it
    can be captured as one graph."""
    steps_t = tuple(steps)

    def fn(cols, active, lits_per_step):
        return trace_stage_steps(steps_t, cols, active, lits_per_step,
                                 device)
    return fn
