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
operators combine child validities. PyTorch runs eagerly, so there is no
compile cache: ``expr_key`` survives only to deduplicate slot sources.
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


def expr_key(e: E.Expression) -> Tuple:
    """Structural identity of an expression (ignores expr_ids and alias
    names); equal keys evaluate to equal columns."""
    parts: List[Any] = [type(e).__name__]
    if isinstance(e, E.BoundReference):
        parts.append(("ord", e.ordinal, repr(e.data_type)))
    elif isinstance(e, E.Literal):
        parts.append(("lit", repr(e.value), repr(e.data_type)))
    elif isinstance(e, E.Cast):
        parts.append(("to", repr(e.data_type), e.ansi))
    elif isinstance(e, E.SortOrder):
        parts.append(("dir", e.ascending, e.nulls_first))
    parts.append(tuple(expr_key(c) for c in e.children))
    return tuple(parts)


class Ctx:
    """Evaluation context: the batch's columns, its capacity and device."""

    def __init__(self, inputs: Sequence[AnyDeviceColumn], capacity: int,
                 device: torch.device):
        self.inputs = list(inputs)
        self.capacity = capacity
        self.device = device

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
    if isinstance(e, E.Literal) or (_foldable(e)
                                    and not isinstance(e, E.Alias)):
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
    if isinstance(e, E.Literal):
        return _literal(e.value, e.data_type, ctx)
    if _foldable(e) and not isinstance(e, E.Alias):
        return _fold(e, ctx)
    h = _HANDLERS.get(type(e))
    if h is None:
        raise NotImplementedError(
            f"expression {type(e).__name__} is not ported yet to "
            "spark_rapids_tpu_torch")
    return h(e, ctx)


def _fold(e: E.Expression, ctx: Ctx) -> AnyDeviceColumn:
    """Evaluate a column-free subtree once with the CPU evaluator."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    hc = e.eval(HostBatch(T.StructType([]), [], 1))
    if not bool(hc.validity[0]):
        return _literal(None, e.data_type, ctx)
    v = hc.data[0]
    if T.is_limb_decimal(e.data_type):
        v = I.to_pyints(hc.data[:1, 0], hc.data[:1, 1])[0]
    return _storage_literal(v, e.data_type, ctx)


def _literal(value, dt: T.DataType, ctx: Ctx) -> AnyDeviceColumn:
    from spark_rapids_tpu_torch.columnar.host import _to_storage
    if value is None:
        return _null_column(dt, ctx)
    return _storage_literal(_to_storage(value, dt), dt, ctx)


def _storage_literal(v, dt: T.DataType, ctx: Ctx) -> AnyDeviceColumn:
    cap, dev = ctx.capacity, ctx.device
    if T.is_limb_decimal(dt):
        hi, lo = I.from_pyints([int(v)])
        return DeviceDecimal128Column(
            dt, torch.full((cap,), int(hi[0]), device=dev),
            torch.full((cap,), int(lo[0]), device=dev), ctx.ones())
    if isinstance(dt, (T.StringType, T.BinaryType)):
        raw = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        cc = bucket_char_cap(max(1, len(raw)))
        row = np.zeros(cc, dtype=np.uint8)
        row[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        chars = torch.from_numpy(row).to(dev).expand(cap, cc)
        return DeviceStringColumn(
            dt, chars, torch.full((cap,), len(raw), dtype=torch.int32,
                                  device=dev), ctx.ones())
    if isinstance(v, np.generic):
        v = v.item()
    return DeviceColumn(dt, torch.full((cap,), v, dtype=torch_dtype(dt),
                                       device=dev), ctx.ones())


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
