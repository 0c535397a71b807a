"""Device expression evaluation on torch tensors (the counterpart of
``spark_rapids_tpu.ops.exprs``).

Every scalar expression the JAX package evaluates on its device runs
here as plain PyTorch ops on the session's device: arithmetic (decimals
under DecimalPrecision), comparisons, three-valued logic, conditionals,
math, strings over the padded byte matrix, dates and times, bitwise ops,
hashes, partition ids and the cast matrix (``ops/cast.py`` holds the
string legs), and over nested columns ``size``, ``element_at``,
``getItem``, ``array_contains``, ``array(...)``, ``struct(...)``,
``getField`` and the tumbling ``window(ts, ...)`` (a struct of start
and end). An array column is a leaf only where one of the collection
handlers reads it (``_ARRAY_ARG_OK``); a struct leaf needs flat fields.
A subtree that references no column (``cast('1998-09-02' as date)``) is
folded once on the host by the CPU expression evaluator and broadcast.

Tagging (``unsupported_reason``) is the twin of the JAX package's
``is_device_expr``: the leaf type check, the decimal128 gate, the
platform gate over the capability probes (``device_caps``), each
expression's extra check, with the JAX package's reason strings word for
word. The rewrite raises ``NotImplementedError`` with the reason: there
is no CPU fallback.

Semantics are the CPU engine's (sql/expressions.py): every column
carries a validity mask; invalid slots hold zeros ("normalized"), and
operators combine child validities. Division and remainder mask a zero
(or, for integers, a -1) divisor before they divide, so nothing traps on
the CPU and nothing reads garbage on the card. A float division is
always by a device tensor: CUDA turns a division by a host scalar into a
multiplication by its reciprocal, which is not the IEEE quotient.

Whole-stage fusion (``exec/fused.py``) runs a chain of filter and
project steps, and an aggregate's update, as one stage program per
batch: ``trace_stage_steps`` and ``build_stage_fn`` compose it, and
``stage_structural_key`` keys it. Every literal, and every column-free
subtree the host folds, is an input tensor of such a program
(``literal_values``), not a constant inside it; so is ``Round``'s
``10**scale`` divisor (``derived_consts``). A CUDA graph captured for
one literal value then serves every other, as one XLA program does in
the JAX package. Numeric literal values are left out of the structural
key (``expr_key(e, program=True)``); string, boolean, 128-bit decimal
and null literals stay in it, and so do the values a handler shapes its
program with (a round scale, a repeat or pad count, a hash seed), as in
the JAX package. Handlers make no host synchronisation and no host to
device copy: their constant tables come from ``cast.const_tensor``.

ANSI casts record their error rows in the context (``Ctx.record_error``);
``run_project`` and ``run_filter`` raise ``ArithmeticError`` after the
batch, as ``_raise_if_errors`` does. A filter or project holding an ANSI
cast is not fused (``exec/fused.py``), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceArrayColumn, DeviceBatch, DeviceColumn,
    DeviceDecimal128Column, DeviceStringColumn, DeviceStructColumn,
    bucket_char_cap, mask_col, take_columns, torch_dtype)
from spark_rapids_tpu_torch.ops import cast as CK
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
    elif isinstance(e, E.Round):
        # the scale shapes the program (trace-time branching)
        parts.append(("scale", e.children[1].value))
    elif isinstance(e, E.Cast):
        parts.append(("to", repr(e.data_type), e.ansi))
    elif isinstance(e, (E.Murmur3Hash, E.XxHash64)):
        parts.append(("seed", e.seed))
    elif isinstance(e, (E.StringRepeat, E.StringLPad, E.StringRPad)):
        # a literal count sets the output's static width
        n = e.children[1]
        parts.append(("n", n.value if isinstance(n, E.Literal) else None))
    elif isinstance(e, E.CaseWhen):
        parts.append(("has_else", e.has_else))
    elif isinstance(e, E.SortOrder):
        parts.append(("dir", e.ascending, e.nulls_first))
    elif isinstance(e, E.TimeWindow):
        parts.append(("window", e.window_us, e.start_us))
    elif isinstance(e, E.GetStructField):
        parts.append(("field", e.ordinal))
    parts.append(tuple(expr_key(c, program) for c in e.children))
    return tuple(parts)


class Ctx:
    """Evaluation context: the batch's columns, its capacity and device;
    for a stage program the tensors of its literal inputs (``lit_vals``,
    in ``collect_literals`` order over ``exprs``); the partition context
    (``part_vals``: partition id and the partition's row count before
    this batch, device scalars) and the active mask for the
    partition-id expressions; and the ANSI error rows."""

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
        self.derived_index: Dict[int, int] = {}
        self.part_vals = None
        self.active_hint: Optional[torch.Tensor] = None
        self.errors: List[Tuple[torch.Tensor, str]] = []
        self._scope: Optional[torch.Tensor] = None
        if lit_vals is not None:
            for i, node in enumerate(collect_literals(exprs)):
                if _is_literal_input(node):
                    self.lit_index[id(node)] = i
                else:
                    self.derived_index[id(node)] = i

    def ones(self) -> torch.Tensor:
        return torch.ones(self.capacity, dtype=torch.bool,
                          device=self.device)

    def zeros(self, dtype=torch.bool) -> torch.Tensor:
        return torch.zeros(self.capacity, dtype=dtype, device=self.device)

    def derived(self, e: E.Expression) -> Optional[Tuple[torch.Tensor, ...]]:
        i = self.derived_index.get(id(e))
        return None if i is None else self.lit_vals[i]

    def record_error(self, row_flags: torch.Tensor, message: str) -> None:
        """An ANSI runtime error on the flagged rows; a conditional
        branch that is not taken masks its rows out (``scoped``)."""
        if self._scope is not None:
            row_flags = row_flags & self._scope
        self.errors.append((row_flags, message))

    @contextlib.contextmanager
    def scoped(self, mask: torch.Tensor):
        """Narrow the ANSI error scope to ``mask`` rows."""
        prev = self._scope
        self._scope = mask if prev is None else (prev & mask)
        try:
            yield
        finally:
            self._scope = prev


_HANDLERS: Dict[type, Callable] = {}


def handles(*expr_types):
    def deco(fn):
        for t in expr_types:
            _HANDLERS[t] = fn
        return fn
    return deco


# Handlers whose program needs host-computed scalars as inputs (Round's
# 10**s divisor) register a producer here.
_DERIVED: Dict[type, Callable[[E.Expression], List[float]]] = {}


def derived_consts(*expr_types):
    def deco(fn):
        for t in expr_types:
            _DERIVED[t] = fn
        return fn
    return deco


def _foldable(e: E.Expression) -> bool:
    """No column reference anywhere below: the value is one constant."""
    if isinstance(e, (E.BoundReference, E.AttributeReference)):
        return False
    if isinstance(e, E.AggregateExpression):
        return False
    if isinstance(e, (E.SparkPartitionID, E.MonotonicallyIncreasingID)):
        return False
    return all(_foldable(c) for c in e.children)


# ---------------------------------------------------------------------------
# Tagging: the twin of the JAX package's is_device_expr
# ---------------------------------------------------------------------------

# Expression classes whose device result performs float division or a
# transcendental, and those doing float arithmetic (platform_gate).
_FLOAT_DIV_LIKE = (E.Divide, E.Sqrt, E.Exp, E.Sin, E.Cos, E.Tan, E.Asin,
                   E.Acos, E.Atan, E.Sinh, E.Cosh, E.Tanh, E.Log, E.Log10,
                   E.Pow, E.Round, E.Log2, E.Log1p, E.Expm1, E.Cbrt,
                   E.Atan2, E.Hypot, E.MonthsBetween)
# UnaryMinus/Abs are excluded: negation and |x| are sign-bit operations.
_FLOAT_ARITH = (E.Add, E.Subtract, E.Multiply, E.Remainder, E.Pmod,
                E.ToDegrees, E.ToRadians, E.Rint)


def platform_gate(e: E.Expression, device=None) -> Optional[str]:
    """Reason when this node's result on ``device`` is not bit-identical
    to the CPU's (None on exact devices: the CPU, an H100)."""
    from spark_rapids_tpu_torch import device_caps as DC
    dt = getattr(e, "data_type", None)
    if dt is None or not T.is_floating(dt):
        return None
    dev = device if device is not None else "cpu"
    if isinstance(e, _FLOAT_DIV_LIKE):
        if not DC.float_div_exact(dev):
            return DC.float_arith_reason("division/transcendental")
        return None
    if isinstance(e, _FLOAT_ARITH):
        needs_f64 = isinstance(dt, T.DoubleType) or isinstance(
            e, (E.Remainder, E.Pmod))
        if needs_f64 and not DC.f64_arith_exact(dev):
            return DC.float_arith_reason("arithmetic")
    return None


_LIMB_OK_EXPRS = (E.Add, E.Subtract, E.Multiply, E.Divide, E.UnaryMinus,
                  E.Abs, E.Cast, E.EqualTo, E.EqualNullSafe, E.LessThan,
                  E.LessThanOrEqual, E.GreaterThan, E.GreaterThanOrEqual,
                  E.IsNull, E.IsNotNull, E.Alias, E.Literal,
                  E.CreateNamedStruct, E.GetStructField)


def _limb_decimal_gate(e: E.Expression) -> Optional[str]:
    """DECIMAL128 limb columns flow only through the expressions with
    limb-aware kernels."""
    if type(e) in _LIMB_OK_EXPRS:
        return None
    for c in e.children:
        dt = getattr(c, "data_type", None)
        if dt is not None and T.is_limb_decimal(dt):
            return (f"{type(e).__name__} over decimal128 columns runs "
                    "on CPU")
    dt = getattr(e, "data_type", None)
    if dt is not None and T.is_limb_decimal(dt):
        return f"{type(e).__name__} producing decimal128 runs on CPU"
    return None


def _incompat_allowed(conf) -> bool:
    if conf is None:
        return False
    from spark_rapids_tpu_torch.conf import INCOMPATIBLE_OPS
    return bool(conf.get(INCOMPATIBLE_OPS))


def _type_support(dt: T.DataType) -> Optional[str]:
    """The JAX package's ``common_tpu`` type signature, with its reason
    strings; structs are refused until nested columns are ported."""
    if isinstance(dt, T.DecimalType):
        if dt.precision > 38:
            return (f"decimal precision {dt.precision} exceeds max "
                    "supported 38")
        return None
    if isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                       T.IntegerType, T.LongType, T.FloatType,
                       T.DoubleType, T.DateType, T.TimestampType,
                       T.StringType, T.BinaryType)):
        return None
    if isinstance(dt, T.NullType):
        return "null is not supported"
    if isinstance(dt, T.ArrayType):
        return "array is not supported"
    if isinstance(dt, T.MapType):
        return "map is not supported"
    if isinstance(dt, T.StructType):
        return "struct is not supported"
    return f"unknown type {dt!r} is not supported"


def leaf_support(e: E.Expression) -> Optional[str]:
    """Type check of an attribute or bound-reference leaf: a struct
    passes as a column of columns when every field is a flat device
    type."""
    dt = e.data_type
    name = getattr(e, "name", repr(e))
    if isinstance(dt, T.StructType):
        for f in dt.fields:
            r = _type_support(f.data_type)
            if r:
                return f"attribute {name}: struct field {f.name}: {r}"
        return None
    r = _type_support(dt)
    if r:
        return f"attribute {name}: {r}"
    return None


# expressions whose listed child ordinals may be ARRAY-typed attribute
# references (the handler reads the element pool itself); arrays are
# otherwise refused as expression leaves
_ARRAY_ARG_OK: Dict[type, Tuple[int, ...]] = {
    E.Size: (0,), E.ElementAt: (0,), E.GetArrayItem: (0,),
    E.ArrayContains: (0,)}
# expressions that read a nested child (the JAX rule table's
# ``common_tpu_nested`` input signatures)
_NESTED_INPUT_OK = (E.Size, E.ElementAt, E.GetArrayItem, E.ArrayContains,
                    E.GetStructField, E.Alias)
# expressions that produce a nested column
_NESTED_OUTPUT_OK = (E.CreateArray, E.CreateNamedStruct, E.TimeWindow,
                     E.Alias)


def _array_leaf_ok(e: E.Expression) -> Optional[str]:
    dt = e.data_type
    if isinstance(dt.element_type, (T.ArrayType, T.MapType, T.StructType)):
        return "nested-of-nested arrays run on CPU"
    r = _type_support(dt.element_type)
    if r:
        return f"array element: {r}"
    return None


# The types a plan node carries (the JAX rule table's signatures):
# ``FLAT`` (common_tpu) for most operators, ``STRUCT`` (common_tpu_struct:
# row-aligned struct columns split, gather and sort as their fields) for
# the exchange, the aggregate and the sort, ``NESTED``
# (common_tpu_nested: arrays too) for project, filter and generate, the
# operators that never move rows apart from their element pools; and
# the nested producers' outputs.
FLAT, STRUCT, NESTED = "flat", "struct", "nested"


def type_reason(dt: T.DataType, sig: str) -> Optional[str]:
    """The JAX ``TypeSig.support`` reason for ``dt`` under ``sig``."""
    if isinstance(dt, T.ArrayType):
        if sig != NESTED:
            return "array is not supported"
        r = type_reason(dt.element_type, sig)
        return f"array element: {r}" if r else None
    if isinstance(dt, T.StructType):
        if sig == FLAT:
            return "struct is not supported"
        for f in dt.fields:
            if isinstance(f.data_type, (T.ArrayType, T.MapType,
                                        T.StructType)):
                return (f"struct field {f.name}: nested types in structs "
                        "are not supported")
            r = type_reason(f.data_type, sig)
            if r:
                return f"struct field {f.name}: {r}"
        return None
    return _type_support(dt)


_EXTRA_CHECKS: Dict[type, Callable] = {}


def extra_check(*expr_types):
    def deco(fn):
        for t in expr_types:
            _EXTRA_CHECKS[t] = fn
        return fn
    return deco


def unsupported_reason(e: E.Expression, conf=None,
                       device=None) -> Optional[str]:
    """None when the whole tree evaluates on ``device``, else the reason
    (the JAX package's ``is_device_expr``, reason for reason)."""
    if isinstance(e, (E.AttributeReference, E.BoundReference)):
        return leaf_support(e)
    if _is_literal_input(e):
        if isinstance(e.data_type, T.NullType):
            return None  # a null leaf takes its parent's type (_eval_as)
        return _dtype_reason(e.data_type)
    if type(e) not in _HANDLERS:
        return f"expression {type(e).__name__} is not supported on TPU"
    r = _limb_decimal_gate(e)
    if r:
        return r
    if not _incompat_allowed(conf):
        r = platform_gate(e, device)
        if r:
            return r
    extra = _EXTRA_CHECKS.get(type(e))
    if extra is not None:
        r = extra(e)
        if r:
            return r
    for i, c in enumerate(e.children):
        if i in _ARRAY_ARG_OK.get(type(e), ()) and \
                isinstance(c, (E.AttributeReference, E.BoundReference)) \
                and isinstance(c.data_type, T.ArrayType):
            r = _array_leaf_ok(c)
        else:
            r = unsupported_reason(c, conf, device)
        if r:
            return r
        cdt = getattr(c, "data_type", None)
        if isinstance(cdt, (T.ArrayType, T.MapType, T.StructType)) and \
                not isinstance(e, _NESTED_INPUT_OK):
            return (f"expression {type(e).__name__}: input "
                    f"{type(c).__name__}: {_type_support(cdt)}")
    dt = e.data_type
    if isinstance(dt, (T.ArrayType, T.StructType)) and \
            isinstance(e, _NESTED_OUTPUT_OK):
        r = type_reason(dt, NESTED)
        return f"expression {type(e).__name__}: output: {r}" if r else None
    return _dtype_reason(dt)


def _dtype_reason(dt: T.DataType) -> Optional[str]:
    if isinstance(dt, (T.ArrayType, T.MapType, T.StructType, T.NullType)):
        return f"output: {_type_support(dt)}"
    return None


def contains_ansi_cast(e: E.Expression) -> bool:
    """Programs without the error channel (sort, join and aggregate
    kernels, fused stages) must not drop ANSI errors: their taggers
    refuse such an expression."""
    return bool(e.collect(lambda x: isinstance(x, E.Cast) and x.ansi))


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
    """Pre-order walk gathering every literal input and every node with
    derived constants; defines the order shared between a stage program
    and its callers."""
    out: List[E.Expression] = []

    def walk(e: E.Expression):
        if _is_literal_input(e):
            out.append(e)
            return
        if type(e) in _DERIVED:
            out.append(e)
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
    """The input tensors of every literal (and derived constant) of
    ``exprs`` on ``device``, in ``collect_literals`` order."""
    out = []
    for node in collect_literals(exprs):
        if _is_literal_input(node):
            out.append(_literal_tensors(_host_literal(node), node.data_type,
                                        device))
        else:
            out.append(tuple(
                torch.full((), float(v), dtype=torch.float64, device=device)
                for v in _DERIVED[type(node)](node)))
    return out


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
    if isinstance(dt, T.NullType):
        return DeviceColumn(dt, off, off)
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


def _scalar(v, dtype: torch.dtype, device) -> torch.Tensor:
    """A 0-d device constant (a fill, not a host-to-device copy)."""
    return torch.full((), v, dtype=dtype, device=device)


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


def _eval_as(e: E.Expression, dt: T.DataType, ctx: Ctx) -> AnyDeviceColumn:
    """``e``'s column; a null literal (NullType) becomes a null column of
    ``dt``, the type the expression around it gives it."""
    if isinstance(e.data_type, T.NullType):
        return _null_column(dt, ctx)
    return dev_eval(e, ctx)


def _binary_cols(e: E.Expression, ctx: Ctx):
    left, right = e.children[0], e.children[1]
    return (_eval_as(left, right.data_type, ctx),
            _eval_as(right, left.data_type, ctx))


def _as_bool(c: DeviceColumn) -> torch.Tensor:
    return c.data.to(torch.bool)


def _f64(c: DeviceColumn) -> torch.Tensor:
    return c.data.to(torch.float64)


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _pad_chars(c: DeviceStringColumn, char_cap: int) -> torch.Tensor:
    if c.char_cap >= char_cap:
        return c.chars
    return torch.nn.functional.pad(c.chars, (0, char_cap - c.char_cap))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-wise take along axis 1 (``idx`` already clamped)."""
    if idx.shape[0] != x.shape[0]:
        idx = idx.expand(x.shape[0], idx.shape[1])
    return torch.gather(x, 1, idx.to(torch.int64))


def _string(chars: torch.Tensor, lengths: torch.Tensor,
            validity: torch.Tensor) -> DeviceStringColumn:
    """A normalized string column: bytes past each length and null rows
    zeroed."""
    pos = _arange(chars.shape[1], chars.device)[None, :]
    keep = (pos < lengths.to(torch.int64)[:, None]) & validity[:, None]
    return DeviceStringColumn(T.StringT, torch.where(keep, chars, 0).to(
        torch.uint8), torch.where(validity, lengths, 0).to(torch.int32),
        validity)


def _empty_strings(validity: torch.Tensor) -> DeviceStringColumn:
    cap = validity.shape[0]
    return DeviceStringColumn(
        T.StringT, torch.zeros((cap, 8), dtype=torch.uint8,
                               device=validity.device),
        torch.zeros(cap, dtype=torch.int32, device=validity.device),
        validity)


def _fdiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


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


@extra_check(E.Add, E.Subtract, E.Multiply, E.UnaryMinus, E.Abs)
def _c_arith(e) -> Optional[str]:
    dt = e.data_type
    if isinstance(dt, T.DecimalType) and isinstance(
            e, (E.Add, E.Subtract, E.Multiply)):
        lt = e.children[0].data_type
        rt = e.children[1].data_type
        if not (isinstance(lt, T.DecimalType)
                and isinstance(rt, T.DecimalType)):
            return "mixed decimal arithmetic operands run on CPU"
        if isinstance(e, E.Multiply):
            if not D.mul_supported(lt, rt):
                return ("decimal multiply beyond the 128-bit envelope "
                        "runs on CPU")
        elif not D.add_sub_supported(lt, rt):
            return ("decimal add/sub with a deep capped rescale runs "
                    "on CPU")
    return None


def _safe_divisor(b: torch.Tensor):
    """``(divisor with 0 and, for integers, -1 replaced by 1, is_zero,
    is_minus_one)``: an integer MIN / -1 traps on the CPU."""
    zero = b == 0
    if b.is_floating_point():
        m1 = torch.zeros_like(zero)
    else:
        m1 = b == -1
    return torch.where(zero | m1, torch.ones_like(b), b), zero, m1


@handles(E.Divide)
def _h_divide(e: E.Divide, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    res = e.data_type
    if isinstance(res, T.DecimalType):
        # div_supported (the _c_divide gate) caps the divisor at 18
        # digits, so it is a plain int64 column here
        d = rc.data.to(torch.int64)
        nonzero = d != 0
        validity = _valid_and([lc, rc]) & nonzero
        ahi, alo = dec_limbs(lc)
        d_safe = torch.where(nonzero, d, 1)
        hi, lo, ok = D.div(torch, ahi, alo, d_safe, lc.dtype, rc.dtype, res)
        return limbs_to_devcol(hi, lo, validity & ok, res)
    out = torch_dtype(res)
    a, b = lc.data.to(out), rc.data.to(out)
    validity = _valid_and([lc, rc]) & (b != 0)
    data = a / torch.where(b != 0, b, torch.ones_like(b))
    return _normalized(res, data.to(out), validity)


@extra_check(E.Divide)
def _c_divide(e) -> Optional[str]:
    if isinstance(e.data_type, T.DecimalType):
        lt = e.children[0].data_type
        rt = e.children[1].data_type
        if not (isinstance(lt, T.DecimalType)
                and isinstance(rt, T.DecimalType)
                and D.div_supported(lt, rt)):
            return ("decimal division beyond the 128-bit envelope "
                    "runs on CPU")
    return None


@handles(E.IntegralDivide)
def _h_intdiv(e: E.IntegralDivide, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    a = lc.data.to(torch.int64)
    b = rc.data.to(torch.int64)
    safe, zero, m1 = _safe_divisor(b)
    validity = _valid_and([lc, rc]) & ~zero
    # truncation toward zero (Java); MIN / -1 wraps to MIN
    data = torch.where(m1, -a, torch.div(a, safe, rounding_mode="trunc"))
    return _normalized(T.LongT, data, validity)


@handles(E.Remainder)
def _h_rem(e: E.Remainder, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    out = torch_dtype(e.data_type)
    a, b = lc.data.to(out), rc.data.to(out)
    safe, zero, m1 = _safe_divisor(b)
    validity = _valid_and([lc, rc]) & ~zero
    # sign follows the dividend (Java %, C fmod)
    data = torch.where(m1, torch.zeros_like(a), torch.fmod(a, safe))
    return _normalized(e.data_type, data, validity)


@handles(E.Pmod)
def _h_pmod(e: E.Pmod, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    out = torch_dtype(e.data_type)
    a, b = lc.data.to(out), rc.data.to(out)
    safe, zero, m1 = _safe_divisor(b)
    # Spark DivModLike: divisor 0 -> null for every numeric type
    validity = _valid_and([lc, rc]) & ~zero
    r = torch.where(m1, torch.zeros_like(a), torch.fmod(a, safe))
    data = torch.where((r != 0) & ((r < 0) != (safe < 0)), r + safe, r)
    return _normalized(e.data_type, data.to(out), validity)


@handles(E.UnaryMinus)
def _h_neg(e: E.UnaryMinus, ctx: Ctx) -> AnyDeviceColumn:
    c = dev_eval(e.child, ctx)
    if T.is_limb_decimal(e.data_type):
        hi, lo = I.neg(torch, *dec_limbs(c))
        return limbs_to_devcol(hi, lo, c.validity, e.data_type)
    return DeviceColumn(e.data_type, -c.data, c.validity)


@handles(E.Abs)
def _h_abs(e: E.Abs, ctx: Ctx) -> AnyDeviceColumn:
    c = dev_eval(e.child, ctx)
    if T.is_limb_decimal(e.data_type):
        hi, lo = I.abs_(torch, *dec_limbs(c))
        return limbs_to_devcol(hi, lo, c.validity, e.data_type)
    return DeviceColumn(e.data_type, torch.abs(c.data), c.validity)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

_CMP_OPS = {
    E.EqualTo: "eq", E.LessThan: "lt", E.LessThanOrEqual: "le",
    E.GreaterThan: "gt", E.GreaterThanOrEqual: "ge",
}


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
    if op == "eq":
        return eq
    if op == "lt":
        return lt
    if op == "le":
        return lt | eq
    gt = ~(lt | eq)
    return gt if op == "gt" else gt | eq


@handles(E.EqualTo, E.LessThan, E.LessThanOrEqual, E.GreaterThan,
         E.GreaterThanOrEqual)
def _h_cmp(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    return _normalized(T.BooleanT, _compare(_CMP_OPS[type(e)], lc, rc),
                       _valid_and([lc, rc]))


@handles(E.EqualNullSafe)
def _h_eqns(e: E.EqualNullSafe, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    both_valid = lc.validity & rc.validity
    both_null = (~lc.validity) & (~rc.validity)
    data = torch.where(both_valid, _compare("eq", lc, rc), both_null)
    return DeviceColumn(T.BooleanT, data, ctx.ones())


# ---------------------------------------------------------------------------
# 3-valued logic, null tests, IN
# ---------------------------------------------------------------------------

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


@handles(E.In)
def _h_in(e: E.In, ctx: Ctx) -> DeviceColumn:
    vc = dev_eval(e.children[0], ctx)
    any_true = ctx.zeros()
    any_null = ctx.zeros()
    for item in e.children[1:]:
        ic = _eval_as(item, vc.dtype, ctx)
        eq = _compare("eq", vc, ic)
        any_true = any_true | (vc.validity & ic.validity & eq)
        any_null = any_null | ~ic.validity
    validity = vc.validity & (any_true | ~any_null)
    return _normalized(T.BooleanT, any_true, validity)


@handles(E.IsNull)
def _h_isnull(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return DeviceColumn(T.BooleanT, ~c.validity, ctx.ones())


@handles(E.IsNotNull)
def _h_isnotnull(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return DeviceColumn(T.BooleanT, c.validity.clone(), ctx.ones())


@handles(E.IsNan)
def _h_isnan(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return DeviceColumn(T.BooleanT, torch.isnan(c.data) & c.validity,
                        ctx.ones())


# ---------------------------------------------------------------------------
# Conditionals
# ---------------------------------------------------------------------------

def _select(dt: T.DataType, cond: torch.Tensor, tc: AnyDeviceColumn,
            fc: AnyDeviceColumn) -> AnyDeviceColumn:
    validity = torch.where(cond, tc.validity, fc.validity)
    if isinstance(tc, DeviceStringColumn):
        cap = max(tc.char_cap, fc.char_cap)
        chars = torch.where(cond[:, None], _pad_chars(tc, cap),
                            _pad_chars(fc, cap))
        lengths = torch.where(cond, tc.lengths, fc.lengths)
        lengths = torch.where(validity, lengths, 0)
        chars = torch.where(validity[:, None], chars, 0)
        return DeviceStringColumn(dt, chars, lengths, validity)
    if isinstance(tc, DeviceDecimal128Column) or \
            isinstance(fc, DeviceDecimal128Column):
        thi, tlo = dec_limbs(tc)
        fhi, flo = dec_limbs(fc)
        return limbs_to_devcol(torch.where(cond, thi, fhi),
                               torch.where(cond, tlo, flo), validity, dt)
    data = torch.where(cond, tc.data, fc.data.to(tc.data.dtype))
    return _normalized(dt, data, validity)


@handles(E.If)
def _h_if(e: E.If, ctx: Ctx) -> AnyDeviceColumn:
    p = dev_eval(e.children[0], ctx)
    cond = p.validity & _as_bool(p)
    # ANSI errors only fire on the taken arm (Spark's lazy branches)
    dt = e.data_type
    with ctx.scoped(cond):
        tv = _eval_as(e.children[1], dt, ctx)
    with ctx.scoped(~cond):
        fv = _eval_as(e.children[2], dt, ctx)
    return _select(dt, cond, tv, fv)


@handles(E.CaseWhen)
def _h_case(e: E.CaseWhen, ctx: Ctx) -> AnyDeviceColumn:
    pairs = e.children[:-1] if e.has_else else e.children
    # first match wins, left to right; ANSI errors scoped to the rows
    # whose branch is taken
    prior = ctx.zeros()
    entries = []
    for i in range(0, len(pairs) - 1, 2):
        with ctx.scoped(~prior):
            p = dev_eval(pairs[i], ctx)
        cond = p.validity & _as_bool(p)
        take = cond & ~prior
        with ctx.scoped(take):
            v = _eval_as(pairs[i + 1], e.data_type, ctx)
        entries.append((take, v))
        prior = prior | cond
    if e.has_else:
        with ctx.scoped(~prior):
            acc = _eval_as(e.children[-1], e.data_type, ctx)
    else:
        acc = _null_column(e.data_type, ctx)
    for take, v in reversed(entries):
        acc = _select(e.data_type, take, v, acc)
    return acc


@handles(E.Coalesce)
def _h_coalesce(e: E.Coalesce, ctx: Ctx) -> AnyDeviceColumn:
    # later arguments evaluate (ANSI-error-wise) only where every
    # earlier one was null
    acc = _eval_as(e.children[0], e.data_type, ctx)
    for child in e.children[1:]:
        with ctx.scoped(~acc.validity):
            c = _eval_as(child, e.data_type, ctx)
        acc = _select(e.data_type, acc.validity, acc, c)
    return acc


# ---------------------------------------------------------------------------
# Math
# ---------------------------------------------------------------------------

def _signum(x: torch.Tensor) -> torch.Tensor:
    """Java Math.signum: keeps +-0.0 and NaN."""
    return torch.where((x == 0.0) | torch.isnan(x), x, torch.sign(x))


_HALF_E = math.e / 2.0


def _sinh(x: torch.Tensor) -> torch.Tensor:
    """sinh that stays finite up to its true overflow (|x| ~ 710.48):
    beyond |x| = 20 it is exp(|x| - 1) * e/2 with the sign (|x| - 1 is
    exact), where a vectorised libm that computes exp(x) / 2 overflows
    from |x| ~ 709.8 on (the CPU's does, CUDA's does not)."""
    ax = torch.abs(x)
    return torch.where(ax > 20.0,
                       torch.sign(x) * (torch.exp(ax - 1.0) * _HALF_E),
                       torch.sinh(x))


def _cosh(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax > 20.0, torch.exp(ax - 1.0) * _HALF_E,
                       torch.cosh(x))


_MATH_FNS = {
    E.Sqrt: torch.sqrt, E.Exp: torch.exp, E.Sin: torch.sin,
    E.Cos: torch.cos, E.Tan: torch.tan, E.Asin: torch.asin,
    E.Acos: torch.acos, E.Atan: torch.atan, E.Sinh: _sinh,
    E.Cosh: _cosh, E.Tanh: torch.tanh, E.Signum: _signum,
}


@handles(E.Sqrt, E.Exp, E.Sin, E.Cos, E.Tan, E.Asin, E.Acos, E.Atan,
         E.Sinh, E.Cosh, E.Tanh, E.Signum)
def _h_math(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return _normalized(T.DoubleT, _MATH_FNS[type(e)](_f64(c)), c.validity)


def _log_like(fn, lower: float):
    def h(e, ctx: Ctx) -> DeviceColumn:
        c = dev_eval(e.children[0], ctx)
        x = _f64(c)
        ok = x > lower
        data = fn(torch.where(ok, x, lower + 1.0))
        return _normalized(T.DoubleT, data, c.validity & ok)
    return h


handles(E.Log)(_log_like(torch.log, 0.0))
handles(E.Log10)(_log_like(torch.log10, 0.0))
handles(E.Log2)(_log_like(torch.log2, 0.0))
handles(E.Log1p)(_log_like(torch.log1p, -1.0))


def _java_double_to_long(x: torch.Tensor) -> torch.Tensor:
    """Java (long) of a truncated double: NaN -> 0, saturating.
    Threshold compares, not clamp-then-cast: float(Long.MAX) rounds up
    to 2**63 and the cast would wrap."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    big = x >= 9.223372036854775807e18
    small = x <= -9.223372036854775808e18
    safe = torch.where(big | small, torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(big, (1 << 63) - 1, out)
    return torch.where(small, -(1 << 63), out)


@handles(E.Floor)
def _h_floor(e: E.Floor, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return _normalized(T.LongT, _java_double_to_long(torch.floor(_f64(c))),
                       c.validity)


@handles(E.Ceil)
def _h_ceil(e: E.Ceil, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return _normalized(T.LongT, _java_double_to_long(torch.ceil(_f64(c))),
                       c.validity)


@handles(E.Pow)
def _h_pow(e: E.Pow, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    return _normalized(T.DoubleT, torch.pow(_f64(lc), _f64(rc)),
                       _valid_and([lc, rc]))


@derived_consts(E.Round)
def _d_round(e: E.Round) -> List[float]:
    s = int(e.children[1].value)
    # the divisor is a program input: a division by a constant would
    # become a multiplication by its reciprocal on the card
    return [10.0 ** s] if s != 0 else []


@handles(E.Round)
def _h_round(e: E.Round, ctx: Ctx) -> DeviceColumn:
    """HALF_UP rounding (not torch's half-to-even)."""
    c = dev_eval(e.children[0], ctx)
    s = int(e.children[1].value)
    x = c.data
    if not x.is_floating_point():
        if s >= 0:
            data = x
        else:
            p = 10 ** (-s)
            xi = x.to(torch.int64)
            q = _fdiv(torch.abs(xi) + p // 2, p) * p
            data = (q * torch.sign(xi)).to(x.dtype)
        return _normalized(e.data_type, data, c.validity)

    def _sign(v):  # -0.0 folds to 0.0, as BigDecimal does
        return torch.where(v == 0.0, torch.zeros_like(v), torch.sign(v))
    xf = x.to(torch.float64)
    if s == 0:
        data = _sign(xf) * torch.floor(torch.abs(xf) + 0.5)
    else:
        got = ctx.derived(e)
        p = got[0] if got else _scalar(10.0 ** s, torch.float64, ctx.device)
        scaled = xf * p
        data = _sign(scaled) * torch.floor(torch.abs(scaled) + 0.5) / p
    return _normalized(e.data_type, data.to(x.dtype), c.validity)


@handles(E.Expm1, E.Cbrt, E.Rint, E.ToDegrees, E.ToRadians)
def _h_math2(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    x = _f64(c)
    if isinstance(e, E.Expm1):
        data = torch.expm1(x)
    elif isinstance(e, E.Cbrt):
        data = torch.where(x == 0.0, x, torch.sign(x) * torch.pow(
            torch.abs(x), 1.0 / 3.0))  # keeps -0.0
    elif isinstance(e, E.Rint):
        data = torch.round(x)  # half to even, as rint
    elif isinstance(e, E.ToDegrees):
        data = x * (180.0 / math.pi)
    else:
        data = x * (math.pi / 180.0)
    return _normalized(T.DoubleT, data, c.validity)


@handles(E.Atan2, E.Hypot)
def _h_binmath(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    fn = torch.atan2 if isinstance(e, E.Atan2) else torch.hypot
    return _normalized(T.DoubleT, fn(_f64(lc), _f64(rc)),
                       _valid_and([lc, rc]))


# ---------------------------------------------------------------------------
# Bitwise and shifts
# ---------------------------------------------------------------------------

@handles(E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor)
def _h_bitwise(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    dt = torch_dtype(e.data_type)
    a, b = lc.data.to(dt), rc.data.to(dt)
    if isinstance(e, E.BitwiseAnd):
        data = a & b
    elif isinstance(e, E.BitwiseOr):
        data = a | b
    else:
        data = a ^ b
    return _normalized(e.data_type, data, _valid_and([lc, rc]))


@handles(E.BitwiseNot)
def _h_bitwise_not(e: E.BitwiseNot, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    return _normalized(e.data_type, ~c.data, c.validity)


@handles(E.ShiftLeft, E.ShiftRight, E.ShiftRightUnsigned)
def _h_shift(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    is_long = isinstance(e.data_type, T.LongType)
    bits = 64 if is_long else 32
    dt = torch_dtype(e.data_type)
    a = lc.data.to(dt)
    n = rc.data.to(torch.int64) & (bits - 1)
    if isinstance(e, E.ShiftLeft):
        data = a << n.to(dt)
    elif isinstance(e, E.ShiftRight):
        data = a >> n.to(dt)  # arithmetic on signed values, like Java
    elif is_long:
        data = I._srl_var(torch, a, n)
    else:
        data = ((a.to(torch.int64) & 0xFFFFFFFF) >> n).to(torch.int64)
        data = torch.where(data >= (1 << 31), data - (1 << 32),
                           data).to(dt)
    return _normalized(e.data_type, data, _valid_and([lc, rc]))


@extra_check(E.Greatest, E.Least)
def _c_greatest_least(e):
    if isinstance(e.data_type, (T.StringType, T.BinaryType)):
        return "greatest/least over strings runs on CPU"
    return None


@handles(E.Greatest, E.Least)
def _h_greatest_least(e, ctx: Ctx) -> AnyDeviceColumn:
    """Null-skipping row-wise extreme; NaN ranks greatest (Spark)."""
    cols = [_eval_as(c, e.data_type, ctx) for c in e.children]
    is_min = isinstance(e, E.Least)
    dt = torch_dtype(e.data_type)
    data = cols[0].data.to(dt)
    have = cols[0].validity
    validity = cols[0].validity
    for c in cols[1:]:
        d = c.data.to(dt)
        if dt.is_floating_point:
            if is_min:
                better = (~torch.isnan(d)) & ((d < data) | torch.isnan(data))
            else:
                better = torch.isnan(d) | (d > data)
        else:
            better = (d < data) if is_min else (d > data)
        take = c.validity & (~have | better)
        data = torch.where(take, d, data)
        have = have | c.validity
        validity = validity | c.validity
    return _normalized(e.data_type, data, validity)


# ---------------------------------------------------------------------------
# Strings (byte-matrix kernels; the ASCII-only ones are tagged incompat by
# the rewrite's rule table)
# ---------------------------------------------------------------------------

def _lit_int(e: E.Expression) -> Optional[int]:
    if isinstance(e, E.Literal) and e.value is not None and \
            not isinstance(e.data_type, (T.StringType, T.BinaryType)):
        return int(e.value)
    return None


def _lit_str(e: E.Expression) -> Optional[str]:
    if isinstance(e, E.Literal) and isinstance(e.data_type, T.StringType) \
            and e.value is not None:
        return str(e.value)
    return None


@handles(E.Length)
def _h_length(e: E.Length, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    if isinstance(c.dtype, T.BinaryType):
        return _normalized(T.IntegerT, c.lengths.to(torch.int32), c.validity)
    # characters = bytes that are not UTF-8 continuation bytes
    in_range = _arange(c.char_cap, ctx.device)[None, :] < \
        c.lengths.to(torch.int64)[:, None]
    not_cont = (c.chars & 0xC0) != 0x80
    data = (in_range & not_cont).sum(dim=1).to(torch.int32)
    return _normalized(T.IntegerT, data, c.validity)


@handles(E.Upper, E.Lower)
def _h_case_conv(e, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    if isinstance(e, E.Upper):
        shift = (c.chars >= 97) & (c.chars <= 122)
        chars = torch.where(shift, c.chars - 32, c.chars)
    else:
        shift = (c.chars >= 65) & (c.chars <= 90)
        chars = torch.where(shift, c.chars + 32, c.chars)
    return DeviceStringColumn(T.StringT, chars, c.lengths, c.validity)


def _lead_trail(c: DeviceStringColumn):
    """(in_str, number of leading spaces, number of trailing spaces)."""
    cap = max(c.char_cap, 1)
    pos = _arange(cap, c.chars.device)[None, :]
    ln = c.lengths.to(torch.int64)
    in_str = pos < ln[:, None]
    is_space = (c.chars == 32) & in_str
    lead = torch.cumprod(torch.where(in_str, is_space, True).to(torch.int32),
                         dim=1) != 0
    n_lead = (lead & in_str).sum(dim=1)
    rev_idx = (ln[:, None] - 1 - pos).clamp(0, cap - 1)
    rev_space = _gather(is_space, rev_idx)
    trail = torch.cumprod(torch.where(in_str, rev_space, True).to(
        torch.int32), dim=1) != 0
    n_trail = (trail & in_str).sum(dim=1)
    return pos, ln, n_lead, n_trail


@handles(E.StringTrim)
def _h_trim(e: E.StringTrim, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    cap = c.char_cap
    pos, ln, n_lead, n_trail = _lead_trail(c)
    n_trail = torch.where(n_lead >= ln, 0, n_trail)
    new_len = torch.clamp(ln - n_lead - n_trail, min=0)
    chars = _gather(c.chars, (pos + n_lead[:, None]).clamp(0, cap - 1))
    return _string(chars, new_len, c.validity)


@handles(E.StringTrimLeft, E.StringTrimRight)
def _h_trim_side(e, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    cap = max(c.char_cap, 1)
    pos, ln, n_lead, n_trail = _lead_trail(c)
    if isinstance(e, E.StringTrimLeft):
        chars = _gather(c.chars, (pos + n_lead[:, None]).clamp(0, cap - 1))
        return _string(chars, ln - n_lead, c.validity)
    return _string(c.chars, ln - n_trail, c.validity)


def _concat_pieces(pieces, cap: int, out_cap: int, device):
    """Lay ``(col, live)`` pieces end to end per row: ``(chars, total
    length)``; a piece adds nothing where ``live`` is False."""
    pos = _arange(out_cap, device)[None, :]
    out = torch.zeros((cap, out_cap), dtype=torch.uint8, device=device)
    off = torch.zeros(cap, dtype=torch.int64, device=device)
    for c, live in pieces:
        ln = torch.where(live, c.lengths.to(torch.int64), 0)
        rel = pos - off[:, None]
        inside = (rel >= 0) & (rel < ln[:, None])
        cc = max(c.char_cap, 1)
        piece = _gather(_pad_chars(c, cc), rel.clamp(0, cc - 1))
        out = torch.where(inside, piece, out)
        off = off + ln
    return out, off


@handles(E.ConcatStr)
def _h_concat(e: E.ConcatStr, ctx: Ctx) -> DeviceStringColumn:
    cols = [dev_eval(c, ctx) for c in e.children]
    validity = _valid_and(cols)
    out_cap = bucket_char_cap(sum(c.char_cap for c in cols))
    chars, lengths = _concat_pieces([(c, ctx.ones()) for c in cols],
                                    ctx.capacity, out_cap, ctx.device)
    return _string(chars, lengths, validity)


@handles(E.ConcatWs)
def _h_concat_ws(e: E.ConcatWs, ctx: Ctx) -> DeviceStringColumn:
    """Null arguments are skipped; the separator goes between every pair
    of kept arguments; null only when the separator is null."""
    cols = [dev_eval(c, ctx) for c in e.children]
    sep, args = cols[0], cols[1:]
    total = sum(c.char_cap for c in args) + \
        sep.char_cap * max(0, len(args) - 1)
    out_cap = bucket_char_cap(max(8, total))
    pieces = []
    any_prev = ctx.zeros()
    for c in args:
        pieces.append((sep, c.validity & any_prev))
        pieces.append((c, c.validity))
        any_prev = any_prev | c.validity
    chars, lengths = _concat_pieces(pieces, ctx.capacity, out_cap,
                                    ctx.device)
    return _string(chars, lengths, sep.validity)


@handles(E.Substring)
def _h_substring(e: E.Substring, ctx: Ctx) -> DeviceStringColumn:
    """Byte-positioned substring (exact for ASCII; tagged incompat)."""
    c = dev_eval(e.children[0], ctx)
    p = dev_eval(e.children[1], ctx)
    ln = dev_eval(e.children[2], ctx)
    validity = _valid_and([c, p, ln])
    pos = p.data.to(torch.int64)
    length = ln.data.to(torch.int64)
    slen = c.lengths.to(torch.int64)
    start = torch.where(pos > 0, pos - 1,
                        torch.where(pos == 0, 0,
                                    torch.clamp(slen + pos, min=0)))
    neg_clip = torch.where((pos < 0) & (slen + pos < 0), slen + pos, 0)
    eff_len = torch.clamp(length + neg_clip, min=0)
    eff_len = torch.where(length <= 0, 0, eff_len)
    new_len = torch.clamp(torch.minimum(eff_len, slen - start), min=0)
    cap = c.char_cap
    idx = (start[:, None] + _arange(cap, ctx.device)[None, :]).clamp(
        0, cap - 1)
    return _string(_gather(c.chars, idx), new_len, validity)


def _sliding_match(s: DeviceStringColumn, pat: DeviceStringColumn,
                   at: torch.Tensor) -> torch.Tensor:
    """True where pat matches s starting at byte offset ``at``."""
    cap = max(s.char_cap, pat.char_cap)
    sc, pc = _pad_chars(s, cap), _pad_chars(pat, cap)
    idx = (at[:, None] + _arange(cap, sc.device)[None, :]).clamp(0, cap - 1)
    window = _gather(sc, idx)
    in_pat = _arange(cap, sc.device)[None, :] < \
        pat.lengths.to(torch.int64)[:, None]
    eq = torch.where(in_pat, window == pc, True).all(dim=1)
    return eq & (at >= 0) & (at + pat.lengths <= s.lengths)


@handles(E.StartsWith)
def _h_startswith(e: E.StartsWith, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    data = _sliding_match(lc, rc, ctx.zeros(torch.int64))
    return _normalized(T.BooleanT, data, _valid_and([lc, rc]))


@handles(E.EndsWith)
def _h_endswith(e: E.EndsWith, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    data = _sliding_match(lc, rc, (lc.lengths - rc.lengths).to(torch.int64))
    return _normalized(T.BooleanT, data, _valid_and([lc, rc]))


def _first_match_at_or_after(s: DeviceStringColumn, pat: DeviceStringColumn,
                             start: torch.Tensor) -> torch.Tensor:
    """Per-row first byte offset >= start where pat occurs in s, or -1:
    one windowed compare (rows, start position, pattern byte)."""
    dev = s.chars.device
    scap = max(s.char_cap, 1)
    pcap = max(pat.char_cap, 1)
    sc, pc = _pad_chars(s, scap), _pad_chars(pat, pcap)
    spos = _arange(scap, dev)
    ppos = _arange(pcap, dev)
    idx = (spos[:, None] + ppos[None, :]).clamp(0, scap - 1).reshape(-1)
    win = sc[:, idx].reshape(sc.shape[0], scap, pcap)
    plen = pat.lengths.to(torch.int64)
    slen = s.lengths.to(torch.int64)
    in_pat = ppos[None, None, :] < plen[:, None, None]
    eq = torch.where(in_pat, win == pc[:, None, :], True).all(dim=2)
    ok_start = (spos[None, :] >= start[:, None]) & \
        (spos[None, :] + plen[:, None] <= slen[:, None])
    hit = eq & ok_start
    best = torch.where(hit.any(dim=1), hit.to(torch.int8).argmax(dim=1), -1)
    # the empty pattern matches at ``start`` when start <= len(s)
    empty_hit = (plen == 0) & (start <= slen)
    return torch.where(empty_hit, start, best)


@handles(E.Contains)
def _h_contains(e: E.Contains, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    found = _first_match_at_or_after(lc, rc, ctx.zeros(torch.int64)) >= 0
    return _normalized(T.BooleanT, found, _valid_and([lc, rc]))


@handles(E.StringInstr)
def _h_instr(e: E.StringInstr, ctx: Ctx) -> DeviceColumn:
    sc, pc = _binary_cols(e, ctx)
    found = _first_match_at_or_after(sc, pc, ctx.zeros(torch.int64))
    return _normalized(T.IntegerT, (found + 1).to(torch.int32),
                       _valid_and([sc, pc]))


@handles(E.StringLocate)
def _h_locate(e: E.StringLocate, ctx: Ctx) -> DeviceColumn:
    pc = dev_eval(e.children[0], ctx)
    sc = dev_eval(e.children[1], ctx)
    posc = dev_eval(e.children[2], ctx)
    validity = _valid_and([pc, sc, posc])
    p = posc.data.to(torch.int64)
    found = _first_match_at_or_after(sc, pc, torch.clamp(p - 1, min=0))
    res = torch.where(p < 1, 0, found + 1).to(torch.int32)
    return _normalized(T.IntegerT, res, validity)


def _like_chunks(pattern: str) -> List[bytes]:
    """LIKE pattern -> literal byte chunks split at ``%`` (escape ``\\``).
    The gate rejects ``_`` before this runs."""
    chunks: List[bytes] = []
    cur: List[str] = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            cur.append(pattern[i + 1])
            i += 2
            continue
        if ch == "%":
            chunks.append("".join(cur).encode("utf-8"))
            cur = []
        else:
            cur.append(ch)
        i += 1
    chunks.append("".join(cur).encode("utf-8"))
    return chunks


@extra_check(E.Like)
def _c_like(e: E.Like):
    r = e.children[1]
    if not isinstance(r, E.Literal) \
            or not isinstance(r.data_type, T.StringType) \
            or r.value is None:
        return "LIKE with a non-literal pattern runs on CPU"
    i, s = 0, r.value
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s):
            i += 2
            continue
        if s[i] == "_":
            return ("LIKE patterns with _ run on CPU (byte-level "
                    "matching cannot honor per-character semantics for "
                    "multi-byte UTF-8 data)")
        i += 1
    return None


def _match_chunk_at(lc: DeviceStringColumn, seg: bytes,
                    at: torch.Tensor) -> torch.Tensor:
    """True where ``seg`` occurs in lc at per-row byte offset ``at``."""
    m = len(seg)
    cc = lc.char_cap
    ok = (at >= 0) & (at + m <= lc.lengths)
    for k, byte in enumerate(seg):
        b = _gather(lc.chars, (at + k).clamp(0, cc - 1)[:, None])[:, 0]
        ok = ok & (b == byte)
    return ok


def _earliest_chunk(lc: DeviceStringColumn, seg: bytes, pos: torch.Tensor,
                    n: torch.Tensor) -> torch.Tensor:
    """Earliest offset >= pos where ``seg`` occurs (fully inside the
    string), or -1: greedy, like the regex ``.*``."""
    m = len(seg)
    cap = lc.capacity
    n_off = max(lc.char_cap - m + 1, 0)
    if n_off == 0:
        return torch.full((cap,), -1, dtype=torch.int64,
                          device=lc.chars.device)
    # windows (rows, offset, m) as a view of the byte matrix
    windows = lc.chars.unfold(1, m, 1)
    seg_t = CK.const_tensor(seg, torch.uint8, lc.chars.device)
    match = (windows == seg_t).all(dim=2)
    offs = _arange(n_off, lc.chars.device)
    eligible = match & (offs[None, :] >= pos[:, None]) \
        & (offs[None, :] + m <= n[:, None])
    return torch.where(eligible.any(dim=1),
                       eligible.to(torch.int8).argmax(dim=1), -1)


@handles(E.Like)
def _h_like(e: E.Like, ctx: Ctx) -> DeviceColumn:
    """SQL LIKE with a literal %-pattern as anchored prefix and suffix
    compares plus greedy in-order chunk searches (the JAX package's
    program); patterns with ``_`` are refused at tagging."""
    lc = dev_eval(e.children[0], ctx)
    chunks = _like_chunks(e.children[1].value)
    n = lc.lengths.to(torch.int64)
    zero = ctx.zeros(torch.int64)
    if len(chunks) == 1:  # no %: exact match
        seg = chunks[0]
        ok = ((n == len(seg)) & _match_chunk_at(lc, seg, zero)) if seg \
            else (n == 0)
        return _normalized(T.BooleanT, ok, lc.validity)
    first, *mid, last = chunks
    ok = ctx.ones()
    pos = zero
    if first:
        ok = ok & _match_chunk_at(lc, first, zero)
        pos = zero + len(first)
    for seg in mid:
        if not seg:
            continue
        found = _earliest_chunk(lc, seg, pos, n)
        ok = ok & (found >= 0)
        pos = torch.where(found >= 0, found + len(seg), pos)
    if last:
        off = n - len(last)
        ok = ok & (off >= pos) & _match_chunk_at(lc, last, off)
    return _normalized(T.BooleanT, ok, lc.validity)


@extra_check(E.StringRepeat)
def _c_repeat(e: E.StringRepeat):
    if _lit_int(e.children[1]) is None:
        return "repeat count must be a literal on device (static width)"
    return None


@handles(E.StringRepeat)
def _h_repeat(e: E.StringRepeat, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    nc = dev_eval(e.children[1], ctx)
    times = max(0, _lit_int(e.children[1]))
    validity = _valid_and([c, nc])
    if times == 0 or c.char_cap == 0:
        return _empty_strings(validity)
    out_cap = bucket_char_cap(c.char_cap * times)
    pos = _arange(out_cap, ctx.device)[None, :]
    slen = torch.clamp(c.lengths.to(torch.int64), min=1)[:, None]
    src = torch.remainder(pos, slen).clamp(0, c.char_cap - 1)
    chars = _gather(_pad_chars(c, out_cap), src)
    return _string(chars, c.lengths.to(torch.int64) * times, validity)


@extra_check(E.StringLPad, E.StringRPad)
def _c_pad(e):
    if _lit_int(e.children[1]) is None or _lit_str(e.children[2]) is None:
        return "lpad/rpad length and pad must be literals on device"
    return None


@handles(E.StringLPad, E.StringRPad)
def _h_pad(e, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    ln = dev_eval(e.children[1], ctx)
    pc = dev_eval(e.children[2], ctx)
    n = _lit_int(e.children[1])
    pad = _lit_str(e.children[2]).encode("utf-8")
    validity = _valid_and([c, ln, pc])
    if n <= 0:
        return _empty_strings(validity)
    out_cap = bucket_char_cap(max(n, c.char_cap))
    slen = c.lengths.to(torch.int64)
    sc = _pad_chars(c, out_cap)
    if not pad:
        return _string(sc, torch.clamp(slen, max=n), validity)
    fill_len = torch.clamp(n - slen, min=0)
    new_len = torch.where(slen >= n, n, slen + fill_len)
    pos = _arange(out_cap, ctx.device)[None, :]
    pad_arr = CK.const_tensor(
        (pad * (n // len(pad) + 1))[:n], torch.uint8, ctx.device)
    if e.left_side:
        # the first fill_len positions from the pad, then the string
        from_pad = pos < fill_len[:, None]
        pad_idx = pos.clamp(0, n - 1).expand(ctx.capacity, out_cap)
        str_idx = (pos - fill_len[:, None]).clamp(0, out_cap - 1)
    else:
        from_pad = (pos >= slen[:, None]) & (pos < new_len[:, None])
        pad_idx = (pos - slen[:, None]).clamp(0, n - 1)
        str_idx = pos.clamp(0, out_cap - 1).expand(ctx.capacity, out_cap)
    chars = torch.where(from_pad, pad_arr[pad_idx], _gather(sc, str_idx))
    return _string(chars, new_len, validity)


@extra_check(E.StringTranslate)
def _c_translate(e: E.StringTranslate):
    m, r = _lit_str(e.children[1]), _lit_str(e.children[2])
    if m is None or r is None:
        return "translate match/replace must be literals on device"
    if any(ord(ch) > 127 for ch in m + r):
        return "non-ASCII translate runs on CPU (byte-level mapping)"
    return None


def _compact_kept(values: torch.Tensor, keep: torch.Tensor):
    """Move each row's kept slots to its front, in order (a stable sort on
    the dropped flag): ``(values, kept count)``."""
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.gather(values, 1, order), keep.sum(dim=1)


@handles(E.StringTranslate)
def _h_translate(e: E.StringTranslate, ctx: Ctx) -> DeviceStringColumn:
    """ASCII translate through a 256-entry table; deleted bytes compact
    out."""
    c = dev_eval(e.children[0], ctx)
    _m = dev_eval(e.children[1], ctx)
    _r = dev_eval(e.children[2], ctx)
    m, r = _lit_str(e.children[1]), _lit_str(e.children[2])
    table = list(range(256))
    delete = [0] * 256
    seen = set()
    for j, ch in enumerate(m):
        if ch in seen:
            continue
        seen.add(ch)
        if j < len(r):
            table[ord(ch)] = ord(r[j])
        else:
            delete[ord(ch)] = 1
    validity = _valid_and([c, _m, _r])
    idx = c.chars.to(torch.int64)
    mapped = CK.const_tensor(table, torch.uint8, ctx.device)[idx]
    deleted = CK.const_tensor(delete, torch.bool, ctx.device)[idx]
    in_str = _arange(c.char_cap, ctx.device)[None, :] < \
        c.lengths.to(torch.int64)[:, None]
    chars, new_len = _compact_kept(mapped, in_str & ~deleted)
    return _string(chars, new_len, validity)


@extra_check(E.StringReplace)
def _c_replace(e: E.StringReplace):
    if _lit_str(e.children[1]) is None or _lit_str(e.children[2]) is None:
        return "replace search/replacement must be literals on device"
    return None


@handles(E.StringReplace)
def _h_replace(e: E.StringReplace, ctx: Ctx) -> DeviceStringColumn:
    """Literal search/replace: greedy non-overlapping matches left to
    right, then each input byte expands into max(1, len(repl)) output
    slots (its replacement at a match start, itself when kept, gaps when
    covered) and the gaps compact out."""
    c = dev_eval(e.children[0], ctx)
    _s = dev_eval(e.children[1], ctx)
    _r = dev_eval(e.children[2], ctx)
    search = _lit_str(e.children[1]).encode("utf-8")
    repl = _lit_str(e.children[2]).encode("utf-8")
    validity = _valid_and([c, _s, _r])
    slen, rlen = len(search), len(repl)
    if slen == 0 or c.char_cap == 0:
        return DeviceStringColumn(T.StringT, c.chars, c.lengths, validity)
    cap = c.char_cap
    rows = ctx.capacity
    ln = c.lengths.to(torch.int64)
    pos = _arange(cap, ctx.device)[None, :]
    padded = _pad_chars(c, cap + slen)
    match = pos + slen <= ln[:, None]
    for k in range(slen):
        match = match & (padded[:, k:k + cap] == search[k])
    # greedy scan: a match is taken where the previous taken one ended
    taken_cols = []
    since = torch.full((rows,), slen, dtype=torch.int64, device=ctx.device)
    for j in range(cap):
        take = match[:, j] & (since >= slen)
        taken_cols.append(take)
        since = torch.where(take, 1, since + 1)
    taken = torch.stack(taken_cols, dim=1)
    covered = torch.zeros_like(taken)
    for k in range(slen):
        covered[:, k:] |= taken[:, :cap - k]
    in_str = pos < ln[:, None]
    emit = max(1, rlen)
    keep_b = in_str & ~covered
    slots = [torch.where(keep_b, c.chars.to(torch.int32), -1)]
    slots += [torch.full((rows, cap), -1, dtype=torch.int32,
                         device=ctx.device) for _ in range(emit - 1)]
    for j in range(rlen):
        slots[j] = torch.where(taken, repl[j], slots[j])
    flat = torch.stack(slots, dim=2).reshape(rows, cap * emit)
    chars, new_len = _compact_kept(flat, flat >= 0)
    out_cap = bucket_char_cap(cap * emit)
    chars = torch.clamp(chars, min=0)
    if chars.shape[1] < out_cap:
        chars = torch.nn.functional.pad(chars, (0, out_cap - chars.shape[1]))
    return _string(chars, new_len, validity)


@handles(E.InitCap)
def _h_initcap(e: E.InitCap, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    prev = torch.cat([torch.full((ctx.capacity, 1), 32, dtype=torch.uint8,
                                 device=ctx.device), c.chars[:, :-1]], dim=1)
    word_start = prev == 32
    lower = (c.chars >= 97) & (c.chars <= 122)
    upper = (c.chars >= 65) & (c.chars <= 90)
    chars = torch.where(word_start & lower, c.chars - 32,
                        torch.where(~word_start & upper, c.chars + 32,
                                    c.chars))
    in_str = _arange(c.char_cap, ctx.device)[None, :] < \
        c.lengths.to(torch.int64)[:, None]
    return DeviceStringColumn(T.StringT, torch.where(in_str, chars, 0),
                              c.lengths, c.validity)


@handles(E.StringReverse)
def _h_str_reverse(e: E.StringReverse, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    cap = max(c.char_cap, 1)
    pos = _arange(cap, ctx.device)[None, :]
    idx = (c.lengths.to(torch.int64)[:, None] - 1 - pos).clamp(0, cap - 1)
    chars = _gather(_pad_chars(c, cap), idx)
    in_str = pos < c.lengths.to(torch.int64)[:, None]
    return DeviceStringColumn(T.StringT, torch.where(in_str, chars, 0),
                              c.lengths, c.validity)


@handles(E.Ascii)
def _h_ascii(e: E.Ascii, ctx: Ctx) -> DeviceColumn:
    """Codepoint of the first character, decoding a UTF-8 lead
    sequence."""
    c = dev_eval(e.children[0], ctx)
    ch = _pad_chars(c, max(c.char_cap, 4)).to(torch.int64)
    b0, b1, b2, b3 = ch[:, 0], ch[:, 1], ch[:, 2], ch[:, 3]
    one = b0 < 0x80
    two = (b0 >= 0xC0) & (b0 < 0xE0)
    three = (b0 >= 0xE0) & (b0 < 0xF0)
    cp = torch.where(
        one, b0,
        torch.where(two, ((b0 & 0x1F) << 6) | (b1 & 0x3F),
                    torch.where(three,
                                ((b0 & 0x0F) << 12) | ((b1 & 0x3F) << 6)
                                | (b2 & 0x3F),
                                ((b0 & 0x07) << 18) | ((b1 & 0x3F) << 12)
                                | ((b2 & 0x3F) << 6) | (b3 & 0x3F))))
    cp = torch.where(c.lengths > 0, cp, 0)
    return _normalized(T.IntegerT, cp.to(torch.int32), c.validity)


@handles(E.Chr)
def _h_chr(e: E.Chr, ctx: Ctx) -> DeviceStringColumn:
    """chr(n % 256) as UTF-8 (code points 128-255 take 2 bytes)."""
    c = dev_eval(e.children[0], ctx)
    n = c.data.to(torch.int64)
    cp = torch.remainder(n, 256)
    two_byte = cp >= 0x80
    b0 = torch.where(two_byte, 0xC0 | (cp >> 6), cp)
    b1 = torch.where(two_byte, 0x80 | (cp & 0x3F), 0)
    lengths = torch.where(n < 0, 0, torch.where(two_byte, 2, 1))
    lengths = torch.where(c.validity, lengths, 0)
    pos = _arange(8, ctx.device)[None, :]
    chars = torch.where(pos == 0, b0[:, None],
                        torch.where(pos == 1, b1[:, None], 0))
    chars = torch.where(pos < lengths[:, None], chars, 0).to(torch.uint8)
    return DeviceStringColumn(T.StringT, chars, lengths.to(torch.int32),
                              c.validity)


# ---------------------------------------------------------------------------
# Dates and times
# ---------------------------------------------------------------------------

# the JAX package's names for the civil-date math of ops/cast.py (floor
# division, so dates before 1970 are right)
_days_to_ymd_dev = CK.civil_from_days
_ymd_to_days_dev = CK.civil_to_days


_MONTH_LEN = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _days_in_month_dev(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    table = CK.const_tensor(_MONTH_LEN, torch.int64, y.device)
    return table[(m - 1).clamp(0, 11)] + ((m == 2) & leap).to(torch.int64)


def _field_days(e, c) -> torch.Tensor:
    if isinstance(e.children[0].data_type, T.TimestampType):
        return _fdiv(c.data.to(torch.int64), 86_400_000_000)
    return c.data.to(torch.int64)


@handles(E.Year, E.Month, E.DayOfMonth)
def _h_datefield(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    y, m, d = _days_to_ymd_dev(_field_days(e, c))
    data = {"year": y, "month": m, "dayofmonth": d}[e.field]
    return _normalized(T.IntegerT, data.to(torch.int32), c.validity)


@handles(E.Hour, E.Minute, E.Second)
def _h_timefield(e, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    sec_of_day = torch.remainder(_fdiv(c.data.to(torch.int64), 1_000_000),
                                 86400)
    data = torch.remainder(_fdiv(sec_of_day, e.divisor), e.modulus)
    return _normalized(T.IntegerT, data.to(torch.int32), c.validity)


@handles(E.DateAdd, E.DateSub, E.DateDiff)
def _h_date_arith(e, ctx: Ctx) -> DeviceColumn:
    lc, rc = _binary_cols(e, ctx)
    a, b = lc.data.to(torch.int64), rc.data.to(torch.int64)
    # DateSub subclasses DateAdd, so it is tested first
    data = a + b if isinstance(e, E.DateAdd) and not isinstance(
        e, E.DateSub) else a - b
    dt = T.IntegerT if isinstance(e, E.DateDiff) else T.DateT
    return _normalized(dt, data.to(torch.int32), _valid_and([lc, rc]))


@handles(E.Quarter)
def _h_quarter(e: E.Quarter, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    _y, m, _d = _days_to_ymd_dev(_field_days(e, c))
    return _normalized(T.IntegerT, (_fdiv(m - 1, 3) + 1).to(torch.int32),
                       c.validity)


@handles(E.DayOfWeek)
def _h_dayofweek(e: E.DayOfWeek, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    days = _field_days(e, c)
    return _normalized(T.IntegerT,
                       (torch.remainder(days + 4, 7) + 1).to(torch.int32),
                       c.validity)


@handles(E.WeekDay)
def _h_weekday(e: E.WeekDay, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    days = _field_days(e, c)
    return _normalized(T.IntegerT,
                       torch.remainder(days + 3, 7).to(torch.int32),
                       c.validity)


@handles(E.DayOfYear)
def _h_dayofyear(e: E.DayOfYear, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    days = _field_days(e, c)
    y, _m, _d = _days_to_ymd_dev(days)
    one = torch.ones_like(y)
    jan1 = _ymd_to_days_dev(y, one, one)
    return _normalized(T.IntegerT, (days - jan1 + 1).to(torch.int32),
                       c.validity)


@handles(E.WeekOfYear)
def _h_weekofyear(e: E.WeekOfYear, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    days = _field_days(e, c)
    thursday = days + 3 - torch.remainder(days + 3, 7)
    ty, _m, _d = _days_to_ymd_dev(thursday)
    one = torch.ones_like(ty)
    jan1 = _ymd_to_days_dev(ty, one, one)
    return _normalized(T.IntegerT,
                       (_fdiv(thursday - jan1, 7) + 1).to(torch.int32),
                       c.validity)


@handles(E.LastDay)
def _h_lastday(e: E.LastDay, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    y, m, _d = _days_to_ymd_dev(c.data.to(torch.int64))
    data = _ymd_to_days_dev(y, m, _days_in_month_dev(y, m))
    return _normalized(T.DateT, data.to(torch.int32), c.validity)


@handles(E.AddMonths)
def _h_addmonths(e: E.AddMonths, ctx: Ctx) -> DeviceColumn:
    sc, mc = _binary_cols(e, ctx)
    y, m, d = _days_to_ymd_dev(sc.data.to(torch.int64))
    total = (y * 12 + (m - 1)) + mc.data.to(torch.int64)
    ny = _fdiv(total, 12)
    nm = total - ny * 12 + 1
    nd = torch.minimum(d, _days_in_month_dev(ny, nm))
    data = _ymd_to_days_dev(ny, nm, nd)
    return _normalized(T.DateT, data.to(torch.int32), _valid_and([sc, mc]))


@handles(E.MonthsBetween)
def _h_months_between(e: E.MonthsBetween, ctx: Ctx) -> DeviceColumn:
    ec, sc = _binary_cols(e, ctx)
    dev = ctx.device
    one_e6 = _scalar(1e6, torch.float64, dev)

    def parts(col, dt):
        if isinstance(dt, T.TimestampType):
            micros = col.data.to(torch.int64)
            days = _fdiv(micros, 86_400_000_000)
            sec = (micros - days * 86_400_000_000).to(torch.float64) / one_e6
        else:
            days = col.data.to(torch.int64)
            sec = torch.zeros(days.shape, dtype=torch.float64, device=dev)
        y, m, d = _days_to_ymd_dev(days)
        return y, m, d, sec
    y1, m1, d1, s1 = parts(ec, e.children[0].data_type)
    y2, m2, d2, s2 = parts(sc, e.children[1].data_type)
    month_diff = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
    both_last = (d1 == _days_in_month_dev(y1, m1)) & \
                (d2 == _days_in_month_dev(y2, m2))
    aligned = (d1 == d2) | both_last
    frac = ((d1 - d2).to(torch.float64) * 86400.0 + (s1 - s2)) \
        / _scalar(31.0 * 86400.0, torch.float64, dev)
    data = torch.where(aligned, month_diff, month_diff + frac)
    # round to 8 places (Spark roundOff)
    data = torch.round(data * 1e8) / _scalar(1e8, torch.float64, dev)
    return _normalized(T.DoubleT, data, _valid_and([ec, sc]))


@extra_check(E.TruncDate)
def _c_truncdate(e: E.TruncDate):
    if _lit_str(e.children[1]) is None:
        return "trunc format must be a literal on device"
    return None


@handles(E.TruncDate)
def _h_truncdate(e: E.TruncDate, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    fc = dev_eval(e.children[1], ctx)
    f = _lit_str(e.children[1]).lower()
    validity = _valid_and([c, fc])
    days = c.data.to(torch.int64)
    y, m, _d = _days_to_ymd_dev(days)
    one = torch.ones_like(y)
    if f in ("year", "yyyy", "yy"):
        data = _ymd_to_days_dev(y, one, one)
    elif f in ("month", "mon", "mm"):
        data = _ymd_to_days_dev(y, m, one)
    elif f == "quarter":
        data = _ymd_to_days_dev(y, _fdiv(m - 1, 3) * 3 + 1, one)
    elif f == "week":
        data = days - torch.remainder(days + 3, 7)
    else:
        data = days
        validity = validity & False
    return _normalized(T.DateT, data.to(torch.int32), validity)


def _format_pattern_check(e, fmt_idx: int):
    f = _lit_str(e.children[fmt_idx])
    if f is None:
        return "datetime pattern must be a literal on device"
    if E.parse_dt_pattern(f) is None:
        return f"datetime pattern {f!r} is outside the supported subset"
    return None


@extra_check(E.DateFormatClass, E.FromUnixTime, E.GetTimestamp)
def _c_dtpattern(e):
    return _format_pattern_check(e, 1)


@extra_check(E.UnixTimestamp)
def _c_unixts(e: E.UnixTimestamp):
    if isinstance(e.children[0].data_type, (T.DateType, T.TimestampType)):
        return None
    return _format_pattern_check(e, 1)


def _format_micros_dev(micros: torch.Tensor, validity: torch.Tensor,
                       parts) -> DeviceStringColumn:
    """Digit-math datetime formatting into a byte matrix (years 0-9999,
    fixed token widths)."""
    cap = micros.shape[0]
    days = _fdiv(micros, 86_400_000_000)
    sec_of_day = _fdiv(micros - days * 86_400_000_000, 1_000_000)
    y, m, d = _days_to_ymd_dev(days)
    validity = validity & (y >= 0) & (y <= 9999)
    fields = {"yyyy": (y, 4), "MM": (m, 2), "dd": (d, 2),
              "HH": (_fdiv(sec_of_day, 3600), 2),
              "mm": (torch.remainder(_fdiv(sec_of_day, 60), 60), 2),
              "ss": (torch.remainder(sec_of_day, 60), 2)}
    cols = []
    for kind, text in parts:
        if kind == "lit":
            cols.append(torch.full((cap, 1), ord(text), dtype=torch.int64,
                                   device=micros.device))
        else:
            v, width = fields[kind]
            for k in range(width - 1, -1, -1):
                cols.append((torch.remainder(_fdiv(v, 10 ** k), 10)
                             + 48)[:, None])
    chars = torch.cat(cols, dim=1)
    total = chars.shape[1]
    char_cap = 8 * ((total + 7) // 8)
    if char_cap > total:
        chars = torch.nn.functional.pad(chars, (0, char_cap - total))
    return _string(chars, torch.full((cap,), total, dtype=torch.int64,
                                     device=micros.device), validity)


def _parse_pattern_dev(col: DeviceStringColumn, validity: torch.Tensor,
                       parts):
    """Fixed-position parse per the token subset: ``(micros, ok)``."""
    total = sum(4 if kind == "yyyy" else (1 if kind == "lit" else 2)
                for kind, _ in parts)
    cap = col.lengths.shape[0]
    dev = col.chars.device
    chars = _pad_chars(col, max(col.char_cap, total)).to(torch.int64)
    ok = validity & (col.lengths == total)

    def full(v):
        return torch.full((cap,), v, dtype=torch.int64, device=dev)
    vals = {"yyyy": full(1970), "MM": full(1), "dd": full(1),
            "HH": full(0), "mm": full(0), "ss": full(0)}
    pos = 0
    for kind, text in parts:
        if kind == "lit":
            ok = ok & (chars[:, pos] == ord(text))
            pos += 1
            continue
        width = 4 if kind == "yyyy" else 2
        v = full(0)
        for k in range(width):
            ch = chars[:, pos + k]
            ok = ok & (ch >= 48) & (ch <= 57)
            v = v * 10 + (ch - 48)
        vals[kind] = v
        pos += width
    ok = ok & (vals["MM"] >= 1) & (vals["MM"] <= 12) \
        & (vals["dd"] >= 1) & (vals["dd"] <= 31) \
        & (vals["HH"] < 24) & (vals["mm"] < 60) & (vals["ss"] < 60)
    day = _ymd_to_days_dev(vals["yyyy"], vals["MM"], vals["dd"])
    micros = ((day * 86400 + vals["HH"] * 3600 + vals["mm"] * 60
               + vals["ss"]) * 1_000_000)
    return torch.where(ok, micros, 0), ok


@handles(E.DateFormatClass)
def _h_date_format(e: E.DateFormatClass, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    fc = dev_eval(e.children[1], ctx)
    parts = E.parse_dt_pattern(_lit_str(e.children[1]))
    micros = c.data.to(torch.int64)
    if isinstance(e.children[0].data_type, T.DateType):
        micros = micros * 86_400_000_000
    return _format_micros_dev(micros, _valid_and([c, fc]), parts)


@handles(E.FromUnixTime)
def _h_from_unixtime(e: E.FromUnixTime, ctx: Ctx) -> DeviceStringColumn:
    c = dev_eval(e.children[0], ctx)
    fc = dev_eval(e.children[1], ctx)
    parts = E.parse_dt_pattern(_lit_str(e.children[1]))
    return _format_micros_dev(c.data.to(torch.int64) * 1_000_000,
                              _valid_and([c, fc]), parts)


@handles(E.UnixTimestamp)
def _h_unix_timestamp(e: E.UnixTimestamp, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    src = e.children[0].data_type
    if isinstance(src, T.DateType):
        return _normalized(T.LongT, c.data.to(torch.int64) * 86400,
                           c.validity)
    if isinstance(src, T.TimestampType):
        return _normalized(T.LongT, _fdiv(c.data.to(torch.int64),
                                          1_000_000), c.validity)
    fc = dev_eval(e.children[1], ctx)
    parts = E.parse_dt_pattern(_lit_str(e.children[1]))
    micros, ok = _parse_pattern_dev(c, _valid_and([c, fc]), parts)
    return _normalized(T.LongT, _fdiv(micros, 1_000_000), ok)


@handles(E.GetTimestamp)
def _h_get_timestamp(e: E.GetTimestamp, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    fc = dev_eval(e.children[1], ctx)
    parts = E.parse_dt_pattern(_lit_str(e.children[1]))
    micros, ok = _parse_pattern_dev(c, _valid_and([c, fc]), parts)
    return _normalized(T.TimestampT, micros, ok)


# ---------------------------------------------------------------------------
# Hashes and partition ids
# ---------------------------------------------------------------------------

@handles(E.Murmur3Hash)
def _h_murmur3(e: E.Murmur3Hash, ctx: Ctx) -> DeviceColumn:
    """Spark hash(...): the murmur3 kernel on the card (its plain version
    on the CPU)."""
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    from spark_rapids_tpu_torch.ops.hashing import struct_key_fields
    cols = [dev_eval(c, ctx) for c in e.children]
    h = KM.murmur3_columns(struct_key_fields(cols), ctx.capacity, e.seed)
    return DeviceColumn(T.IntegerT, h, ctx.ones())


@handles(E.XxHash64)
def _h_xxhash64(e: E.XxHash64, ctx: Ctx) -> DeviceColumn:
    from spark_rapids_tpu_torch.ops import hashing
    cols = [dev_eval(c, ctx) for c in e.children]
    h = hashing.xxhash64_columns(cols, ctx.capacity, e.seed, ctx.device)
    return DeviceColumn(T.LongT, h, ctx.ones())


@handles(E.SparkPartitionID)
def _h_spark_partition_id(e: E.SparkPartitionID, ctx: Ctx) -> DeviceColumn:
    pid, _start = ctx.part_vals
    data = pid.to(torch.int32).expand(ctx.capacity).contiguous()
    return DeviceColumn(T.IntegerT, data, ctx.ones())


@handles(E.MonotonicallyIncreasingID)
def _h_monotonic_id(e: E.MonotonicallyIncreasingID,
                    ctx: Ctx) -> DeviceColumn:
    """partition_id << 33 | row position within the partition; positions
    count active rows in batch order, continuing across batches from the
    row count the project threads through."""
    pid, start = ctx.part_vals
    active = ctx.active_hint
    rank = torch.cumsum(active.to(torch.int64), 0) - 1
    base = (pid.to(torch.int64) << 33) + start
    data = torch.where(active, base + rank, 0)
    return DeviceColumn(T.LongT, data, ctx.ones())


# ---------------------------------------------------------------------------
# Casts
# ---------------------------------------------------------------------------

@handles(E.Cast)
def _h_cast(e: E.Cast, ctx: Ctx) -> AnyDeviceColumn:
    return cast_device_column(dev_eval(e.child, ctx), e.data_type, ctx,
                              ansi=e.ansi)


def device_cast_supported(frm: T.DataType, to: T.DataType,
                          ansi: bool) -> Optional[str]:
    """The cast matrix (GpuCast.scala:1338): None when the from -> to leg
    runs on the device."""
    if frm == to:
        return None
    if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
        if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType):
            return None if D.cast_supported(frm, to) else \
                "deep decimal down-rescale runs on CPU"
        if isinstance(to, T.DecimalType) and (
                T.is_integral(frm) or isinstance(frm, T.BooleanType)):
            return None
        if isinstance(frm, T.DecimalType) and (
                T.is_integral(to) or T.is_floating(to)):
            return None
        return (f"cast {frm.simple_string} -> {to.simple_string} "
                "on TPU")
    is_plain_num = (lambda t: T.is_numeric(t)
                    and not isinstance(t, T.DecimalType))
    ok_num = is_plain_num(frm) and is_plain_num(to)
    ok_bool = (isinstance(frm, T.BooleanType) and is_plain_num(to)) or \
              (is_plain_num(frm) and isinstance(to, T.BooleanType))
    ok_dt = (isinstance(frm, T.DateType) and isinstance(to, T.TimestampType)
             ) or (isinstance(frm, T.TimestampType)
                   and isinstance(to, T.DateType))
    ok_from_str = isinstance(frm, T.StringType) and (
        T.is_integral(to) or isinstance(to, (T.BooleanType, T.DateType)))
    ok_to_str = isinstance(to, T.StringType) and (
        T.is_integral(frm) or isinstance(frm, (T.BooleanType, T.DateType)))
    if not (ok_num or ok_bool or ok_dt or ok_from_str or ok_to_str):
        return f"cast {frm.simple_string} -> {to.simple_string} on TPU"
    if ansi and not ok_num:
        return (f"ANSI cast {frm.simple_string} -> {to.simple_string} "
                "runs on CPU")
    return None


@extra_check(E.Cast)
def _c_cast(e: E.Cast) -> Optional[str]:
    return device_cast_supported(e.child.data_type, e.data_type, e.ansi)


def _cast_decimal_device(c: AnyDeviceColumn, to: T.DataType, ctx: Ctx,
                         ansi: bool) -> AnyDeviceColumn:
    """Decimal legs: decimal <-> decimal rescale, integral -> decimal,
    decimal -> floating, decimal -> integral."""
    frm = c.dtype
    if isinstance(frm, T.DecimalType) and isinstance(to, T.DecimalType):
        hi, lo, ok = D.cast_decimal(torch, *dec_limbs(c), frm, to)
        if ansi:
            ctx.record_error(~ok & c.validity,
                             "Decimal overflow in ANSI mode")
        return limbs_to_devcol(hi, lo, c.validity & ok, to)
    if isinstance(to, T.DecimalType):  # integral/boolean source
        hi, lo = I.from_i64(torch, c.data.to(torch.int64))
        hi, lo, over = D.rescale_up(torch, hi, lo, to.scale)
        ok = ~over & I.fits_precision(torch, hi, lo, to.precision)
        if ansi:
            ctx.record_error(~ok & c.validity,
                             "Decimal overflow in ANSI mode")
        return limbs_to_devcol(hi, lo, c.validity & ok, to)
    hi, lo = dec_limbs(c)
    if T.is_floating(to):
        v64, small = I.to_i64(torch, hi, lo)
        # uint64 -> float64 with one rounding: both halves are exact
        ulo = (I._srl(lo, 32).to(torch.float64) * (2.0 ** 32)
               + (lo & 0xFFFFFFFF).to(torch.float64))
        wide = hi.to(torch.float64) * (2.0 ** 64) + ulo
        # a reciprocal multiply, as the JAX package (and its host legs)
        # compute it
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
    ok = fits & (v >= info.min) & (v <= info.max)
    if ansi:
        ctx.record_error(~ok & c.validity, "Cast overflow in ANSI mode")
    validity = c.validity & ok
    return DeviceColumn(to, torch.where(validity, v, 0).to(dt), validity)


def cast_device_column(c: AnyDeviceColumn, to: T.DataType,
                       ctx: Optional[Ctx] = None,
                       ansi: bool = False) -> AnyDeviceColumn:
    frm = c.dtype
    if frm == to:
        return c
    if isinstance(frm, T.DecimalType) or isinstance(to, T.DecimalType):
        return _cast_decimal_device(c, to, ctx, ansi)
    if isinstance(frm, T.StringType) and not isinstance(to, T.StringType):
        return _cast_string_device(c, to)
    if isinstance(to, T.StringType):
        return _cast_to_string_device(c)
    if isinstance(to, T.BooleanType):
        return DeviceColumn(to, c.data != 0, c.validity)
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        return DeviceColumn(to, c.data.to(torch.int64) * 86_400_000_000,
                            c.validity)
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        return DeviceColumn(to, _fdiv(c.data.to(torch.int64),
                                      86_400_000_000).to(torch.int32),
                            c.validity)
    src = c.data
    dt = torch_dtype(to)
    if src.is_floating_point() and not T.is_floating(to):
        info = torch.iinfo(dt)
        t = torch.trunc(src.to(torch.float64))
        data = _java_double_to_long(t).clamp(info.min, info.max).to(dt)
        if ansi:
            # bound compares in float space (2^k bounds are exact)
            bad = (torch.isnan(src) | (t >= float(info.max) + 1.0)
                   | (t < float(info.min)))
            ctx.record_error(bad & c.validity, "Cast overflow in ANSI mode")
    else:
        data = src.to(dt)
        if ansi and not src.is_floating_point() and not T.is_floating(to) \
                and data.element_size() < src.element_size():
            ctx.record_error((data.to(src.dtype) != src) & c.validity,
                             "Cast overflow in ANSI mode")
    return DeviceColumn(to, data, c.validity)


def _cast_string_device(c: DeviceStringColumn, to: T.DataType
                        ) -> DeviceColumn:
    if T.is_integral(to):
        value, ok, overflow = CK.parse_string_to_long(
            c.chars, c.lengths, c.validity)
        dt = torch_dtype(to)
        info = torch.iinfo(dt)
        in_range = (value >= info.min) & (value <= info.max)
        validity = ok & ~overflow & in_range
        return DeviceColumn(to, torch.where(validity, value, 0).to(dt),
                            validity)
    if isinstance(to, T.BooleanType):
        value, ok = CK.parse_string_to_bool(c.chars, c.lengths, c.validity)
        return DeviceColumn(to, value & ok, ok)
    days, ok = CK.parse_string_to_date(c.chars, c.lengths, c.validity)
    return DeviceColumn(to, torch.where(ok, days, 0), ok)


def _cast_to_string_device(c: AnyDeviceColumn) -> DeviceStringColumn:
    frm = c.dtype
    if isinstance(frm, T.BooleanType):
        chars, lengths = CK.bool_to_string(c.data, c.validity)
    elif isinstance(frm, T.DateType):
        chars, lengths = CK.date_to_string(c.data, c.validity)
    else:
        chars, lengths = CK.long_to_string(c.data.to(torch.int64),
                                           c.validity)
    return DeviceStringColumn(T.StringT, chars, lengths, c.validity)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _raise_if_errors(ctx: Ctx, active: torch.Tensor) -> None:
    """After a batch: raise when an ANSI error row is still active (one
    host read, only when the expressions hold an ANSI cast)."""
    if not ctx.errors:
        return
    flags = torch.stack([(f & active).any() for f, _m in ctx.errors])
    if bool(flags.any()):
        raise ArithmeticError("Cast overflow in ANSI mode")


# ---------------------------------------------------------------------------
# Collections and structs over nested device columns (the JAX package's
# collectionOperations / complexType twins)
# ---------------------------------------------------------------------------

@handles(E.Size)
def _h_size(e: E.Size, ctx: Ctx) -> DeviceColumn:
    c = dev_eval(e.children[0], ctx)
    data = torch.where(c.validity, c.lengths,
                       E.Size.LEGACY_NULL).to(torch.int32)
    return DeviceColumn(T.IntegerT, data, ctx.ones())


@handles(E.ElementAt, E.GetArrayItem)
def _h_element_at(e, ctx: Ctx) -> AnyDeviceColumn:
    """The element at a 1-based index (negative from the end) or a
    0-based ordinal, gathered from the pool; out of range is null."""
    ac = dev_eval(e.children[0], ctx)
    ic = dev_eval(e.children[1], ctx)
    idx = ic.data.to(torch.int32)
    n = ac.lengths
    if type(e) is E.GetArrayItem:
        in_range = (idx >= 0) & (idx < n)
        off = idx
    else:
        in_range = (idx != 0) & (torch.abs(idx) <= n)
        off = torch.where(idx > 0, idx - 1, n + idx)
    pool_cap = ac.child.capacity
    src = torch.clamp(ac.starts + torch.clamp(off, min=0), 0,
                      pool_cap - 1).to(torch.int64)
    valid = ac.validity & ic.validity & in_range
    return take_columns([ac.child], src, valid_at=valid)[0]


@extra_check(E.ArrayContains)
def _c_array_contains(e: E.ArrayContains):
    if not isinstance(e.children[1], E.Literal):
        return ("array_contains with a non-literal search value runs "
                "on CPU")
    return None


@handles(E.ArrayContains)
def _h_array_contains(e: E.ArrayContains, ctx: Ctx) -> DeviceColumn:
    """Literal search value: equality over the whole pool, then each
    row's hits and null elements counted by prefix sums over its slice
    (no scatter). True on a hit; null when no hit and a null element."""
    ac = dev_eval(e.children[0], ctx)
    lit = e.children[1]
    pool = ac.child
    if lit.value is None:
        z = ctx.zeros()
        return DeviceColumn(T.BooleanT, z, z)
    if isinstance(pool, DeviceStringColumn):
        b = str(lit.value).encode("utf-8")
        eq = pool.lengths == len(b)
        if len(b) > pool.char_cap:
            eq = eq & False
        for k, byte in enumerate(b[:pool.char_cap]):
            eq = eq & (pool.chars[:, k] == byte)
    else:
        target = dev_eval(lit, ctx).data[0]
        eq = pool.data == target.to(pool.data.dtype)
    hit = eq & pool.validity
    zero = torch.zeros(1, dtype=torch.int64, device=ctx.device)
    pref_hit = torch.cat([zero, torch.cumsum(hit.to(torch.int64), 0)])
    pref_null = torch.cat([zero, torch.cumsum((~pool.validity)
                                              .to(torch.int64), 0)])
    lo = torch.clamp(ac.starts.to(torch.int64), 0, pool.capacity)
    hi = torch.clamp((ac.starts + ac.lengths).to(torch.int64), 0,
                     pool.capacity)
    found = (pref_hit[hi] - pref_hit[lo]) > 0
    nulls = pref_null[hi] - pref_null[lo]
    validity = ac.validity & (found | (nulls == 0))
    return _normalized(T.BooleanT, found, validity)


@derived_consts(E.TimeWindow)
def _d_time_window(e: E.TimeWindow) -> List[float]:
    # the window and its start are program inputs (exact in float64
    # below 2**53 microseconds)
    return [float(e.window_us), float(e.start_us)]


@handles(E.TimeWindow)
def _h_time_window(e: E.TimeWindow, ctx: Ctx) -> AnyDeviceColumn:
    """Tumbling window assignment on int64 microseconds ->
    struct<start, end>: start = ts - floorMod(ts - startTime, window),
    ``torch.remainder`` following the divisor's sign as Math.floorMod."""
    c = dev_eval(e.children[0], ctx)
    ts = c.data.to(torch.int64)
    got = ctx.derived(e)
    if got is not None:
        w, st = got[0].to(torch.int64), got[1].to(torch.int64)
    else:
        w = _scalar(e.window_us, torch.int64, ctx.device)
        st = _scalar(e.start_us, torch.int64, ctx.device)
    start = ts - torch.remainder(ts - st, w)
    v = c.validity
    fields = [DeviceColumn(T.TimestampT, torch.where(v, start, 0), v),
              DeviceColumn(T.TimestampT, torch.where(v, start + w, 0), v)]
    return DeviceStructColumn(e.data_type, fields, v)


@handles(E.CreateNamedStruct)
def _h_create_named_struct(e: E.CreateNamedStruct,
                           ctx: Ctx) -> AnyDeviceColumn:
    """struct(...): the evaluated children are the fields; the struct
    itself is never null."""
    cols = [dev_eval(c, ctx) for c in e.children]
    return DeviceStructColumn(e.data_type, cols, ctx.ones())


@handles(E.GetStructField)
def _h_get_struct_field(e: E.GetStructField, ctx: Ctx) -> AnyDeviceColumn:
    """struct.field: the field column masked by the struct's validity."""
    sc = dev_eval(e.children[0], ctx)
    return mask_col(sc.fields[e.ordinal], sc.validity)


@handles(E.CreateArray)
def _h_create_array(e: E.CreateArray, ctx: Ctx) -> AnyDeviceColumn:
    """array(c1, ..., ck): a pool of k elements a row, row-major; never
    null, null inputs are null elements."""
    cols = [_eval_as(c, e.data_type.element_type, ctx)
            for c in e.children]
    k = len(cols)
    cap = ctx.capacity
    et = e.data_type.element_type
    ev = torch.stack([c.validity for c in cols], dim=1).reshape(-1)
    if isinstance(cols[0], DeviceStringColumn):
        cc = max(c.char_cap for c in cols)
        chars = torch.stack([_pad_chars(c, cc) for c in cols],
                            dim=1).reshape(cap * k, cc)
        lens = torch.stack([c.lengths for c in cols], dim=1).reshape(-1)
        pool: AnyDeviceColumn = DeviceStringColumn(et, chars, lens, ev)
    else:
        data = torch.stack([c.data for c in cols], dim=1).reshape(-1)
        pool = mask_col(DeviceColumn(et, data, ev), ev)
    starts = torch.arange(cap, dtype=torch.int32, device=ctx.device) * k
    lengths = torch.full((cap,), k, dtype=torch.int32, device=ctx.device)
    return DeviceArrayColumn(e.data_type, starts, lengths, pool, ctx.ones())


def run_project(exprs: Sequence[E.Expression], batch: DeviceBatch,
                part_ctx=None) -> List[AnyDeviceColumn]:
    """Evaluate bound expressions over a device batch; padding rows stay
    normalized. ``part_ctx`` is the (partition id, row start) pair of
    device scalars the partition-id expressions read."""
    ctx = Ctx(batch.columns, batch.capacity, batch.device)
    ctx.part_vals = part_ctx
    ctx.active_hint = batch.active
    outs = [mask_col(dev_eval(e, ctx), batch.active) for e in exprs]
    _raise_if_errors(ctx, batch.active)
    return outs


def run_filter(cond: E.Expression, batch: DeviceBatch,
               part_ctx=None) -> DeviceBatch:
    """Filter = mask update only; compaction happens at exchanges."""
    ctx = Ctx(batch.columns, batch.capacity, batch.device)
    ctx.part_vals = part_ctx
    ctx.active_hint = batch.active
    p = dev_eval(cond, ctx)
    _raise_if_errors(ctx, batch.active)
    new_active = batch.active & p.validity & _as_bool(p)
    return DeviceBatch(batch.schema, batch.columns, new_active, None,
                       chip=batch.chip)


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
        ctx.active_hint = active
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
