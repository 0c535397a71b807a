"""Catalyst-like expression trees with vectorized CPU evaluation.

In the reference, Spark provides Catalyst expressions and the plugin mirrors
231 of them as Gpu* case classes (SURVEY.md 2.2 'Expressions'). Here the
expression tree itself is part of the framework; each node carries a
vectorized CPU `eval` over HostBatch implementing *Spark* semantics
(null propagation, two's-complement overflow wrap in non-ANSI mode,
NaN-equals-NaN ordering, 3-valued logic), and the plugin layer
(overrides.py) maps nodes to device implementations.

CPU eval requires bound references (`bind_references`), exactly like Spark's
BoundReference binding before codegen.
"""

from __future__ import annotations

import functools

import itertools
import math
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from spark_rapids_tpu_torch.columnar import murmur3
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.sql import types as T

_expr_id = itertools.count(1)


def next_expr_id() -> int:
    return next(_expr_id)


class Expression:
    """Base expression node."""

    children: List["Expression"]

    @property
    def data_type(self) -> T.DataType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return True

    def eval(self, batch: HostBatch) -> HostColumn:
        raise NotImplementedError(
            f"CPU eval not implemented for {type(self).__name__}")

    @property
    def pretty_name(self) -> str:
        return type(self).__name__.lower()

    def __repr__(self) -> str:
        cs = ", ".join(repr(c) for c in self.children)
        return f"{type(self).__name__}({cs})"

    def transform(self, fn: Callable[["Expression"], Optional["Expression"]]
                  ) -> "Expression":
        """Bottom-up transform; fn returns replacement or None to keep."""
        new_children = [c.transform(fn) for c in self.children]
        node = self
        if new_children != self.children:
            node = node.with_children(new_children)
        replaced = fn(node)
        return replaced if replaced is not None else node

    def with_children(self, children: List["Expression"]) -> "Expression":
        import copy
        node = copy.copy(self)
        node.children = children
        return node

    def collect(self, pred: Callable[["Expression"], bool]
                ) -> List["Expression"]:
        out = []
        if pred(self):
            out.append(self)
        for c in self.children:
            out.extend(c.collect(pred))
        return out

    def references(self) -> List["AttributeReference"]:
        return self.collect(lambda e: isinstance(e, AttributeReference))


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[T.DataType] = None):
        self.children = []
        if dtype is None:
            dtype = _infer_literal_type(value)
        self.value = value
        self._dtype = dtype

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def eval(self, batch: HostBatch) -> HostColumn:
        from spark_rapids_tpu_torch.columnar.host import _to_storage
        n = batch.num_rows
        if self.value is None:
            return HostColumn.nulls(n, self._dtype)
        if T.is_limb_decimal(self._dtype):
            from spark_rapids_tpu_torch.ops import int128 as I
            u = _to_storage(self.value, self._dtype)
            hi, lo = I.from_pyints([u])
            data = np.empty((n, 2), dtype=np.int64)
            data[:, 0] = hi[0]
            data[:, 1] = lo[0]
            return HostColumn.all_valid(data, self._dtype)
        np_dt = T.numpy_dtype(self._dtype)
        if np_dt == np.dtype(object):
            data = np.full(n, self.value, dtype=object)
        else:
            data = np.full(n, _to_storage(self.value, self._dtype),
                           dtype=np_dt)
        return HostColumn.all_valid(data, self._dtype)

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


def _infer_literal_type(v: Any) -> T.DataType:
    import datetime
    if v is None:
        return T.NullT
    if isinstance(v, bool):
        return T.BooleanT
    if isinstance(v, int):
        return T.IntegerT if -(2**31) <= v < 2**31 else T.LongT
    if isinstance(v, float):
        return T.DoubleT
    if isinstance(v, str):
        return T.StringT
    if isinstance(v, bytes):
        return T.BinaryT
    if isinstance(v, datetime.datetime):
        return T.TimestampT
    if isinstance(v, datetime.date):
        return T.DateT
    import decimal
    if isinstance(v, decimal.Decimal):
        sign, digits, exp = v.as_tuple()
        scale = -exp if exp < 0 else 0
        return T.DecimalType(max(len(digits), scale), scale)
    raise TypeError(f"cannot infer literal type for {v!r}")


class AttributeReference(Expression):
    """A resolved column with a unique id (Catalyst AttributeReference).
    ``qualifier`` carries the relation alias/table name so ``t.col``
    references resolve against the right side of a join (Catalyst keeps
    a qualifier seq on every attribute the same way)."""

    def __init__(self, name: str, dtype: T.DataType, nullable: bool = True,
                 expr_id: Optional[int] = None,
                 qualifier: Optional[str] = None):
        self.children = []
        self.name = name
        self._dtype = dtype
        self._nullable = nullable
        self.expr_id = expr_id if expr_id is not None else next_expr_id()
        self.qualifier = qualifier

    def with_qualifier(self, qualifier: str) -> "AttributeReference":
        return AttributeReference(self.name, self._dtype, self._nullable,
                                  self.expr_id, qualifier)

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def __repr__(self) -> str:
        return f"{self.name}#{self.expr_id}"

    def __eq__(self, other) -> bool:
        return (isinstance(other, AttributeReference)
                and other.expr_id == self.expr_id)

    def __hash__(self) -> int:
        return hash(("attr", self.expr_id))

    def renamed(self, name: str) -> "AttributeReference":
        return AttributeReference(name, self._dtype, self._nullable,
                                  self.expr_id)


class UnresolvedAttribute(Expression):
    def __init__(self, name: str):
        self.children = []
        self.name = name

    @property
    def data_type(self) -> T.DataType:
        raise RuntimeError(f"unresolved attribute {self.name}")

    def __repr__(self) -> str:
        return f"'{self.name}"


class BoundReference(Expression):
    """Column by ordinal after binding (Catalyst BoundReference)."""

    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool):
        self.children = []
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self._nullable

    def eval(self, batch: HostBatch) -> HostColumn:
        return batch.columns[self.ordinal]

    def __repr__(self) -> str:
        return f"input[{self.ordinal}]"


class Alias(Expression):
    def __init__(self, child: Expression, name: str,
                 expr_id: Optional[int] = None,
                 qualifier: Optional[str] = None):
        self.children = [child]
        self.name = name
        self.expr_id = expr_id if expr_id is not None else next_expr_id()
        self.qualifier = qualifier  # kept by self-join dedup re-aliasing

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    @property
    def nullable(self) -> bool:
        return self.child.nullable

    def eval(self, batch: HostBatch) -> HostColumn:
        return self.child.eval(batch)

    def to_attribute(self) -> AttributeReference:
        return AttributeReference(self.name, self.data_type, self.nullable,
                                  self.expr_id, self.qualifier)

    def __repr__(self) -> str:
        return f"{self.child!r} AS {self.name}#{self.expr_id}"


def named_output(expr: Expression) -> AttributeReference:
    """Output attribute for a projection item (Catalyst NamedExpression)."""
    if isinstance(expr, Alias):
        return expr.to_attribute()
    if isinstance(expr, AttributeReference):
        return expr
    raise TypeError(f"not a named expression: {expr!r}")


def bind_references(expr: Expression, input_attrs: Sequence[AttributeReference]
                    ) -> Expression:
    ids = {a.expr_id: i for i, a in enumerate(input_attrs)}

    def rule(e: Expression) -> Optional[Expression]:
        if isinstance(e, AttributeReference):
            if e.expr_id not in ids:
                raise KeyError(f"couldn't bind {e!r} against {input_attrs}")
            return BoundReference(ids[e.expr_id], e.data_type, e.nullable)
        return None

    return expr.transform(rule)


# ---------------------------------------------------------------------------
# Eval helpers
# ---------------------------------------------------------------------------

def _combined_validity(cols: Sequence[HostColumn]) -> np.ndarray:
    v = cols[0].validity
    for c in cols[1:]:
        v = v & c.validity
    return v.copy()


class UnaryExpression(Expression):
    @property
    def child(self) -> Expression:
        return self.children[0]


class BinaryExpression(Expression):
    @property
    def left(self) -> Expression:
        return self.children[0]

    @property
    def right(self) -> Expression:
        return self.children[1]


# ---------------------------------------------------------------------------
# Arithmetic (Spark semantics: null-propagating; non-ANSI ints wrap like
# Java two's complement — numpy matches; see GpuAdd etc. in the reference's
# arithmetic.scala)
# ---------------------------------------------------------------------------

class BinaryArithmetic(BinaryExpression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        lt = self.left.data_type
        if self.symbol in ("+", "-", "*", "/") \
                and isinstance(lt, T.DecimalType) \
                and isinstance(self.right.data_type, T.DecimalType):
            return T.decimal_binary_result(self.symbol, lt,
                                           self.right.data_type)
        return lt

    def op(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, batch: HostBatch) -> HostColumn:
        lc = self.left.eval(batch)
        rc = self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        if self.symbol in ("+", "-", "*") and \
                isinstance(self.data_type, T.DecimalType):
            return _decimal_arith(self.symbol, lc, rc, validity,
                                  self.data_type)
        with np.errstate(all="ignore"):
            data = self.op(lc.data, rc.data)
        np_dt = T.numpy_dtype(self.data_type)
        if data.dtype != np_dt:
            data = data.astype(np_dt)
        return HostColumn(self.data_type, data, validity).normalized()


class Add(BinaryArithmetic):
    symbol = "+"

    def op(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    symbol = "-"

    def op(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    symbol = "*"

    def op(self, a, b):
        return a * b


class Divide(BinaryArithmetic):
    """Fractional division (Spark analyzer casts ints to double first).
    Spark non-ANSI returns NULL for a zero divisor on every numeric type
    (unlike IEEE); ANSI raises."""
    symbol = "/"

    def op(self, a, b):
        return np.divide(a, b)

    def eval(self, batch: HostBatch) -> HostColumn:
        if isinstance(self.data_type, T.DecimalType):
            return _decimal_divide(self, batch)
        lc = self.left.eval(batch)
        rc = self.right.eval(batch)
        validity = _combined_validity([lc, rc]) & (rc.data != 0)
        with np.errstate(all="ignore"):
            data = np.divide(lc.data, np.where(rc.data != 0, rc.data, 1))
        np_dt = T.numpy_dtype(self.data_type)
        if data.dtype != np_dt:
            data = data.astype(np_dt)
        return HostColumn(self.data_type, data, validity).normalized()


class IntegralDivide(BinaryExpression):
    """`div`: long division, null on divide-by-zero (Spark IntegralDivide)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        a = lc.data.astype(np.int64)
        b = rc.data.astype(np.int64)
        validity = _combined_validity([lc, rc]) & (b != 0)
        with np.errstate(all="ignore"):
            safe_b = np.where(b == 0, 1, b)
            # Java integer division truncates toward zero; numpy floors.
            q = np.abs(a) // np.abs(safe_b)
            data = np.where((a < 0) != (safe_b < 0), -q, q).astype(np.int64)
        return HostColumn(T.LongT, data, validity).normalized()


class Remainder(BinaryArithmetic):
    """% with Java sign semantics (follows dividend); x % 0 -> null for
    all numeric types in Spark non-ANSI mode."""
    symbol = "%"

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        a, b = lc.data, rc.data
        validity = _combined_validity([lc, rc]) & (b != 0)
        with np.errstate(all="ignore"):
            safe_b = np.where(b == 0, 1, b)
            data = np.fmod(a, safe_b)
        np_dt = T.numpy_dtype(self.data_type)
        return HostColumn(self.data_type, data.astype(np_dt),
                          validity).normalized()


class Pmod(BinaryArithmetic):
    symbol = "pmod"

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        a, b = lc.data, rc.data
        # Spark DivModLike: divisor 0 -> null for ALL numeric types
        validity = _combined_validity([lc, rc]) & (b != 0)
        with np.errstate(all="ignore"):
            b = np.where(b == 0, 1, b).astype(b.dtype)
            r = np.fmod(a, b)
            data = np.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)
        np_dt = T.numpy_dtype(self.data_type)
        return HostColumn(self.data_type, data.astype(np_dt),
                          validity).normalized()


class BitwiseAnd(BinaryArithmetic):
    """& over integral types (GpuBitwiseAnd, arithmetic.scala role)."""
    symbol = "&"

    def op(self, a, b):
        return a & b


class BitwiseOr(BinaryArithmetic):
    symbol = "|"

    def op(self, a, b):
        return a | b


class BitwiseXor(BinaryArithmetic):
    symbol = "^"

    def op(self, a, b):
        return a ^ b


class BitwiseNot(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        return HostColumn(self.data_type, ~c.data,
                          c.validity.copy()).normalized()


class _Shift(BinaryExpression):
    """Java shift semantics: the amount is masked to the value width
    (x << 65 == x << 1 for long), like the JVM bytecodes Spark compiles
    to (GpuShiftLeft/Right/RightUnsigned twins)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return self.left.data_type

    def _mask(self) -> int:
        return 63 if isinstance(self.data_type, T.LongType) else 31

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        n = (rc.data.astype(np.int64) & self._mask()).astype(np.int64)
        data = self.shift(lc.data, n)
        np_dt = T.numpy_dtype(self.data_type)
        return HostColumn(self.data_type, data.astype(np_dt),
                          validity).normalized()

    def shift(self, a: np.ndarray, n: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class ShiftLeft(_Shift):
    def shift(self, a, n):
        return a << n


class ShiftRight(_Shift):
    def shift(self, a, n):
        return a >> n  # numpy >> on signed ints is arithmetic, like Java


class ShiftRightUnsigned(_Shift):
    def shift(self, a, n):
        if a.dtype == np.dtype(np.int64):
            return (a.view(np.uint64) >> n.astype(np.uint64)).view(np.int64)
        return (a.astype(np.int32).view(np.uint32)
                >> n.astype(np.uint32)).view(np.int32)


class Greatest(Expression):
    """Row-wise max skipping nulls; null only when every input is null
    (Spark Greatest; NaN is greatest among floats)."""
    is_min = False

    def __init__(self, children: List[Expression]):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        np_dt = T.numpy_dtype(self.data_type)
        validity = np.zeros(batch.num_rows, dtype=bool)
        for c in cols:
            validity |= c.validity
        is_float = np.issubdtype(np_dt, np.floating)
        data = None
        for c in cols:
            d = c.data.astype(np_dt)
            if data is None:
                data, have = d.copy(), c.validity.copy()
                continue
            if is_float:
                # NaN ranks greatest (Spark total order)
                better = (np.isnan(d) | (d > data)) if not self.is_min \
                    else ((~np.isnan(d)) & ((d < data) | np.isnan(data)))
            else:
                better = (d > data) if not self.is_min else (d < data)
            take = c.validity & (~have | better)
            data = np.where(take, d, data)
            have |= c.validity
        return HostColumn(self.data_type, data, validity).normalized()


class Least(Greatest):
    """Row-wise min skipping nulls (NaN still sorts greatest)."""
    is_min = True


class UnaryMinus(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        if T.is_limb_decimal(self.data_type):
            from spark_rapids_tpu_torch.ops import int128 as I
            hi, lo = I.neg(np, *_dec_limbs(c))
            return _limbs_to_col(hi, lo, c.validity.copy(), self.data_type)
        with np.errstate(all="ignore"):
            return HostColumn(self.data_type, -c.data, c.validity.copy())


class Abs(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        if T.is_limb_decimal(self.data_type):
            from spark_rapids_tpu_torch.ops import int128 as I
            hi, lo = I.abs_(np, *_dec_limbs(c))
            return _limbs_to_col(hi, lo, c.validity.copy(), self.data_type)
        with np.errstate(all="ignore"):
            return HostColumn(self.data_type, np.abs(c.data),
                              c.validity.copy())


def _dec_limbs(col: HostColumn):
    """HostColumn (decimal storage) -> (hi, lo) int64 limb arrays."""
    from spark_rapids_tpu_torch.ops import int128 as I
    if T.is_limb_decimal(col.dtype):
        return np.ascontiguousarray(col.data[:, 0]), \
            np.ascontiguousarray(col.data[:, 1])
    return I.from_i64(np, col.data.astype(np.int64))


def _limbs_to_col(hi, lo, validity, dt: T.DecimalType) -> HostColumn:
    from spark_rapids_tpu_torch.ops import decimal_ops as D
    if T.is_limb_decimal(dt):
        hi = np.where(validity, hi, 0)
        lo = np.where(validity, lo, 0)
        return HostColumn(dt, np.stack([hi, lo], axis=1), validity)
    v = D.to_i64_unscaled(np, hi, lo)
    return HostColumn(dt, np.where(validity, v, 0), validity)


def _decimal_arith(sym: str, lc: HostColumn, rc: HostColumn,
                   validity: np.ndarray, res: T.DecimalType) -> HostColumn:
    """Host +,-,* on decimals: vectorized limb math when the shapes are
    in the supported envelope, exact Python-int fallback otherwise
    (CheckOverflow -> NULL, non-ANSI)."""
    from spark_rapids_tpu_torch.ops import decimal_ops as D
    from spark_rapids_tpu_torch.ops import int128 as I
    lt, rt = lc.dtype, rc.dtype
    narrow = not (T.is_limb_decimal(lt) or T.is_limb_decimal(rt))
    if narrow and sym in ("+", "-") and not T.is_limb_decimal(res) \
            and res.scale >= max(lt.scale, rt.scale):
        # every operand and the result within 18 digits: the rescaled
        # operands and their sum or difference are exact in int64
        a = lc.data.astype(np.int64) * 10 ** (res.scale - lt.scale)
        b = rc.data.astype(np.int64) * 10 ** (res.scale - rt.scale)
        v = a + b if sym == "+" else a - b
        ok = validity & (np.abs(v) < 10 ** res.precision)
        return HostColumn(res, np.where(ok, v, 0), ok)
    if sym == "*" and res.scale == lt.scale + rt.scale:
        a, b = _as_i64(lc), _as_i64(rc)
        if a is not None and b is not None and _i64_bound(a) \
                * _i64_bound(b) < (1 << 63):
            # the exact product fits int64: no limb math, no rescale
            v = a * b
            ok = validity if res.precision > 18 else \
                validity & (np.abs(v) < 10 ** res.precision)
            return _limbs_to_col(v >> np.int64(63), v, ok, res)
    if narrow and sym == "*" and res.scale == lt.scale + rt.scale:
        # two 64-bit operands: their exact 128-bit product, no rescale
        hi, lo = I.mul_i64(np, lc.data.astype(np.int64),
                           rc.data.astype(np.int64))
        ok = I.fits_precision(np, hi, lo, res.precision)
        return _limbs_to_col(hi, lo, validity & ok, res)
    if sym in ("+", "-"):
        if not D.add_sub_supported(lt, rt):
            return _decimal_slow(sym, lc, rc, validity, res)
        ahi, alo = _dec_limbs(lc)
        bhi, blo = _dec_limbs(rc)
        hi, lo, ok = D.add_sub(np, sym, ahi, alo, bhi, blo, lt, rt, res)
    elif D.mul_supported(lt, rt):
        ahi, alo = _dec_limbs(lc)
        bhi, blo = _dec_limbs(rc)
        hi, lo, ok = D.mul(np, ahi, alo, bhi, blo, lt, rt, res)
    else:  # exact slow path (both operands wide, or deep rescale)
        return _decimal_slow(sym, lc, rc, validity, res)
    return _limbs_to_col(hi, lo, validity & ok, res)


def _as_i64(col: HostColumn) -> Optional[np.ndarray]:
    """A decimal column's unscaled values as int64, or None where a
    decimal128 value does not fit."""
    if not T.is_limb_decimal(col.dtype):
        return col.data.astype(np.int64)
    hi, lo = _dec_limbs(col)
    return lo if bool((hi == (lo >> np.int64(63))).all()) else None


def _i64_bound(v: np.ndarray) -> int:
    """The largest magnitude in ``v`` as a Python int (0 when empty)."""
    if not len(v):
        return 0
    return max(-int(v.min()), int(v.max()), 0)


def _decimal_slow(sym: str, lc: HostColumn, rc: HostColumn,
                  validity: np.ndarray, res: T.DecimalType) -> HostColumn:
    from spark_rapids_tpu_torch.ops import int128 as I
    a = I.to_pyints(*_dec_limbs(lc))
    b = I.to_pyints(*_dec_limbs(rc))
    s1, s2 = lc.dtype.scale, rc.dtype.scale
    out = []
    bound = 10 ** res.precision

    def _to_scale(v: int, s_from: int) -> int:
        # per-operand cast to the result scale (HALF_UP on reduction),
        # matching Spark's PromotePrecision(Cast(operand, resultType))
        d = res.scale - s_from
        if d >= 0:
            return v * 10 ** d
        q, r = divmod(abs(v), 10 ** -d)
        if 2 * r >= 10 ** -d:
            q += 1
        return q if v >= 0 else -q

    for x, y, ok in zip(a, b, validity):
        if not ok:
            out.append(None)
            continue
        if sym == "+":
            v = _to_scale(x, s1) + _to_scale(y, s2)
        elif sym == "-":
            v = _to_scale(x, s1) - _to_scale(y, s2)
        elif sym == "*":
            v = x * y
            down = (s1 + s2) - res.scale
            if down > 0:
                d = 10 ** down
                q, r = divmod(abs(v), d)
                if 2 * r >= d:
                    q += 1
                v = q if v >= 0 else -q
        else:  # "/"
            if y == 0:
                out.append(None)
                continue
            num = x * 10 ** (res.scale - s1 + s2)
            q, r = divmod(abs(num), abs(y))
            if 2 * r >= abs(y):
                q += 1
            v = q if (num >= 0) == (y >= 0) else -q
        out.append(None if abs(v) >= bound else v)
    from decimal import Decimal
    return HostColumn.from_pylist(
        [None if v is None else Decimal(v).scaleb(-res.scale)
         for v in out], res)


def _decimal_divide(node: Divide, batch: HostBatch) -> HostColumn:
    """Spark decimal division: HALF_UP at the DecimalPrecision result
    scale, NULL on zero divisor (non-ANSI) or overflow."""
    from spark_rapids_tpu_torch.ops import decimal_ops as D
    lc = node.left.eval(batch)
    rc = node.right.eval(batch)
    res = node.data_type
    lt, rt = lc.dtype, rc.dtype
    if T.is_limb_decimal(rt):
        bhi, blo = _dec_limbs(rc)
        nonzero = (bhi != 0) | (blo != 0)
    else:
        nonzero = rc.data.astype(np.int64) != 0
    validity = _combined_validity([lc, rc]) & nonzero
    if not D.div_supported(lt, rt):
        return _decimal_slow("/", lc, rc, validity, res)
    ahi, alo = _dec_limbs(lc)
    # div_supported caps the divisor at 18 digits -> plain int64 storage
    assert not T.is_limb_decimal(rt), rt
    d_safe = np.where(nonzero, rc.data.astype(np.int64), 1)
    hi, lo, ok = D.div(np, ahi, alo, d_safe, lt, rt, res)
    return _limbs_to_col(hi, lo, validity & ok, res)


# ---------------------------------------------------------------------------
# Comparisons. Spark orders NaN greater than any other value and
# NaN == NaN is true (unlike IEEE); see the reference's hasNans handling.
# ---------------------------------------------------------------------------

class BinaryComparison(BinaryExpression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def cmp(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        data = self._compare(lc, rc)
        return HostColumn(T.BooleanT, data, validity).normalized()

    def _compare(self, lc: HostColumn, rc: HostColumn) -> np.ndarray:
        a, b = lc.data, rc.data
        if T.is_limb_decimal(lc.dtype) or T.is_limb_decimal(rc.dtype):
            # coercion aligned both sides to one (wide) decimal type:
            # reduce the limb comparison to a sign surrogate so every
            # operator reuses its scalar cmp
            from spark_rapids_tpu_torch.ops import int128 as I
            ahi, alo = _dec_limbs(lc)
            bhi, blo = _dec_limbs(rc)
            lt = I.cmp_lt(np, ahi, alo, bhi, blo)
            eqm = I.eq(np, ahi, alo, bhi, blo)
            sign = np.where(lt, -1, np.where(eqm, 0, 1)).astype(np.int8)
            return self.cmp(sign, np.zeros_like(sign))
        if a.dtype == np.dtype(object):
            n = len(a)
            out = np.zeros(n, dtype=bool)
            for i in range(n):
                out[i] = self.cmp_scalar(a[i], b[i])
            return out
        if np.issubdtype(a.dtype, np.floating):
            # Total order with NaN largest: compare via ordered keys.
            ka, kb = _float_total_order(a), _float_total_order(b)
            return self.cmp(ka, kb)
        return self.cmp(a, b)

    def cmp_scalar(self, a, b) -> bool:
        return bool(self.cmp(np.array([a], dtype=object),
                             np.array([b], dtype=object))[0])


def _float_total_order(a: np.ndarray) -> np.ndarray:
    """Map floats to unsigned keys preserving Spark's total order
    (-inf < ... < -0.0 = 0.0 < ... < inf < NaN; all NaNs equal).

    Classic radix trick on the IEEE bit pattern: flip all bits for
    negatives, set the sign bit for non-negatives; NaNs and -0.0 are
    canonicalized first so every NaN maps to one (maximal) key.
    """
    v = (a.astype(np.float32) if a.dtype == np.float32
         else a.astype(np.float64)).copy()
    v[np.isnan(v)] = np.nan  # canonical positive NaN
    v[v == 0.0] = 0.0        # fold -0.0 into +0.0
    if v.dtype == np.float32:
        u = v.view(np.uint32)
        return np.where((u >> np.uint32(31)) == 1, ~u,
                        u | np.uint32(0x80000000))
    u = v.view(np.uint64)
    return np.where((u >> np.uint64(63)) == 1, ~u,
                    u | np.uint64(0x8000000000000000))


class EqualTo(BinaryComparison):
    symbol = "="

    def cmp(self, a, b):
        return a == b


class LessThan(BinaryComparison):
    symbol = "<"

    def cmp(self, a, b):
        return a < b


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def cmp(self, a, b):
        return a <= b


class GreaterThan(BinaryComparison):
    symbol = ">"

    def cmp(self, a, b):
        return a > b


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def cmp(self, a, b):
        return a >= b


class EqualNullSafe(BinaryComparison):
    """<=>: never null; null <=> null is true."""
    symbol = "<=>"

    def cmp(self, a, b):
        return a == b

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        both_valid = lc.validity & rc.validity
        both_null = (~lc.validity) & (~rc.validity)
        eq = self._compare(lc, rc)
        data = np.where(both_valid, eq, both_null)
        return HostColumn.all_valid(data.astype(bool), T.BooleanT)


# ---------------------------------------------------------------------------
# Logic (3-valued)
# ---------------------------------------------------------------------------

class And(BinaryExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        lt = lc.validity & lc.data.astype(bool)
        lf = lc.validity & ~lc.data.astype(bool)
        rt = rc.validity & rc.data.astype(bool)
        rf = rc.validity & ~rc.data.astype(bool)
        data = lt & rt
        validity = lf | rf | (lt & rt)
        return HostColumn(T.BooleanT, data, validity).normalized()


class Or(BinaryExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        lt = lc.validity & lc.data.astype(bool)
        rt = rc.validity & rc.data.astype(bool)
        lf = lc.validity & ~lc.data.astype(bool)
        rf = rc.validity & ~rc.data.astype(bool)
        data = lt | rt
        validity = lt | rt | (lf & rf)
        return HostColumn(T.BooleanT, data, validity).normalized()


class Not(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        return HostColumn(T.BooleanT, ~c.data.astype(bool),
                          c.validity.copy()).normalized()


class In(Expression):
    def __init__(self, value: Expression, items: List[Expression]):
        self.children = [value] + items

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def eval(self, batch: HostBatch) -> HostColumn:
        vc = self.children[0].eval(batch)
        any_true = np.zeros(batch.num_rows, dtype=bool)
        any_null = np.zeros(batch.num_rows, dtype=bool)
        for item in self.children[1:]:
            ic = item.eval(batch)
            eq = EqualTo(self.children[0], item)._compare(vc, ic)
            valid = vc.validity & ic.validity
            any_true |= valid & eq
            any_null |= ~ic.validity
        validity = vc.validity & (any_true | ~any_null)
        return HostColumn(T.BooleanT, any_true, validity).normalized()


# ---------------------------------------------------------------------------
# Null handling / conditionals
# ---------------------------------------------------------------------------

class IsNull(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        return HostColumn.all_valid(~c.validity, T.BooleanT)


class IsNotNull(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        return HostColumn.all_valid(c.validity.copy(), T.BooleanT)


class IsNan(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        data = np.isnan(c.data) & c.validity
        return HostColumn.all_valid(data, T.BooleanT)


class Coalesce(Expression):
    def __init__(self, children: List[Expression]):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        """Later arguments evaluate only where every earlier one was null
        (short-circuit; matches the device handler's ANSI scoping)."""
        first = self.children[0].eval(batch)
        data = first.data.copy()
        validity = first.validity.copy()
        for child in self.children[1:]:
            idx = np.nonzero(~validity)[0]
            if not len(idx):
                break
            c = child.eval(batch.take(idx))
            data[idx] = np.where(c.validity, c.data, data[idx])
            validity[idx] = c.validity
        return HostColumn(self.data_type, data, validity).normalized()


class If(Expression):
    def __init__(self, predicate: Expression, true_value: Expression,
                 false_value: Expression):
        self.children = [predicate, true_value, false_value]

    @property
    def data_type(self) -> T.DataType:
        return self.children[1].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        """Arms evaluate only on their taken rows (Spark's lazy
        branches), so ANSI errors in the untaken arm never fire."""
        p = self.children[0].eval(batch)
        cond = p.validity & p.data.astype(bool)  # null predicate -> false
        n = batch.num_rows
        np_dt = T.numpy_dtype(self.data_type)
        data = (np.full(n, "", dtype=object)
                if np_dt == np.dtype(object) else np.zeros(n, dtype=np_dt))
        validity = np.zeros(n, dtype=bool)
        for mask, child in ((cond, self.children[1]),
                            (~cond, self.children[2])):
            idx = np.nonzero(mask)[0]
            if len(idx):
                v = child.eval(batch.take(idx))
                data[idx] = v.data
                validity[idx] = v.validity
        return HostColumn(self.data_type, data,
                          validity.astype(bool)).normalized()


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... ELSE e END. children =
    [p1, v1, p2, v2, ..., (else)]."""

    def __init__(self, branches: List, else_value: Optional[Expression]):
        self.children = []
        for p, v in branches:
            self.children.extend([p, v])
        self.has_else = else_value is not None
        if else_value is not None:
            self.children.append(else_value)

    @property
    def data_type(self) -> T.DataType:
        return self.children[1].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        """Branches evaluate only on the rows that REACH them (Spark's
        first-match short-circuit), so ANSI errors inside an untaken
        branch never fire."""
        n = batch.num_rows
        np_dt = T.numpy_dtype(self.data_type)
        data = (np.full(n, "", dtype=object)
                if np_dt == np.dtype(object) else np.zeros(n, dtype=np_dt))
        validity = np.zeros(n, dtype=bool)
        decided = np.zeros(n, dtype=bool)
        pairs = (self.children[:-1] if self.has_else else self.children)
        for i in range(0, len(pairs), 2):
            und = np.nonzero(~decided)[0]
            if not len(und):
                break
            sub = batch.take(und)
            p = pairs[i].eval(sub)
            hit_idx = und[p.validity & p.data.astype(bool)]
            if len(hit_idx):
                v = pairs[i + 1].eval(batch.take(hit_idx))
                data[hit_idx] = v.data
                validity[hit_idx] = v.validity
                decided[hit_idx] = True
        if self.has_else:
            rest = np.nonzero(~decided)[0]
            if len(rest):
                e = self.children[-1].eval(batch.take(rest))
                data[rest] = e.data
                validity[rest] = e.validity
        return HostColumn(self.data_type, data, validity).normalized()


# ---------------------------------------------------------------------------
# Math functions
# ---------------------------------------------------------------------------

class UnaryMath(UnaryExpression):
    np_fn: Callable = None

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.DoubleT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        with np.errstate(all="ignore"):
            data = type(self).np_fn(c.data.astype(np.float64))
        return HostColumn(T.DoubleT, data, c.validity.copy()).normalized()


class Sqrt(UnaryMath):
    np_fn = np.sqrt


class Exp(UnaryMath):
    np_fn = np.exp


class Log(UnaryMath):
    """Natural log; Spark non-ANSI returns null for x <= 0."""

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        x = c.data.astype(np.float64)
        validity = c.validity & (x > 0)
        with np.errstate(all="ignore"):
            data = np.log(np.where(x > 0, x, 1.0))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Log10(UnaryMath):
    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        x = c.data.astype(np.float64)
        validity = c.validity & (x > 0)
        with np.errstate(all="ignore"):
            data = np.log10(np.where(x > 0, x, 1.0))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Sin(UnaryMath):
    np_fn = np.sin


class Cos(UnaryMath):
    np_fn = np.cos


class Tan(UnaryMath):
    np_fn = np.tan


class Asin(UnaryMath):
    np_fn = np.arcsin


class Acos(UnaryMath):
    np_fn = np.arccos


class Atan(UnaryMath):
    np_fn = np.arctan


class Sinh(UnaryMath):
    np_fn = np.sinh


class Cosh(UnaryMath):
    np_fn = np.cosh


class Tanh(UnaryMath):
    np_fn = np.tanh


class Signum(UnaryMath):
    """Java Math.signum: preserves ±0.0 and NaN (np.sign folds -0.0)."""

    @staticmethod
    def np_fn(x):
        return np.where(x == 0.0, x, np.sign(x))


class Log2(UnaryMath):
    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        x = c.data.astype(np.float64)
        validity = c.validity & (x > 0)
        with np.errstate(all="ignore"):
            data = np.log2(np.where(x > 0, x, 1.0))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Log1p(UnaryMath):
    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        x = c.data.astype(np.float64)
        validity = c.validity & (x > -1.0)
        with np.errstate(all="ignore"):
            data = np.log1p(np.where(x > -1.0, x, 0.0))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Expm1(UnaryMath):
    np_fn = np.expm1


class Cbrt(UnaryMath):
    np_fn = np.cbrt


class Rint(UnaryMath):
    np_fn = np.rint  # Math.rint = round-half-even, same as IEEE rint


class ToDegrees(UnaryMath):
    np_fn = np.degrees


class ToRadians(UnaryMath):
    np_fn = np.radians


class BinaryMath(BinaryExpression):
    np_fn: Callable = None

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.DoubleT

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        with np.errstate(all="ignore"):
            data = type(self).np_fn(lc.data.astype(np.float64),
                                    rc.data.astype(np.float64))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Atan2(BinaryMath):
    np_fn = np.arctan2


class Hypot(BinaryMath):
    np_fn = np.hypot


class Floor(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        with np.errstate(all="ignore"):
            data = _java_double_to_long(np.floor(c.data.astype(np.float64)))
        return HostColumn(T.LongT, data, c.validity.copy()).normalized()


class Ceil(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        with np.errstate(all="ignore"):
            data = _java_double_to_long(np.ceil(c.data.astype(np.float64)))
        return HostColumn(T.LongT, data, c.validity.copy()).normalized()


def _java_double_to_long(x: np.ndarray) -> np.ndarray:
    """Java (long) cast: NaN -> 0, saturate at Long.MIN/MAX, trunc.

    Saturation needs threshold compares: float(Long.MAX) rounds up to
    2**63, so clip-then-astype would wrap positive overflow to MIN."""
    info = np.iinfo(np.int64)
    with np.errstate(all="ignore"):
        y = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        hi = x >= 2.0 ** 63          # covers +inf
        lo = x <= -(2.0 ** 63) - 1.0  # -2^63 itself is representable
        y = np.where(hi | lo, 0.0, y)
        out = y.astype(np.int64)
        out = np.where(hi, info.max, out)
        out = np.where(lo | (x == -np.inf), info.min, out)
        return np.where(np.isnan(x), 0, out)


class Pow(BinaryExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.DoubleT

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        with np.errstate(all="ignore"):
            data = np.power(lc.data.astype(np.float64),
                            rc.data.astype(np.float64))
        return HostColumn(T.DoubleT, data, validity).normalized()


class Round(Expression):
    """HALF_UP rounding (Spark Round)."""

    def __init__(self, child: Expression, scale: Expression):
        self.children = [child, scale]

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.children[0].eval(batch)
        scale = self.children[1]
        assert isinstance(scale, Literal), "round scale must be literal"
        s = int(scale.value)
        x = c.data
        if np.issubdtype(x.dtype, np.integer):
            if s >= 0:
                data = x.copy()
            else:
                p = 10 ** (-s)
                half = p // 2
                data = ((np.abs(x) + half) // p * p) * np.sign(x)
                data = data.astype(x.dtype)
        else:
            with np.errstate(all="ignore"):
                p = 10.0 ** s
                scaled = x.astype(np.float64) * p
                # HALF_UP: away from zero on ties (np.round is HALF_EVEN)
                data = (np.sign(scaled)
                        * np.floor(np.abs(scaled) + 0.5)) / p
                data = data.astype(x.dtype)
        return HostColumn(self.data_type, data, c.validity.copy()).normalized()


# ---------------------------------------------------------------------------
# Strings (host: object arrays; per-row loops are acceptable on the CPU
# baseline path). Mirrors the reference's stringFunctions.scala surface.
# ---------------------------------------------------------------------------

class StringUnary(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def fn(self, s: str) -> Any:
        raise NotImplementedError

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        out = np.empty(len(c.data), dtype=T.numpy_dtype(self.data_type))
        if out.dtype == np.dtype(object):
            out[:] = ""
        for i in range(len(c.data)):
            if c.validity[i]:
                out[i] = self.fn(c.data[i])
        return HostColumn(self.data_type, out, c.validity.copy())


class Upper(StringUnary):
    def fn(self, s: str) -> str:
        return s.upper()


class Lower(StringUnary):
    def fn(self, s: str) -> str:
        return s.lower()


class Length(StringUnary):
    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        data = np.array([len(s) if v else 0
                         for s, v in zip(c.data, c.validity)], dtype=np.int32)
        return HostColumn(T.IntegerT, data, c.validity.copy())


class StringTrim(StringUnary):
    def fn(self, s: str) -> str:
        return s.strip(" ")


class Substring(Expression):
    """1-based substring with Spark's negative-position semantics."""

    def __init__(self, child: Expression, pos: Expression, length: Expression):
        self.children = [child, pos, length]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.children[0].eval(batch)
        p = self.children[1].eval(batch)
        ln = self.children[2].eval(batch)
        validity = _combined_validity([c, p, ln])
        out = np.full(len(c.data), "", dtype=object)
        for i in range(len(c.data)):
            if not validity[i]:
                continue
            s = c.data[i]
            pos, length = int(p.data[i]), int(ln.data[i])
            if length <= 0:
                out[i] = ""
                continue
            if pos > 0:
                start = pos - 1
            elif pos == 0:
                start = 0
            else:
                start = max(len(s) + pos, 0)
                if len(s) + pos < 0:
                    length = length + (len(s) + pos)
                    if length <= 0:
                        out[i] = ""
                        continue
            out[i] = s[start:start + length]
        return HostColumn(T.StringT, out, validity)


class ConcatStr(Expression):
    def __init__(self, children: List[Expression]):
        self.children = list(children)

    @property
    def pretty_name(self) -> str:
        return "concat"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                out[i] = "".join(c.data[i] for c in cols)
        return HostColumn(T.StringT, out, validity)


class StartsWith(BinaryExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def scalar(self, s: str, p: str) -> bool:
        return s.startswith(p)

    def eval(self, batch: HostBatch) -> HostColumn:
        lc, rc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([lc, rc])
        if isinstance(self.right, Literal) and self.right.value is not None:
            out = _per_distinct(self.scalar, lc, self.right.value, validity)
            if out is not None:
                return HostColumn(T.BooleanT, out, validity)
        scalar = self.scalar
        out = np.fromiter(
            (ok and scalar(a, b) for a, b, ok in zip(
                lc.data.tolist(), rc.data.tolist(), validity.tolist())),
            dtype=bool, count=batch.num_rows)
        return HostColumn(T.BooleanT, out, validity)


def _per_distinct(scalar, col: HostColumn, p: str,
                  validity: np.ndarray) -> Optional[np.ndarray]:
    """``scalar(s, p)`` for each row's string ``s``, computed once per
    distinct string (Arrow's dictionary encoding) and gathered back; None
    where pyarrow is missing or a value is not a string."""
    try:
        import pyarrow as pa
        enc = pa.array(col.data, type=pa.string(),
                       mask=~validity).dictionary_encode()
    except Exception:
        return None
    hits = np.fromiter((scalar(v, p) for v in enc.dictionary.to_pylist()),
                       dtype=bool, count=len(enc.dictionary))
    if not len(hits):
        return np.zeros(len(validity), dtype=bool)
    idx = enc.indices.fill_null(0).to_numpy(zero_copy_only=False)
    return hits[idx] & validity


class EndsWith(StartsWith):
    def scalar(self, s: str, p: str) -> bool:
        return s.endswith(p)


class Contains(StartsWith):
    def scalar(self, s: str, p: str) -> bool:
        return p in s


class Like(StartsWith):
    """SQL LIKE with %% and _ wildcards, escape '\\'."""

    def scalar(self, s: str, p: str) -> bool:
        return _like_pattern(p).fullmatch(s) is not None


@functools.lru_cache(maxsize=256)
def _like_pattern(pattern: str):
    """The compiled regular expression of a LIKE pattern, compiled once
    for all the rows that share the pattern."""
    import re
    return re.compile(_like_to_regex(pattern), flags=re.DOTALL)


def _like_to_regex(pattern: str) -> str:
    import re
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


import threading as _threading

# Per-thread partition context for partition-aware expressions; set by
# the Project execs (pid, row_start) and the file scan (input_file)
# right before each batch evaluation.
_PART_CTX = _threading.local()


class SparkPartitionID(Expression):
    """spark_partition_id() (GpuSparkPartitionID role)."""

    children: List[Expression] = []

    def __init__(self):
        self.children = []

    @property
    def pretty_name(self) -> str:
        return "spark_partition_id"

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        pid = getattr(_PART_CTX, "pid", 0)
        return HostColumn.all_valid(
            np.full(batch.num_rows, pid, dtype=np.int32), T.IntegerT)


class MonotonicallyIncreasingID(Expression):
    """monotonically_increasing_id(): partition id << 33 | row position
    within the partition (GpuMonotonicallyIncreasingID.scala)."""

    def __init__(self):
        self.children = []

    @property
    def pretty_name(self) -> str:
        return "monotonically_increasing_id"

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        pid = getattr(_PART_CTX, "pid", 0)
        start = getattr(_PART_CTX, "row_start", 0)
        base = (pid << 33) + start
        return HostColumn.all_valid(
            base + np.arange(batch.num_rows, dtype=np.int64), T.LongT)


class InputFileName(Expression):
    """input_file_name(): path of the file the current rows came from;
    empty string outside a file scan (Spark semantics; the reference's
    InputFileBlockRule likewise confines it to scan-adjacent projects)."""

    def __init__(self):
        self.children = []

    @property
    def pretty_name(self) -> str:
        return "input_file_name"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        f = getattr(_PART_CTX, "input_file", "")
        n = batch.num_rows
        col = HostColumn.all_valid(np.full(n, f, dtype=object), T.StringT)
        if f:
            # the compact bytes too: an upload ships them as they are
            # instead of encoding the path once a row
            raw = np.frombuffer(f.encode("utf-8"), dtype=np.uint8)
            col.varbytes = (np.tile(raw, n),
                            np.full(n, len(raw), dtype=np.int32))
        return col


class RLike(StartsWith):
    """RLIKE / regexp: Java-regex search semantics (unanchored), CPU
    only — the device rewrite tags regexp to CPU (the reference gates
    GpuRLike behind cudf regex support the same way)."""

    def scalar(self, s: str, p: str) -> bool:
        import re
        return re.search(p, s) is not None


class RegExpReplace(Expression):
    """regexp_replace(str, pattern, replacement); CPU only."""

    def __init__(self, child: Expression, pattern: Expression,
                 replacement: Expression):
        self.children = [child, pattern, replacement]

    @property
    def pretty_name(self) -> str:
        return "regexp_replace"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        import re
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                # Java $1 group references map to python \1
                rep = re.sub(r"\$(\d+)", r"\\\1", cols[2].data[i])
                out[i] = re.sub(cols[1].data[i], rep, cols[0].data[i])
        return HostColumn(T.StringT, out, validity)


class RegExpExtract(Expression):
    """regexp_extract(str, pattern, idx): group idx of the FIRST match,
    empty string when no match (Spark semantics); CPU only."""

    def __init__(self, child: Expression, pattern: Expression,
                 idx: Expression):
        self.children = [child, pattern, idx]

    @property
    def pretty_name(self) -> str:
        return "regexp_extract"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        import re
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                m = re.search(cols[1].data[i], cols[0].data[i])
                g = int(cols[2].data[i])
                out[i] = (m.group(g) or "") if m and g <= len(
                    m.groups()) else ""
        return HostColumn(T.StringT, out, validity)


class StringSplit(Expression):
    """split(str, regex[, limit]) -> array<string> (GpuStringSplit,
    stringFunctions.scala:1014). Java split semantics: limit > 0 caps
    the parts; limit <= 0 keeps trailing empty strings."""

    def __init__(self, child: Expression, pattern: Expression,
                 limit: Expression):
        self.children = [child, pattern, limit]

    @property
    def pretty_name(self) -> str:
        return "split"

    @property
    def data_type(self) -> T.DataType:
        return T.ArrayType(T.StringT)

    def eval(self, batch: HostBatch) -> HostColumn:
        import re
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.empty(batch.num_rows, dtype=object)
        for i in range(batch.num_rows):
            if not validity[i]:
                out[i] = ()
                continue
            lim = int(cols[2].data[i])
            parts = re.split(cols[1].data[i], cols[0].data[i],
                             maxsplit=lim - 1 if lim > 0 else 0)
            if lim == 0 and len(parts) > 1:
                # Java Pattern.split(limit=0) strips trailing empties;
                # the no-match case returns [input] untouched (so
                # "".split(",") stays [""])
                while parts and parts[-1] == "":
                    parts.pop()
            out[i] = tuple(parts)
        return HostColumn(self.data_type, out, validity)


class ConcatWs(Expression):
    """concat_ws(sep, ...): null arguments are SKIPPED; null only when
    the separator itself is null (stringFunctions.scala GpuConcatWs)."""

    def __init__(self, children: List[Expression]):
        self.children = list(children)  # [sep, arg0, arg1, ...]

    @property
    def pretty_name(self) -> str:
        return "concat_ws"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        sep, args = cols[0], cols[1:]
        validity = sep.validity.copy()
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                out[i] = sep.data[i].join(
                    c.data[i] for c in args if c.validity[i])
        return HostColumn(T.StringT, out, validity)


class StringRepeat(BinaryExpression):
    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        sc, nc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([sc, nc])
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                out[i] = sc.data[i] * max(0, int(nc.data[i]))
        return HostColumn(T.StringT, out, validity)


class StringLPad(Expression):
    """lpad/rpad with Spark semantics: result is exactly `len` chars
    (truncating when longer); an empty pad leaves the string as-is."""
    left_side = True

    def __init__(self, child: Expression, length: Expression,
                 pad: Expression):
        self.children = [child, length, pad]

    @property
    def pretty_name(self) -> str:
        return "lpad" if self.left_side else "rpad"

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if not validity[i]:
                continue
            s, n, p = cols[0].data[i], int(cols[1].data[i]), cols[2].data[i]
            if n <= 0:
                out[i] = ""
            elif len(s) >= n:
                out[i] = s[:n]
            elif not p:
                out[i] = s
            else:
                fill = (p * ((n - len(s)) // len(p) + 1))[:n - len(s)]
                out[i] = fill + s if self.left_side else s + fill
        return HostColumn(T.StringT, out, validity)


class StringRPad(StringLPad):
    left_side = False


class StringTranslate(Expression):
    """translate(src, match, replace): per-char mapping; match chars
    beyond len(replace) are deleted."""

    def __init__(self, child: Expression, match: Expression,
                 replace: Expression):
        self.children = [child, match, replace]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if not validity[i]:
                continue
            m, r = cols[1].data[i], cols[2].data[i]
            # first occurrence of a duplicated matching char wins
            # (Spark/Hive semantics; mirrors the device kernel)
            table = {}
            for j, ch in enumerate(m):
                table.setdefault(ord(ch), r[j] if j < len(r) else None)
            out[i] = cols[0].data[i].translate(table)
        return HostColumn(T.StringT, out, validity)


class StringReplace(Expression):
    """replace(str, search, replace): empty search returns the input."""

    def __init__(self, child: Expression, search: Expression,
                 replace: Expression):
        self.children = [child, search, replace]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.full(batch.num_rows, "", dtype=object)
        for i in range(batch.num_rows):
            if validity[i]:
                s, f, r = (cols[0].data[i], cols[1].data[i],
                           cols[2].data[i])
                out[i] = s.replace(f, r) if f else s
        return HostColumn(T.StringT, out, validity)


class StringInstr(BinaryExpression):
    """instr(str, substr): 1-based position of first occurrence, 0 when
    absent, 1 for the empty substring."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        sc, pc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([sc, pc])
        out = np.zeros(batch.num_rows, dtype=np.int32)
        for i in range(batch.num_rows):
            if validity[i]:
                out[i] = sc.data[i].find(pc.data[i]) + 1
        return HostColumn(T.IntegerT, out, validity).normalized()


class StringLocate(Expression):
    """locate(substr, str, pos): search from 1-based `pos`; pos < 1
    yields 0 (Spark StringLocate)."""

    def __init__(self, substr: Expression, child: Expression,
                 pos: Expression):
        self.children = [substr, child, pos]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        validity = _combined_validity(cols)
        out = np.zeros(batch.num_rows, dtype=np.int32)
        for i in range(batch.num_rows):
            if not validity[i]:
                continue
            sub, s, pos = cols[0].data[i], cols[1].data[i], int(
                cols[2].data[i])
            if pos < 1:
                out[i] = 0
            else:
                out[i] = s.find(sub, pos - 1) + 1
        return HostColumn(T.IntegerT, out, validity).normalized()


class InitCap(StringUnary):
    """First character of each space-separated word uppercased, the rest
    lowercased (UTF8String.toTitleCase semantics)."""

    def fn(self, s: str) -> str:
        out = []
        prev_space = True
        for ch in s:
            out.append(ch.upper() if prev_space else ch.lower())
            prev_space = ch == " "
        return "".join(out)


class StringReverse(StringUnary):
    def fn(self, s: str) -> str:
        return s[::-1]


class StringTrimLeft(StringUnary):
    def fn(self, s: str) -> str:
        return s.lstrip(" ")


class StringTrimRight(StringUnary):
    def fn(self, s: str) -> str:
        return s.rstrip(" ")


class Ascii(UnaryExpression):
    """Codepoint of the first character (0 for the empty string)."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        out = np.zeros(len(c.data), dtype=np.int32)
        for i in range(len(c.data)):
            if c.validity[i] and c.data[i]:
                out[i] = ord(c.data[i][0])
        return HostColumn(T.IntegerT, out, c.validity.copy()).normalized()


class Chr(UnaryExpression):
    """chr(n): the character of codepoint n % 256 (empty for n < 0)."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        out = np.full(len(c.data), "", dtype=object)
        for i in range(len(c.data)):
            if c.validity[i]:
                n = int(c.data[i])
                out[i] = "" if n < 0 else chr(n % 256)
        return HostColumn(T.StringT, out, c.validity.copy())


# ---------------------------------------------------------------------------
# Date/time (DateType = days since epoch; TimestampType = micros UTC;
# mirrors datetimeExpressions.scala)
# ---------------------------------------------------------------------------

_EPOCH_ORD = 719163  # datetime.date(1970,1,1).toordinal()


def _days_to_ymd(days: np.ndarray):
    # Proleptic Gregorian, vectorized civil-from-days (Howard Hinnant's algo)
    z = days.astype(np.int64) + 719468
    era = np.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    y = np.where(m <= 2, y + 1, y)
    return y.astype(np.int64), m.astype(np.int64), d.astype(np.int64)


class DateTimeField(UnaryExpression):
    field = "year"

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def _days(self, c: HostColumn) -> np.ndarray:
        if isinstance(self.child.data_type, T.TimestampType):
            micros = c.data.astype(np.int64)
            return np.floor_divide(micros, 86_400_000_000)
        return c.data.astype(np.int64)

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        y, m, d = _days_to_ymd(self._days(c))
        data = {"year": y, "month": m, "dayofmonth": d}[self.field]
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class Year(DateTimeField):
    field = "year"


class Month(DateTimeField):
    field = "month"


class DayOfMonth(DateTimeField):
    field = "dayofmonth"


class TimeField(UnaryExpression):
    divisor = 1
    modulus = 1

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        micros = c.data.astype(np.int64)
        sec_of_day = np.mod(np.floor_divide(micros, 1_000_000), 86400)
        data = np.mod(np.floor_divide(sec_of_day, self.divisor), self.modulus)
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class Hour(TimeField):
    divisor, modulus = 3600, 24


class Minute(TimeField):
    divisor, modulus = 60, 60


class Second(TimeField):
    divisor, modulus = 1, 60


class DateAdd(BinaryExpression):
    def __init__(self, start: Expression, days: Expression):
        self.children = [start, days]

    @property
    def data_type(self) -> T.DataType:
        return T.DateT

    def eval(self, batch: HostBatch) -> HostColumn:
        sc, dc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([sc, dc])
        data = (sc.data.astype(np.int64)
                + dc.data.astype(np.int64)).astype(np.int32)
        return HostColumn(T.DateT, data, validity).normalized()


class DateSub(DateAdd):
    def eval(self, batch: HostBatch) -> HostColumn:
        sc, dc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([sc, dc])
        data = (sc.data.astype(np.int64)
                - dc.data.astype(np.int64)).astype(np.int32)
        return HostColumn(T.DateT, data, validity).normalized()


class DateDiff(BinaryExpression):
    def __init__(self, end: Expression, start: Expression):
        self.children = [end, start]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    def eval(self, batch: HostBatch) -> HostColumn:
        ec, sc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([ec, sc])
        data = (ec.data.astype(np.int64)
                - sc.data.astype(np.int64)).astype(np.int32)
        return HostColumn(T.IntegerT, data, validity).normalized()


def _ymd_to_days(y: np.ndarray, m: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Inverse of _days_to_ymd (Hinnant's days-from-civil), vectorized."""
    y = y.astype(np.int64) - (m <= 2)
    era = np.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = np.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _days_in_month(y: np.ndarray, m: np.ndarray) -> np.ndarray:
    lengths = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       dtype=np.int64)
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    return lengths[m - 1] + ((m == 2) & leap)


class Quarter(DateTimeField):
    field = "quarter"

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        _y, m, _d = _days_to_ymd(self._days(c))
        data = (m - 1) // 3 + 1
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class DayOfWeek(DateTimeField):
    """1 = Sunday .. 7 = Saturday (Spark DayOfWeek)."""
    field = "dayofweek"

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        days = self._days(c)
        data = np.mod(days + 4, 7) + 1  # epoch day 0 was a Thursday
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class WeekDay(DateTimeField):
    """0 = Monday .. 6 = Sunday (Spark WeekDay)."""
    field = "weekday"

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        days = self._days(c)
        data = np.mod(days + 3, 7)
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class DayOfYear(DateTimeField):
    field = "dayofyear"

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        days = self._days(c)
        y, _m, _d = _days_to_ymd(days)
        jan1 = _ymd_to_days(y, np.ones_like(y), np.ones_like(y))
        data = days - jan1 + 1
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class WeekOfYear(DateTimeField):
    """ISO-8601 week number (Spark WeekOfYear)."""
    field = "weekofyear"

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        days = self._days(c)
        # the Thursday of this date's ISO week decides the week-year
        thursday = days + 3 - np.mod(days + 3, 7)
        ty, _m, _d = _days_to_ymd(thursday)
        jan1 = _ymd_to_days(ty, np.ones_like(ty), np.ones_like(ty))
        data = (thursday - jan1) // 7 + 1
        return HostColumn(T.IntegerT, data.astype(np.int32),
                          c.validity.copy()).normalized()


class LastDay(UnaryExpression):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.DateT

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        days = c.data.astype(np.int64)
        y, m, _d = _days_to_ymd(days)
        data = _ymd_to_days(y, m, _days_in_month(y, m)).astype(np.int32)
        return HostColumn(T.DateT, data, c.validity.copy()).normalized()


class AddMonths(BinaryExpression):
    """add_months: day-of-month clamps to the target month's last day."""

    def __init__(self, start: Expression, months: Expression):
        self.children = [start, months]

    @property
    def data_type(self) -> T.DataType:
        return T.DateT

    def eval(self, batch: HostBatch) -> HostColumn:
        sc, mc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([sc, mc])
        y, m, d = _days_to_ymd(sc.data.astype(np.int64))
        total = (y * 12 + (m - 1)) + mc.data.astype(np.int64)
        ny = total // 12  # numpy // already floors for negatives
        nm = total - ny * 12 + 1
        nd = np.minimum(d, _days_in_month(ny, nm))
        data = _ymd_to_days(ny, nm, nd).astype(np.int32)
        return HostColumn(T.DateT, data, validity).normalized()


class MonthsBetween(BinaryExpression):
    """months_between(end, start): whole months when both fall on the
    same day-of-month or both on month-ends, else 31-day fractional
    months; result rounded to 8 places (Spark roundOff default)."""

    def __init__(self, end: Expression, start: Expression):
        self.children = [end, start]

    @property
    def data_type(self) -> T.DataType:
        return T.DoubleT

    @staticmethod
    def _parts(col: HostColumn, dtype: T.DataType):
        if isinstance(dtype, T.TimestampType):
            micros = col.data.astype(np.int64)
            days = np.floor_divide(micros, 86_400_000_000)
            sec = (micros - days * 86_400_000_000) / 1e6
        else:
            days = col.data.astype(np.int64)
            sec = np.zeros(len(col.data))
        y, m, d = _days_to_ymd(days)
        return y, m, d, sec

    def eval(self, batch: HostBatch) -> HostColumn:
        ec, sc = self.left.eval(batch), self.right.eval(batch)
        validity = _combined_validity([ec, sc])
        y1, m1, d1, s1 = self._parts(ec, self.left.data_type)
        y2, m2, d2, s2 = self._parts(sc, self.right.data_type)
        month_diff = (y1 - y2) * 12.0 + (m1 - m2)
        both_last = (d1 == _days_in_month(y1, m1)) & \
                    (d2 == _days_in_month(y2, m2))
        aligned = (d1 == d2) | both_last
        frac = ((d1 - d2) * 86400.0 + (s1 - s2)) / (31.0 * 86400.0)
        data = np.where(aligned, month_diff, month_diff + frac)
        data = np.round(data, 8)
        return HostColumn(T.DoubleT, data, validity).normalized()


class TruncDate(BinaryExpression):
    """trunc(date, fmt): fmt in year/yyyy/yy, quarter, month/mon/mm,
    week; unknown fmt -> null (Spark TruncDate)."""

    def __init__(self, child: Expression, fmt: Expression):
        self.children = [child, fmt]

    @property
    def data_type(self) -> T.DataType:
        return T.DateT

    def eval(self, batch: HostBatch) -> HostColumn:
        c, fc = self.left.eval(batch), self.right.eval(batch)
        days = c.data.astype(np.int64)
        y, m, _d = _days_to_ymd(days)
        out = np.zeros(len(days), dtype=np.int64)
        validity = _combined_validity([c, fc])
        ones = np.ones_like(y)
        year_start = _ymd_to_days(y, ones, ones)
        month_start = _ymd_to_days(y, m, ones)
        q_month = ((m - 1) // 3) * 3 + 1
        quarter_start = _ymd_to_days(y, q_month, ones)
        week_start = days - np.mod(days + 3, 7)  # Monday
        for i in range(len(days)):
            if not validity[i]:
                continue
            f = fc.data[i].lower()
            if f in ("year", "yyyy", "yy"):
                out[i] = year_start[i]
            elif f in ("month", "mon", "mm"):
                out[i] = month_start[i]
            elif f == "quarter":
                out[i] = quarter_start[i]
            elif f == "week":
                out[i] = week_start[i]
            else:
                validity[i] = False
        return HostColumn(T.DateT, out.astype(np.int32),
                          validity).normalized()


# Restricted datetime pattern support shared by CPU and device paths:
# literal text plus the unambiguous numeric tokens. Anything else falls
# back (device tags to CPU; CPU raises).
_DT_TOKENS = ("yyyy", "MM", "dd", "HH", "mm", "ss")


def parse_dt_pattern(fmt: str) -> Optional[List[Tuple[str, str]]]:
    """[(kind, text)] where kind is 'lit' or a token; None when the
    pattern uses anything outside the supported subset."""
    out: List[Tuple[str, str]] = []
    i = 0
    while i < len(fmt):
        for tok in _DT_TOKENS:
            if fmt.startswith(tok, i):
                out.append((tok, tok))
                i += len(tok)
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                return None  # unsupported pattern letter
            out.append(("lit", ch))
            i += 1
    return out


DEFAULT_TS_FMT = "yyyy-MM-dd HH:mm:ss"


def _format_micros(micros: np.ndarray, validity: np.ndarray,
                   parts: List[Tuple[str, str]]) -> np.ndarray:
    days = np.floor_divide(micros, 86_400_000_000)
    sec_of_day = np.floor_divide(micros - days * 86_400_000_000, 1_000_000)
    y, m, d = _days_to_ymd(days)
    # fixed-width digit formatting only represents years 0-9999; rows
    # outside become null on BOTH engines so CPU and device agree
    # (documented deviation from Spark's signed 5+-digit year output)
    validity = validity & (y >= 0) & (y <= 9999)
    fields = {
        "yyyy": (y, 4), "MM": (m, 2), "dd": (d, 2),
        "HH": (sec_of_day // 3600, 2), "mm": (sec_of_day // 60 % 60, 2),
        "ss": (sec_of_day % 60, 2),
    }
    n = len(micros)
    out = np.full(n, "", dtype=object)
    pieces = []
    for kind, text in parts:
        if kind == "lit":
            pieces.append(np.full(n, text, dtype=object))
        else:
            vals, width = fields[kind]
            pieces.append(np.char.zfill(
                vals.astype(np.int64).astype("U16"), width).astype(object))
    for i in range(n):
        if validity[i]:
            out[i] = "".join(p[i] for p in pieces)
    return out


def _parse_with_pattern(strings: np.ndarray, validity: np.ndarray,
                        parts: List[Tuple[str, str]]):
    """Parse per the token list; returns (micros, ok). Lenient like
    Spark's legacy parser about trailing text only when the pattern
    consumed everything."""
    n = len(strings)
    micros = np.zeros(n, dtype=np.int64)
    ok = validity.copy()
    for i in range(n):
        if not ok[i]:
            continue
        s = str(strings[i])
        pos = 0
        vals = {"yyyy": 1970, "MM": 1, "dd": 1, "HH": 0, "mm": 0, "ss": 0}
        good = True
        for kind, text in parts:
            if kind == "lit":
                if pos < len(s) and s[pos] == text:
                    pos += 1
                else:
                    good = False
                    break
            else:
                width = 4 if kind == "yyyy" else 2
                chunk = s[pos:pos + width]
                if len(chunk) == width and chunk.isdigit():
                    vals[kind] = int(chunk)
                    pos += width
                else:
                    good = False
                    break
        if not good or pos != len(s):
            ok[i] = False
            continue
        if not (1 <= vals["MM"] <= 12 and 1 <= vals["dd"] <= 31
                and vals["HH"] < 24 and vals["mm"] < 60
                and vals["ss"] < 60):
            ok[i] = False
            continue
        day = _ymd_to_days(np.array([vals["yyyy"]]), np.array([vals["MM"]]),
                           np.array([vals["dd"]]))[0]
        micros[i] = ((day * 86400 + vals["HH"] * 3600 + vals["mm"] * 60
                      + vals["ss"]) * 1_000_000)
    return micros, ok


class DateFormatClass(BinaryExpression):
    """date_format(ts, fmt) over the supported token subset."""

    def __init__(self, child: Expression, fmt: Expression):
        self.children = [child, fmt]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def _micros(self, c: HostColumn) -> np.ndarray:
        if isinstance(self.left.data_type, T.DateType):
            return c.data.astype(np.int64) * 86_400_000_000
        return c.data.astype(np.int64)

    def eval(self, batch: HostBatch) -> HostColumn:
        c, fc = self.left.eval(batch), self.right.eval(batch)
        assert isinstance(self.right, Literal), \
            "date_format pattern must be a literal"
        parts = parse_dt_pattern(self.right.value)
        if parts is None:
            raise NotImplementedError(
                f"unsupported datetime pattern {fc.data[0]!r}")
        validity = _combined_validity([c, fc])
        out = _format_micros(self._micros(c), validity, parts)
        return HostColumn(T.StringT, out, validity)


class UnixTimestamp(BinaryExpression):
    """unix_timestamp(col, fmt) -> long seconds; strings parse with the
    pattern (null on failure), dates/timestamps convert directly."""
    pretty = "unix_timestamp"

    def __init__(self, child: Expression, fmt: Expression):
        self.children = [child, fmt]

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    def eval(self, batch: HostBatch) -> HostColumn:
        c, fc = self.left.eval(batch), self.right.eval(batch)
        src = self.left.data_type
        if isinstance(src, T.DateType):
            data = c.data.astype(np.int64) * 86400
            return HostColumn(T.LongT, data, c.validity.copy()).normalized()
        if isinstance(src, T.TimestampType):
            data = np.floor_divide(c.data.astype(np.int64), 1_000_000)
            return HostColumn(T.LongT, data, c.validity.copy()).normalized()
        assert isinstance(self.right, Literal), \
            "unix_timestamp pattern must be a literal"
        parts = parse_dt_pattern(self.right.value)
        if parts is None:
            raise NotImplementedError(
                f"unsupported datetime pattern {fc.data[0]!r}")
        validity = _combined_validity([c, fc])
        micros, ok = _parse_with_pattern(c.data, validity, parts)
        return HostColumn(T.LongT, np.floor_divide(micros, 1_000_000),
                          ok).normalized()


class FromUnixTime(BinaryExpression):
    """from_unixtime(seconds, fmt) -> formatted string (UTC session)."""

    def __init__(self, child: Expression, fmt: Expression):
        self.children = [child, fmt]

    @property
    def data_type(self) -> T.DataType:
        return T.StringT

    def eval(self, batch: HostBatch) -> HostColumn:
        c, fc = self.left.eval(batch), self.right.eval(batch)
        assert isinstance(self.right, Literal), \
            "from_unixtime pattern must be a literal"
        parts = parse_dt_pattern(self.right.value)
        if parts is None:
            raise NotImplementedError(
                f"unsupported datetime pattern {fc.data[0]!r}")
        validity = _combined_validity([c, fc])
        out = _format_micros(c.data.astype(np.int64) * 1_000_000,
                             validity, parts)
        return HostColumn(T.StringT, out, validity)


class GetTimestamp(BinaryExpression):
    """to_date/to_timestamp(col, fmt): pattern-parse to TimestampType
    (to_date wraps this in a Cast to date, like Spark's ParseToDate)."""

    def __init__(self, child: Expression, fmt: Expression):
        self.children = [child, fmt]

    @property
    def data_type(self) -> T.DataType:
        return T.TimestampT

    def eval(self, batch: HostBatch) -> HostColumn:
        c, fc = self.left.eval(batch), self.right.eval(batch)
        assert isinstance(self.right, Literal), \
            "to_date/to_timestamp pattern must be a literal"
        parts = parse_dt_pattern(self.right.value)
        if parts is None:
            raise NotImplementedError(
                f"unsupported datetime pattern {fc.data[0]!r}")
        validity = _combined_validity([c, fc])
        micros, ok = _parse_with_pattern(c.data, validity, parts)
        return HostColumn(T.TimestampT, micros, ok).normalized()


# ---------------------------------------------------------------------------
# Hash
# ---------------------------------------------------------------------------

class Murmur3Hash(Expression):
    """Spark Murmur3Hash(seed=42) over columns left-to-right; the rewrite
    maps this to the device twin in kernels/hashing.py
    (reference: GpuMurmur3Hash, HashFunctions.scala)."""

    def __init__(self, children: List[Expression], seed: int = 42):
        self.children = list(children)
        self.seed = seed

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        n = batch.num_rows
        h = np.full(n, self.seed, dtype=np.int32)
        for child in self.children:
            c = child.eval(batch)
            h = _hash_column(c, h)
        return HostColumn.all_valid(h, T.IntegerT)


def _hash_column(c: HostColumn, seed: np.ndarray) -> np.ndarray:
    dt = c.dtype
    if isinstance(dt, (T.StringType, T.BinaryType)):
        out = seed.copy()
        for i in range(len(c.data)):
            if c.validity[i]:
                raw = (c.data[i].encode("utf-8")
                       if isinstance(c.data[i], str) else bytes(c.data[i]))
                out[i] = murmur3.hash_bytes_one(raw, int(seed[i]))
        return out
    if isinstance(dt, T.BooleanType):
        h = murmur3.hash_int(c.data.astype(np.int32), seed)
    elif isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType, T.DateType)):
        h = murmur3.hash_int(c.data.astype(np.int32), seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = murmur3.hash_long(c.data.astype(np.int64), seed)
    elif isinstance(dt, T.FloatType):
        h = murmur3.hash_float(c.data, seed)
    elif isinstance(dt, T.DoubleType):
        h = murmur3.hash_double(c.data, seed)
    elif isinstance(dt, T.DecimalType) and dt.precision <= 18:
        h = murmur3.hash_long(c.data.astype(np.int64), seed)
    elif isinstance(dt, T.DecimalType):
        # Spark hashes a big decimal as the minimal big-endian
        # two's-complement bytes of its unscaled value
        # (Murmur3Hash.computeHash on Decimal, hash.scala)
        from spark_rapids_tpu_torch.ops import int128 as I
        ints = I.to_pyints(np.ascontiguousarray(c.data[:, 0]),
                           np.ascontiguousarray(c.data[:, 1]))
        out = seed.copy()
        for i in range(len(ints)):
            if c.validity[i]:
                v = int(ints[i])
                # BigInteger.toByteArray length: bitLength/8 + 1, where
                # bitLength excludes the sign bit (negatives count the
                # bits of minimal two's complement)
                bl = v.bit_length() if v >= 0 else (-v - 1).bit_length()
                raw = v.to_bytes(bl // 8 + 1, "big", signed=True)
                out[i] = murmur3.hash_bytes_one(raw, int(seed[i]))
        return out
    elif isinstance(dt, T.StructType):
        # Spark hashes a struct by folding murmur3 over its fields with
        # the running hash as each field's seed; null fields keep the
        # seed (HashExpression.computeHash on struct)
        out = seed.copy()
        from spark_rapids_tpu_torch.columnar.host import struct_field_values
        from spark_rapids_tpu_torch.columnar.transfer import \
            _col_from_storage_values
        for fi, f in enumerate(dt.fields):
            fc = _col_from_storage_values(
                struct_field_values(c, fi), f.data_type)
            # only valid STRUCT rows advance their hash
            nh = _hash_column(fc, out)
            out = np.where(c.validity, nh, out)
        return out
    else:
        raise TypeError(f"cannot hash {dt}")
    return np.where(c.validity, h, seed)


# ---------------------------------------------------------------------------
# Collections (collectionOperations.scala, complexTypeCreator/Extractor
# twins) + generators (GpuGenerateExec.scala:440)
# ---------------------------------------------------------------------------

class CreateArray(Expression):
    """array(e1, e2, ...): never null; null inputs become null elements."""

    def __init__(self, children: List[Expression]):
        self.children = list(children)

    @property
    def data_type(self) -> T.DataType:
        et = self.children[0].data_type if self.children else T.NullT
        return T.ArrayType(et)

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        out = np.empty(batch.num_rows, dtype=object)
        for i in range(batch.num_rows):
            out[i] = tuple(
                (c.data[i].item() if isinstance(c.data[i], np.generic)
                 else c.data[i]) if c.validity[i] else None
                for c in cols)
        return HostColumn(self.data_type, out,
                          np.ones(batch.num_rows, dtype=bool))


class CreateNamedStruct(Expression):
    """struct(c1, c2, ...) / named_struct: never-null struct whose
    fields keep the children's names and null-ness
    (complexTypeCreator.scala GpuCreateNamedStruct role)."""

    def __init__(self, names: List[str], children: List[Expression]):
        self.names = list(names)
        self.children = list(children)

    @property
    def pretty_name(self) -> str:
        return "named_struct"

    @property
    def data_type(self) -> T.DataType:
        return T.StructType([
            T.StructField(n, c.data_type, True)
            for n, c in zip(self.names, self.children)])

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        from spark_rapids_tpu_torch.columnar.host import struct_storage_rows
        cols = [c.eval(batch) for c in self.children]
        n = batch.num_rows
        validity = np.ones(n, dtype=bool)
        return HostColumn(self.data_type,
                          struct_storage_rows(cols, validity), validity)


class GetStructField(UnaryExpression):
    """struct.field extraction (complexTypeExtractors.scala
    GpuGetStructField role). The ordinal resolves lazily from the field
    name so the expression can be built over an unresolved column."""

    def __init__(self, child: Expression, ordinal: Optional[int] = None,
                 name: Optional[str] = None):
        assert ordinal is not None or name is not None
        self.children = [child]
        self._ordinal = ordinal
        self.field_name = name

    @property
    def ordinal(self) -> int:
        if self._ordinal is None:
            dt = self.children[0].data_type
            self._ordinal = next(
                i for i, f in enumerate(dt.fields)
                if f.name == self.field_name)
        return self._ordinal

    @property
    def pretty_name(self) -> str:
        if self.field_name is not None:
            return self.field_name
        return self.children[0].data_type.fields[self.ordinal].name

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type.fields[self.ordinal].data_type

    def eval(self, batch: HostBatch) -> HostColumn:
        from spark_rapids_tpu_torch.columnar.host import struct_field_values
        from spark_rapids_tpu_torch.columnar.transfer import \
            _col_from_storage_values
        c = self.children[0].eval(batch)
        return _col_from_storage_values(
            struct_field_values(c, self.ordinal),
            self.data_type).normalized()


class TimeWindow(UnaryExpression):
    """window(ts, duration[, slide, start]) for TUMBLING windows
    (slide == duration): struct<start:timestamp, end:timestamp> with
    start = ts - floorMod(ts - startTime, duration) in microseconds
    (Spark TimeWindow / GpuOverrides TimeWindow rule role). Sliding
    windows (slide < duration) emit multiple rows per input and are not
    supported."""

    def __init__(self, child: Expression, window_us: int,
                 start_us: int = 0):
        self.children = [child]
        self.window_us = int(window_us)
        self.start_us = int(start_us)

    @property
    def pretty_name(self) -> str:
        return "window"

    @property
    def data_type(self) -> T.DataType:
        return T.StructType([T.StructField("start", T.TimestampT, True),
                             T.StructField("end", T.TimestampT, True)])

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.children[0].eval(batch)
        ts = c.data.astype(np.int64)
        w = np.int64(self.window_us)
        # numpy % already floor-mods like Spark's Math.floorMod
        start = ts - np.mod(ts - np.int64(self.start_us), w)
        end = start + w
        out = np.empty(batch.num_rows, dtype=object)
        for i in range(batch.num_rows):
            out[i] = ((int(start[i]), int(end[i]))
                      if c.validity[i] else ())
        return HostColumn(self.data_type, out, c.validity.copy())


class Size(UnaryExpression):
    """size(array): element count; null input -> -1 (legacy Spark
    default spark.sql.legacy.sizeOfNull=true semantics)."""

    LEGACY_NULL = -1

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        out = np.full(len(c.data), self.LEGACY_NULL, dtype=np.int32)
        for i in range(len(c.data)):
            if c.validity[i]:
                out[i] = len(c.data[i])
        return HostColumn.all_valid(out, T.IntegerT)


class ElementAt(BinaryExpression):
    """element_at(array, i): 1-based, negative from the end; null when
    out of range (non-ANSI)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return self.left.data_type.element_type

    def eval(self, batch: HostBatch) -> HostColumn:
        ac, ic = self.left.eval(batch), self.right.eval(batch)
        n = len(ac.data)
        np_dt = T.numpy_dtype(self.data_type)
        validity = np.zeros(n, dtype=bool)
        fill = "" if np_dt == np.dtype(object) else _zero_for_np(np_dt)
        data = np.full(n, fill, dtype=np_dt)
        for i in range(n):
            if not (ac.validity[i] and ic.validity[i]):
                continue
            arr, idx = ac.data[i], int(ic.data[i])
            if idx == 0 or abs(idx) > len(arr):
                continue
            v = arr[idx - 1] if idx > 0 else arr[idx]
            if v is not None:
                validity[i] = True
                data[i] = v
        return HostColumn(self.data_type, data, validity).normalized()


class GetArrayItem(ElementAt):
    """array[i]: 0-based ordinal access (null when out of range)."""

    def eval(self, batch: HostBatch) -> HostColumn:
        ac, ic = self.left.eval(batch), self.right.eval(batch)
        n = len(ac.data)
        np_dt = T.numpy_dtype(self.data_type)
        validity = np.zeros(n, dtype=bool)
        fill = "" if np_dt == np.dtype(object) else _zero_for_np(np_dt)
        data = np.full(n, fill, dtype=np_dt)
        for i in range(n):
            if not (ac.validity[i] and ic.validity[i]):
                continue
            arr, idx = ac.data[i], int(ic.data[i])
            if idx < 0 or idx >= len(arr):
                continue
            v = arr[idx]
            if v is not None:
                validity[i] = True
                data[i] = v
        return HostColumn(self.data_type, data, validity).normalized()


class ArrayContains(BinaryExpression):
    """array_contains(array, value): 3-valued like IN (null when absent
    but null elements exist)."""

    def __init__(self, left: Expression, right: Expression):
        self.children = [left, right]

    @property
    def data_type(self) -> T.DataType:
        return T.BooleanT

    def eval(self, batch: HostBatch) -> HostColumn:
        ac, vc = self.left.eval(batch), self.right.eval(batch)
        n = len(ac.data)
        validity = np.zeros(n, dtype=bool)
        data = np.zeros(n, dtype=bool)
        for i in range(n):
            if not (ac.validity[i] and vc.validity[i]):
                continue
            arr = ac.data[i]
            target = vc.data[i]
            if isinstance(target, np.generic):
                target = target.item()
            found = any(x is not None and x == target for x in arr)
            has_null = any(x is None for x in arr)
            if found:
                validity[i], data[i] = True, True
            elif not has_null:
                validity[i] = True
        return HostColumn(T.BooleanT, data, validity).normalized()


def _zero_for_np(np_dt) -> Any:
    if np_dt == np.dtype(bool):
        return False
    if np.issubdtype(np_dt, np.floating):
        return 0.0
    return 0


class Explode(UnaryExpression):
    """Generator: one output row per array element (GpuGenerateExec
    role). ``position`` adds the pos column (posexplode); ``outer``
    keeps empty/null arrays as one null row."""

    is_generator = True

    def __init__(self, child: Expression, position: bool = False,
                 outer: bool = False):
        self.children = [child]
        self.position = position
        self.outer = outer

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type.element_type

    def generator_output(self, col_name: str = "col"
                         ) -> List["AttributeReference"]:
        out = []
        if self.position:
            out.append(AttributeReference("pos", T.IntegerT,
                                          nullable=False))
        out.append(AttributeReference(col_name, self.data_type))
        return out


class XxHash64(Expression):
    """Spark XxHash64(seed=42L) over columns left-to-right (reference:
    GpuXxHash64, HashFunctions.scala); device twin in ops/hashing.py,
    host twin in columnar/xxhash64.py."""

    def __init__(self, children: List[Expression], seed: int = 42):
        self.children = list(children)
        self.seed = seed

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    @property
    def nullable(self) -> bool:
        return False

    def eval(self, batch: HostBatch) -> HostColumn:
        from spark_rapids_tpu_torch.columnar import xxhash64
        n = batch.num_rows
        h = np.full(n, self.seed, dtype=np.int64)
        for child in self.children:
            c = child.eval(batch)
            h = _xx_hash_column(c, h, xxhash64)
        return HostColumn.all_valid(h, T.LongT)


def _xx_hash_column(c: HostColumn, seed: np.ndarray, xx) -> np.ndarray:
    dt = c.dtype
    if isinstance(dt, (T.StringType, T.BinaryType)):
        out = seed.copy()
        for i in range(len(c.data)):
            if c.validity[i]:
                raw = (c.data[i].encode("utf-8")
                       if isinstance(c.data[i], str) else bytes(c.data[i]))
                out[i] = xx.hash_bytes_one(raw, int(seed[i]))
        return out
    if isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                       T.IntegerType, T.DateType)):
        h = xx.hash_int(c.data.astype(np.int32), seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = xx.hash_long(c.data.astype(np.int64), seed)
    elif isinstance(dt, T.FloatType):
        h = xx.hash_float(c.data, seed)
    elif isinstance(dt, T.DoubleType):
        h = xx.hash_double(c.data, seed)
    elif isinstance(dt, T.DecimalType) and dt.precision <= 18:
        h = xx.hash_long(c.data.astype(np.int64), seed)
    else:
        raise TypeError(f"cannot xxhash {dt}")
    return np.where(c.validity, h, seed)


# ---------------------------------------------------------------------------
# Cast (GpuCast.scala:1338 equivalent; the CastChecks matrix in typesig.py
# gates which directions the device may take)
# ---------------------------------------------------------------------------

class Cast(UnaryExpression):
    def __init__(self, child: Expression, dtype: T.DataType,
                 ansi: bool = False):
        self.children = [child]
        self._dtype = dtype
        self.ansi = ansi

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    def eval(self, batch: HostBatch) -> HostColumn:
        c = self.child.eval(batch)
        return cast_host_column(c, self._dtype, self.ansi)

    def __repr__(self) -> str:
        return f"cast({self.child!r} as {self._dtype.simple_string})"


def cast_host_column(c: HostColumn, to: T.DataType, ansi: bool = False
                     ) -> HostColumn:
    frm = c.dtype
    if frm == to:
        return c
    if isinstance(frm, T.NullType):
        return HostColumn.nulls(len(c), to)

    # numeric -> numeric
    if T.is_numeric(frm) and T.is_numeric(to) and not isinstance(
            to, T.DecimalType) and not isinstance(frm, T.DecimalType):
        return _cast_numeric(c, to, ansi)
    # bool -> numeric
    if isinstance(frm, T.BooleanType) and T.is_numeric(to):
        data = c.data.astype(T.numpy_dtype(to))
        return HostColumn(to, data, c.validity.copy())
    # numeric -> bool
    if T.is_numeric(frm) and isinstance(to, T.BooleanType):
        return HostColumn(to, c.data != 0, c.validity.copy())
    # anything -> string
    if isinstance(to, T.StringType):
        return _cast_to_string(c)
    # string -> *
    if isinstance(frm, T.StringType):
        return _cast_from_string(c, to, ansi)
    # date/timestamp conversions
    if isinstance(frm, T.DateType) and isinstance(to, T.TimestampType):
        data = c.data.astype(np.int64) * 86_400_000_000
        return HostColumn(to, data, c.validity.copy())
    if isinstance(frm, T.TimestampType) and isinstance(to, T.DateType):
        data = np.floor_divide(c.data.astype(np.int64),
                               86_400_000_000).astype(np.int32)
        return HostColumn(to, data, c.validity.copy())
    # decimal <-> numeric (decimal64 path)
    if isinstance(to, T.DecimalType):
        return _cast_to_decimal(c, to, ansi)
    if isinstance(frm, T.DecimalType):
        return _cast_from_decimal(c, to, ansi)
    raise TypeError(f"unsupported cast {frm} -> {to}")


def _cast_numeric(c: HostColumn, to: T.DataType, ansi: bool) -> HostColumn:
    np_to = T.numpy_dtype(to)
    src = c.data
    validity = c.validity.copy()
    if np.issubdtype(src.dtype, np.floating) and not T.is_floating(to):
        # Java double->int semantics: NaN -> 0, saturate at bounds,
        # truncate toward zero (Spark non-ANSI Cast). Long.MAX is not
        # representable as double, so saturate via threshold compares.
        info = np.iinfo(np_to)
        as_long = _java_double_to_long(np.trunc(src))
        data = np.clip(as_long, info.min, info.max).astype(np_to)
        if ansi:
            # bound compares (exact 2^k floats) — round-trip compares
            # miss values that round back onto the clipped result (2^63)
            with np.errstate(all="ignore"):
                t = np.trunc(src)
                bad = (np.isnan(src) | (t >= np.float64(info.max) + 1.0)
                       | (t < np.float64(info.min)))
            if (bad & validity).any():
                raise ArithmeticError("Cast overflow in ANSI mode")
    else:
        # int narrowing wraps (two's complement), widening exact;
        # int->float may round — all match Java/Spark non-ANSI.
        with np.errstate(all="ignore"):
            data = src.astype(np_to)
        if ansi and np.issubdtype(src.dtype, np.integer) \
                and np.issubdtype(np_to, np.integer) \
                and np_to.itemsize < src.dtype.itemsize:
            bad = data.astype(src.dtype) != src
            if (bad & validity).any():
                raise ArithmeticError("Cast overflow in ANSI mode")
    return HostColumn(to, data, validity)


def _format_double_java(v: float) -> str:
    """Approximate Java Double.toString (Spark cast double->string).
    Gated behind castFloatToString like the reference."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == int(v) and abs(v) < 1e7:
        return f"{int(v)}.0"
    r = repr(float(v))
    if "e" in r:
        mant, exp = r.split("e")
        e = int(exp)
        if "." not in mant:
            mant += ".0"
        return f"{mant}E{e}"
    return r


def _cast_to_string(c: HostColumn) -> HostColumn:
    frm = c.dtype
    out = np.full(len(c), "", dtype=object)
    if isinstance(frm, T.BooleanType):
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = "true" if c.data[i] else "false"
    elif isinstance(frm, T.DateType):
        y, m, d = _days_to_ymd(c.data.astype(np.int64))
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = f"{y[i]:04d}-{m[i]:02d}-{d[i]:02d}"
    elif isinstance(frm, T.TimestampType):
        micros = c.data.astype(np.int64)
        days = np.floor_divide(micros, 86_400_000_000)
        y, m, d = _days_to_ymd(days)
        rem = micros - days * 86_400_000_000
        for i in range(len(c)):
            if c.validity[i]:
                s = int(rem[i] // 1_000_000)
                us = int(rem[i] % 1_000_000)
                base = (f"{y[i]:04d}-{m[i]:02d}-{d[i]:02d} "
                        f"{s // 3600:02d}:{(s // 60) % 60:02d}:{s % 60:02d}")
                if us:
                    base += ("." + f"{us:06d}".rstrip("0"))
                out[i] = base
    elif T.is_floating(frm):
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = _format_double_java(float(c.data[i]))
    elif isinstance(frm, T.DecimalType):
        scale = frm.scale
        for i in range(len(c)):
            if c.validity[i]:
                u = int(c.data[i])
                out[i] = _format_decimal(u, scale)
    elif isinstance(frm, T.StringType):
        return c
    else:
        for i in range(len(c)):
            if c.validity[i]:
                out[i] = str(int(c.data[i]))
    return HostColumn(T.StringT, out, c.validity.copy())


def _format_decimal(unscaled: int, scale: int) -> str:
    sign = "-" if unscaled < 0 else ""
    u = abs(unscaled)
    if scale == 0:
        return f"{sign}{u}"
    s = str(u).rjust(scale + 1, "0")
    return f"{sign}{s[:-scale]}.{s[-scale:]}"


def _cast_from_string(c: HostColumn, to: T.DataType, ansi: bool
                      ) -> HostColumn:
    n = len(c)
    validity = c.validity.copy()
    np_dt = T.numpy_dtype(to)
    if isinstance(to, T.BooleanType):
        data = np.zeros(n, dtype=bool)
        for i in range(n):
            if not validity[i]:
                continue
            s = c.data[i].strip().lower()
            if s in ("t", "true", "y", "yes", "1"):
                data[i] = True
            elif s in ("f", "false", "n", "no", "0"):
                data[i] = False
            else:
                validity[i] = False
        return HostColumn(to, data, validity)
    if T.is_floating(to):
        data = np.zeros(n, dtype=np_dt)
        for i in range(n):
            if not validity[i]:
                continue
            try:
                data[i] = float(c.data[i].strip())
            except ValueError:
                validity[i] = False
        return HostColumn(to, data, validity)
    if T.is_integral(to):
        data = np.zeros(n, dtype=np_dt)
        info = np.iinfo(np_dt)
        for i in range(n):
            if not validity[i]:
                continue
            s = c.data[i].strip()
            try:
                v = int(s)
            except ValueError:
                # Spark accepts "123.45" -> 123 for cast to int? It does
                # truncate decimals in strings (UTF8String.toInt rejects;
                # Cast uses toLongExact on trimmed decimal strings). Keep
                # the common behavior: reject non-integer strings.
                validity[i] = False
                continue
            if v < info.min or v > info.max:
                validity[i] = False
                continue
            data[i] = v
        return HostColumn(to, data, validity)
    if isinstance(to, T.DateType):
        data = np.zeros(n, dtype=np.int32)
        import datetime
        import re as _re
        # ASCII digits only (\d matches Unicode digits, which the device
        # byte-matrix parser rightly rejects)
        pat = _re.compile(r"[+]?([0-9]{1,7})-([0-9]{1,2})-([0-9]{1,2})\Z")
        for i in range(n):
            if not validity[i]:
                continue
            m = pat.match(c.data[i].strip())
            if m is None:
                validity[i] = False
                continue
            try:
                d = datetime.date(int(m.group(1)), int(m.group(2)),
                                  int(m.group(3)))
                data[i] = d.toordinal() - _EPOCH_ORD
            except ValueError:
                validity[i] = False
        return HostColumn(to, data, validity)
    if isinstance(to, T.TimestampType):
        data = np.zeros(n, dtype=np.int64)
        import datetime
        for i in range(n):
            if not validity[i]:
                continue
            s = c.data[i].strip().replace("T", " ")
            try:
                if " " in s:
                    dt = datetime.datetime.fromisoformat(s)
                else:
                    dt = datetime.datetime.fromisoformat(s + " 00:00:00")
                dt = dt.replace(tzinfo=datetime.timezone.utc)
                data[i] = int(dt.timestamp() * 1_000_000)
            except ValueError:
                validity[i] = False
        return HostColumn(to, data, validity)
    if isinstance(to, T.DecimalType):
        data = np.zeros(n, dtype=np.int64)
        import decimal as pydec
        q = pydec.Decimal(1).scaleb(-to.scale)
        for i in range(n):
            if not validity[i]:
                continue
            try:
                d = pydec.Decimal(c.data[i].strip()).quantize(
                    q, rounding=pydec.ROUND_HALF_UP)
                u = int(d.scaleb(to.scale))
                if abs(u) >= 10 ** to.precision:
                    validity[i] = False
                else:
                    data[i] = u
            except pydec.InvalidOperation:
                validity[i] = False
        return HostColumn(to, data, validity)
    raise TypeError(f"unsupported cast string -> {to}")


def _cast_to_decimal(c: HostColumn, to: T.DecimalType, ansi: bool
                     ) -> HostColumn:
    from spark_rapids_tpu_torch.ops import decimal_ops as D
    validity = c.validity.copy()
    frm = c.dtype
    if isinstance(frm, T.DecimalType):
        if D.cast_supported(frm, to):
            hi, lo = _dec_limbs(c)
            hi, lo, ok = D.cast_decimal(np, hi, lo, frm, to)
            if ansi and (~ok & validity).any():
                raise ArithmeticError("Decimal overflow in ANSI mode")
            return _limbs_to_col(hi, lo, validity & ok, to)
        # deep down-rescale: exact Python ints (rare)
        from spark_rapids_tpu_torch.ops import int128 as I
        vals = I.to_pyints(*_dec_limbs(c))
        d = 10 ** (frm.scale - to.scale)
        bound_i = 10 ** to.precision
        out = []
        for v, okv in zip(vals, validity):
            if not okv:
                out.append(None)
                continue
            q, r = divmod(abs(v), d)
            if 2 * r >= d:
                q += 1
            q = q if v >= 0 else -q
            out.append(None if abs(q) >= bound_i else q)
        if ansi and any(v is None for v, okv in zip(out, validity) if okv):
            raise ArithmeticError("Decimal overflow in ANSI mode")
        from decimal import Decimal
        return HostColumn.from_pylist(
            [None if v is None else Decimal(v).scaleb(-to.scale)
             for v in out], to)
    if T.is_integral(frm) or isinstance(frm, T.BooleanType):
        from spark_rapids_tpu_torch.ops import int128 as I
        hi, lo = I.from_i64(np, c.data.astype(np.int64))
        hi, lo, over = D.rescale_up(np, hi, lo, to.scale)
        ok = ~over & I.fits_precision(np, hi, lo, to.precision)
        if ansi and (~ok & validity).any():
            raise ArithmeticError("Decimal overflow in ANSI mode")
        return _limbs_to_col(np.where(ok, hi, 0), np.where(ok, lo, 0),
                             validity & ok, to)
    if T.is_floating(frm):
        bound = 10 ** to.precision
        with np.errstate(all="ignore"):
            scaled = c.data.astype(np.float64) * (10.0 ** to.scale)
            data = (np.sign(scaled) * np.floor(np.abs(scaled) + 0.5))
            over = (np.isnan(scaled) | np.isinf(scaled)
                    | (np.abs(data) >= float(bound)))
            data = np.nan_to_num(data, nan=0.0, posinf=0.0,
                                 neginf=0.0)
            data = np.where(over, 0.0, data)
        if ansi and (over & validity).any():
            raise ArithmeticError("Decimal overflow in ANSI mode")
        validity &= ~over
        # exact limb extraction from the (integral-valued) float: the
        # split v = hi*2^64 + lo is exact float arithmetic, so values
        # beyond 2^63 but within the precision survive (Spark keeps
        # e.g. 1e20 in a decimal(38,0))
        with np.errstate(all="ignore"):
            hi_f = np.floor(data * 2.0 ** -64)
            lo_f = data - hi_f * 2.0 ** 64
        hi = hi_f.astype(np.int64)
        lo = lo_f.astype(np.uint64).astype(np.int64)
        if T.is_limb_decimal(to):
            return _limbs_to_col(hi, lo, validity, to)
        return HostColumn(to, np.where(validity, lo, 0), validity
                          ).normalized()
    raise TypeError(f"cast {frm} -> {to}")


def _cast_from_decimal(c: HostColumn, to: T.DataType, ansi: bool
                       ) -> HostColumn:
    frm = c.dtype
    assert isinstance(frm, T.DecimalType)
    if T.is_limb_decimal(frm):
        from spark_rapids_tpu_torch.ops import int128 as I
        hi, lo = _dec_limbs(c)
        if T.is_floating(to):
            # exact int64 path when the value fits; the 2-term wide sum
            # (within ~1 ulp of correctly rounded) only beyond 64 bits.
            # Multiply by the reciprocal rather than divide: XLA folds a
            # constant-divisor division into exactly this multiply, so
            # doing the same here keeps CPU == device bit-identical
            v64, small = I.to_i64(np, hi, lo)
            ulo = np.asarray(lo).astype(np.uint64).astype(np.float64)
            wide = hi.astype(np.float64) * 2.0 ** 64 + ulo
            data = np.where(small, v64.astype(np.float64), wide) \
                * (1.0 / 10.0 ** frm.scale)
            return HostColumn(to, data.astype(T.numpy_dtype(to)),
                              c.validity.copy())
        if T.is_integral(to):
            d = np.int64(10 ** min(frm.scale, 18))
            mhi, mlo = I.abs_(np, hi, lo)
            qh, ql, _r = I.divmod_u128_by_u64(np, mhi, mlo, d)
            if frm.scale > 18:
                qh, ql, _r2 = I.divmod_u128_by_u64(
                    np, qh, ql, np.int64(10 ** (frm.scale - 18)))
            neg = I.is_neg(np, hi, lo)
            nh, nl = I.neg(np, qh, ql)
            qh = np.where(neg, nh, qh)
            ql = np.where(neg, nl, ql)
            v, fits = I.to_i64(np, qh, ql)
            info = np.iinfo(T.numpy_dtype(to))
            validity = c.validity & fits & (v >= info.min) & (v <= info.max)
            if ansi and (~validity & c.validity).any():
                raise ArithmeticError("Cast overflow in ANSI mode")
            return HostColumn(to, v.astype(T.numpy_dtype(to)),
                              validity).normalized()
        raise TypeError(f"cast {frm} -> {to}")
    scale_div = 10 ** frm.scale
    if T.is_floating(to):
        # reciprocal multiply, matching XLA's constant-divisor folding
        # on the device leg (see the limb branch above)
        data = (c.data.astype(np.float64) * (1.0 / scale_div)).astype(
            T.numpy_dtype(to))
        return HostColumn(to, data, c.validity.copy())
    if T.is_integral(to):
        q = c.data.astype(np.int64)
        trunc = np.where(q < 0, -((-q) // scale_div), q // scale_div)
        info = np.iinfo(T.numpy_dtype(to))
        validity = c.validity & (trunc >= info.min) & (trunc <= info.max)
        if ansi and (~validity & c.validity).any():
            raise ArithmeticError("Cast overflow in ANSI mode")
        return HostColumn(to, trunc.astype(T.numpy_dtype(to)),
                          validity).normalized()
    raise TypeError(f"cast {frm} -> {to}")


# ---------------------------------------------------------------------------
# Aggregate functions. Modeled as (buffer slots + primitive segment ops)
# so CPU (numpy) and TPU (jax.ops.segment_*) share one contract; mirrors
# the update/merge split the reference binds separately per mode
# (aggregate.scala:247 strategy doc).
# ---------------------------------------------------------------------------

# primitive segment ops understood by both engines
PRIM_SUM = "sum"
PRIM_COUNT = "count"   # counts valid slots
PRIM_MIN = "min"
PRIM_MAX = "max"
PRIM_FIRST = "first"   # first valid value in segment (ignoreNulls=true)
PRIM_LAST = "last"
PRIM_FIRST_ANY = "first_any"  # first row incl. nulls (ignoreNulls=false);
PRIM_LAST_ANY = "last_any"    # sound at merge: partial rows exist only for
                              # non-empty groups, so a null buffer slot means
                              # "first value was null", never "no rows"
PRIM_SUM_NONNULL = "sum_nonnull"  # null-skipping sum that yields 0, not null
PRIM_COLLECT = "collect"          # gather valid values per group into a tuple
PRIM_COLLECT_MERGE = "collect_merge"  # concatenate gathered tuples


class AggregateFunction(Expression):
    """Declarative aggregate: buffer slots with update/merge primitives.

    buffer_slots(): [(slot_name, DataType, update_prim, update_child_expr,
                      merge_prim)]
    evaluate(buffers): final result column from merged buffer columns.
    """

    def buffer_slots(self) -> List:
        raise NotImplementedError

    def evaluate(self, buffers: List[HostColumn]) -> HostColumn:
        raise NotImplementedError


def _sum_result_type(dt: T.DataType) -> T.DataType:
    if isinstance(dt, T.DecimalType):
        return T.DecimalType(min(dt.precision + 10, 38), dt.scale)
    if T.is_integral(dt) or isinstance(dt, T.BooleanType):
        return T.LongT
    return T.DoubleT


class Sum(AggregateFunction):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return _sum_result_type(self.children[0].data_type)

    def buffer_slots(self):
        return [("sum", self.data_type, PRIM_SUM, self.children[0], PRIM_SUM)]

    def evaluate(self, buffers):
        return buffers[0]


class Count(AggregateFunction):
    def __init__(self, children: List[Expression]):
        self.children = list(children)  # empty = COUNT(*)

    @property
    def data_type(self) -> T.DataType:
        return T.LongT

    @property
    def nullable(self) -> bool:
        return False

    def buffer_slots(self):
        child = self.children[0] if self.children else Literal(1)
        return [("count", T.LongT, PRIM_COUNT, child, PRIM_SUM_NONNULL)]

    def evaluate(self, buffers):
        b = buffers[0]
        data = np.where(b.validity, b.data, 0).astype(np.int64)
        return HostColumn.all_valid(data, T.LongT)


class Min(AggregateFunction):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def buffer_slots(self):
        return [("min", self.data_type, PRIM_MIN, self.children[0], PRIM_MIN)]

    def evaluate(self, buffers):
        return buffers[0]


class Max(AggregateFunction):
    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def buffer_slots(self):
        return [("max", self.data_type, PRIM_MAX, self.children[0], PRIM_MAX)]

    def evaluate(self, buffers):
        return buffers[0]


class Average(AggregateFunction):
    def __init__(self, child: Expression):
        self.children = [child]

    def _child_decimal(self) -> Optional[T.DecimalType]:
        dt = self.children[0].data_type
        return dt if isinstance(dt, T.DecimalType) else None

    @property
    def data_type(self) -> T.DataType:
        dec = self._child_decimal()
        if dec is not None:
            # Spark Average for decimal: adjusted (p+4, s+4)
            return T.adjust_precision_scale(dec.precision + 4,
                                            dec.scale + 4)
        return T.DoubleT

    @property
    def nullable(self) -> bool:
        return True

    def buffer_slots(self):
        child = self.children[0]
        dec = self._child_decimal()
        if dec is not None:
            sum_t = T.DecimalType(min(dec.precision + 10, 38), dec.scale)
            return [("sum", sum_t, PRIM_SUM, child, PRIM_SUM),
                    ("count", T.LongT, PRIM_COUNT, child, PRIM_SUM_NONNULL)]
        if not isinstance(child.data_type, T.DoubleType):
            child_d = Cast(child, T.DoubleT)
        else:
            child_d = child
        return [("sum", T.DoubleT, PRIM_SUM, child_d, PRIM_SUM),
                ("count", T.LongT, PRIM_COUNT, child, PRIM_SUM_NONNULL)]

    def evaluate(self, buffers):
        s, cnt = buffers[0], buffers[1]
        count = np.where(cnt.validity, cnt.data, 0)
        dec = self._child_decimal()
        if dec is not None:
            # HALF_UP(sum * 10^4 / count) at the adjusted result scale
            from spark_rapids_tpu_torch.ops import decimal_ops as D
            from spark_rapids_tpu_torch.ops import int128 as I
            res = self.data_type
            hi, lo = _dec_limbs(s)
            up = res.scale - dec.scale
            hi, lo, over = D.rescale_up(np, hi, lo, max(up, 0))
            nz = count.astype(np.int64) > 0
            qh, ql = I.div_halfup(np, hi, lo,
                                  np.where(nz, count, 1).astype(np.int64))
            validity = s.validity & nz & ~over & I.fits_precision(
                np, qh, ql, res.precision)
            return _limbs_to_col(qh, ql, validity, res)
        count = count.astype(np.float64)
        validity = count > 0
        with np.errstate(all="ignore"):
            data = s.data.astype(np.float64) / np.where(count > 0, count, 1)
        return HostColumn(T.DoubleT, data, validity).normalized()


class First(AggregateFunction):
    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.children = [child]
        self.ignore_nulls = ignore_nulls

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def buffer_slots(self):
        prim = PRIM_FIRST if self.ignore_nulls else PRIM_FIRST_ANY
        return [("first", self.data_type, prim, self.children[0], prim)]

    def evaluate(self, buffers):
        return buffers[0]


class Last(AggregateFunction):
    def __init__(self, child: Expression, ignore_nulls: bool = False):
        self.children = [child]
        self.ignore_nulls = ignore_nulls

    @property
    def data_type(self) -> T.DataType:
        return self.children[0].data_type

    def buffer_slots(self):
        prim = PRIM_LAST if self.ignore_nulls else PRIM_LAST_ANY
        return [("last", self.data_type, prim, self.children[0], prim)]

    def evaluate(self, buffers):
        return buffers[0]


class CollectList(AggregateFunction):
    """collect_list: per-group array of the non-null values, in row
    order (GpuCollectList, AggregateFunctions.scala:953). Empty groups
    yield an empty array, never null (Spark TypedImperativeAggregate
    createAggregationBuffer semantics)."""

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.ArrayType(self.children[0].data_type)

    @property
    def nullable(self) -> bool:
        return False

    def buffer_slots(self):
        return [("collect", self.data_type, PRIM_COLLECT,
                 self.children[0], PRIM_COLLECT_MERGE)]

    def evaluate(self, buffers):
        b = buffers[0]
        data = np.empty(len(b.data), dtype=object)
        for i in range(len(b.data)):
            data[i] = tuple(b.data[i]) if b.validity[i] else ()
        return HostColumn.all_valid(data, self.data_type)


class CollectSet(CollectList):
    """collect_set: collect_list deduplicated at evaluation, first
    occurrence kept (GpuCollectSet role); NaNs deduplicate as one
    value and 0.0/-0.0 stay distinct (JVM Double.equals semantics of
    Spark's OpenHashSet buffer)."""

    def evaluate(self, buffers):
        b = buffers[0]
        data = np.empty(len(b.data), dtype=object)
        for i in range(len(b.data)):
            if not b.validity[i]:
                data[i] = ()
                continue
            seen = set()
            out = []
            for v in b.data[i]:
                k = ("<nan>",) if isinstance(v, float) and v != v else \
                    (v, math.copysign(1.0, v)) if isinstance(v, float) \
                    else v
                if k in seen:
                    continue
                seen.add(k)
                out.append(v)
            data[i] = tuple(out)
        return HostColumn.all_valid(data, self.data_type)


class CentralMomentAgg(AggregateFunction):
    """stddev/variance family over (count, sum, sum-of-squares) buffers.

    Spark's CentralMomentAgg (AggregateFunctions twin) keeps a Welford
    (n, avg, M2) buffer; this engine uses the algebraically equal
    moment sums so the update/merge primitives stay the shared
    sum/count vocabulary: M2 = sumsq - sum^2/n, clamped at 0 against
    float cancellation (a constant column must give stddev 0, not
    sqrt(-1e-18)). Both engines evaluate the SAME formula, so
    CPU == device holds bit-for-bit wherever their sums do."""

    is_sample = False   # /(n-1) vs /n
    is_stddev = False   # sqrt at the end

    def __init__(self, child: Expression):
        self.children = [child]

    @property
    def data_type(self) -> T.DataType:
        return T.DoubleT

    @property
    def nullable(self) -> bool:
        return True

    def buffer_slots(self):
        child = self.children[0]
        child_d = child if isinstance(child.data_type, T.DoubleType) \
            else Cast(child, T.DoubleT)
        sq = Multiply(child_d, child_d)
        return [("n", T.LongT, PRIM_COUNT, child, PRIM_SUM_NONNULL),
                ("sum", T.DoubleT, PRIM_SUM, child_d, PRIM_SUM),
                ("sumsq", T.DoubleT, PRIM_SUM, sq, PRIM_SUM)]

    def _finish(self, n, s, sq):
        """Shared (numpy) finisher; the device twin mirrors it in
        exec/agg.dev_evaluate."""
        nf = n.astype(np.float64)
        with np.errstate(all="ignore"):
            m2 = np.maximum(sq - (s * s) / np.where(n > 0, nf, 1.0), 0.0)
            div = nf - 1.0 if self.is_sample else nf
            out = m2 / div  # n==1 sample: 0/0 -> NaN (Spark semantics)
            if self.is_stddev:
                out = np.sqrt(out)
        return out

    def evaluate(self, buffers):
        n = np.where(buffers[0].validity, buffers[0].data, 0)
        s = buffers[1].data.astype(np.float64)
        sq = buffers[2].data.astype(np.float64)
        validity = n > 0
        out = self._finish(n, s, sq)
        return HostColumn(T.DoubleT, np.where(validity, out, 0.0),
                          validity).normalized()


class VariancePop(CentralMomentAgg):
    pass


class VarianceSamp(CentralMomentAgg):
    is_sample = True


class StddevPop(CentralMomentAgg):
    is_stddev = True


class StddevSamp(CentralMomentAgg):
    is_sample = True
    is_stddev = True


class AggregateExpression(Expression):
    """Wraps an AggregateFunction with mode + distinct flag (Catalyst
    AggregateExpression)."""

    def __init__(self, func: AggregateFunction, is_distinct: bool = False):
        self.children = [func]
        self.is_distinct = is_distinct

    @property
    def func(self) -> AggregateFunction:
        return self.children[0]

    @property
    def data_type(self) -> T.DataType:
        return self.func.data_type

    def __repr__(self) -> str:
        d = "distinct " if self.is_distinct else ""
        return f"{self.func.pretty_name}({d}{self.func.children})"


# ---------------------------------------------------------------------------
# Sort order
# ---------------------------------------------------------------------------

class SortOrder(Expression):
    def __init__(self, child: Expression, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.children = [child]
        self.ascending = ascending
        # Spark default: NULLS FIRST for asc, NULLS LAST for desc
        self.nulls_first = (ascending if nulls_first is None else nulls_first)

    @property
    def child(self) -> Expression:
        return self.children[0]

    @property
    def data_type(self) -> T.DataType:
        return self.child.data_type

    def __repr__(self) -> str:
        dirn = "ASC" if self.ascending else "DESC"
        nf = "NULLS FIRST" if self.nulls_first else "NULLS LAST"
        return f"{self.child!r} {dirn} {nf}"


# ---------------------------------------------------------------------------
# Window expressions (Catalyst windowExpressions.scala shape; reference
# device impl: GpuWindowExec.scala:187, GpuWindowExpression.scala)
# ---------------------------------------------------------------------------

# Frame boundary sentinels: None = unbounded in that direction, 0 = the
# current row, +/-k = k rows after/before (rows frames only).
class WindowFrame:
    """Rows/range frame. Spark defaults: with an order spec -> RANGE
    BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW; without -> ROWS BETWEEN
    UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING."""

    def __init__(self, frame_type: str, lower: Optional[int],
                 upper: Optional[int]):
        assert frame_type in ("rows", "range")
        self.frame_type = frame_type
        self.lower = lower
        self.upper = upper

    @property
    def is_unbounded_whole(self) -> bool:
        return self.lower is None and self.upper is None

    @property
    def is_running(self) -> bool:
        """UNBOUNDED PRECEDING .. CURRENT ROW."""
        return self.lower is None and self.upper == 0

    def key(self) -> tuple:
        return (self.frame_type, self.lower, self.upper)

    def __repr__(self) -> str:
        def b(v, side):
            if v is None:
                return f"UNBOUNDED {side}"
            if v == 0:
                return "CURRENT ROW"
            return f"{abs(v)} {'PRECEDING' if v < 0 else 'FOLLOWING'}"
        return (f"{self.frame_type.upper()} BETWEEN "
                f"{b(self.lower, 'PRECEDING')} AND "
                f"{b(self.upper, 'FOLLOWING')}")


def default_frame(has_order: bool) -> WindowFrame:
    if has_order:
        return WindowFrame("range", None, 0)
    return WindowFrame("rows", None, None)


class WindowFunction(Expression):
    """Base of ranking/offset window functions (non-aggregate)."""


class RowNumber(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False


class Rank(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False


class DenseRank(WindowFunction):
    def __init__(self):
        self.children = []

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT

    @property
    def nullable(self) -> bool:
        return False


class NTile(WindowFunction):
    def __init__(self, n: int):
        self.children = []
        self.n = n

    @property
    def data_type(self) -> T.DataType:
        return T.IntegerT


class Lag(WindowFunction):
    """children = [input, default?]; offset is static."""

    def __init__(self, child: Expression, offset: int = 1,
                 default: Optional[Expression] = None):
        self.children = [child] + ([default] if default is not None else [])
        self.offset = offset

    @property
    def input(self) -> Expression:
        return self.children[0]

    @property
    def default(self) -> Optional[Expression]:
        return self.children[1] if len(self.children) > 1 else None

    @property
    def data_type(self) -> T.DataType:
        return self.input.data_type


class Lead(Lag):
    pass


class WindowExpression(Expression):
    """function OVER (spec). children = [func] + partition exprs + order
    SortOrders so resolution/transforms reach every subtree; the frame
    rides alongside."""

    def __init__(self, func: Expression, partition_spec: List[Expression],
                 order_spec: List[SortOrder],
                 frame: Optional[WindowFrame] = None):
        self.children = [func] + list(partition_spec) + list(order_spec)
        self.n_partition = len(partition_spec)
        self.n_order = len(order_spec)
        self.frame = frame or default_frame(bool(order_spec))

    @property
    def func(self) -> Expression:
        return self.children[0]

    @property
    def partition_spec(self) -> List[Expression]:
        return self.children[1:1 + self.n_partition]

    @property
    def order_spec(self) -> List["SortOrder"]:
        return self.children[1 + self.n_partition:]

    @property
    def data_type(self) -> T.DataType:
        return self.func.data_type

    def __repr__(self) -> str:
        return (f"{self.func!r} OVER (PARTITION BY {self.partition_spec} "
                f"ORDER BY {self.order_spec} {self.frame!r})")


# ---------------------------------------------------------------------------
# Python UDFs (sql/core PythonUDF; the reference routes these to its
# python worker pool — here they evaluate on the host row loop and the
# rewrite engine tags them NOT_ON_GPU, same placement the reference
# reports for un-compiled UDFs)
# ---------------------------------------------------------------------------

class ScalarSubquery(Expression):
    """Uncorrelated scalar subquery `(SELECT ... )` in expression
    position (Catalyst ScalarSubquery; the reference keeps the plan on
    device via GpuScalarSubquery over a materialized value). The session
    materializes it to a Literal before physical planning
    (session.plan_physical) — this node never reaches execution."""

    def __init__(self, plan, dtype: T.DataType):
        self.children = []
        self.plan = plan
        self._dtype = dtype

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    def __repr__(self) -> str:
        return "scalar-subquery"


def materialize_scalar_subqueries(plan, session):
    """Replace every ScalarSubquery with the Literal it evaluates to
    (executing each subquery ONCE per query, like Spark's subquery
    reuse). Enforces the at-most-one-row contract. With ``session``
    None (the explain path) subqueries substitute to unevaluated NULL
    placeholders instead — rendering a plan must never execute it."""
    cache: dict = {}

    def subst(e: Expression):
        if not isinstance(e, ScalarSubquery):
            return None
        if session is None:
            return Literal(None, e.data_type)
        key = id(e.plan)
        if key not in cache:
            batch = session.execute_plan(e.plan)
            if batch.num_rows > 1:
                raise ValueError(
                    "scalar subquery returned more than one row")
            if batch.num_rows == 0 or not batch.columns[0].validity[0]:
                val = None
            else:
                val = batch.columns[0].to_pylist()[0]
            cache[key] = Literal(val, e.data_type)
        return cache[key]

    _EXPR_ATTRS = ("project_list", "condition", "aggregates",
                   "grouping", "order", "window_exprs",
                   "partition_spec", "order_spec", "generator",
                   "expressions")

    def walk(p):
        """Copy-on-write: the input plan keeps its ScalarSubquery nodes
        so a later collect() re-evaluates against fresh data."""
        import copy as _copy
        new_children = [walk(c) for c in p.children]
        repl = {}
        for attr in _EXPR_ATTRS:
            v = getattr(p, attr, None)
            if isinstance(v, list) and any(isinstance(x, Expression)
                                           for x in v):
                repl[attr] = [x.transform(subst)
                              if isinstance(x, Expression) else x
                              for x in v]
            elif isinstance(v, Expression):
                repl[attr] = v.transform(subst)
        if new_children == p.children and not repl:
            return p
        q = _copy.copy(p)
        q.children = new_children
        for k, v in repl.items():
            setattr(q, k, v)
        return q

    def has_subquery(p) -> bool:
        for attr in _EXPR_ATTRS:
            v = getattr(p, attr, None)
            vs = v if isinstance(v, list) else [v] if v is not None else []
            for x in vs:
                if isinstance(x, Expression) and x.collect(
                        lambda n: isinstance(n, ScalarSubquery)):
                    return True
        return any(has_subquery(c) for c in p.children)

    if has_subquery(plan):
        return walk(plan)
    return plan


class PandasUDF(Expression):
    """Vectorized (scalar) pandas UDF (sql/core PythonUDF with
    SQL_SCALAR_PANDAS_UDF evalType; GpuPythonUDF.scala role). The
    planner EXTRACTS these out of projections into an
    ArrowEvalPythonExec (Spark's ExtractPythonUDFs rule) — eval() here
    is the in-process evaluation for an expression position the
    extractor doesn't cover (filters, sort keys), which the JAX package
    places on its CPU: in the port such a UDF raises at the rewrite
    until the per-operator CPU fallback is ported."""

    def __init__(self, fn, name: str, dtype: T.DataType,
                 children: List[Expression]):
        self.children = list(children)
        self.fn = fn
        self.name = name
        self._dtype = dtype

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    def eval(self, batch: HostBatch) -> HostColumn:
        import pandas as pd
        import pyarrow as pa

        from spark_rapids_tpu_torch.io.arrow_convert import (
            arrow_column_to_host, host_column_to_arrow, sql_type_to_arrow)
        args = [host_column_to_arrow(c.eval(batch)).to_pandas()
                for c in self.children]
        out = self.fn(*args)
        if not isinstance(out, pd.Series):
            out = pd.Series([out] * batch.num_rows)
        arr = pa.Array.from_pandas(out, type=sql_type_to_arrow(self._dtype))
        if len(arr) != batch.num_rows:
            raise ValueError(
                f"pandas_udf {self.name} returned {len(arr)} rows for a "
                f"{batch.num_rows}-row batch")
        return arrow_column_to_host(arr, self._dtype)

    def __repr__(self) -> str:
        return f"{self.name}({self.children})"


class PythonUDF(Expression):
    def __init__(self, fn, name: str, dtype: T.DataType,
                 children: List[Expression]):
        self.children = list(children)
        self.fn = fn
        self.name = name
        self._dtype = dtype

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    def eval(self, batch: HostBatch) -> HostColumn:
        cols = [c.eval(batch) for c in self.children]
        n = batch.num_rows
        np_dt = T.numpy_dtype(self._dtype)
        data = (np.full(n, "", dtype=object)
                if np_dt == np.dtype(object) else np.zeros(n, dtype=np_dt))
        validity = np.zeros(n, dtype=bool)
        for i in range(n):
            args = [None if not c.validity[i]
                    else (c.data[i].item() if isinstance(c.data[i],
                                                         np.generic)
                          else c.data[i]) for c in cols]
            out = self.fn(*args)
            if out is not None:
                data[i] = out
                validity[i] = True
        return HostColumn(self._dtype, data, validity).normalized()

    def __repr__(self) -> str:
        return f"{self.name}({self.children})"
