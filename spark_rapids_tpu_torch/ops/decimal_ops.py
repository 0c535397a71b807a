"""Decimal arithmetic over 128-bit limb pairs, written once against the
array surface numpy and torch share (the counterpart of
``spark_rapids_tpu.ops.decimal_ops``).

Spark semantics (DecimalPrecision / decimalExpressions): operands
rescale to the result type's scale, compute on unscaled integers, round
HALF_UP on scale reduction, and go NULL (non-ANSI) when the value exceeds
the result precision (CheckOverflow). The math core is ``ops/int128``.

Support envelope (the rewrite keeps anything beyond it off the device):
add/sub with down-rescales of at most 18 digits; mul with one operand
within 18 digits; div with an 18-digit divisor and a scaled-up dividend
within 38 digits.
"""

from __future__ import annotations

from spark_rapids_tpu_torch.ops import int128 as I
from spark_rapids_tpu_torch.sql import types as T


def rescale_up(xp, hi, lo, k: int):
    """x * 10^k for k >= 0 (chained 64-bit multiplies). Returns
    (hi, lo, overflowed)."""
    over = hi != hi
    while k > 0:
        step = min(k, 18)
        hi, lo, o = I.mul_by_i64(xp, hi, lo,
                                 xp.full_like(hi, I.POW10_I64[step]))
        over = over | o
        k -= step
    return hi, lo, over


def rescale_to(xp, hi, lo, delta: int):
    """x * 10^delta, HALF_UP when delta < 0 (|delta| <= 18 down)."""
    if delta >= 0:
        return rescale_up(xp, hi, lo, delta)
    if -delta > 18:
        raise ValueError(f"decimal down-rescale by {-delta} digits")
    qh, ql = I.div_halfup(xp, hi, lo,
                          xp.full_like(hi, I.POW10_I64[-delta]))
    return qh, ql, hi != hi


def checked(xp, hi, lo, over, precision: int):
    """CheckOverflow: (hi, lo, ok) — ok False where the value is lost or
    exceeds 10^precision (the caller turns !ok into NULL)."""
    ok = ~over & I.fits_precision(xp, hi, lo, precision)
    return xp.where(ok, hi, 0), xp.where(ok, lo, 0), ok


def add_sub_supported(lt: T.DecimalType, rt: T.DecimalType) -> bool:
    res = T.decimal_binary_result("+", lt, rt)
    return res.scale - max(lt.scale, rt.scale) >= -18


def add_sub(xp, op: str, ahi, alo, bhi, blo,
            lt: T.DecimalType, rt: T.DecimalType, res: T.DecimalType):
    """a +/- b at the Spark result type: each operand is cast to the
    result type first (HALF_UP where the 38-digit cap reduced the
    scale), then added. Returns (hi, lo, ok)."""
    ahi, alo, o1 = rescale_to(xp, ahi, alo, res.scale - lt.scale)
    bhi, blo, o2 = rescale_to(xp, bhi, blo, res.scale - rt.scale)
    if op == "+":
        hi, lo = I.add(xp, ahi, alo, bhi, blo)
    else:
        hi, lo = I.sub(xp, ahi, alo, bhi, blo)
    return checked(xp, hi, lo, o1 | o2, res.precision)


def mul_supported(lt: T.DecimalType, rt: T.DecimalType) -> bool:
    res = T.decimal_binary_result("*", lt, rt)
    down = (lt.scale + rt.scale) - res.scale
    return (min(lt.precision, rt.precision)
            <= T.DecimalType.MAX_LONG_DIGITS and 0 <= down <= 18)


def mul(xp, ahi, alo, bhi, blo, lt: T.DecimalType, rt: T.DecimalType,
        res: T.DecimalType):
    """a * b; requires mul_supported(lt, rt): the 64-bit side multiplies
    into the 128-bit side, then the product rescales to the result."""
    if rt.precision <= T.DecimalType.MAX_LONG_DIGITS:
        whi, wlo, small = ahi, alo, blo
    else:
        whi, wlo, small = bhi, blo, alo
    hi, lo, over = I.mul_by_i64(xp, whi, wlo, small)
    down = res.scale - (lt.scale + rt.scale)
    hi, lo, o2 = rescale_to(xp, hi, lo, down)
    return checked(xp, hi, lo, over | o2, res.precision)


def div_supported(lt: T.DecimalType, rt: T.DecimalType) -> bool:
    res = T.decimal_binary_result("/", lt, rt)
    k = res.scale - lt.scale + rt.scale
    return (rt.precision <= T.DecimalType.MAX_LONG_DIGITS
            and k >= 0 and lt.precision + k <= T.DecimalType.MAX_PRECISION)


def div(xp, ahi, alo, blo_64, lt: T.DecimalType, rt: T.DecimalType,
        res: T.DecimalType):
    """a / b HALF_UP at the result scale; the caller masks zero divisors
    to NULL and passes a nonzero placeholder."""
    k = res.scale - lt.scale + rt.scale
    nhi, nlo, over = rescale_up(xp, ahi, alo, k)
    qh, ql = I.div_halfup(xp, nhi, nlo, blo_64)
    return checked(xp, qh, ql, over, res.precision)


def cast_supported(frm: T.DecimalType, to: T.DecimalType) -> bool:
    return to.scale - frm.scale >= -18


def cast_decimal(xp, hi, lo, frm: T.DecimalType, to: T.DecimalType):
    """decimal -> decimal rescale with overflow detection; requires
    cast_supported."""
    hi, lo, over = rescale_to(xp, hi, lo, to.scale - frm.scale)
    return checked(xp, hi, lo, over, to.precision)


def to_i64_unscaled(xp, hi, lo):
    """Limb pair -> int64 (values known to fit 18 digits)."""
    v, _fits = I.to_i64(xp, hi, lo)
    return v
