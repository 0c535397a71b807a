"""Vectorized signed 128-bit integer arithmetic on two int64 limbs.

The decimal engine's math core: Spark's DecimalType computations beyond
18 digits run on unscaled 128-bit integers. Written ONCE against the
array surface numpy and torch share (``xp`` is the ``numpy`` or the
``torch`` module), so the host engine (numpy) and the device operators
(torch tensors on the card) are bit-identical by construction.

Representation: ``(hi, lo)`` — ``hi`` int64 signed high limb, ``lo``
int64 holding the LOW limb's uint64 bit pattern. value = hi * 2**64 +
uint64(lo). All functions take/return this pair of same-shape arrays.

torch has no usable unsigned 64-bit arithmetic, so everything here runs
on signed int64 only: two's-complement add/sub/mul wrap exactly like
their unsigned twins, unsigned compares flip the sign bit of both sides
(``_ult``), logical right shifts mask off the sign extension (``_srl``),
and every division is arranged to divide non-negative values below 2^63.
No data-dependent Python control flow: every correction step is a
``where``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Pair = Tuple  # (hi: int64 array, lo: int64-as-uint64-bits array)

_B32 = 0xFFFFFFFF
_MIN = -(1 << 63)


def _ult(a, b):
    """a < b on the uint64 bit patterns of two int64 arrays."""
    return (a ^ _MIN) < (b ^ _MIN)


def _srl(a, k: int):
    """Logical right shift of an int64 bit pattern by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def _srl_var(xp, a, k):
    """Logical right shift by an array of amounts in [0, 63]."""
    ks = xp.where(k == 0, 1, k)
    one = xp.ones_like(ks)
    # (1 << (64 - ks)) - 1 wraps to the right mask for ks == 1 too
    shifted = (a >> ks) & ((one << (64 - ks)) - 1)
    return xp.where(k == 0, a, shifted)


def _i64(xp, flag):
    """bool array -> 0/1 int64."""
    return xp.where(flag, 1, 0)


def from_i64(xp, x) -> Pair:
    """Sign-extend an int64 array to a 128-bit pair."""
    return x >> 63, x


def to_i64(xp, hi, lo):
    """(value as int64, fits flag): fits iff hi is lo's sign extension."""
    return lo, hi == (lo >> 63)


def is_neg(xp, hi, lo):
    return hi < 0


def add(xp, ahi, alo, bhi, blo) -> Pair:
    lo = alo + blo
    return ahi + bhi + _i64(xp, _ult(lo, alo)), lo


def neg(xp, hi, lo) -> Pair:
    nlo = ~lo + 1
    return ~hi + _i64(xp, nlo == 0), nlo


def sub(xp, ahi, alo, bhi, blo) -> Pair:
    nh, nl = neg(xp, bhi, blo)
    return add(xp, ahi, alo, nh, nl)


def abs_(xp, hi, lo) -> Pair:
    n = is_neg(xp, hi, lo)
    nh, nl = neg(xp, hi, lo)
    return xp.where(n, nh, hi), xp.where(n, nl, lo)


def cmp_lt(xp, ahi, alo, bhi, blo):
    """a < b, signed."""
    return (ahi < bhi) | ((ahi == bhi) & _ult(alo, blo))


def eq(xp, ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def _umul64(xp, a, b) -> Pair:
    """Unsigned 64x64 -> 128 on uint64 bit patterns (as int64 arrays):
    32-bit halves, wrapping partial products, logical carries."""
    m = _B32
    a0, a1 = a & m, _srl(a, 32)
    b0, b1 = b & m, _srl(b, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _srl(p00, 32) + (p01 & m) + (p10 & m)
    lo = (p00 & m) | (mid << 32)
    hi = p11 + _srl(p01, 32) + _srl(p10, 32) + _srl(mid, 32)
    return hi, lo


def mul_i64(xp, a, b) -> Pair:
    """Signed 64x64 -> exact 128."""
    hi, lo = _umul64(xp, a, b)
    # signed adjustment: uhi - (a<0 ? b : 0) - (b<0 ? a : 0)
    hi = hi - xp.where(a < 0, b, 0) - xp.where(b < 0, a, 0)
    return hi, lo


def mul_by_i64(xp, hi, lo, b):
    """Signed 128 x signed 64 -> (hi, lo, overflowed): low 128 bits of
    the exact product, plus a flag set when the true value does not fit
    a signed 128."""
    sa = is_neg(xp, hi, lo)
    sb = b < 0
    mhi, mlo = abs_(xp, hi, lo)
    mb = xp.where(sb, -b, b)  # int64.min excluded by decimal bounds
    p_lo_hi, p_lo_lo = _umul64(xp, mlo, mb)
    p_hi_hi, p_hi_lo = _umul64(xp, mhi, mb)
    rhi = p_lo_hi + p_hi_lo
    carry_out = (p_hi_hi != 0) | _ult(rhi, p_lo_hi)
    # signed-128 magnitude limit: 2^127 (decimal bounds (10^38 < 2^127)
    # make the -2^127 edge unreachable)
    over = carry_out | (rhi < 0)
    sneg = sa ^ sb
    nh, nl = neg(xp, rhi, p_lo_lo)
    return (xp.where(sneg, nh, rhi), xp.where(sneg, nl, p_lo_lo), over)


POW10_I64 = [10 ** k for k in range(19)]


def _udivmod_small(xp, hi, lo, d):
    """Unsigned 128 / d where 0 < d < 2^32: long division over 16-bit
    digits; every partial dividend (r << 16 | digit) stays below 2^48,
    so signed floor division is exact. Returns (qhi, qlo, rem)."""
    m16 = 0xFFFF
    u = [_srl(lo, 16 * k) & m16 if k else lo & m16 for k in range(4)] + \
        [_srl(hi, 16 * k) & m16 if k else hi & m16 for k in range(4)]
    r = xp.zeros_like(d)
    q = [None] * 8
    for j in range(7, -1, -1):
        cur = (r << 16) | u[j]
        q[j] = cur // d
        r = cur - q[j] * d
    qlo = q[0] | (q[1] << 16) | (q[2] << 32) | (q[3] << 48)
    qhi = q[4] | (q[5] << 16) | (q[6] << 32) | (q[7] << 48)
    return qhi, qlo, r


def _nlz32_of_hi(xp, v1):
    """Leading zeros of v1 (the divisor's high 32-bit digit, 1..2^32-1)
    within 32 bits."""
    n = xp.zeros_like(v1)
    x = v1
    for shift in (16, 8, 4, 2, 1):
        t = x < (1 << (32 - shift))
        n = n + xp.where(t, shift, 0)
        x = xp.where(t, x << shift, x)
    return n


def _udiv_by_digit(xp, num, v):
    """Unsigned 64-bit num / v for 2^31 <= v < 2^32 -> (q, r). num may
    exceed 2^63, so the signed division runs on num >> 1 and one
    correction step restores the exact quotient."""
    q = (_srl(num, 1) // v) << 1
    r = num - q * v                      # 0 <= r < 2v < 2^33
    fix = r >= v
    return q + _i64(xp, fix), xp.where(fix, r - v, r)


def _udivmod_knuth(xp, hi, lo, d):
    """Unsigned 128 / uint64 d where d >= 2^32 (two 32-bit digits),
    Knuth algorithm D with base 2^32. Returns (qhi, qlo, rem)."""
    m = _B32
    # normalize so the divisor's high digit >= 2^31
    v1 = _srl(d, 32)
    sh = _nlz32_of_hi(xp, v1)
    dn = d << sh
    v1n = _srl(dn, 32)
    v0n = dn & m
    # dividend digits after the same shift (dividend < d * 2^64 assumed
    # by callers, so a 5-digit window suffices)
    big = sh > 0
    back = xp.where(big, 64 - sh, 0)  # 0 where unused: no 64-bit shift
    hi_n = xp.where(big, (hi << sh) | _srl_var(xp, lo, back), hi)
    lo_n = lo << sh
    u4 = xp.where(big, _srl_var(xp, hi, back), 0)
    u = [lo_n & m, _srl(lo_n, 32), hi_n & m, _srl(hi_n, 32), u4]
    qd = [None, None, None]
    for j in (2, 1, 0):
        num = (u[j + 2] << 32) | u[j + 1]
        qhat, rhat = _udiv_by_digit(xp, num, v1n)
        # clamp to b-1 (Knuth D3: qhat <= true digit + 2 once
        # normalized, so a bounded correction loop follows)
        clamp = qhat > m
        rhat = xp.where(clamp, num - m * v1n, rhat)
        qhat = xp.where(clamp, m, qhat)
        for _ in range(3):  # qhat <= q+2 after clamp: 3 steps suffice
            # when rhat >= b the RHS >= 2^64 > any qhat*v0n: not too big
            too_big = ~_ult(m, rhat) & _ult(
                (rhat << 32) | u[j], qhat * v0n)
            qhat = xp.where(too_big, qhat - 1, qhat)
            rhat = xp.where(too_big, rhat + v1n, rhat)
        # multiply-subtract: u[j..j+2] -= qhat * dn  (3-digit window)
        p = qhat * v0n
        t0 = u[j] - (p & m)
        u_j = t0 & m
        carry = _srl(p, 32) + _i64(xp, _ult(m, t0))
        p1 = qhat * v1n + carry
        t1 = u[j + 1] - (p1 & m)
        u_j1 = t1 & m
        carry1 = _srl(p1, 32) + _i64(xp, _ult(m, t1))
        t2 = u[j + 2] - carry1
        u_j2 = t2 & m
        went_neg = _ult(m, t2)  # borrow out of the window
        # add back dn once if negative
        ab0 = u_j + v0n
        ab1 = u_j1 + v1n + _srl(ab0, 32)
        ab2 = u_j2 + _srl(ab1, 32)
        u[j] = xp.where(went_neg, ab0 & m, u_j)
        u[j + 1] = xp.where(went_neg, ab1 & m, u_j1)
        u[j + 2] = xp.where(went_neg, ab2 & m, u_j2)
        qd[j] = xp.where(went_neg, qhat - 1, qhat) & m
    rem = _srl_var(xp, (u[1] << 32) | u[0], sh)
    qlo = (qd[0] & m) | (qd[1] << 32)
    qhi = qd[2] & m
    return qhi, qlo, rem


def divmod_u128_by_u64(xp, hi, lo, d):
    """Unsigned 128 / unsigned 64 -> (qhi, qlo, rem). d must be >= 1."""
    small = _ult(d, xp.full_like(d, 1 << 32))
    d_small = xp.where(small, d, 3)
    d_big = xp.where(small, 1 << 32, d)
    qh_s, ql_s, r_s = _udivmod_small(xp, hi, lo, d_small)
    qh_b, ql_b, r_b = _udivmod_knuth(xp, hi, lo, d_big)
    return (xp.where(small, qh_s, qh_b), xp.where(small, ql_s, ql_b),
            xp.where(small, r_s, r_b))


def div_halfup(xp, hi, lo, d):
    """Signed 128 / signed 64 with HALF_UP (round half away from zero;
    java.math.BigDecimal/Spark Decimal semantics). d != 0."""
    sa = is_neg(xp, hi, lo)
    sb = d < 0
    mhi, mlo = abs_(xp, hi, lo)
    md = xp.where(sb, -d, d)
    qh, ql, r = divmod_u128_by_u64(xp, mhi, mlo, md)
    # r < md <= 2^63, so 2r < 2^64 compares exactly as unsigned
    round_up = ~_ult(r * 2, md)
    qh2, ql2 = add(xp, qh, ql, xp.zeros_like(qh), _i64(xp, round_up))
    sneg = sa ^ sb
    nh, nl = neg(xp, qh2, ql2)
    return xp.where(sneg, nh, qh2), xp.where(sneg, nl, ql2)


def _const_pair(v: int) -> Tuple[int, int]:
    lo = v & 0xFFFFFFFFFFFFFFFF
    if lo >= 1 << 63:
        lo -= 1 << 64
    return (v >> 64), lo


def fits_precision(xp, hi, lo, precision: int):
    """|x| < 10^precision (Spark CheckOverflow bound)."""
    bh, bl = _const_pair(10 ** precision)
    mhi, mlo = abs_(xp, hi, lo)
    return cmp_lt(xp, mhi, mlo, xp.full_like(hi, bh), xp.full_like(lo, bl))


def to_pyints(hi, lo) -> np.ndarray:
    """(numpy only) object array of exact Python ints."""
    hi_o = np.asarray(hi).astype(object)
    lo_o = (np.asarray(lo).astype(np.uint64)).astype(object)
    return hi_o * (1 << 64) + lo_o


def from_pyints(vals) -> Tuple[np.ndarray, np.ndarray]:
    """(numpy only) exact Python ints -> limb pair arrays."""
    vals = [int(v) for v in vals]
    hi = np.array([v >> 64 for v in vals], dtype=np.int64)
    lo_u = [(v & 0xFFFFFFFFFFFFFFFF) for v in vals]
    lo = np.array([u - (1 << 64) if u >= (1 << 63) else u for u in lo_u],
                  dtype=np.int64)
    return hi, lo
