"""The port's int128 and decimal ops (on torch tensors, and on numpy as
the port's host engine runs them) against the JAX package's
``ops/int128`` and ``ops/decimal_ops`` with ``xp=numpy``, bit-exact, on
edge values: carries across the limbs, negatives, HALF_UP ties, Knuth-D
divisors near 2^32 and 2^63."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import decimal_ops as JD
from spark_rapids_tpu.ops import int128 as JI
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch.ops import decimal_ops as PD
from spark_rapids_tpu_torch.ops import int128 as PI
from spark_rapids_tpu_torch.sql import types as PT

torch.set_num_threads(2)

_EDGE = [0, 1, -1, 2, -2, 5, -5, 15, 25, -25, 35, 10**18, -10**18,
         2**31, 2**32 - 1, 2**32, 2**32 + 1, 2**63 - 1, -2**63 + 1,
         2**63, 2**64 - 1, 2**64, -2**64, 2**64 + 5, 2**96 + 12345,
         -(2**96) - 7, 10**37, -10**37, 10**38 - 1, -(10**38 - 1),
         2**126, -(2**126)]


def _values(n=400, seed=0):
    rng = np.random.default_rng(seed)
    vals = list(_EDGE)
    for _ in range(n):
        bits = int(rng.integers(1, 127))
        v = int(rng.integers(0, 2**62)) * (1 << max(0, bits - 62)) \
            + int(rng.integers(0, 2**62))
        v %= 1 << bits
        vals.append(-v if rng.random() < 0.5 else v)
    return vals


def _limbs(vals):
    return JI.from_pyints(vals)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pair_equal(jpair, ppair):
    for j, p in zip(jpair, ppair):
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        assert np.array_equal(np.asarray(j).astype(p.dtype), p), (j, p)


@pytest.mark.parametrize("xp", ["torch", "numpy"])
def test_add_sub_neg_cmp(xp):
    a = _values(seed=1)
    b = list(reversed(_values(seed=2)))
    ah, al = _limbs(a)
    bh, bl = _limbs(b)
    mod, conv = (torch, _t) if xp == "torch" else (np, np.asarray)
    _pair_equal(JI.add(np, ah, al, bh, bl),
                PI.add(mod, conv(ah), conv(al), conv(bh), conv(bl)))
    _pair_equal(JI.sub(np, ah, al, bh, bl),
                PI.sub(mod, conv(ah), conv(al), conv(bh), conv(bl)))
    _pair_equal(JI.neg(np, ah, al), PI.neg(mod, conv(ah), conv(al)))
    _pair_equal(JI.abs_(np, ah, al), PI.abs_(mod, conv(ah), conv(al)))
    _pair_equal([JI.cmp_lt(np, ah, al, bh, bl)],
                [PI.cmp_lt(mod, conv(ah), conv(al), conv(bh), conv(bl))])
    for p in (18, 25, 38):
        _pair_equal([JI.fits_precision(np, ah, al, p)],
                    [PI.fits_precision(mod, conv(ah), conv(al), p)])


def test_mul_i64_and_mul_by_i64():
    rng = np.random.default_rng(3)
    a = np.array([0, 1, -1, 2**62, -2**62, 2**63 - 1, -2**63 + 1, 3, -7]
                 + list(rng.integers(-2**63 + 1, 2**63 - 1, 300)),
                 dtype=np.int64)
    b = np.roll(a, 3)
    _pair_equal(JI.mul_i64(np, a, b), PI.mul_i64(torch, _t(a), _t(b)))
    vals = _values(len(a) - len(_EDGE), seed=4)[:len(a)]
    h, lo = _limbs(vals)
    _pair_equal(JI.mul_by_i64(np, h, lo, b),
                PI.mul_by_i64(torch, _t(h), _t(lo), _t(b)))


@pytest.mark.parametrize("dlist", [
    [1, 2, 3, 7, 10, 2**31 - 1, 2**31, 2**32 - 1],
    [2**32, 2**32 + 1, 2**33 - 1, 2**40 + 3, 10**18, 2**62,
     2**63 - 1, 2**63 - 25],
])
def test_divmod_and_div_halfup(dlist):
    vals = [v for v in _values(seed=5) if abs(v) < 2**126]
    n = len(vals)
    h, lo = _limbs(vals)
    d = np.array([dlist[i % len(dlist)] for i in range(n)], dtype=np.int64)
    mh, ml = JI.abs_(np, h, lo)
    _pair_equal(JI.divmod_u128_by_u64(np, mh, ml, d),
                PI.divmod_u128_by_u64(torch, _t(mh), _t(ml), _t(d)))
    sd = np.where(np.arange(n) % 2 == 0, d, -d)
    _pair_equal(JI.div_halfup(np, h, lo, sd),
                PI.div_halfup(torch, _t(h), _t(lo), _t(sd)))


def test_div_halfup_ties():
    """x.5 rounds away from zero, both signs."""
    vals = [5, -5, 15, -15, 25, -25, 2**64 + 5, -(2**64 + 5), 1, -1]
    h, lo = _limbs(vals)
    d = np.full(len(vals), 10, dtype=np.int64)
    got = PI.div_halfup(torch, _t(h), _t(lo), _t(d))
    want = JI.div_halfup(np, h, lo, d)
    _pair_equal(want, got)
    ints = PI.to_pyints(got[0].numpy(), got[1].numpy())
    assert list(ints[:6]) == [1, -1, 2, -2, 3, -3]


_DECS = [(15, 2), (16, 2), (10, 0), (25, 2), (32, 4), (38, 6), (38, 4),
         (18, 0), (20, 10), (38, 18)]


@pytest.mark.parametrize("lp,ls", _DECS)
@pytest.mark.parametrize("rp,rs", [(15, 2), (16, 2), (10, 0), (18, 9)])
def test_decimal_arith_matches(lp, ls, rp, rs):
    rng = np.random.default_rng(lp * 100 + rp)
    n = 200
    jl, jr = JT.DecimalType(lp, ls), JT.DecimalType(rp, rs)
    pl, pr = PT.DecimalType(lp, ls), PT.DecimalType(rp, rs)
    a = [int(rng.integers(-10**min(lp, 18), 10**min(lp, 18)))
         * (10 ** max(0, lp - 18) if rng.random() < 0.3 else 1)
         for _ in range(n)]
    b = [int(rng.integers(-10**rp + 1, 10**rp)) for _ in range(n)]
    b[0], b[1] = 5, -5
    ah, al = _limbs(a)
    bh, bl = _limbs(b)
    ta = [_t(x) for x in (ah, al, bh, bl)]
    for op in ("+", "-"):
        if JD.add_sub_supported(jl, jr):
            jres = JT.decimal_binary_result(op, jl, jr)
            pres = PT.decimal_binary_result(op, pl, pr)
            _pair_equal(JD.add_sub(np, op, ah, al, bh, bl, jl, jr, jres),
                        PD.add_sub(torch, op, *ta, pl, pr, pres))
    if JD.mul_supported(jl, jr):
        _pair_equal(JD.mul(np, ah, al, bh, bl, jl, jr,
                           JT.decimal_binary_result("*", jl, jr)),
                    PD.mul(torch, *ta, pl, pr,
                           PT.decimal_binary_result("*", pl, pr)))
    if JD.div_supported(jl, jr):
        d = np.where(bl == 0, 1, bl)
        _pair_equal(JD.div(np, ah, al, d, jl, jr,
                           JT.decimal_binary_result("/", jl, jr)),
                    PD.div(torch, ta[0], ta[1], _t(d), pl, pr,
                           PT.decimal_binary_result("/", pl, pr)))
    for tp, tsc in ((38, 10), (20, 0), (25, 2)):
        if JD.cast_supported(jl, JT.DecimalType(tp, tsc)):
            _pair_equal(JD.cast_decimal(np, ah, al, jl,
                                        JT.DecimalType(tp, tsc)),
                        PD.cast_decimal(torch, ta[0], ta[1], pl,
                                        PT.DecimalType(tp, tsc)))
    for k in (0, 4, 19, 30):
        _pair_equal(JD.rescale_up(np, ah, al, k),
                    PD.rescale_up(torch, ta[0], ta[1], k))
