"""The port's host engine (``sql/physical.py``, ``sql/nested_loop.py``,
``sql/window_exec.py``) against the JAX package's CPU engine: with
``spark.rapids.sql.enabled=false`` both packages run the CPU plan with no
rewrite, and over the repo's query corpus at small sizes the rows must be
equal (exact, NaN equal to NaN) and the port's plan must hold no device
operator and no transition.

The corpus, each query as ``chip_smoke.py`` runs it on the card: TPC-H
q1, TPC-DS q3 (bench.py's text and the pushed form), TPC-H q12 and q19,
TPC-DS q98 (pushed, double form) and q51's store half, the Yahoo
Streaming Benchmark's windowed count, the three Stack Overflow tag
queries, ClickBench Q10 (mixed DISTINCT over a cached child) and TPC-DS
q28 (11 nested-loop joins). Also here: ``group_ids``, the host
aggregate's key numbering, against its row-by-row walk; the host's
int64 decimal arithmetic (both operands within 18 digits, or a product
that fits int64) against its 128-bit limb arithmetic; the decimal128
group sums against Python ints; the string predicates evaluated once a
distinct value against the row loop; and the Parquet string pages'
length walk and dictionary decode against a Python reference."""

import decimal
import struct

import numpy as np
import pytest
import torch

import chip_smoke as C
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_fallback import jax_batch

from spark_rapids_tpu_torch.columnar.host import HostColumn
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.ops import decimal_ops as D
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows, _sort_key
from tests.support import values_equal

torch.set_num_threads(2)

OFF = {"spark.rapids.sql.enabled": "false",
       "spark.sql.shuffle.partitions": "4"}
KINDS = {"long": PT.LongT, "int": PT.IntegerT, "str": PT.StringT,
         "date": PT.DateT, "dec": PT.DecimalType(15, 2),
         "dec72": PT.DecimalType(7, 2), "dbl": PT.DoubleT}


def _batch(cols):
    return host_batch_from_numpy([(n, KINDS[k]) for n, k, _a in cols],
                                 [a for _n, _k, a in cols])


def _windows(n):
    t = C.windows_tables(n)
    return {name: host_batch_from_numpy(*C.windows_fields(cols, True))
            for name, cols in t.items()}


def _q1():
    arrays = C.lineitem_arrays(4000)
    return {"lineitem": host_batch_from_numpy(C.lineitem_fields(), arrays)}


def _q13():
    return C.q13_batches(C.q13_tables(300, 3000))


CORPUS = {
    "q1": (_q1, C.Q1),
    "q3_bench": (lambda: {n: _batch(c) for n, c in
                          C.q3_tables(20_000).items()}, C.Q3_BENCH),
    "q3_pushed": (lambda: {n: _batch(c) for n, c in
                           C.q3_tables(20_000).items()}, C.Q3_PUSHED),
    "q12": (lambda: {n: _batch(c) for n, c in
                     C.q12_tables(4000, 1000).items()}, C.Q12),
    "q19": (lambda: {n: _batch(c) for n, c in
                     C.q19_tables(4000, 400, 1000).items()}, C.Q19),
    "q98_pushed": (lambda: _windows(4000), C.Q98_PUSHED),
    "q51_store": (lambda: _windows(4000), C.Q51_STORE),
    "ysb": (lambda: C.ysb_batches(C.ysb_tables(4000)), C.YSB_SQL),
    **{f"tags_{q}": (lambda: {"posts": C.tags_batch(C.tags_tables(1000))},
                     sql) for q, sql in C.TAGS_SQL.items()},
    "clickbench_q10": (lambda: {"hits": C.hits_batch(C.hits_tables(4000))},
                       C.Q10),
    "q13": (_q13, C.Q13),
    "q28": (lambda: {"store_sales": C.q28_batch(C.q28_tables(4000))},
            C.Q28),
}


@pytest.mark.parametrize("query", sorted(CORPUS))
def test_host_engine_equals_jax_cpu_engine(query):
    make, sql = CORPUS[query]
    batches = make()
    js = TpuSparkSession(dict(OFF))
    try:
        for name, b in batches.items():
            js.createDataFrame(jax_batch(b), num_partitions=4) \
                .createOrReplaceTempView(name)
        want = _rows(js.sql(sql)._execute().to_pydict())
    finally:
        js.stop()
    ps = TorchSparkSession(dict(OFF), device="cpu")
    for name, b in batches.items():
        ps.createDataFrame(b, num_partitions=4).createOrReplaceTempView(name)
    got = _rows(ps.sql(sql)._execute().to_pydict())
    assert want, query
    assert len(got) == len(want)
    for w, g in zip(sorted(want, key=_sort_key), sorted(got, key=_sort_key)):
        for a, b in zip(w, g):
            assert values_equal(a, b, False), (w, g)
    names = []

    def walk(p):
        names.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(ps.last_plan)
    assert all(n.startswith("Cpu") for n in names), names
    assert ps.last_rewrite_report is None


@pytest.mark.parametrize("seed", range(6))
def test_group_ids_equals_the_row_walk(seed):
    """Nulls form groups, NaN is one key, -0.0 equals 0.0, and groups are
    numbered in the order of their first row, as the row walk numbers
    them."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    cols = []
    for kind in rng.integers(0, 4, int(rng.integers(1, 4))):
        valid = rng.random(n) < 0.85
        if kind == 0:
            cols.append(HostColumn(PT.IntegerT, rng.integers(
                -3, 3, n).astype(np.int32), valid))
        elif kind == 1:
            cols.append(HostColumn(PT.DoubleT, rng.choice(np.array(
                [0.0, -0.0, 1.5, np.nan, -2.0]), n), valid))
        elif kind == 2:
            cols.append(HostColumn(PT.StringT, np.array(
                [str(rng.choice(["a", "b", "", "ab"])) for _ in range(n)],
                dtype=object), valid))
        else:
            cols.append(HostColumn(PT.BooleanT,
                                   rng.integers(0, 2, n).astype(bool), valid))
    gids, ngroups, reps = P.group_ids(cols, n)
    want = P._group_ids_rows(cols, n)
    assert ngroups == want[1]
    assert (gids == want[0]).all() and (reps == want[2]).all()


@pytest.mark.parametrize("seed", range(4))
def test_narrow_decimal_arithmetic_equals_the_limb_path(seed):
    """``+``, ``-`` and ``*`` of two decimals within 18 digits take int64
    (or one 64x64 product) on the host; data and validity equal the
    128-bit limb path's (``ops.decimal_ops``) on random precisions and
    scales, at both ends of each range and with nulls."""
    rng = np.random.default_rng(seed)
    n = 2000
    checked = 0
    for _ in range(60):
        p1, p2 = (int(x) for x in rng.integers(1, 19, 2))
        s1, s2 = int(rng.integers(0, p1 + 1)), int(rng.integers(0, p2 + 1))
        lt, rt = PT.DecimalType(p1, s1), PT.DecimalType(p2, s2)
        a = rng.integers(-(10 ** p1) + 1, 10 ** p1, n, dtype=np.int64)
        b = rng.integers(-(10 ** p2) + 1, 10 ** p2, n, dtype=np.int64)
        a[:4], b[:4] = 10 ** p1 - 1, -(10 ** p2 - 1)
        lc = HostColumn(lt, a, rng.random(n) < 0.9)
        rc = HostColumn(rt, b, rng.random(n) < 0.9)
        valid = lc.validity & rc.validity
        for sym in "+-*":
            res = PT.decimal_binary_result(sym, lt, rt)
            ahi, alo = PE._dec_limbs(lc)
            bhi, blo = PE._dec_limbs(rc)
            if sym == "*":
                if not D.mul_supported(lt, rt):
                    continue
                hi, lo, ok = D.mul(np, ahi, alo, bhi, blo, lt, rt, res)
            else:
                hi, lo, ok = D.add_sub(np, sym, ahi, alo, bhi, blo, lt, rt,
                                       res)
            want = PE._limbs_to_col(hi, lo, valid & ok, res)
            got = PE._decimal_arith(sym, lc, rc, valid, res)
            assert (got.validity == want.validity).all(), (sym, lt, rt)
            assert (got.data == want.data).all(), (sym, lt, rt)
            checked += 1
    assert checked > 100


@pytest.mark.parametrize("seed", range(3))
def test_wide_times_narrow_product_equals_the_limb_path(seed):
    """A decimal128 column times a narrow one, where the values fit int64
    (the product in int64) and where some do not (the limb path): data
    and validity equal ``decimal_ops.mul``'s."""
    rng = np.random.default_rng(seed)
    n = 3000
    lt, rt = PT.DecimalType(32, 4), PT.DecimalType(16, 2)
    res = PT.decimal_binary_result("*", lt, rt)
    for top in (10 ** 11, 10 ** 30):
        vals = [int(v) for v in rng.integers(-10 ** 11, 10 ** 11, n)]
        vals[:3] = [top - 1, -(top - 1), 0]
        from spark_rapids_tpu_torch.ops import int128 as I
        hi, lo = I.from_pyints(vals)
        lc = HostColumn(lt, np.stack([hi, lo], axis=1),
                        rng.random(n) < 0.9).normalized()
        rc = HostColumn(rt, rng.integers(-10 ** 6, 10 ** 6, n),
                        rng.random(n) < 0.9)
        valid = lc.validity & rc.validity
        ahi, alo = PE._dec_limbs(lc)
        bhi, blo = PE._dec_limbs(rc)
        whi, wlo, ok = D.mul(np, ahi, alo, bhi, blo, lt, rt, res)
        want = PE._limbs_to_col(whi, wlo, valid & ok, res)
        got = PE._decimal_arith("*", lc, rc, valid, res)
        assert (got.validity == want.validity).all(), top
        assert (got.data == want.data).all(), top


@pytest.mark.parametrize("wide", [False, True])
def test_decimal_group_sums_equal_python_ints(wide):
    """The host's decimal128 sums per group (exact bincounts over 32-bit
    parts) equal Python's sums, at the ends of int64 and of 38 digits,
    with nulls, and an overflowing group is null."""
    from spark_rapids_tpu_torch.ops import int128 as I
    rng = np.random.default_rng(7)
    n = 5000
    ngroups = 5
    gids = rng.integers(0, ngroups, n).astype(np.int64)
    if wide:
        vals = [int(v) * 10 ** 18 + int(w) for v, w in zip(
            rng.integers(-10 ** 12, 10 ** 12, n),
            rng.integers(0, 10 ** 18, n))]
        vals[:12] = [10 ** 37] * 12  # group 4 overflows 38 digits
        gids[:12] = 4
        gids[12:][gids[12:] == 4] = 3
        valid = rng.random(n) < 0.9
        valid[:12] = True
        hi, lo = I.from_pyints(vals)
        col = HostColumn(PT.DecimalType(38, 0), np.stack([hi, lo], axis=1),
                         valid).normalized()
    else:
        vals = [int(v) for v in rng.integers(-(1 << 63), (1 << 63) - 1, n,
                                             dtype=np.int64)]
        col = HostColumn(PT.DecimalType(18, 0), np.array(vals, np.int64),
                         rng.random(n) < 0.9)
    out_type = PT.DecimalType(38, 0)
    got = P.apply_update_prim(PE.PRIM_SUM, col, gids, ngroups, out_type)
    assert got.validity.tolist() == [True] * 4 + [not wide]
    ints = I.to_pyints(got.data[:, 0], got.data[:, 1])
    for g in range(ngroups):
        members = [v for v, gg, ok in zip(vals, gids, col.validity)
                   if ok and gg == g]
        total = sum(members)
        if not members or abs(total) >= 10 ** 38:
            assert not got.validity[g], g
        else:
            assert got.validity[g] and int(ints[g]) == total, g


@pytest.mark.parametrize("cls", ["StartsWith", "EndsWith", "Contains",
                                 "Like", "RLike"])
def test_string_predicates_once_a_distinct_value(cls):
    """A string predicate with a literal pattern, evaluated once a
    distinct value and gathered back, equals the row loop (nulls
    false and invalid)."""
    rng = np.random.default_rng(11)
    n = 600
    words = np.array(["special requests", "a_b%", "", "xspecial",
                      "requests special", "ab\n", "日本"], dtype=object)
    data = words[rng.integers(0, len(words), n)]
    valid = rng.random(n) < 0.8
    data[~valid] = ""
    col = HostColumn(PT.StringT, data, valid)
    batch = PE.HostBatch(PT.StructType([PT.StructField("s", PT.StringT)]),
                         [col], n)
    pattern = {"Like": "%special%requests%", "RLike": "spec.*"}.get(
        cls, "special")
    expr = getattr(PE, cls)(PE.BoundReference(0, PT.StringT, True),
                            PE.Literal(pattern, PT.StringT))
    got = expr.eval(batch)
    want = [bool(ok) and expr.scalar(v, pattern)
            for v, ok in zip(data, valid)]
    assert got.data.tolist() == want
    assert (got.validity == valid).all()


@pytest.mark.parametrize("mean_len", [1, 3, 40, 300])
def test_plain_string_pages_decode_as_python_reads_them(mean_len):
    """A PLAIN byte-array body's value lengths (the pointer doubling for
    short values, the walk for long ones) and a dictionary page's char
    matrix equal a Python read of the same bytes."""
    from spark_rapids_tpu_torch.io import device_decode as DD
    rng = np.random.default_rng(mean_len)
    n = 700
    vals = [bytes(rng.integers(32, 127, int(k)).astype(np.uint8))
            for k in rng.integers(0, 2 * mean_len + 1, n)]
    body = b"".join(struct.pack("<I", len(v)) + v for v in vals)
    lens = DD._plain_str_lengths(b"pad" + body, 3, 3 + len(body), n)
    assert lens.tolist() == [len(v) for v in vals]
    walked = DD._plain_str_lengths_walk(body, 0, len(body), n)
    assert walked.tolist() == [len(v) for v in vals]
    with pytest.raises(DD.UnsupportedColumn):
        DD._plain_str_lengths_walk(body[:-1], 0, len(body) - 1, n)
    (chars, lengths), cap = DD._decode_dict_page(body, n, PT.StringT,
                                                 "str", None)
    assert cap >= max(len(v) for v in vals)
    for i, v in enumerate(vals):
        assert lengths[i] == len(v)
        assert chars[i, :len(v)].tobytes() == v
        assert not chars[i, len(v):].any()
