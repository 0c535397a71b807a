"""The NumPy references against brute-force loops at a tiny size, and
the controls against the references."""

import datetime
import decimal
import json
import os

import pytest

import parquet_data
from conftest import BENCH

D = decimal.Decimal


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def half_up(x: D, scale: int) -> D:
    return x.quantize(D(1).scaleb(-scale), decimal.ROUND_HALF_UP)


def q1_loop(li, shipdate: str):
    """q1 row by row with Python decimals."""
    cutoff = (datetime.date.fromisoformat(shipdate)
              - datetime.date(1970, 1, 1)).days
    acc = {}
    for i in range(len(li["l_quantity"])):
        if li["l_shipdate"][i] > cutoff:
            continue
        q, p = D(int(li["l_quantity"][i])) / 100, \
            D(int(li["l_extendedprice"][i])) / 100
        d, t = D(int(li["l_discount"][i])) / 100, D(int(li["l_tax"][i])) / 100
        a = acc.setdefault((li["l_returnflag"][i], li["l_linestatus"][i]),
                           [D(0)] * 5 + [0])
        for j, v in enumerate((q, p, p * (1 - d), p * (1 - d) * (1 + t), d)):
            a[j] += v
        a[5] += 1
    out = []
    for k in sorted(acc):
        sq, sp, sd, sc, sdisc, n = acc[k]
        out.append(k + (half_up(sq, 2), half_up(sp, 2), half_up(sd, 4),
                        half_up(sc, 6), half_up(sq / n, 6),
                        half_up(sp / n, 6), half_up(sdisc / n, 6), n))
    return out


@pytest.mark.parametrize("shipdate",
                         ["1998-08-03", "1998-10-02", "1995-06-17"])
def test_q1_reference_matches_loop(shipdate):
    data = parquet_data.generate(config("tpch_sf1"), 21, scale=0.001)
    ref = parquet_data.load_module("reference", "tpch_q1")
    state = ref.prepare(data)
    want = q1_loop(data["lineitem"], shipdate)
    got = ref.rows(state, {"SHIPDATE": shipdate})
    assert ref.compare(got, want) is None
    assert ref.agg_input(state, {"SHIPDATE": shipdate})["rows"] == \
        sum(r[-1] for r in want)


def q3_loop(data, manufact: int, moy: int):
    """q3 by nested loops over dictionaries."""
    dd = {int(k): (int(y), int(m)) for k, y, m in zip(
        data["date_dim"]["d_date_sk"], data["date_dim"]["d_year"],
        data["date_dim"]["d_moy"])}
    it = {int(k): (int(b), s, int(m)) for k, b, s, m in zip(
        data["item"]["i_item_sk"], data["item"]["i_brand_id"],
        data["item"]["i_brand"], data["item"]["i_manufact_id"])}
    sums = {}
    ss = data["store_sales"]
    for d, i, p in zip(ss["ss_sold_date_sk"].tolist(),
                       ss["ss_item_sk"].tolist(),
                       ss["ss_ext_sales_price"].tolist()):
        if d in dd and i in it and dd[d][1] == moy and it[i][2] == manufact:
            k = (dd[d][0], it[i][0], it[i][1])
            sums[k] = sums.get(k, D(0)) + D(p) / 100
    rows = sorted(((y, b, s, half_up(v, 2)) for (y, b, s), v in sums.items()),
                  key=lambda r: (r[0], -r[3], r[1]))
    return rows[:100]


def q3_small():
    cfg = config("tpcds_sf1")
    cfg["params"] = dict(cfg["params"], item_rows=300, manufacturers=20)
    return parquet_data.generate(cfg, 8, scale=0.01)


@pytest.mark.parametrize("manufact,moy", [(3, 11), (7, 12), (19, 11)])
def test_q3_reference_matches_loop(manufact, moy):
    data = q3_small()
    ref = parquet_data.load_module("reference", "tpcds_q3")
    state = ref.prepare(data)
    binding = {"MANUFACT": manufact, "MONTH": moy}
    want = q3_loop(data, manufact, moy)
    assert want, "the case should have rows"
    assert ref.compare(ref.rows(state, binding), want) is None
    assert ref.agg_input(state, binding)["groups"] == len(
        {r[:3] for r in want}) or len(want) == 100


def test_compare_catches_scale_order_and_values():
    data = q3_small()
    ref = parquet_data.load_module("reference", "tpcds_q3")
    want = ref.rows(ref.prepare(data), {"MANUFACT": 3, "MONTH": 11})
    assert len(want) > 2
    assert ref.compare(list(reversed(want)), want) is not None
    bad = [r[:3] + (r[3].quantize(D("0.001")),) for r in want]
    assert ref.compare(bad, want) is not None
    off = [want[0][:3] + (want[0][3] + D("0.01"),)] + want[1:]
    assert ref.compare(off, want) is not None


def test_controls_differ_from_references():
    """The controls' rows are caught: q1's float64 decimals at the
    cell's size (SF1: the charge's sums pass 2**53 units), q3's order cut
    to d_year."""
    q1 = parquet_data.load_module("reference", "tpch_q1")
    data = parquet_data.generate(config("tpch_sf1"), 4)
    st = q1.prepare(data)
    b = {"SHIPDATE": "1998-09-02"}
    assert q1.compare(q1.control_rows(st, b), q1.rows(st, b)) is not None
    q3 = parquet_data.load_module("reference", "tpcds_q3")
    data = q3_small()
    st = q3.prepare(data)
    caught = [q3.compare(q3.control_rows(st, {"MANUFACT": m, "MONTH": 11}),
                         q3.rows(st, {"MANUFACT": m, "MONTH": 11}))
              is not None for m in range(1, 21)]
    assert sum(caught) >= 15
