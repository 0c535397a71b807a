"""TPC-H q1 in plain NumPy and Python integers, independent of any
engine: the filter on ``l_shipdate``, the grouping on (returnflag,
linestatus), the exact decimal sums, products and averages at Spark's
result scales, and the ORDER BY.

Spark's types: a sum of decimal(15,2) is decimal(25,2); price x (1 -
discount) has scale 4 and x (1 + tax) scale 6; avg of decimal(15,2) is
decimal(19,6), rounded HALF_UP. Each query's cut-off is one binding,
so the rows of every cut-off come from one pass: each group's rows
sorted by ship date with running int64 sums (the largest, the charge at
scale 6, stays below 2**63 at SF1: about 1.7e17).
"""

from __future__ import annotations

import datetime
import decimal

import numpy as np

# the columns q1 reads, by table
SCANS = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount",
                      "l_tax", "l_returnflag", "l_linestatus",
                      "l_shipdate"]}
# what enters the partial aggregate: its key columns and the columns it
# aggregates (the products are computed from these inside the stage)
AGG_KEYS = ("l_returnflag", "l_linestatus")
AGG_INPUTS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
# the aggregates a group yields: four sums, three averages, a count
AGG_OUTPUTS = 8
# every (returnflag, linestatus) the specification's domains allow, in
# the ORDER BY's order; groups with no rows are left out
GROUPS = tuple((rf, ls) for rf in "ANR" for ls in "FO")


def _day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


def _half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return -q if num < 0 else q


def prepare(data: dict) -> dict:
    """Each group's ship dates sorted, with running sums beside them."""
    li = data["lineitem"]
    qty, price = li["l_quantity"], li["l_extendedprice"]
    disc, tax = li["l_discount"], li["l_tax"]
    disc_price = price * (100 - disc)             # scale 4
    charge = disc_price * (100 + tax)              # scale 6
    groups = {}
    for rf, ls in GROUPS:
        m = (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
        if not m.any():
            continue
        order = np.argsort(li["l_shipdate"][m], kind="stable")
        cols = np.stack([qty[m], price[m], disc_price[m], charge[m],
                         disc[m], np.ones(int(m.sum()), np.int64)])
        groups[(rf, ls)] = (li["l_shipdate"][m][order],
                            np.cumsum(cols[:, order], axis=1))
    if sum(int(c[-1, -1]) for _s, c in groups.values()) != len(qty):
        raise ValueError("a flag outside the specification's domains")
    return {"groups": groups, "data": data}


def _sums(state: dict, binding: dict):
    cutoff = _day(binding["SHIPDATE"])
    for key, (ship, cum) in state["groups"].items():
        n = int(np.searchsorted(ship, cutoff, side="right"))
        if n:
            yield key, [int(v) for v in cum[:, n - 1]]


def rows(state: dict, binding: dict) -> list:
    """The exact result rows: (rf, ls, sum_qty, sum_base_price,
    sum_disc_price, sum_charge, avg_qty, avg_price, avg_disc,
    count_order), decimals as ``Decimal`` at their result scales."""
    out = []
    for (rf, ls), (sq, sp, sd, sc, sdisc, cnt) in _sums(state, binding):
        vals = [(sq, 2), (sp, 2), (sd, 4), (sc, 6),
                (_half_up_div(sq * 10**4, cnt), 6),
                (_half_up_div(sp * 10**4, cnt), 6),
                (_half_up_div(sdisc * 10**4, cnt), 6)]
        out.append((rf, ls) + tuple(decimal.Decimal(v).scaleb(-s)
                                    for v, s in vals) + (cnt,))
    return out


def compare(got: list, want: list) -> str | None:
    """None where ``got`` equals ``want`` value for value, in order and
    at every decimal's scale; else what differs."""
    got = [tuple(r) for r in got]
    if len(got) != len(want):
        return f"{len(got)} rows, want {len(want)}"
    for g, w in zip(got, want):
        if g != w:
            return f"row {g} != {w}"
        for v, e in zip(g[2:9], w[2:9]):
            if not isinstance(v, decimal.Decimal) \
                    or v.as_tuple().exponent != e.as_tuple().exponent:
                return f"row {g}: {v!r} not at scale {-e.as_tuple().exponent}"
    return None


def agg_input(state: dict, binding: dict) -> dict:
    """What the partial aggregate takes in for ``binding``: the rows that
    pass the filter, and the groups it yields."""
    sums = list(_sums(state, binding))
    return {"rows": sum(s[-1] for _k, s in sums), "groups": len(sums)}


def control_rows(state: dict, binding: dict) -> list:
    """The control: q1 with its decimals computed in float64, the nearest
    precision below exact decimals (values as doubles, sums in double,
    each result rounded HALF_UP at its scale)."""
    li = state["data"]["lineitem"]
    cutoff = _day(binding["SHIPDATE"])
    qty, price = li["l_quantity"] / 100.0, li["l_extendedprice"] / 100.0
    disc, tax = li["l_discount"] / 100.0, li["l_tax"] / 100.0
    keep = li["l_shipdate"] <= cutoff
    out = []

    def dec(x: float, scale: int) -> decimal.Decimal:
        return decimal.Decimal(repr(float(x))).quantize(
            decimal.Decimal(1).scaleb(-scale), decimal.ROUND_HALF_UP)
    for rf, ls in GROUPS:
        m = keep & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
        cnt = int(m.sum())
        if not cnt:
            continue
        dp = price[m] * (1 - disc[m])
        sq, sp, sdisc = qty[m].sum(), price[m].sum(), disc[m].sum()
        out.append((rf, ls, dec(sq, 2), dec(sp, 2), dec(dp.sum(), 4),
                    dec((dp * (1 + tax[m])).sum(), 6), dec(sq / cnt, 6),
                    dec(sp / cnt, 6), dec(sdisc / cnt, 6), cnt))
    return out
