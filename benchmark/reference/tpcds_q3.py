"""TPC-DS q3 in plain NumPy and Python integers, independent of any
engine: both joins by key (a sorted search over each dimension's keys),
the two dimension predicates, the grouping on (d_year, i_brand_id,
i_brand), the exact sum of decimal(7,2) at scale 2 (Spark's
decimal(17,2)), ORDER BY d_year, sum_agg DESC, brand_id and LIMIT 100.

Every binding is a (MANUFACT, MONTH) pair, so the joined rows are sorted
once by that pair and each query's rows are one slice of them.
"""

from __future__ import annotations

import decimal

import numpy as np

SCANS = {"store_sales": ["ss_sold_date_sk", "ss_item_sk",
                         "ss_ext_sales_price"],
         "item": ["i_item_sk", "i_brand_id", "i_brand", "i_manufact_id"],
         "date_dim": ["d_date_sk", "d_year", "d_moy"]}
AGG_KEYS = ("d_year", "i_brand_id", "i_brand")
AGG_INPUTS = ("ss_ext_sales_price",)
AGG_OUTPUTS = 1
LIMIT = 100


def _lookup(dim_keys: np.ndarray, fact_keys: np.ndarray):
    order = np.argsort(dim_keys, kind="stable")
    pos = np.minimum(np.searchsorted(dim_keys[order], fact_keys),
                     len(order) - 1)
    return order[pos], dim_keys[order][pos] == fact_keys


def prepare(data: dict) -> dict:
    """The joined rows sorted by (i_manufact_id, d_moy), in store_sales
    order within each pair."""
    ss, it, dd = data["store_sales"], data["item"], data["date_dim"]
    drow, dhit = _lookup(dd["d_date_sk"], ss["ss_sold_date_sk"])
    irow, ihit = _lookup(it["i_item_sk"], ss["ss_item_sk"])
    keep = np.flatnonzero(dhit & ihit)
    pair = (it["i_manufact_id"][irow[keep]].astype(np.int64) * 16
            + dd["d_moy"][drow[keep]])
    order = np.argsort(pair, kind="stable")
    rows = keep[order]
    return {"pair": pair[order], "year": dd["d_year"][drow[rows]],
            "item": irow[rows], "price": ss["ss_ext_sales_price"][rows],
            "data": data}


def _groups(state: dict, binding: dict) -> dict:
    """{(d_year, i_brand_id, i_brand): unscaled sum}, in first-seen
    order."""
    k = int(binding["MANUFACT"]) * 16 + int(binding["MONTH"])
    lo, hi = np.searchsorted(state["pair"], [k, k + 1])
    it = state["data"]["item"]
    groups: dict = {}
    for y, i, p in zip(state["year"][lo:hi].tolist(),
                       state["item"][lo:hi].tolist(),
                       state["price"][lo:hi].tolist()):
        g = (y, int(it["i_brand_id"][i]), it["i_brand"][i])
        groups[g] = groups.get(g, 0) + p
    return groups


def _result(groups: dict, order_key) -> list:
    rows = sorted(((y, b, s, v) for (y, b, s), v in groups.items()),
                  key=order_key)
    return [(y, b, s, decimal.Decimal(v).scaleb(-2))
            for y, b, s, v in rows[:LIMIT]]


def rows(state: dict, binding: dict) -> list:
    """The exact result rows: (d_year, brand_id, brand, sum_agg), the
    sum a ``Decimal`` at scale 2."""
    return _result(_groups(state, binding),
                   lambda r: (r[0], -r[3], r[1]))


def compare(got: list, want: list) -> str | None:
    """None where ``got`` equals ``want``: the same rows in the ORDER BY's
    order, each sum at scale 2. Rows that tie on the whole sort key
    (d_year, sum_agg, brand_id) may come in either order."""
    got = [tuple(r) for r in got]
    if len(got) != len(want):
        return f"{len(got)} rows, want {len(want)}"

    def key(r):
        return (r[0], r[3], r[1])
    if [key(r) for r in got] != [key(r) for r in want]:
        return f"order or values differ: {got[:3]} vs {want[:3]}"
    for g, w in zip(sorted(got, key=repr), sorted(want, key=repr)):
        if g != w:
            return f"row {g} != {w}"
        if not isinstance(g[3], decimal.Decimal) \
                or g[3].as_tuple().exponent != -2:
            return f"row {g}: sum_agg not a decimal at scale 2"
    return None


def agg_input(state: dict, binding: dict) -> dict:
    """What the partial aggregate takes in for ``binding``: the rows that
    pass both joins and predicates, and the groups they form."""
    groups = _groups(state, binding)
    k = int(binding["MANUFACT"]) * 16 + int(binding["MONTH"])
    lo, hi = np.searchsorted(state["pair"], [k, k + 1])
    return {"rows": int(hi - lo), "groups": len(groups)}


def control_rows(state: dict, binding: dict) -> list:
    """The control: q3 with ORDER BY's guarantee broken the way a plan
    that skips the final sort's secondary keys would: rows ordered by
    d_year alone, in the order their groups were first seen. (Doubles in
    place of decimals are no control here: the sums of q3's few rows a
    group stay below 2**53 cents, so float64 gives the exact rows.)"""
    return _result(_groups(state, binding), lambda r: r[0])
