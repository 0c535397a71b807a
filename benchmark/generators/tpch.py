"""TPC-H ``lineitem`` by the specification's rules (TPC-H v3, clause
4.2.3), for the columns q1 reads.

Rows follow the clause:

- each order's count of lines uniform in [1, 7], drawn per order as
  dbgen draws it (about 6.0M rows at SF1; the count varies with the seed
  by some thousands);
- ``O_ORDERDATE`` uniform in [STARTDATE, ENDDATE - 151 days]
  (1992-01-01 .. 1998-08-02);
- ``L_SHIPDATE`` = orderdate + [1, 121] days, ``L_RECEIPTDATE`` =
  shipdate + [1, 30] days;
- ``L_RETURNFLAG`` 'R' or 'A' at random where the receipt date is on or
  before CURRENTDATE (1995-06-17), else 'N';
- ``L_LINESTATUS`` 'O' where the ship date is after CURRENTDATE, else 'F';
- ``L_QUANTITY`` in [1, 50], ``L_DISCOUNT`` in [0.00, 0.10], ``L_TAX`` in
  [0.00, 0.08];
- ``L_EXTENDEDPRICE`` = quantity x ``P_RETAILPRICE`` of a part key uniform
  in [1, SF x 200,000], with P_RETAILPRICE = (90000 + ((partkey / 10)
  mod 20001) + 100 x (partkey mod 1000)) / 100 (clause 4.2.3).

Decimals are unscaled int64 (scale 2), dates int32 days since
1970-01-01, flags one-character strings.
"""

from __future__ import annotations

import numpy as np

EPOCH = np.datetime64("1970-01-01")


def _day(iso: str) -> int:
    return int((np.datetime64(iso) - EPOCH).astype(int))


def generate(params: dict, rng: np.random.Generator) -> dict:
    """``{"lineitem": {column: array}}`` for ``params["orders"]`` orders,
    rows in order-key order as dbgen writes them."""
    n_orders = int(params["orders"])
    lo_lines, hi_lines = params["lines_per_order"]
    lines = rng.integers(lo_lines, hi_lines + 1, n_orders)
    n = int(lines.sum())
    start, end = _day(params["start_date"]), _day(params["end_date"])
    current = _day(params["current_date"])
    orderdate = rng.integers(start, end - 151 + 1, n_orders,
                             dtype=np.int32)
    orderdate = np.repeat(orderdate, lines)
    shipdate = orderdate + rng.integers(1, 122, n, dtype=np.int32)
    receiptdate = shipdate + rng.integers(1, 31, n, dtype=np.int32)
    partkey = rng.integers(1, int(params["parts"]) + 1, n)
    retail_cents = (90000 + (partkey // 10) % 20001
                    + 100 * (partkey % 1000))
    quantity = rng.integers(1, 51, n)
    flags = np.array(["R", "A"], dtype=object)[rng.integers(0, 2, n)]
    returnflag = np.where(receiptdate <= current, flags, "N").astype(object)
    linestatus = np.where(shipdate > current, "O", "F").astype(object)
    return {"lineitem": {
        "l_quantity": quantity * 100,
        "l_extendedprice": quantity * retail_cents,
        "l_discount": rng.integers(0, 11, n),
        "l_tax": rng.integers(0, 9, n),
        "l_returnflag": returnflag,
        "l_linestatus": linestatus,
        "l_shipdate": shipdate,
    }}
