"""TPC-DS ``store_sales``, ``item`` and ``date_dim`` at the
specification's row counts, for the columns q3 reads.

``date_dim`` is the calendar itself: ``d_date_sk`` 2415022 for
1900-01-02, one row a day, with its year and month. The sold-date keys
are uniform over the days ``store_sales`` covers (1998-01-02 ..
2003-01-02, ``d_date_sk`` 2450816 .. 2452642). Every other column is
uniform over its domain, which the configuration lists under
``assumed``: item keys over the items, ``i_manufact_id`` in [1, 1000],
the brand from a category (1-10), a class (1-16) and a brand number
(1-10) as dsdgen composes ``i_brand_id``, with a name made of the
specification's syllables, and ``ss_ext_sales_price`` in cents over
[0.00, max]. No column holds nulls.

Keys are int32 (``int`` in Spark's TPC-DS schema), the price an unscaled
int64 at scale 2, the brand a string.
"""

from __future__ import annotations

import numpy as np

EPOCH = np.datetime64("1970-01-01")
# the specification's digit syllables, from which dsdgen builds names
SYLLABLES = ("ought", "able", "pri", "ese", "anti", "cally", "ation",
             "eing", "n st", "bar")


def _word(k: np.ndarray) -> np.ndarray:
    """dsdgen's name of a number: one syllable per decimal digit."""
    out = []
    for v in k.tolist():
        out.append("".join(SYLLABLES[int(d)] for d in str(v)))
    return np.array(out, dtype=object)


def generate(params: dict, rng: np.random.Generator) -> dict:
    n_date = int(params["date_dim_rows"])
    first = np.datetime64(params["date_dim_first_date"])
    days = first + np.arange(n_date).astype("timedelta64[D]")
    months = days.astype("datetime64[M]")
    date_dim = {
        "d_date_sk": (int(params["date_dim_first_sk"])
                      + np.arange(n_date)).astype(np.int32),
        "d_year": (days.astype("datetime64[Y]").astype(int)
                   + 1970).astype(np.int32),
        "d_moy": (months.astype(int) % 12 + 1).astype(np.int32),
    }

    n_item = int(params["item_rows"])
    category = rng.integers(1, 11, n_item)
    klass = rng.integers(1, 17, n_item)
    brand_n = rng.integers(1, 11, n_item)
    brand_id = (category * 1_000_000 + klass * 1_000 + brand_n)
    names = _word(np.arange(1, 17))[klass - 1] + \
        _word(np.arange(1, 11))[category - 1]
    item = {
        "i_item_sk": np.arange(1, n_item + 1, dtype=np.int32),
        "i_brand_id": brand_id.astype(np.int32),
        "i_brand": np.array([f"{s} #{b}" for s, b in
                             zip(names.tolist(), brand_n.tolist())],
                            dtype=object),
        "i_manufact_id": rng.integers(
            1, int(params["manufacturers"]) + 1, n_item).astype(np.int32),
    }

    n_sales = int(params["store_sales_rows"])
    lo, hi = params["sold_date_sk_range"]
    store_sales = {
        "ss_sold_date_sk": rng.integers(lo, hi + 1, n_sales,
                                        dtype=np.int32),
        "ss_item_sk": rng.integers(1, n_item + 1, n_sales,
                                   dtype=np.int32),
        "ss_ext_sales_price": rng.integers(
            0, int(params["ext_sales_price_max_cents"]) + 1, n_sales),
    }
    return {"store_sales": store_sales, "item": item, "date_dim": date_dim}
