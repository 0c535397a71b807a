"""The generators follow their specifications' rules."""

import datetime
import json
import os

import numpy as np

import parquet_data
from conftest import BENCH


def config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def day(iso):
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def test_tpch_lineitem_rules_and_q1_groups():
    cfg = config("tpch_sf1")
    li = parquet_data.generate(cfg, 11, scale=0.02)["lineitem"]
    n_orders = int(cfg["params"]["orders"] * 0.02)
    # 1..7 lines an order, each order's count drawn uniformly: 4 a mean
    n = len(li["l_quantity"])
    assert n_orders <= n <= 7 * n_orders
    assert abs(n - 4 * n_orders) < 5 * (4 * n_orders) ** 0.5
    ship, current = li["l_shipdate"], day("1995-06-17")
    assert ship.min() >= day("1992-01-02")
    assert ship.max() <= day("1998-08-02") + 121
    assert set(np.unique(li["l_quantity"] // 100)) <= set(range(1, 51))
    assert li["l_quantity"].min() % 100 == 0
    assert 0 <= li["l_discount"].min() and li["l_discount"].max() <= 10
    assert 0 <= li["l_tax"].min() and li["l_tax"].max() <= 8
    np.testing.assert_array_equal(li["l_linestatus"] == "O", ship > current)
    # 'N' exactly where the receipt date (ship + 1..30) is after CURRENTDATE
    n = li["l_returnflag"] == "N"
    assert n[ship > current].all() and not n[ship + 30 <= current].any()
    # extended price = quantity x a retail price of the spec's formula
    qty = li["l_quantity"] // 100
    assert (li["l_extendedprice"] % qty == 0).all()
    retail = li["l_extendedprice"] // qty
    assert retail.min() >= 90000 and retail.max() <= 90000 + 20000 + 99900
    groups = set(zip(li["l_returnflag"].tolist(),
                     li["l_linestatus"].tolist()))
    assert groups == {("A", "F"), ("N", "F"), ("N", "O"), ("R", "F")}


def test_tpch_same_seed_same_data_and_sizes():
    cfg = config("tpch_sf1")
    a = parquet_data.generate(cfg, 5, scale=0.005)["lineitem"]
    b = parquet_data.generate(cfg, 5, scale=0.005)["lineitem"]
    c = parquet_data.generate(cfg, 6, scale=0.005)["lineitem"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    n_orders = int(cfg["params"]["orders"] * 0.005)
    for d in (a, c):
        # the row count varies with the seed by a small share only
        assert abs(len(d["l_tax"]) - 4 * n_orders) < 5 * (4 * n_orders) ** 0.5
    assert not np.array_equal(a["l_shipdate"][:100], c["l_shipdate"][:100])


def test_tpcds_cardinalities_and_calendar():
    data = parquet_data.generate(config("tpcds_sf1"), 3)
    assert len(data["store_sales"]["ss_item_sk"]) == 2_880_404
    assert len(data["item"]["i_item_sk"]) == 18_000
    dd = data["date_dim"]
    assert len(dd["d_date_sk"]) == 73_049
    i = int(np.flatnonzero(dd["d_date_sk"] == 2450816)[0])
    first = datetime.date(1900, 1, 2) + datetime.timedelta(days=i)
    assert first == datetime.date(1998, 1, 2)
    assert (dd["d_year"][i], dd["d_moy"][i]) == (1998, 1)
    sold = data["store_sales"]["ss_sold_date_sk"]
    assert sold.min() >= 2450816 and sold.max() <= 2452642
    it = data["item"]
    assert it["i_manufact_id"].min() >= 1 and it["i_manufact_id"].max() <= 1000
    # a brand id names one brand
    pairs = set(zip(it["i_brand_id"].tolist(), it["i_brand"].tolist()))
    assert len(pairs) == len(set(it["i_brand_id"].tolist()))


def test_parquet_layout_as_spark_writes_it(tmp_path):
    import pyarrow.parquet as pq
    cfg = config("tpch_sf1")
    data = parquet_data.generate(cfg, 2, scale=0.002)
    views = parquet_data.write_tables(cfg, data, str(tmp_path))
    files = sorted(os.listdir(views["lineitem"]))
    assert len(files) == 6
    md = pq.ParquetFile(os.path.join(views["lineitem"], files[0])).metadata
    assert md.num_row_groups == 1
    phys = {md.schema.column(j).name: md.schema.column(j).physical_type
            for j in range(md.num_columns)}
    assert phys["l_extendedprice"] == "INT64"
    assert phys["l_shipdate"] == "INT32"
    assert md.row_group(0).column(0).compression == "SNAPPY"
    back = pq.read_table(views["lineitem"]).column("l_tax").to_pylist()
    assert [int(v * 100) for v in back] == data["lineitem"]["l_tax"].tolist()
