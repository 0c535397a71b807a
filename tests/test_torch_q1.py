"""TPC-H q1 and two more queries on the same operators, run through the
JAX package's TpuSparkSession (kernels on, interpreted on the CPU) and
through the port's TorchSparkSession on the CPU: the ordered rows must be
identical. Inputs are made with numpy from a seed and fed to both
packages as the same arrays."""

import numpy as np
import pytest
import torch

from bench import Q1
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

N_ROWS = 3000
N_PARTS = 3
CONF = {"spark.sql.shuffle.partitions": "4"}


def _lineitem_arrays(n=N_ROWS, seed=20260730):
    """bench.py's lineitem generator, at a small row count."""
    rng = np.random.default_rng(seed)
    lo = (np.datetime64("1992-01-02") - np.datetime64("1970-01-01")).astype(
        int)
    hi = (np.datetime64("1998-12-01") - np.datetime64("1970-01-01")).astype(
        int)
    return [rng.integers(1, 51, n) * 100,
            rng.integers(90100, 10494951, n),
            rng.integers(0, 11, n),
            rng.integers(0, 9, n),
            np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)],
            np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)],
            rng.integers(lo, hi + 1, n).astype(np.int32)]


_LINEITEM = [("l_quantity", "dec"), ("l_extendedprice", "dec"),
             ("l_discount", "dec"), ("l_tax", "dec"),
             ("l_returnflag", "str"), ("l_linestatus", "str"),
             ("l_shipdate", "date")]


def _groupy_arrays(n=N_ROWS, seed=7, n_keys=5):
    rng = np.random.default_rng(seed)
    keys = np.array([f"k{i}" for i in range(n_keys)], dtype=object)
    k = keys[rng.integers(0, n_keys, n)]
    k_valid = rng.random(n) > 0.1
    k2 = rng.integers(-3, 3, n).astype(np.int32)
    k2_valid = rng.random(n) > 0.2
    v = rng.integers(-10**12, 10**12, n)
    v_valid = rng.random(n) > 0.15
    d = rng.integers(-10**9, 10**9, n)
    return ([k, k2, v, d], [k_valid, k2_valid, v_valid, None])


_GROUPY = [("k", "str"), ("k2", "int"), ("v", "long"), ("d", "dec10")]


def _types(mod):
    return {"dec": mod.DecimalType(15, 2), "dec10": mod.DecimalType(10, 2),
            "str": mod.StringT, "date": mod.DateT, "int": mod.IntegerT,
            "long": mod.LongT}


def _jax_batch(fields, arrays, validities=None):
    types = _types(JT)
    validities = validities or [None] * len(arrays)
    n = len(arrays[0])
    schema = JT.StructType([JT.StructField(name, types[t])
                            for name, t in fields])
    cols = [JHostColumn(f.data_type, np.asarray(a),
                        np.ones(n, bool) if v is None else v).normalized()
            for f, a, v in zip(schema.fields, arrays, validities)]
    return JHostBatch(schema, cols, n)


def _torch_batch(fields, arrays, validities=None):
    types = _types(PT)
    return host_batch_from_numpy([(name, types[t]) for name, t in fields],
                                 arrays, validities)


def _run_both(sql, fields, arrays, validities=None, conf=CONF):
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        jax_s.createDataFrame(_jax_batch(fields, arrays, validities),
                              num_partitions=N_PARTS) \
            .createOrReplaceTempView("t")
        want = [tuple(r) for r in jax_s.sql(sql).collect()]
    finally:
        jax_s.stop()
    port = TorchSparkSession(dict(conf), device="cpu")
    port.createDataFrame(_torch_batch(fields, arrays, validities),
                         num_partitions=N_PARTS).createOrReplaceTempView("t")
    got = [tuple(r) for r in port.sql(sql).collect()]
    return want, got, port


def _q1_sql():
    return Q1.replace("FROM lineitem", "FROM t")


def test_q1_rows_identical_to_jax_package():
    want, got, _port = _run_both(_q1_sql(), _LINEITEM, _lineitem_arrays())
    assert len(want) == 6
    assert got == want


def test_q1_plan_is_all_torch_between_transitions():
    _want, _got, port = _run_both(_q1_sql(), _LINEITEM, _lineitem_arrays())
    names = []

    def walk(p):
        names.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(port.last_plan)
    assert names[0] == "TorchColumnarToRowExec"
    r2c = names.index("TorchRowToColumnarExec")
    assert names[-1] == "CpuLocalScanExec" and r2c == len(names) - 2
    assert all(n.startswith("Torch") and n.endswith("Exec")
               for n in names[:r2c + 1])
    assert "TorchHashAggregateExec" in names
    assert "TorchShuffleExchangeExec" in names


def test_groupby_min_max_count_with_null_keys():
    sql = ("SELECT k, k2, min(v) AS mn, max(v) AS mx, count(v) AS cv, "
           "count(*) AS c, sum(d) AS sd, avg(d) AS ad FROM t "
           "GROUP BY k, k2 ORDER BY k, k2")
    arrays, valid = _groupy_arrays()
    want, got, _port = _run_both(sql, _GROUPY, arrays, valid)
    assert any(r[0] is None for r in want)
    assert any(r[1] is None for r in want)
    assert got == want


def test_filter_removing_every_row():
    sql = ("SELECT k, sum(v) AS s, count(*) AS c FROM t "
           "WHERE v > 2000000000000 GROUP BY k ORDER BY k")
    arrays, valid = _groupy_arrays()
    want, got, _port = _run_both(sql, _GROUPY, arrays, valid)
    assert want == [] and got == []


def test_table_overflow_reruns_on_sort_path():
    """More distinct groups per batch than the smallest table holds: the
    partial aggregate re-runs those batches on the sort-based path, the
    re-runs are counted, and the rows stay identical."""
    sql = ("SELECT k, k2, min(v) AS mn, count(*) AS c, sum(d) AS sd "
           "FROM t GROUP BY k, k2 ORDER BY k, k2")
    arrays, valid = _groupy_arrays(n_keys=150)
    conf = dict(CONF, **{"spark.rapids.sql.kernel.groupbyHash.tableSlots":
                         "64"})
    want, got, port = _run_both(sql, _GROUPY, arrays, valid, conf=conf)
    assert got == want

    def partial(p):
        if type(p).__name__ == "TorchHashAggregateExec" and \
                p.mode == "partial":
            return p
        for c in p.children:
            found = partial(c)
            if found is not None:
                return found
        return None
    assert partial(port.last_plan).overflow_reruns == N_PARTS


def test_global_aggregate_over_empty_input():
    sql = "SELECT sum(v) AS s, count(*) AS c FROM t WHERE v > 2000000000000"
    arrays, valid = _groupy_arrays()
    want, got, _port = _run_both(sql, _GROUPY, arrays, valid)
    assert want == [(None, 0)]
    assert got == want


@pytest.mark.parametrize("sql", [
    "SELECT k2, v FROM t WHERE v IS NOT NULL AND k2 >= 0 ORDER BY v DESC",
    "SELECT k, d * d AS dd, d + d AS d2 FROM t WHERE k2 = 1 ORDER BY d2",
    "SELECT CAST(k2 AS BIGINT) + v AS a, CAST(d AS DECIMAL(12,3)) AS b, "
    "CAST(k2 AS DECIMAL(5,1)) AS c, CAST(d AS DOUBLE) AS f, "
    "CAST(d AS INT) AS i, CAST(CAST(v AS DOUBLE) AS INT) AS j, "
    "d - CAST(k2 AS DECIMAL(10,2)) AS e FROM t WHERE NOT (k2 < 0) "
    "OR k IS NULL ORDER BY a, b",
])
def test_project_filter_sort(sql):
    arrays, valid = _groupy_arrays()
    want, got, _port = _run_both(sql, _GROUPY, arrays, valid)
    assert got == want
