"""Row faults of the port found by a differential probe against the JAX
package, each held against it here.

- ``date_sub`` (the port's ``_h_date_arith`` once took ``DateSub``, a
  subclass of ``DateAdd``, for an addition): ``date_sub(dt, 10)`` and
  ``date_sub(dt, k)`` with a column ``k`` through both packages, and the
  JAX package's ``test_datetime_exprs`` (``tests/test_device_columnar.py``)
  rerun through both (``tests/torch_dual.py``). Exact.
- min/max over values of equal rank: -0.0 and 0.0 tie, and so do NaNs of
  different payloads; the later of the tied rows wins in the JAX
  package's ``seg_extreme`` and now in the port's. Grouped and global,
  double and float, both orders; the results are compared bit for bit
  (the bits of -0.0 and of each NaN payload as the JAX package returns
  them: its host round trip keeps a float64 NaN's payload, and a float32
  NaN's is compared as the float32 bits both packages return).
"""

import datetime
import struct

import numpy as np
import pytest

from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_columnar as JC
from tests.torch_dual import port_batch, run_expr_case


def _both(make_df):
    """Rows of ``make_df(session, F)`` on the JAX package's device path
    and on the port (CPU)."""
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        want = [tuple(r) for r in make_df(js, JF).collect()]
    finally:
        js.stop()
    ps = TorchSparkSession({}, device="cpu")
    return want, [tuple(r) for r in make_df(ps, PF).collect()]


def _dates(s, F):
    df = s.createDataFrame({"dt": [datetime.date(1995, 1, 1),
                                   datetime.date(2000, 3, 1), None],
                            "k": [10, -3, 5]}, "dt date, k int")
    return df.select(F.date_sub("dt", 10).alias("a"),
                     F.date_sub(F.col("dt"), F.col("k")).alias("b"),
                     F.date_add("dt", 10).alias("c"))


def test_date_sub_literal_and_column():
    want, got = _both(_dates)
    assert got == want
    assert got[0] == (datetime.date(1994, 12, 22),
                      datetime.date(1994, 12, 22),
                      datetime.date(1995, 1, 11))
    assert got[1][1] == datetime.date(2000, 3, 4)


def test_date_sub_through_sql():
    def q(s, F):
        _dates(s, F)
        s.createDataFrame({"dt": [datetime.date(1995, 1, 1)]},
                          "dt date").createOrReplaceTempView("t")
        return s.sql("SELECT date_sub(dt, 10) a FROM t")
    want, got = _both(q)
    assert got == want == [(datetime.date(1994, 12, 22),)]


def test_jax_datetime_exprs_case():
    run_expr_case(JC, "test_datetime_exprs")


NAN_A = np.array([0x7FF8000000000001], dtype=np.uint64).view(np.float64)[0]
NAN_B = np.array([0x7FF8000000000ABC], dtype=np.uint64).view(np.float64)[0]
NAN32_A = np.array([0x7FC00001], dtype=np.uint32).view(np.float32)[0]
NAN32_B = np.array([0x7FC00ABC], dtype=np.uint32).view(np.float32)[0]

TIES = {
    "zeros": [-0.0, 0.0, 1.0],
    "zeros_swapped": [0.0, -0.0, 1.0],
    "zeros_max": [1.0, -0.0, -5.0, 0.0, -0.0, -1.0],
    "nans": ["A", "B", 1.0],
    "nans_swapped": ["B", "A", 1.0],
}


def _values(name, kind):
    nans = ({"A": NAN_A, "B": NAN_B} if kind == "double"
            else {"A": NAN32_A, "B": NAN32_B})
    dt = np.float64 if kind == "double" else np.float32
    return np.array([nans[v] if isinstance(v, str) else v
                     for v in TIES[name]], dtype=dt)


def _bits(v, kind):
    return struct.pack("<d" if kind == "double" else "<f", v)


def _frames(vals, kind):
    """The same numpy column as a JAX package and a port batch: the value
    in group 1 twice over (so a group holds the ties) and a group 2."""
    n = len(vals)
    jdt = JT.DoubleT if kind == "double" else JT.FloatT
    data = np.concatenate([vals, vals[:1]])
    g = np.array([1] * n + [2], dtype=np.int32)
    schema = JT.StructType([JT.StructField("g", JT.IntegerT),
                            JT.StructField("d", jdt)])
    jb = JHostBatch(schema, [
        JHostColumn(JT.IntegerT, g, np.ones(n + 1, dtype=bool)),
        JHostColumn(jdt, data, np.ones(n + 1, dtype=bool))], n + 1)
    return jb, port_batch(jb)


@pytest.mark.parametrize("kind", ["double", "float"])
@pytest.mark.parametrize("name", sorted(TIES))
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped",
                                                        "global"])
def test_min_max_ties_bit_for_bit(name, kind, grouped):
    jb, pb = _frames(_values(name, kind), kind)

    def q(s, F, b):
        df = s.createDataFrame(b, num_partitions=1)
        if grouped:
            return df.groupBy("g").agg(F.min("d").alias("mn"),
                                       F.max("d").alias("mx"))
        return df.filter(F.col("g") == 1).agg(F.min("d").alias("mn"),
                                              F.max("d").alias("mx"))
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        want = sorted(tuple(r) for r in q(js, JF, jb).collect())
    finally:
        js.stop()
    ps = TorchSparkSession({}, device="cpu")
    got = sorted(tuple(r) for r in q(ps, PF, pb).collect())
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert [_bits(v, kind) for v in w[-2:]] == \
            [_bits(v, kind) for v in g[-2:]], (w, g)


def test_zero_ties_take_the_later_row():
    """The probe's rows: min over (-0.0, 0.0, 1.0) is 0.0 and over
    (0.0, -0.0, 1.0) is -0.0, in both packages."""
    for vals, sign in (([-0.0, 0.0, 1.0], 0), ([0.0, -0.0, 1.0], 1)):
        ps = TorchSparkSession({}, device="cpu")
        (r,) = ps.createDataFrame({"d": vals}, "d double",
                                  num_partitions=1).agg(
            PF.min("d").alias("mn")).collect()
        assert r.mn == 0.0 and (struct.pack("<d", r.mn)[-1] >> 7) == sign
