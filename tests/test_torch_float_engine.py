"""Float expressions whose reference is the JAX package's CPU engine.

For these expression shapes the JAX package's device rows on XLA:CPU
differ from its own CPU engine (``spark.rapids.sql.enabled=false``) by
1-3 ulp: XLA rewrites the arithmetic (one fused multiply-add of the
reciprocal scaling for ``m + 1.5`` over a decimal, a folded constant
``0.01 * 1.5`` for ``m * 1.5``, a multiply by 1e-8 for the ``/ 1e8`` of
``months_between``). The port computes what the CPU engine computes, so
here it is held against the CPU engine, exactly (bit for bit), and not
against the XLA:CPU device rows the other port tests compare with."""

import datetime
import struct
from decimal import Decimal

import pytest

from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession


def _bits(rows):
    return [tuple(struct.pack("<d", v) if isinstance(v, float) else v
                  for v in r) for r in rows]


def _cpu_and_port(make):
    cpu = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        want = [tuple(r) for r in make(cpu, JF).collect()]
    finally:
        cpu.stop()
    got = [tuple(r) for r in make(TorchSparkSession({}, device="cpu"),
                                  PF).collect()]
    return want, got


@pytest.mark.parametrize("op", ["add", "mul"])
def test_decimal_times_or_plus_a_double(op):
    def make(s, F):
        df = s.createDataFrame({"m": [Decimal("-1.90"), Decimal("-123.45")]},
                               "m decimal(10,2)", num_partitions=1)
        c = F.col("m") + 1.5 if op == "add" else F.col("m") * 1.5
        return df.select(c.alias("r"))
    want, got = _cpu_and_port(make)
    assert _bits(got) == _bits(want)
    if op == "add":
        assert got[0][0] == -0.40000000000000013
    else:
        assert got[1][0] == -185.175


def test_months_between_literals():
    def make(s, F):
        df = s.createDataFrame({"a": [datetime.date(1995, 5, 13)],
                                "b": [datetime.date(1995, 6, 15)]},
                               "a date, b date", num_partitions=1)
        return df.select(F.months_between("a", "b").alias("r"))
    want, got = _cpu_and_port(make)
    assert _bits(got) == _bits(want)
    assert got == [(-1.06451613,)]


def test_months_between_sql_literals():
    def make(s, F):
        s.createDataFrame({"x": [1]}, "x int").createOrReplaceTempView("t")
        return s.sql("SELECT months_between(date '1995-05-13', "
                     "date '1995-06-15') r FROM t")
    want, got = _cpu_and_port(make)
    assert _bits(got) == _bits(want)
