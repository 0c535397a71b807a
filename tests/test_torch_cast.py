"""The port's cast matrix (``ops/exprs.py`` cast legs, ``ops/cast.py``)
against the JAX package's: each case is one of the JAX package's own
cast cases (``tests/test_device_cast.py``) run through its device path
and through ``TorchSparkSession(device="cpu")`` (``tests/torch_dual.py``),
rows exact. A cast the JAX package keeps on the CPU must raise
``NotImplementedError`` in the port; an ANSI cast that overflows raises
``ArithmeticError`` in both, and the port raises it from the device
path."""

import pytest

from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_cast as JC
from tests.torch_dual import run_case

TARGETS = [("byte", JT.ByteT), ("short", JT.ShortT), ("int", JT.IntegerT),
           ("long", JT.LongT), ("double", JT.DoubleT), ("float", JT.FloatT)]


@pytest.mark.parametrize("to_name,to", TARGETS, ids=[n for n, _ in TARGETS])
@pytest.mark.parametrize("gen", ["int", "long", "double"])
def test_numeric_to_numeric(gen, to_name, to):
    from tests.datagen import DoubleGen, IntegerGen, LongGen
    run_case(JC, "test_numeric_to_numeric",
             {"int": IntegerGen(), "long": LongGen(),
              "double": DoubleGen()}[gen], to_name, to)


@pytest.mark.parametrize("gen", ["int", "long", "small", "bool", "date"])
def test_to_string(gen):
    from tests.datagen import (BooleanGen, DateGen, IntegerGen, LongGen,
                               SmallIntGen)
    run_case(JC, "test_to_string",
             {"int": IntegerGen(), "long": LongGen(),
              "small": SmallIntGen(), "bool": BooleanGen(),
              "date": DateGen()}[gen], gen)


CASES = ["test_bool_numeric_legs", "test_string_to_int_parsing",
         "test_string_to_bool_parsing", "test_string_to_date_parsing",
         "test_date_string_roundtrip", "test_unsupported_cast_falls_back",
         "test_ansi_cast_ok_values_pass",
         "test_ansi_error_scoped_to_taken_branch",
         "test_ansi_cast_in_sort_key_falls_back",
         "test_string_cast_edge_regressions"]


@pytest.mark.parametrize("name", CASES)
def test_cast_case(name):
    run_case(JC, name)


@pytest.mark.parametrize("value,to", [(1e300, PT.IntegerT),
                                      (9.223372036854775808e18, PT.LongT),
                                      (float("nan"), PT.ShortT)])
def test_ansi_cast_overflow_raises(value, to):
    """The JAX package's ANSI overflow cases: the port raises
    ArithmeticError after the batch, from its device path."""
    s = TorchSparkSession(device="cpu")
    df = s.createDataFrame({"v": [1.0, value]}, "v double").select(
        PF.Column(PE.Cast(PF.col("v").expr, to, ansi=True)).alias("c"))
    with pytest.raises(ArithmeticError):
        df.collect()
    names = []

    def walk(p):
        names.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(s.last_plan)
    assert "TorchProjectExec" in names
