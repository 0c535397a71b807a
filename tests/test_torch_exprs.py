"""The port's expression layer against the JAX package's, family by
family: each case is one of the JAX package's own dual-session cases
(``tests/test_device_exprs2.py``, ``tests/test_device_exec.py``), a
projection or filter batching one family's expressions over seeded data
with nulls, run through the JAX package's device path and through
``TorchSparkSession(device="cpu")`` (``tests/torch_dual.py``). Rows are
exact, or within rel_tol=1e-12 where the JAX case marks them approximate
(transcendentals); a case the JAX package keeps on the CPU must raise
``NotImplementedError`` in the port. Also here: the handler registry
against the JAX package's, and the tagging parity of
``unsupported_reason`` with ``is_device_expr``."""

import pytest

from tests import test_device_exec as JX
from tests import test_device_exprs2 as J2
from tests.torch_dual import run_case

EXPRS2 = ["test_bitwise_and_or_xor_not", "test_greatest_least",
          "test_extra_math_unary", "test_atan2_hypot", "test_concat_ws",
          "test_repeat_lpad_rpad", "test_translate_replace",
          "test_translate_duplicate_matching_chars", "test_instr_locate",
          "test_initcap_reverse_trims_ascii_chr",
          "test_string_funcs_via_sql", "test_extra_date_fields",
          "test_add_months_trunc", "test_months_between",
          "test_date_format_roundtrip", "test_unix_timestamp_family",
          "test_to_date_to_timestamp_parse", "test_xxhash64_fixed_width",
          "test_xxhash64_strings", "test_like_underscore_falls_back"]


@pytest.mark.parametrize("name", EXPRS2)
def test_family(name):
    run_case(J2, name)


@pytest.mark.parametrize("fn", ["shiftleft", "shiftright",
                                "shiftrightunsigned"])
def test_shifts(fn):
    run_case(J2, "test_shifts", getattr(J2.F, fn))


@pytest.mark.parametrize("pat", [
    "app%", "%ple", "%ppl%", "a%e", "%", "a%p%e", "ap\\%%", "%apple%", ""])
def test_like_literal_patterns(pat):
    run_case(J2, "test_like_literal_patterns_device", pat)


EXEC = ["test_project_conditional", "test_filter_predicates",
        "test_filter_string_predicates", "test_string_project",
        "test_datetime_fields", "test_decimal_project_on_device",
        "test_incompat_substring_gated",
        "test_monotonically_increasing_id_and_partition_id",
        "test_monotonic_id_after_filter"]


@pytest.mark.parametrize("name", EXEC)
def test_exec_family(name):
    run_case(JX, name)


@pytest.mark.parametrize("gen", ["int", "long", "double"])
def test_project_arithmetic(gen):
    from tests.datagen import DoubleGen, IntegerGen, LongGen
    run_case(JX, "test_project_arithmetic",
             {"int": IntegerGen(), "long": LongGen(),
              "double": DoubleGen()}[gen])


# ---------------------------------------------------------------------------
# The handler registry and the tagging parity with the JAX package
# ---------------------------------------------------------------------------

def test_every_jax_handler_has_a_port_counterpart():
    """Every expression class the JAX package evaluates on its device
    has a port handler, the eight over nested device columns included;
    a Literal is the port's literal-input path (``_is_literal_input``)."""
    from spark_rapids_tpu.ops import exprs as JXP

    from spark_rapids_tpu_torch.ops import exprs as PX
    jax_names = {t.__name__ for t in JXP._HANDLERS}
    port_names = {t.__name__ for t in PX._HANDLERS} | {"Literal"}
    assert not hasattr(PX, "NOT_PORTED")
    assert {"Size", "ElementAt", "GetArrayItem", "ArrayContains",
            "TimeWindow", "CreateNamedStruct", "GetStructField",
            "CreateArray"} <= port_names
    assert len(jax_names) == 123
    assert jax_names == port_names


def _expr_cases(E, T):
    """(expression, columns) cases over attribute leaves, built the same
    way from either package's modules."""
    def a(name, dt):
        return E.AttributeReference(name, dt)
    s, i, d = a("s", T.StringT), a("i", T.IntegerT), a("d", T.DoubleT)
    dt, lg = a("dt", T.DateT), a("l", T.LongT)
    d128 = a("w", T.DecimalType(30, 2))
    d10 = a("m", T.DecimalType(10, 2))
    lit = E.Literal
    return [
        E.Like(s, lit("a_b")),
        E.Like(s, s),
        E.Like(s, lit("ab%c")),
        E.CaseWhen([(E.GreaterThan(i, lit(0)), d128)], d128),
        E.CaseWhen([(E.GreaterThan(i, lit(0)), d)], lit(1.5)),
        E.Greatest([s, s]),
        E.Greatest([i, lit(3)]),
        E.StringRepeat(s, i),
        E.StringRepeat(s, lit(2)),
        E.StringLPad(s, lit(5), s),
        E.StringTranslate(s, lit("é"), lit("e")),
        E.StringReplace(s, s, lit("x")),
        E.TruncDate(dt, s),
        E.DateFormatClass(dt, lit("yyyy-MM-dd EEE")),
        E.DateFormatClass(dt, lit("yyyy-MM-dd")),
        E.Cast(d, T.StringT),
        E.Cast(s, T.IntegerT, ansi=True),
        E.Cast(i, T.StringT),
        E.Cast(d128, T.DoubleT),
        E.Murmur3Hash([d128]),
        E.Murmur3Hash([s, i]),
        E.Sqrt(d),
        E.Divide(d128, d128),
        E.Divide(d10, d10),
        E.In(s, [lit("MAIL"), lit("SHIP")]),
        E.Coalesce([i, lit(0)]),
        E.XxHash64([s, lg]),
        E.Abs(d128),
        E.UnaryMinus(d128),
        E.IsNan(d),
        a("arr", T.ArrayType(T.IntegerT)),
    ]


def test_tagging_parity_with_is_device_expr():
    """``unsupported_reason`` refuses exactly where the JAX package's
    ``is_device_expr`` does, with the same reason text."""
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.ops import exprs as JXP
    from spark_rapids_tpu.sql import expressions as JE
    from spark_rapids_tpu.sql import types as JT

    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.ops import exprs as PX
    from spark_rapids_tpu_torch.sql import expressions as PE
    from spark_rapids_tpu_torch.sql import types as PT
    jcases = _expr_cases(JE, JT)
    pcases = _expr_cases(PE, PT)
    refused = 0
    for je, pe in zip(jcases, pcases):
        want = JXP.is_device_expr(je, TpuConf({}))
        got = PX.unsupported_reason(pe, TorchConf({}), "cpu")
        assert got == want, (je, got, want)
        refused += want is not None
    assert refused >= 15


def test_aggregate_tagging_parity_with_is_device_agg():
    from spark_rapids_tpu.conf import TpuConf
    from spark_rapids_tpu.exec import agg as JA
    from spark_rapids_tpu.sql import expressions as JE
    from spark_rapids_tpu.sql import types as JT

    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.exec import agg as PA
    from spark_rapids_tpu_torch.sql import expressions as PE
    from spark_rapids_tpu_torch.sql import types as PT

    def cases(E, T):
        k = E.AttributeReference("k", T.StringT)
        v = E.AttributeReference("v", T.DoubleT)
        i = E.AttributeReference("i", T.IntegerT)

        def agg(f, distinct=False):
            return [E.Alias(E.AggregateExpression(f, distinct), "x")]
        return [
            ([k], agg(E.Sum(i), distinct=True)),
            ([k], agg(E.CollectList(i))),
            ([k], agg(E.Sum(E.Cast(v, T.LongT, ansi=True)))),
            ([k], agg(E.Sum(E.Like(k, E.Literal("a_c"))))),
            ([k], agg(E.StddevSamp(v))),
            ([k], agg(E.Average(v))),
            ([k], agg(E.First(i))),
            ([], agg(E.Max(k))),
        ]
    refused = 0
    for (jg, ja), (pg, pa) in zip(cases(JE, JT), cases(PE, PT)):
        want = JA.is_device_agg(jg, ja, TpuConf({}))
        got = PA.is_device_agg(pg, pa, TorchConf({}), "cpu")
        assert got == want, (got, want)
        refused += want is not None
    assert refused == 4


SQL_DATA = {"a": [1, 2, None, -3, 0, 7], "s": ["ab", None, "xb", "a", "",
                                               "MAIL"]}


@pytest.mark.parametrize("sql", [
    "SELECT if(a > 0, a, NULL) AS x, coalesce(s, NULL) AS y, "
    "CASE WHEN a > 1 THEN s ELSE NULL END AS z FROM t",
    "SELECT a / 0 AS d, a % 0 AS r, a = NULL AS e, -a AS n FROM t",
    "SELECT a, s FROM t WHERE a IN (1, 2, 7) OR s IN ('xb', 'MAIL')",
    "SELECT s LIKE 'a%' AS l1, s LIKE '%b' AS l2, length(s) AS n, "
    "cast(a AS string) AS c, cast(s AS int) AS i FROM t",
])
def test_sql_edge_cases(sql):
    """Null literals take their parent's type, a zero divisor gives null,
    and IN, LIKE and casts through SQL, against the JAX package."""
    from spark_rapids_tpu.sql.session import TpuSparkSession

    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    j = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        j.createDataFrame(SQL_DATA, "a int, s string") \
            .createOrReplaceTempView("t")
        want = [tuple(r) for r in j.sql(sql).collect()]
    finally:
        j.stop()
    p = TorchSparkSession(device="cpu")
    p.createDataFrame(SQL_DATA, "a int, s string").createOrReplaceTempView("t")
    assert [tuple(r) for r in p.sql(sql).collect()] == want
