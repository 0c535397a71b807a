"""The UDF compiler in the port (``udf_compiler.py``, on under
``spark.rapids.sql.udfCompiler.enabled``) against the JAX package's.

Checked: the expression tree each supported construct compiles to equals
the JAX package's (by ``repr``, attribute ids aside), and what neither
compiles is refused by both (``and``/``or`` among them: on Python 3.12
their bytecode's COPY is outside both executors); the cases of ``tests/test_tools_udf.py``
(device placement; conditionals; ``%``, builtins, ``math``, string
methods and local variables, each against row-at-a-time Python) on the
port's session; the compiled project inside the aggregate's stage,
fused as the JAX package's; an uncompilable ``F.udf``, and any
``F.udf`` with the compiler off, evaluated on the host in both packages
with the same rows; each lambda neither compiles, run as a Python UDF in
both packages."""

import math
import random
import re

import pytest
import torch

from spark_rapids_tpu import udf_compiler as JU
from spark_rapids_tpu.sql import expressions as JE
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch import udf_compiler as PU
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows
from tests.torch_dual import assert_all_torch, dual_run, port_type

torch.set_num_threads(2)

ON = {"spark.rapids.sql.udfCompiler.enabled": "true"}


def _local(x):
    t = x * 2
    u = t + 1
    return u if t > 0 else -u


def _shadowed(x):
    abs = max  # noqa: F841  (a shadowed builtin never compiles)
    return x


# (name, fn, argument types as JAX types)
CONSTRUCTS = [
    ("add", lambda x: x + 1, [JT.IntegerT]),
    ("arith", lambda x, y: (x * 2 - y) / 3, [JT.LongT, JT.DoubleT]),
    ("py_mod", lambda x: x % 7 - (-x) % 3, [JT.IntegerT]),
    ("ternary", lambda x: x * 2 if x > 1 else -x, [JT.IntegerT]),
    ("not", lambda x: not x > 3, [JT.IntegerT]),
    ("locals", _local, [JT.IntegerT]),
    ("builtins", lambda x: abs(x) + min(x, 3) + max(x, 0), [JT.IntegerT]),
    ("float_len", lambda s: float(len(s)), [JT.StringT]),
    ("math", lambda f: math.sqrt(f) + math.log(f) + math.floor(f),
     [JT.DoubleT]),
    ("startswith", lambda s: s.upper().startswith("A"), [JT.StringT]),
    ("endswith", lambda s: s.endswith("z"), [JT.StringT]),
    ("replace", lambda s: s.lower().replace("a", "b"), [JT.StringT]),
    ("compare_strings", lambda s: s == "x", [JT.StringT]),
    ("decimal", lambda d: d * 2 + 1, [JT.DecimalType(7, 2)]),
]
# ``and``/``or`` compile to COPY and conditional jumps on Python 3.12,
# which neither package's executor takes
REFUSED = [
    ("and_or", lambda x, y: (x > 1 and y < 2) or x == y,
     [JT.LongT, JT.LongT]),
    ("or_methods", lambda s: s.upper().startswith("A") or s.endswith("z"),
     [JT.StringT]),
    ("call", lambda x: int(str(x)) + 1, [JT.IntegerT]),
    ("strip", lambda s: s.strip(), [JT.StringT]),
    ("floor_div", lambda x: x // 2, [JT.IntegerT]),
    ("float_mod", lambda f: f % 2.0, [JT.DoubleT]),
    ("loop", lambda x: sum(i for i in range(x)), [JT.IntegerT]),
    ("shadowed", _shadowed, [JT.IntegerT]),
    ("subscript", lambda s: s[0], [JT.StringT]),
]


def _norm(e) -> str:
    return re.sub(r"#\d+", "#", repr(e))


def _compile(pkg, fn, types, rtype):
    E, U = (JE, JU) if pkg == "jax" else (PE, PU)
    conv = (lambda t: t) if pkg == "jax" else port_type
    args = [E.AttributeReference(f"c{i}", conv(t), True)
            for i, t in enumerate(types)]
    return U.compile_udf(fn, args, conv(rtype))


@pytest.mark.parametrize("name,fn,types",
                         CONSTRUCTS, ids=[c[0] for c in CONSTRUCTS])
def test_compiled_tree_equals_jax_package(name, fn, types):
    rtype = JT.DoubleT
    want = _compile("jax", fn, types, rtype)
    got = _compile("port", fn, types, rtype)
    assert want is not None and got is not None
    assert _norm(got) == _norm(want)


# each refused lambda's result type and its arguments' rows
REFUSED_RUNS = {
    "and_or": ("boolean", {"c0": [1, 2, 3, 0], "c1": [3, 1, 3, 2]}),
    "or_methods": ("boolean", {"c0": ["Abz", "qz", "q", "ab"]}),
    "call": ("int", {"c0": [1, -5, 42, 7]}),
    "strip": ("string", {"c0": [" a ", "b", "  c", "d "]}),
    "floor_div": ("int", {"c0": [1, -5, 42, 7]}),
    "float_mod": ("double", {"c0": [1.5, -3.25, 4.0, 9.75]}),
    "loop": ("int", {"c0": [1, 0, 5, 3]}),
    "shadowed": ("int", {"c0": [1, -5, 42, 7]}),
    "subscript": ("string", {"c0": ["ab", "c", "de", "f"]}),
}


@pytest.mark.parametrize("name,fn,types",
                         REFUSED, ids=[c[0] for c in REFUSED])
def test_refused_by_both(name, fn, types):
    """Neither compiler takes the lambda, so it stays a Python UDF, which
    both packages evaluate in a projection on the host: the same
    placement and the same rows."""
    assert _compile("jax", fn, types, JT.IntegerT) is None
    assert _compile("port", fn, types, JT.IntegerT) is None
    rtype, data = REFUSED_RUNS[name]
    ddl = ", ".join(f"c{i} {port_type(t).simple_string}"
                    for i, t in enumerate(types))

    def make(s, Fm):
        df = s.createDataFrame({k: data[k] for k in
                                [f"c{i}" for i in range(len(types))]},
                               ddl)
        u = Fm.udf(fn, rtype)
        return df.select(u(*[Fm.col(f"c{i}")
                             for i in range(len(types))]).alias("u"))
    _jax_rec, port_rec = dual_run(lambda s: make(s, JF),
                                  lambda s: make(s, F), conf=dict(ON))
    assert "PythonUDF" in port_rec.messages[0]


def test_device_placement():
    """``tests/test_tools_udf.py`` ``test_udf_compiler_device_placement``
    on the port."""
    sp = TorchSparkSession(ON, device="cpu")
    df = sp.createDataFrame({"a": [1, 5, 9]}, "a int")
    plus1 = F.udf(lambda x: x + 1, "int")
    sp.start_capture()
    r = df.select(plus1(F.col("a")).alias("u")).collect()
    plans = sp.get_captured_plans()
    assert [row[0] for row in r] == [2, 6, 10]
    assert "TorchProject" in "\n".join(p.tree_string() for p in plans)
    assert_all_torch(sp.last_plan)


def test_conditionals_compile_and_uncompilable_raises():
    """``test_udf_compiler_conditionals_and_fallback``: the conditional
    compiles (rows as row-at-a-time Python gives them); the UDF with a
    call stays a Python UDF, which both packages run on the host, and so
    does any ``F.udf`` with the compiler off: the same placement and the
    same rows."""
    sp = TorchSparkSession(ON, device="cpu")
    df = sp.createDataFrame({"a": [1, 2, 5, -3], "b": [2.0, 0.5, 1.0, 4.0]},
                            "a int, b double")
    fn = lambda x: x * 2 if x > 1 else -x  # noqa: E731
    cond = F.udf(fn, "int")
    assert [r[0] for r in df.select(cond(F.col("a"))).collect()] == \
        [fn(a) for a in (1, 2, 5, -3)]
    _jax_rec, port_rec = dual_run(
        lambda s: _two_udfs(s, JF, fn), lambda s: _two_udfs(s, F, fn),
        conf=dict(ON))
    assert "PythonUDF" in port_rec.messages[0]
    # the compiler off: every F.udf is a Python UDF on the host
    _jax_rec, port_rec = dual_run(
        lambda s: _two_udfs(s, JF, fn, both=False),
        lambda s: _two_udfs(s, F, fn, both=False))
    assert "PythonUDF" in port_rec.messages[0]


def _two_udfs(s, Fm, fn, both: bool = True):
    """The conditional UDF beside one no compiler takes."""
    df = s.createDataFrame({"a": [1, 2, 5, -3], "b": [2.0, 0.5, 1.0, 4.0]},
                           "a int, b double")
    cols = [Fm.udf(fn, "int")(Fm.col("a")).alias("c")]
    if both:
        cols.append(Fm.udf(lambda x: int(str(x)) + 1, "int")(
            Fm.col("a")).alias("h"))
    return df.select(*cols)


def _v1_rows(n=200):
    random.seed(4)
    return {"x": [random.randint(-50, 50) or 1 for _ in range(n)],
            "f": [random.uniform(0.5, 100.0) for _ in range(n)],
            "s": [random.choice([" Ab ", "cd", "EEf "]) for _ in range(n)]}


def _v1_udfs(F, T):
    return [F.udf(lambda x: x % 7 - (-x) % 3, T.IntegerT),
            F.udf(_local, T.IntegerT),
            F.udf(lambda x: abs(x) + min(x, 3) + max(x, 0), T.IntegerT),
            F.udf(lambda f: math.sqrt(f) + math.log(f), T.DoubleT),
            F.udf(lambda s_: s_.upper().replace("A", "_"), T.StringT)]


def test_v1_mod_math_strings_locals_equal_python_and_jax_package():
    """``test_udf_compiler_v1_mod_math_strings_locals``: ``%`` with
    Python's sign, builtins, ``math``, string methods and local
    variables, against row-at-a-time Python and the JAX package's
    device path (the string method is ``replace`` here: ``strip`` does
    not compile, so the JAX package keeps it on its CPU)."""
    data = _v1_rows()
    conf = dict(ON, **{"spark.rapids.sql.incompatibleOps.enabled": "true"})

    def run(s, F, T):
        df = s.createDataFrame(data, "x int, f double, s string")
        u = _v1_udfs(F, T)
        return [tuple(r) for r in df.select(
            u[0](F.col("x")), u[1](F.col("x")), u[2](F.col("x")),
            u[3](F.col("f")), u[4](F.col("s")), "x").collect()]
    js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled": "true"}))
    try:
        want = run(js, JF, JT)
    finally:
        js.stop()
    got = run(TorchSparkSession(conf, device="cpu"), F, T)
    # sqrt + log within 1e-12 relative (the expression tests' tolerance
    # for transcendentals), every other column exact
    for w, g in zip(want, got):
        assert w[:3] == g[:3] and w[4:] == g[4:]
        assert abs(w[3] - g[3]) <= 1e-12 * abs(w[3])
    plain = [(x % 7 - (-x) % 3, _local(x), abs(x) + min(x, 3) + max(x, 0),
              math.sqrt(f) + math.log(f), s.upper().replace("A", "_"), x)
             for x, f, s in zip(data["x"], data["f"], data["s"])]
    for p, g in zip(plain, got):
        assert p[:3] == g[:3] and p[4:] == g[4:]
        assert abs(p[3] - g[3]) <= 1e-12 * abs(p[3])


def test_compiled_project_fuses_into_the_aggregate_stage():
    """The compiled UDF under a group-by: one stage program (project and
    partial aggregate), fused as the JAX package's."""
    conf = dict(ON, **{"spark.rapids.sql.variableFloatAgg.enabled": "true"})
    fn = lambda v: v * 2.0 + 1.0 if v > 0.5 else -v  # noqa: E731
    vals = [i / 97.0 for i in range(300)]

    def q(s, F):
        u = F.udf(fn, "double")
        df = s.createDataFrame({"id": [i // 30 for i in range(300)],
                                "v": vals}, "id int, v double",
                               num_partitions=3)
        return df.select("id", u("v").alias("x")).groupBy("id").agg(
            F.sum("x").alias("s"), F.count("x").alias("n"))
    js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled": "true"}))
    try:
        js.start_capture()
        want = sorted(_rows(q(js, JF)._execute().to_pydict()))
        jplan = js.get_captured_plans()[-1]
    finally:
        js.stop()
    ps = TorchSparkSession(conf, device="cpu")
    got = sorted(_rows(q(ps, F)._execute().to_pydict()))
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert g[2] == w[2] and abs(g[1] - w[1]) <= 1e-12 * abs(w[1])
        ref = math.fsum(fn(v) for i, v in enumerate(vals) if i // 30 == g[0])
        assert abs(g[1] - ref) <= 1e-12 * abs(ref)
    shape = fused_shape(ps.last_plan)
    assert shape == fused_shape(jplan)
    assert ("TorchFusedStageExec", ("TorchProjectExec",
                                    "TorchHashAggregateExec"),
            "TorchHashAggregateExec") in shape
