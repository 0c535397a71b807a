"""The port's support matrix (``spark_rapids_tpu_torch/typesig.py`` and
``tools.generate_supported_ops``) against the JAX package's: every exec
and expression row equal cell for cell, the type sets equal the JAX
signatures they mirror, and ``TypeSig.support`` gives the port's tagging
reason (``ops.exprs.type_reason``) for every type, word for word."""

from __future__ import annotations

import pytest

from spark_rapids_tpu import typesig as JTS
from spark_rapids_tpu import tools as JTOOLS
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch import tools as TOOLS
from spark_rapids_tpu_torch import typesig as TS
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.sql import types as T


def _table(doc: str, heading: str):
    """The rows of the Markdown table under ``## heading``, each a list
    of its cells."""
    lines = doc.splitlines()
    i = lines.index(f"## {heading}")
    rows = []
    for line in lines[i + 1:]:
        if line.startswith("## "):
            break
        if line.startswith("| ") and not line.startswith("|---"):
            rows.append([c.strip() for c in line.strip("|").split("|")])
    return rows[1:]  # the header row


@pytest.fixture(scope="module")
def docs():
    return JTOOLS.generate_supported_ops(), TOOLS.generate_supported_ops()


def test_exec_rows_equal_cell_for_cell(docs):
    jax_doc, port_doc = docs
    jrows, prows = _table(jax_doc, "Execs"), _table(port_doc, "Execs")
    assert len(prows) == len(jrows) == 17
    assert prows == jrows


def test_expression_rows_equal_cell_for_cell(docs):
    jax_doc, port_doc = docs
    jrows = _table(jax_doc, "Expressions")
    prows = _table(port_doc, "Expressions")
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    assert prows == jrows


@pytest.mark.parametrize("name,jax_sig", [
    ("flat", JTS.common_tpu), ("struct", JTS.common_tpu_struct),
    ("nested", JTS.common_tpu_nested)])
def test_type_sets_mirror_the_jax_signatures(name, jax_sig):
    sig = TS.sig_of(name)
    assert sig.tags == jax_sig.tags
    assert sig.max_decimal_precision == jax_sig.max_decimal_precision


def _types(mod):
    flat = [mod.BooleanT, mod.ByteT, mod.ShortT, mod.IntegerT, mod.LongT,
            mod.FloatT, mod.DoubleT, mod.DateT, mod.TimestampT,
            mod.StringT, mod.BinaryT, mod.DecimalType(10, 2),
            mod.DecimalType(38, 4), mod.NullT]
    return flat + [
        mod.ArrayType(mod.LongT), mod.ArrayType(mod.StringT),
        mod.ArrayType(mod.NullT),
        mod.StructType([mod.StructField("a", mod.LongT),
                        mod.StructField("b", mod.StringT)]),
        mod.StructType([mod.StructField("a", mod.ArrayType(mod.LongT))]),
        mod.StructType([mod.StructField("n", mod.NullT)]),
        mod.MapType(mod.StringT, mod.LongT)]


@pytest.mark.parametrize("sig", ["flat", "struct", "nested"])
def test_support_reasons_equal_the_tagging_and_the_jax_package(sig):
    jax_sig = {"flat": JTS.common_tpu, "struct": JTS.common_tpu_struct,
               "nested": JTS.common_tpu_nested}[sig]
    for pdt, jdt in zip(_types(T), _types(JT)):
        want = jax_sig.support(jdt)
        assert TS.sig_of(sig).support(pdt) == want, (sig, pdt)
        assert X.type_reason(pdt, sig) == want, (sig, pdt)


def test_render_matches_the_jax_cell():
    for name, jax_sig in (("flat", JTS.common_tpu),
                          ("nested", JTS.common_tpu_nested)):
        assert TS.sig_of(name).render() == ", ".join(sorted(jax_sig.tags))
    assert TS.TypeSig().render() == "none"


def test_algebra():
    s = TS.common + TS.TypeSig(frozenset({TS.MAP}))
    assert TS.MAP in s.tags and (s - TS.common).tags == {TS.MAP}
    assert TS.DECIMAL_128.support(T.DecimalType(39, 0)) is not None
