"""Run the JAX package's own dual-session test cases through both
packages: the JAX package's device path (``TpuSparkSession``, kernels
interpreted on the CPU) and the port (``TorchSparkSession`` on the CPU).

A JAX test function builds its query with the JAX package's ``F``,
``E``, ``T`` and ``gen_batch`` and hands it to
``assert_tpu_and_cpu_equal_collect``. ``run_case`` calls the function
twice: once as it is, with that harness replaced by a recorder that runs
the query on the JAX package's device path; once with the function (and
the helpers of its module) rebuilt over the port's ``functions``,
``expressions`` and ``types`` modules, with a ``gen_batch`` that hands
the same seeded numpy columns to the port, and a recorder that runs the
query on ``TorchSparkSession(device="cpu")``. The recorded results must
agree: rows exact (NaN equal to NaN, -0.0 distinct from 0.0), or within
``rel_tol=1e-12`` where the case is marked approximate (transcendentals
and float aggregates). Where the JAX package keeps part of a query on its
CPU (``assert_tpu_fallback_collect``, or a ``Cpu*`` operator in any of
its plans), the port must keep the same operators on its host engine at
the same places in the tree (``placement``), and give the same rows.
"""

from __future__ import annotations

import contextlib
import types as pytypes
from typing import Callable, Dict, List, Optional

import torch

from spark_rapids_tpu.sql.session import TpuSparkSession
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch.columnar.host import HostBatch as PHostBatch
from spark_rapids_tpu_torch.columnar.host import HostColumn as PHostColumn
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows, _sort_key
from tests.support import values_equal

torch.set_num_threads(2)


def port_type(jt):
    """The port's DataType equal to a JAX package DataType."""
    if isinstance(jt, JT.DecimalType):
        return PT.DecimalType(jt.precision, jt.scale)
    if isinstance(jt, JT.ArrayType):
        return PT.ArrayType(port_type(jt.element_type))
    if isinstance(jt, JT.StructType):
        return PT.StructType([PT.StructField(f.name, port_type(f.data_type))
                              for f in jt.fields])
    return getattr(PT, type(jt).__name__)()


def port_batch(jb) -> PHostBatch:
    """A JAX package HostBatch's columns (the same numpy arrays) as a
    port HostBatch."""
    fields = [PT.StructField(f.name, port_type(f.data_type))
              for f in jb.schema.fields]
    cols = [PHostColumn(f.data_type, c.data, c.validity)
            for f, c in zip(fields, jb.columns)]
    return PHostBatch(PT.StructType(fields), cols, jb.num_rows)


class Recorder:
    """Stands in for the JAX harness's assertions and records what each
    query gives on one package: its rows and its placement. On the port,
    ``messages`` holds the explain lines of each query that fell back
    (``!Exec <op> cannot run on GPU because ...``) and ``reports`` each
    query's ``RewriteReport``."""

    def __init__(self, port: bool):
        self.port = port
        self.results: List[tuple] = []
        self.messages: List[str] = []
        self.reports: List = []

    def equal(self, df_fn: Callable, conf: Optional[Dict] = None,
              ignore_order: bool = True, approx: bool = False,
              require_device: bool = True, expect_execs=None) -> None:
        rows, where = self._run(df_fn, dict(conf or {}))
        if ignore_order:
            rows = sorted(rows, key=_sort_key)
        self.results.append(("rows", rows, approx, where))

    def fallback(self, df_fn: Callable, fallback_exec: str,
                 conf: Optional[Dict] = None) -> None:
        """The named CPU operator must have stayed on the host with a
        recorded reason, in the port as in the JAX package."""
        self.equal(df_fn, conf)
        if self.port:
            names = [n for n, _ in self.reports[-1].fallbacks]
            assert fallback_exec in names, (fallback_exec,
                                            self.reports[-1].fallbacks)

    def _run(self, df_fn, conf):
        """``(rows, placement)`` of one query; the placement over every
        plan that ran it (a cached relation's materialisation too)."""
        if self.port:
            s = TorchSparkSession(conf, device="cpu")
            s.start_capture()
            rows = _rows(df_fn(s)._execute().to_pydict())
            plans = s.get_captured_plans()
            report = s.last_rewrite_report
            self.reports.append(report)
            text = report.format() if report is not None else ""
            if text:
                self.messages.append(text)
            return rows, placement(plans)
        s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
        try:
            with _materializations() as nested:
                s.start_capture()
                rows = _rows(df_fn(s)._execute().to_pydict())
                plans = s.get_captured_plans()
            return rows, placement(query_plans(plans, nested))
        finally:
            s.stop()


def dual_run(jax_fn: Callable, port_fn: Callable,
             conf: Optional[Dict] = None, ignore_order: bool = True,
             approx: bool = False):
    """One query on both packages (``jax_fn`` builds it over a
    ``TpuSparkSession``, ``port_fn`` over a ``TorchSparkSession`` on the
    CPU): rows and placement must agree. Returns both recorders."""
    jax_rec, port_rec = Recorder(port=False), Recorder(port=True)
    jax_rec.equal(jax_fn, conf, ignore_order, approx)
    port_rec.equal(port_fn, conf, ignore_order, approx)
    compare(jax_rec.results, port_rec.results)
    return jax_rec, port_rec


@contextlib.contextmanager
def _materializations():
    """Record the ids of the plans the JAX package captures while a
    cached relation materialises inside a query."""
    from spark_rapids_tpu.io import cache as JC
    plain = JC.CachedRelation.materialize
    nested: set = set()

    def recording(rel):
        before = list(rel.session._plan_capture)
        try:
            return plain(rel)
        finally:
            nested.update(id(p) for p in rel.session._plan_capture
                          if all(p is not b for b in before))
    JC.CachedRelation.materialize = recording
    try:
        yield nested
    finally:
        JC.CachedRelation.materialize = plain


def query_plans(plans, nested) -> list:
    """The plans that ran a JAX query: the query's own (the last captured
    outside a materialisation; scalar subqueries are captured before it)
    and every materialisation's."""
    outer = [p for p in plans if id(p) not in nested]
    return outer[-1:] + [p for p in plans if id(p) in nested]


HOST_SOURCES = ("CpuLocalScanExec", "CpuFileScanExec", "CpuCachedScanExec")


def cpu_operators(plan) -> List[str]:
    """The CPU operators of a plan of either package (its host sources
    aside): where the query ran partly on the host."""
    out = []

    def walk(p):
        n = type(p).__name__
        if n.startswith("Cpu") and n not in HOST_SOURCES:
            out.append(n)
        for c in p.children:
            walk(c)
    walk(plan)
    return out


def _kind(p) -> str:
    """A node as a neighbour of a CPU operator: a transition to or from
    the device, a host source, or a CPU operator by name."""
    n = type(p).__name__
    if n in ("TpuColumnarToRowExec", "TorchColumnarToRowExec",
             "TpuRowToColumnarExec", "TorchRowToColumnarExec"):
        return "device"
    if n in HOST_SOURCES:
        return "source"
    return n


def placement(plans) -> List[tuple]:
    """Each CPU operator of the plans, with what sits above it (``root``,
    ``device`` through an upload, or a CPU operator) and below it (a
    download from the device, a host source, or a CPU operator), sorted:
    two packages place a query alike when these lists are equal."""
    out = []

    def walk(p, parent: str):
        n = type(p).__name__
        if n.startswith("Cpu") and n not in HOST_SOURCES:
            out.append((n, parent, tuple(_kind(c) for c in p.children)))
        for c in p.children:
            walk(c, _kind(p) if n.startswith("Cpu") or _kind(p) ==
                 "device" else "device-op")
    for plan in plans:
        walk(plan, "root")
    return sorted(out)


def assert_all_torch(plan) -> None:
    """Every node between the transitions is a Torch* operator."""
    names = []

    def walk(p):
        names.append(type(p).__name__)
        for c in p.children:
            walk(c)
    walk(plan)
    assert names[0] == "TorchColumnarToRowExec", names
    for n in names:
        if n.startswith("Cpu"):
            assert n in HOST_SOURCES, names
        else:
            assert n.startswith("Torch"), names


def _port_globals(module) -> dict:
    """The module's namespace over the port's modules, its own functions
    rebuilt to read it."""
    from tests import datagen

    def gen_batch(named_gens, n, seed=datagen.DEFAULT_SEED):
        return port_batch(datagen.gen_batch(named_gens, n, seed))

    g = dict(vars(module))
    g.update(F=PF, E=PE, T=PT, Column=PF.Column, gen_batch=gen_batch)
    if "Window" in g:
        g["Window"] = PF.Window
    for name, v in list(g.items()):
        if isinstance(v, pytypes.FunctionType) and \
                v.__module__ == module.__name__:
            g[name] = _rebind(v, g)
    return g


def _rebind(fn: pytypes.FunctionType, g: dict) -> pytypes.FunctionType:
    return pytypes.FunctionType(fn.__code__, g, fn.__name__,
                                fn.__defaults__, fn.__closure__)


def _port_arg(v, g: Optional[dict] = None):
    if isinstance(v, JT.DataType):
        return port_type(v)
    if g is not None and isinstance(v, pytypes.FunctionType) and \
            v.__module__ == g.get("__name__"):
        return _rebind(v, g)  # a case's lambda, over the port's modules
    if callable(v) and getattr(v, "__module__", "") == \
            "spark_rapids_tpu.sql.functions":
        return getattr(PF, v.__name__)
    return v


def _run_with(g: dict, rec: Recorder, test_name: str, args) -> None:
    """Call the test with the recorder standing in for the harness, in
    its globals and in ``tests.harness`` (some cases import it
    locally)."""
    from tests import harness
    g.update(assert_tpu_and_cpu_equal_collect=rec.equal,
             assert_tpu_fallback_collect=rec.fallback)
    saved = (harness.assert_tpu_and_cpu_equal_collect,
             harness.assert_tpu_fallback_collect)
    harness.assert_tpu_and_cpu_equal_collect = rec.equal
    harness.assert_tpu_fallback_collect = rec.fallback
    try:
        g[test_name](*args)
    finally:
        (harness.assert_tpu_and_cpu_equal_collect,
         harness.assert_tpu_fallback_collect) = saved


def run_case(module, test_name: str, *args) -> List[tuple]:
    """Run one JAX test case through both packages and compare; returns
    the port's recorded results (and, on its recorder, the messages of
    the port's refusals)."""
    jax_rec, port_rec = Recorder(port=False), Recorder(port=True)
    jg = dict(vars(module))
    for name, v in list(jg.items()):
        if isinstance(v, pytypes.FunctionType) and \
                v.__module__ == module.__name__:
            jg[name] = _rebind(v, jg)
    _run_with(jg, jax_rec, test_name, args)
    pg = _port_globals(module)
    _run_with(pg, port_rec, test_name, [_port_arg(a, pg) for a in args])
    compare(jax_rec.results, port_rec.results)
    return port_rec


def compare(want: List[tuple], got: List[tuple]) -> None:
    assert [w[0] for w in want] == [g[0] for g in got], (want, got)
    for w, g in zip(want, got):
        wrows, grows, approx = w[1], g[1], w[2]
        if len(w) > 3 and len(g) > 3:
            assert w[3] == g[3], f"placement: JAX {w[3]}, port {g[3]}"
        assert len(wrows) == len(grows), (len(wrows), len(grows))
        for i, (wr, gr) in enumerate(zip(wrows, grows)):
            for j, (a, b) in enumerate(zip(wr, gr)):
                assert values_equal(a, b, approx), (
                    f"row {i} col {j}: JAX={a!r} port={b!r}\n"
                    f"JAX row: {wr}\nport row: {gr}")


def rows_close(want, got, approx: bool = False) -> None:
    """Ordered rows equal, floats within rel_tol=1e-12 where
    ``approx``."""
    assert len(want) == len(got), (len(want), len(got))
    for wr, gr in zip(want, got):
        assert len(wr) == len(gr)
        for a, b in zip(wr, gr):
            assert values_equal(a, b, approx), (wr, gr)


def run_expr_case(module, test_name: str, *args) -> None:
    """Run one of the JAX package's expression-level cases (a test that
    hands each expression and a host batch to the module's
    ``_assert_expr_matches``) through both packages' sessions: each
    expression is selected over the batch on the JAX package's device
    path and on the port (``device="cpu"``), and the rows must agree
    exactly, or within rel_tol=1e-12 for the module's ``APPROX_EXPRS``."""
    from spark_rapids_tpu.sql import functions as JF
    results = {False: [], True: []}

    def recorder(port: bool):
        def mk_batch(data, schema):
            return data, schema

        def matches(expr, hb):
            data, schema = hb
            approx = isinstance(expr, tuple(
                getattr(module, "APPROX_EXPRS", ()) or ()))
            if port:
                s = TorchSparkSession({}, device="cpu")
                col = PF.Column(expr)
            else:
                s = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
                col = JF.Column(expr)
            try:
                rows = _rows(s.createDataFrame(data, schema).select(
                    col.alias("r"))._execute().to_pydict())
            finally:
                if not port:
                    s.stop()
            results[port].append((repr(expr), rows, approx))
        return mk_batch, matches

    jg = dict(vars(module))
    for name, v in list(jg.items()):
        if isinstance(v, pytypes.FunctionType) and \
                v.__module__ == module.__name__:
            jg[name] = _rebind(v, jg)
    pg = _port_globals(module)
    for port, g in ((False, jg), (True, pg)):
        mk, matches = recorder(port)
        g.update(_mk_batch=mk, _assert_expr_matches=matches)
        g[test_name](*[_port_arg(a, pg) if port else a for a in args])
    want, got = results[False], results[True]
    assert len(want) == len(got) and want, (len(want), len(got))
    for (we, wrows, approx), (_ge, grows, _a) in zip(want, got):
        assert len(wrows) == len(grows), we
        for wr, gr in zip(wrows, grows):
            for a, b in zip(wr, gr):
                assert values_equal(a, b, approx), (
                    f"{we}: JAX={a!r} port={b!r}")
