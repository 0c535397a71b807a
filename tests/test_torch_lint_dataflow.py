"""The port's data-flow lint tier and its compile-discipline rules
(``spark_rapids_tpu_torch/lint/{dataflow,rules_dataflow,rules_jit}.py``)
on fixture trees: for each data-flow and jit case of the JAX package's
``tests/test_lint.py`` the PyTorch-idiom fixture gives the same rule's
findings at the same shapes (hidden-sync on a device value and not on a
host value, its scope and allowlist; handle-leak and its escapes;
capture-purity two calls deep, a conf read, across a module import, a
closure accumulator; graph-direct and its builder resolution; the
module cache). Fixtures whose text is package-agnostic (spillable
handle leaks, module caches, ``reads_after_call``) run through both
engines and must agree. The torch-only forcing shapes each have a bad
fixture and a good twin."""

from __future__ import annotations

import ast
import textwrap

import pytest

from spark_rapids_tpu.lint import LintConfig as JLintConfig
from spark_rapids_tpu.lint import dataflow as JDF
from spark_rapids_tpu.lint import run_lint as jax_run_lint
from spark_rapids_tpu.lint.astutil import FileCtx as JFileCtx

from spark_rapids_tpu_torch.lint import LintConfig, load_config, run_lint
from spark_rapids_tpu_torch.lint import dataflow as DF
from spark_rapids_tpu_torch.lint.astutil import FileCtx
from spark_rapids_tpu_torch.lint.engine import RULES, default_root


def _tree(tmp_path, files):
    root = tmp_path / "fixture"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).lstrip("\n"))
    return str(root)


_PORT = dict(
    scan_roots=("pkg",), check_docs=False, retry_scope=(),
    concurrency_scope=(), cancel_scope=(), alloc_scope=(),
    hot_scope=("pkg/exec/", "pkg/ops/", "pkg/kernels/", "pkg/columnar/"),
    sync_allowlist={}, purity_allowlist={}, jit_home="pkg/jit_cache.py",
    graph_home="pkg/exec/fused.py", metrics_rel="pkg/metrics.py",
    trace_rel="pkg/trace.py", prometheus_rel="pkg/telemetry/prometheus.py",
    history_rel="pkg/telemetry/history.py",
    tuning_rel="pkg/telemetry/tuning.py")


def _lint(root, **over):
    return run_lint(root, LintConfig(**dict(_PORT, **over)))


def _jax_lint(root, **over):
    kw = dict(scan_roots=("pkg",), check_docs=False, retry_scope=(),
              concurrency_scope=(), cancel_scope=(),
              jit_home="pkg/jit_cache.py", kernels_home="pkg/kernels",
              hot_scope=("pkg/exec/",), sync_allowlist={},
              purity_allowlist={})
    kw.update(over)
    return jax_run_lint(root, JLintConfig(**kw))


def _lines(result, rule):
    assert not result.internal_errors, result.internal_errors
    return [f.line for f in result.findings if f.rule == rule]


def _of(result, rule):
    assert not result.internal_errors, result.internal_errors
    return [f for f in result.findings if f.rule == rule]


def test_new_rules_are_registered():
    assert {"hidden-sync", "handle-leak", "capture-purity",
            "jit-module-cache", "graph-direct"} <= set(RULES)
    assert "donation-safety" not in RULES and "trace-purity" not in RULES


# ---------------------------------------------------------------------------
# hidden-sync
# ---------------------------------------------------------------------------

def test_hidden_sync_tainted_flagged_host_value_not(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import numpy as np
        import torch

        def bad(n, device):
            s = torch.arange(n, device=device).sum()
            return s.item()  # device scalar forced on the hot path

        def bad2(n, device):
            s = torch.arange(n, device=device).sum()
            return float(np.asarray(s))  # one finding: the asarray

        def fine(host_list):
            a = np.asarray(host_list)  # NOT a device value
            return int(a[0])

        def kwargs_only(rows):
            return np.array(object=rows)  # no positional arg: no crash

        def outer(n, device):
            s = torch.arange(n, device=device).sum()

            def cb(s):
                return float(s)  # SHADOWED host param: not the device s
            return cb
    """})
    bad = _of(_lint(root), "hidden-sync")
    assert [f.line for f in bad] == [6, 10]
    assert ".item()" in bad[0].message and "np.asarray" in bad[1].message


def test_hidden_sync_scope_and_allowlist(tmp_path):
    src = """
        import torch

        def drain(n, device):
            s = torch.zeros(n, device=device).sum()
            return int(s)
    """
    root = _tree(tmp_path, {"pkg/exec/x.py": src, "pkg/sql/y.py": src})
    r = _lint(root)
    assert [(f.path, f.line) for f in _of(r, "hidden-sync")] == \
        [("pkg/exec/x.py", 5)]
    allow = {"pkg/exec/x.py::drain": "fixture sanctioned drain point"}
    assert not _of(_lint(root, sync_allowlist=allow), "hidden-sync")


def test_hidden_sync_seeds(tmp_path):
    """What makes a value a device value: a factory handed a device, a
    ``.to(device)``/``.cuda()``, a kernel wrapper (a def under kernels/
    that counts a launch), ``run_program``, a DeviceBatch's fields; what
    does not: ``torch.from_numpy``, a factory without a device, a tensor's
    metadata, a batch's host methods."""
    root = _tree(tmp_path, {
        "pkg/kernels/k.py": """
            def count_launch(name):
                pass

            def launch(x):
                count_launch("k")
                return x

            def wrapper(x):
                return launch(x)

            def helper(x):
                return x
        """,
        "pkg/exec/x.py": """
            import numpy as np
            import torch
            from pkg.kernels import k as K
            from pkg.columnar.device import DeviceBatch

            def kernel_out(x):
                return int(K.wrapper(x))

            def not_a_kernel(x):
                return int(K.helper(x))

            def moved(a, device):
                return torch.from_numpy(a).to(device).tolist()

            def cuda(a):
                return torch.from_numpy(a).cuda().cpu()

            def host_tensor(a):
                return torch.from_numpy(a).tolist()

            def host_factory(n):
                return torch.zeros(n).sum().item()

            def cpu_device(n):
                return torch.zeros(n, device="cpu").sum().item()

            def program(key, fn, flat, metrics):
                outs, meta = run_program(key, fn, flat, metrics)
                return int(outs[0])

            def fields(b: DeviceBatch):
                return b.active.sum().item()

            def metadata(b: DeviceBatch, n, device):
                t = torch.zeros(n, device=device)
                return int(t.shape[0]) + int(b.capacity) + t.numel() \\
                    + int(b.row_count())
        """})
    assert _lines(_lint(root), "hidden-sync") == [7, 13, 16, 29, 32]


def test_forcing_shapes_of_torch(tmp_path):
    """Each torch-only forcing shape flags on a device value (the ``bad_*``
    defs) and passes its twin on a host value or with its size given."""
    root = _tree(tmp_path, {"pkg/ops/x.py": """
        import numpy as np
        import torch

        def bad_nonzero(n, device):
            t = torch.arange(n, device=device)
            return torch.nonzero(t > 2)

        def bad_nonzero_method(n, device):
            t = torch.arange(n, device=device)
            return (t > 2).nonzero()

        def bad_mask_index(n, device):
            t = torch.arange(n, device=device)
            return t[t > 2]

        def bad_unique(n, device):
            t = torch.arange(n, device=device)
            return torch.unique(t)

        def bad_repeat(n, device):
            t = torch.arange(n, device=device)
            return torch.repeat_interleave(t, t)

        def bad_repeat_method(n, device):
            t = torch.arange(n, device=device)
            return t.repeat_interleave(t)

        def bad_masked_select(n, device):
            t = torch.arange(n, device=device)
            return torch.masked_select(t, t > 2)

        def bad_event(device):
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

        def bad_stream(device):
            torch.cuda.current_stream(device).synchronize()

        def bad_device_sync():
            torch.cuda.synchronize()

        def bad_int(n, device):
            return int(torch.arange(n, device=device).max())

        def bad_to_cpu(n, device):
            return torch.arange(n, device=device).to("cpu")

        def good_host_nonzero(a):
            t = torch.from_numpy(a)
            return torch.nonzero(t > 2), t[t > 2], torch.unique(t)

        def good_repeat_sized(n, device):
            t = torch.arange(n, device=device)
            return torch.repeat_interleave(t, t, output_size=4 * n)

        def good_int_of_host(n, device):
            t = torch.arange(n, device=device)
            return int(n) + int(len(t)) + int(t.shape[0])

        def good_index(n, device):
            t = torch.arange(n, device=device)
            return t[torch.arange(2, device=device)], t[:2]
    """})
    assert _lines(_lint(root), "hidden-sync") == [
        6, 10, 14, 18, 22, 26, 30, 35, 38, 41, 44, 47]


@pytest.fixture(scope="module")
def unallowlisted():
    """The port's hidden-sync findings with an empty ``sync_allowlist``:
    ``(path, line)`` of each."""
    cfg = load_config(default_root())
    cfg.sync_allowlist = {}
    cfg.check_docs = False
    return {(f.path, f.line) for f in run_lint(default_root(), cfg).findings
            if f.rule == "hidden-sync"}


def test_repaired_concat_takes_no_sync(unallowlisted):
    """``columnar/device.py::concat_device`` compacts each batch with a
    stable sort where it used ``torch.nonzero`` (the JAX package's
    ``compact`` takes no sync there): even without the allowlist the rule
    finds nothing in it (its row counts are ``DeviceBatch.row_count``'s)."""
    fctx = FileCtx(default_root(), "spark_rapids_tpu_torch/columnar/device.py")
    concat = next(n for n in ast.walk(fctx.tree)
                  if isinstance(n, ast.FunctionDef)
                  and n.name == "concat_device")
    assert not {ln for p, ln in unallowlisted if p == fctx.rel
                and concat.lineno <= ln <= concat.end_lineno}
    assert any(p == fctx.rel for p, _ln in unallowlisted)


# ---------------------------------------------------------------------------
# handle-leak
# ---------------------------------------------------------------------------

_HANDLES = """
    def leak(staged, device):
        tok = start_upload(staged, device)  # never finished
        return None

    def dropped(staged, device):
        start_upload(staged, device)  # result dropped

    def tracked(store, b, out):
        h = store.register(b)
        out.append(h)  # escapes to the tracked container: fine

    def closed(store, b):
        h = store.register(b)
        try:
            return h.get()
        finally:
            h.close()

    def returned(store, b):
        return store.register(b)

    def except_only(store, b):
        h = store.register(b)
        try:
            return compute(h.get())
        except Exception:
            h.close()  # success path still leaks
            raise

    def spilled(self, store, b, out):
        h = self.register_spillable(store, b)
        return h.get()
"""


def test_handle_leak_same_findings_as_the_jax_engine(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": _HANDLES})
    srcs = ("register_spillable", "start_upload")
    port = [(f.line, f.message) for f in _of(
        _lint(root, handle_sources=srcs), "handle-leak")]
    jax = [(f.line, f.message) for f in _of(
        _jax_lint(root, handle_sources=srcs), "handle-leak")]
    assert [ln for ln, _m in port] == [ln for ln, _m in jax] == [2, 6, 23, 31]
    assert "never closed" in port[0][1] and "result dropped" in port[1][1]
    assert "exception path" in port[2][1]


def test_handle_leak_upload_ring_tokens(tmp_path):
    """The ring's ``place`` and ``start`` tokens (matched on a receiver
    named ``*ring*``) must reach ``release``/``finish_started`` or escape;
    a thread's ``start()`` is no source."""
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import threading

        def leaked_slot(ring, staged):
            placed = ring.place(staged)  # neither started nor released
            return staged

        def dropped_copy(self, placed):
            self.ring.start(placed)  # the started token is dropped

        def good(ring, staged):
            placed = ring.place(staged)
            started = ring.start(placed)
            return finish_started(started)

        def given_back(ring, staged, ok):
            placed = ring.place(staged)
            if not ok:
                ring.release(placed)

        def thread(fn):
            t = threading.Thread(target=fn)
            t.start()
            return t
    """})
    assert _lines(_lint(root), "handle-leak") == [4, 8]
    assert not _of(_lint(root), "hidden-sync")


# ---------------------------------------------------------------------------
# capture-purity
# ---------------------------------------------------------------------------

def test_capture_purity_two_calls_deep(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import time

        from pkg.exec.fused import run_program

        _REG = {}

        def stage(flat, metrics):
            return run_program(("k",), _captured, flat, metrics)

        def _captured(flat):
            return _helper(flat)

        def _helper(flat):
            t = time.time()  # host clock two calls below the root
            _REG["k"] = t    # module-state mutation
            return flat, None
    """})
    bad = _of(_lint(root), "capture-purity")
    assert [f.line for f in bad] == [14, 15]
    assert "host clock" in bad[0].message
    assert "mutates free state" in bad[1].message


def test_capture_purity_conf_read_and_pure_twin(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        from pkg.exec import fused as F

        def stage(conf, flat, metrics):
            limit = conf.get("k")  # read OUTSIDE the capture: ok
            return F.run_program("k", lambda f: _captured(f, limit), flat,
                                 metrics)

        def _captured(flat, limit):
            return flat, limit

        def stage_bad(conf, flat, metrics):
            def fn(f):
                return f, conf.get("k")  # read AT CAPTURE TIME
            return F.run_program("k2", fn, flat, metrics)
    """})
    bad = _of(_lint(root), "capture-purity")
    assert [f.line for f in bad] == [13]
    assert "dynamic conf read" in bad[0].message


def test_capture_purity_cross_module_from_import(tmp_path):
    root = _tree(tmp_path, {
        "pkg/exec/a.py": """
            from pkg.exec import fused as F
            from pkg.exec.b import helper

            def stage(flat, metrics):
                return F.run_program("k", _captured, flat, metrics)

            def _captured(flat):
                return helper(flat), None
        """,
        "pkg/exec/b.py": """
            import time

            def helper(x):
                return x + time.time()
        """})
    bad = _of(_lint(root), "capture-purity")
    assert [(f.path, f.line) for f in bad] == [("pkg/exec/b.py", 4)]


def test_capture_purity_closure_accumulator_is_pure(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        from pkg.exec import fused as F

        def make():
            def fn(flat):
                lanes = []
                memo = None

                def add(v):
                    nonlocal memo
                    lanes.append(v)
                    memo = v
                    return memo
                return add(flat), lanes
            return fn

        def stage(flat, metrics):
            return F.run_program("k", make(), flat, metrics)
    """})
    assert not _of(_lint(root), "capture-purity")


def test_capture_purity_factory_syncs_and_pageable_copies(tmp_path):
    """Through a factory (``fn = make(...)``, then ``stage = build(...)``
    inside it) the captured body may neither sync nor copy from pageable
    host memory; a pinned copy, a seeded generator and a device factory
    are fine."""
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import numpy as np
        import torch
        from pkg.exec import fused as F

        def build(device):
            def stage(t):
                host = torch.from_numpy(np.arange(4))
                a = host.to(device)  # pageable host->device copy
                b = torch.tensor([1, 2], device=device)  # pageable too
                c = t.nonzero()  # host sync
                d = t[t > 0].sum()  # host sync (mask index)
                e = torch.rand(4, device=device)  # RNG, no generator
                return a, b, c, d, e
            return stage

        def make(device):
            stage = build(device)

            def fn(flat):
                return stage(flat[0]), None
            return fn

        def run(flat, metrics, device):
            fn = make(device)
            return F.run_program("k", fn, flat, metrics)

        def pure(device):
            def fn(flat):
                pinned = torch.from_numpy(np.arange(4)).pin_memory()
                g = torch.Generator(device=device)
                return [pinned.to(device, non_blocking=True),
                        torch.rand(4, generator=g, device=device),
                        torch.zeros(4, device=device), flat[0] + 1], None
            return fn

        def run_pure(flat, metrics, device):
            return F.run_program("p", pure(device), flat, metrics)
    """})
    assert _lines(_lint(root), "capture-purity") == [8, 9, 10, 11, 12]


def test_capture_purity_capture_window_and_allowlist(tmp_path):
    """The statements between ``capture_begin`` and ``capture_end`` (and a
    ``torch.cuda.graph`` block's body) are captured too; an except
    clause's ``capture_end`` does not end the window."""
    root = _tree(tmp_path, {"pkg/exec/fused.py": """
        import time
        import torch

        def capture(fn, x, side):
            x.sum().item()  # before the capture: not checked
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            try:
                out = fn(x)
                t = time.perf_counter()  # inside the window
            except BaseException:
                graph.capture_end()
                raise
            graph.capture_end()
            n = out.sum().item()  # after the capture: not checked
            return graph, n, t

        def block(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = _inner(x)
            return g, y

        def _inner(x):
            return torch.ones(2, device=x.device).sum().item()
    """})
    r = _lint(root)
    assert _lines(r, "capture-purity") == [10, 25]
    allow = {"pkg/exec/fused.py::_inner": "fixture: not on the path"}
    assert _lines(_lint(root, purity_allowlist=allow),
                  "capture-purity") == [10]


# ---------------------------------------------------------------------------
# graph-direct and jit-module-cache
# ---------------------------------------------------------------------------

def test_graph_direct_bad_and_routed_good(tmp_path):
    root = _tree(tmp_path, {
        "pkg/exec/fused.py": """
            import torch
            from pkg.jit_cache import JitCache

            _C = JitCache("fixture")

            def bad():
                return torch.cuda.CUDAGraph()

            def good(key):
                prog, _ = _C.get_or_build(key, lambda: _builder())
                return prog

            def _builder():
                g = torch.cuda.CUDAGraph()
                return g

            def named(key):
                def build():
                    return Program.make()
                return _C.get_or_build(key, build)

            class Program:
                @classmethod
                def make(cls):
                    return cls()._capture()

                def _capture(self):
                    with torch.cuda.graph(torch.cuda.CUDAGraph()):
                        pass
        """,
        "pkg/exec/other.py": """
            import torch

            def elsewhere():
                return torch.cuda.CUDAGraph()
        """})
    bad = _of(_lint(root), "graph-direct")
    assert [(f.path, f.line) for f in bad] == [
        ("pkg/exec/fused.py", 7), ("pkg/exec/other.py", 4)]
    assert "outside the stage cache" in bad[0].message
    assert "outside pkg/exec/fused.py" in bad[1].message


def test_graph_builder_resolves_across_modules(tmp_path):
    root = _tree(tmp_path, {
        "pkg/exec/a.py": """
            from pkg.jit_cache import JitCache
            from pkg.exec import fused as B

            _C = JitCache("x")

            def use(key, steps):
                return _C.put(key, B.build_fn(steps))
        """,
        "pkg/exec/fused.py": """
            import torch

            def build_fn(steps):
                return torch.cuda.CUDAGraph()
        """})
    assert not _of(_lint(root), "graph-direct")


def test_graph_direct_suppressible_with_reason(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import torch

        def probe():
            return torch.cuda.CUDAGraph()  # tpu-lint: disable=graph-direct(one-shot capability probe)
    """})
    r = _lint(root)
    assert not _of(r, "graph-direct") and r.suppressed == 1


_MODULE_CACHES = """
    from collections import OrderedDict
    from pkg.jit_cache import JitCache

    _BAD_CACHE = {}
    _ALSO_BAD_CACHE = OrderedDict()
    _GOOD_CACHE = JitCache("good")
    _PLAIN_TABLE = {}
    _MEMO_CACHE = {}  # tpu-lint: disable=jit-module-cache(fixture memo of host values)
"""


def test_jit_module_cache_same_findings_as_the_jax_engine(tmp_path):
    root = _tree(tmp_path, {"pkg/exec/x.py": _MODULE_CACHES,
                            "pkg/jit_cache.py": "_HOME_CACHE = {}\n"})
    port = _lint(root)
    jax = _jax_lint(root)
    assert _lines(port, "jit-module-cache") \
        == _lines(jax, "jit-module-cache") == [4, 5]
    assert port.suppressed == jax.suppressed == 1


# ---------------------------------------------------------------------------
# the substrate against the JAX package's
# ---------------------------------------------------------------------------

_READS = """
def bad(x):
    y = f(x)
    return x.shape

def rebound(x):
    y = f(x)
    x = y
    return x.shape

def canonical(x):
    x = f(x)
    return x.shape

def loop(batches, acc):
    for b in batches:
        use(acc)
        f(acc)

def loop_target(batches):
    for b in batches:
        use(b)
        f(b)
"""


@pytest.mark.parametrize("fn_name,name", [
    ("bad", "x"), ("rebound", "x"), ("canonical", "x"), ("loop", "acc"),
    ("loop_target", "b")])
def test_reads_after_call_matches_the_jax_helper(tmp_path, fn_name, name):
    p = tmp_path / "m.py"
    p.write_text(_READS)

    def reads(fctx_cls, helper):
        fctx = fctx_cls(str(tmp_path), "m.py")
        fn = next(n for n in ast.walk(fctx.tree)
                  if isinstance(n, ast.FunctionDef) and n.name == fn_name)
        call = next(c for c in ast.walk(fn) if isinstance(c, ast.Call)
                    and getattr(c.func, "id", None) == "f")
        return [(n.lineno, n.col_offset) for n in helper(fn, call, name)]
    port = reads(FileCtx, DF.reads_after_call)
    assert port == reads(JFileCtx, JDF.reads_after_call)
    assert bool(port) == (fn_name in ("bad", "loop"))


# ---------------------------------------------------------------------------
# the port's own allowlists
# ---------------------------------------------------------------------------

def test_every_allowlist_entry_names_a_function_that_exists():
    """Each ``sync_allowlist`` and ``purity_allowlist`` key names a def of
    the port by its qualname, so neither list can go stale."""
    cfg = LintConfig()
    assert cfg.sync_allowlist and cfg.purity_allowlist
    root = default_root()
    quals = {}
    for key in list(cfg.sync_allowlist) + list(cfg.purity_allowlist):
        rel, _, qual = key.partition("::")
        if rel not in quals:
            from spark_rapids_tpu_torch.lint import astutil as A
            tree = FileCtx(root, rel).tree
            quals[rel] = {A.qualname(n) for n in ast.walk(tree)
                          if isinstance(n, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))}
        assert qual in quals[rel], key


def test_the_sanctioned_drain_points_are_flagged_without_their_entries(
        unallowlisted):
    """The drain points the JAX package sanctions, and the port's own,
    are real findings of the rule (so their entries are not dead): with
    an empty allowlist the rule flags each of them."""
    from spark_rapids_tpu_torch.lint import astutil as A
    root = default_root()
    flagged = set()
    for path, line in unallowlisted:
        fctx = FileCtx(root, path)
        flagged |= {f"{path}::{A.qualname(n)}" for n in ast.walk(fctx.tree)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.lineno <= line <= n.end_lineno}
    pkg = "spark_rapids_tpu_torch/"
    for fn in ("exec/exchange.py::split_by_pid", "ops/join.py::device_join",
               "exec/agg.py::TorchHashAggregateExec._run_partial",
               "ops/join.py::build_key_max_multiplicity",
               "columnar/device.py::DeviceBatch.row_count",
               "columnar/device.py::DeviceBatch.to_host",
               "columnar/device.py::finish_to_host",
               "columnar/device.py::_col_to_host",
               "columnar/transfer.py::StagingRing.place",
               "exec/fused.py::StageProgram.build"):
        assert pkg + fn in flagged, fn


# ---------------------------------------------------------------------------
# the repaired sync: concat_device's compaction, against the JAX package
# ---------------------------------------------------------------------------

def _concat_inputs(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    parts = []
    for n in (5, 40, 17):
        vals = [None if rng.random() < 0.2 else int(x)
                for x in rng.integers(-1000, 1000, n)]
        strs = [None if rng.random() < 0.2 else "s" * int(k)
                for k in rng.integers(0, 12, n)]
        parts.append(({"v": vals, "s": strs}, rng.random(n) < 0.6))
    return parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repaired_concat_rows_match_the_jax_package(seed):
    """``concat_device`` over batches with scattered active masks (nulls,
    strings of several widths) gives the JAX package's rows, in order."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from spark_rapids_tpu.columnar.device import DeviceBatch as JDB
    from spark_rapids_tpu.columnar.device import concat_device as jconcat
    from spark_rapids_tpu.columnar.host import HostBatch as JHB
    from spark_rapids_tpu.sql import types as JT
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        concat_device)
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    from spark_rapids_tpu_torch.sql import types as T

    schema = T.StructType([T.StructField("v", T.LongT),
                           T.StructField("s", T.StringT)])
    jschema = JT.StructType([JT.StructField("v", JT.LongT),
                             JT.StructField("s", JT.StringT)])
    ours, theirs, want = [], [], {"v": [], "s": []}
    for data, keep in _concat_inputs(seed):
        b = DeviceBatch.from_host(HostBatch.from_pydict(data, schema),
                                  torch.device("cpu"))
        mask = np.zeros(b.capacity, dtype=bool)
        mask[:len(keep)] = keep
        ours.append(DeviceBatch(schema, b.columns,
                                b.active & torch.from_numpy(mask), None))
        jb = JDB.from_host(JHB.from_pydict(data, jschema))
        jmask = np.zeros(jb.capacity, dtype=bool)
        jmask[:len(keep)] = keep
        theirs.append(JDB(jschema, jb.columns,
                          jb.active & jnp.asarray(jmask), None))
        for k in want:
            want[k] += [x for x, t in zip(data[k], keep) if t]
    got = concat_device(ours).to_host().to_pydict()
    assert got == jconcat(theirs).to_host().to_pydict() == want


# ---------------------------------------------------------------------------
# chip_smoke.py's sync audit: its attribution on the CPU
# ---------------------------------------------------------------------------

def test_sync_audit_names_functions_as_the_allowlist_does(monkeypatch):
    """The audit's recorder takes a sync to the innermost frame of the
    package on the stack, and ``enclosing_qualnames`` names it as the
    linter names the allowlist's functions: a warning raised inside
    ``DeviceBatch.row_count`` on the CPU lands on that entry."""
    import warnings

    import numpy as np
    import torch

    import chip_smoke as CS
    from spark_rapids_tpu_torch.columnar import device as D
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T

    root = default_root()
    b = D.DeviceBatch.from_host(host_batch_from_numpy(
        [("a", T.LongT)], [np.arange(10)]), torch.device("cpu"))
    b._num_rows = None

    def warning_int(x):
        warnings.warn(CS.SYNC_WARNING)
        return int(x)
    monkeypatch.setattr(D, "int", warning_int, raising=False)
    rec = CS.SyncRecorder(root)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = rec.hook
        assert b.row_count() == 10
        warnings.warn("not a sync")
    [(site, n)] = rec.lines.items()
    rel, line = site.rsplit(":", 1)
    quals = CS.enclosing_qualnames(root, rel, int(line), {})
    assert n == 1 and f"{rel}::{quals[0]}" in LintConfig().sync_allowlist
    assert quals[0] == "DeviceBatch.row_count"
    assert [m for m, _f, _l in rec.passed] == ["not a sync"]
    # called from this test, outside the package: no calling function
    assert list(rec.calls) == [(site, None)]
