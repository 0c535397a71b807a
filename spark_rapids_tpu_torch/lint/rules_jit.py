"""The port's compile-discipline rules (the counterpart of
``spark_rapids_tpu.lint.rules_jit``).

``graph-direct`` — the counterpart of ``jit-direct``. A CUDA graph
(``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``,
``torch.cuda.make_graphed_callables``) pins a private memory pool and a
fixed set of kernel launches, as a compiled program pins an executable.
It is built only in ``exec/fused.py`` (``graph_home``), inside a builder
reachable from a ``JitCache`` ``get_or_build`` / ``put`` call — closed
transitively over the package call graph, as the JAX rule closes over
its builders — so every graph is bounded by the stage cache's LRU and
released by its recovery path.

``jit-module-cache`` — a module-level dict named ``*cache*`` used as a
cache of built programs bypasses the LRU bound and the single-flight
build path of ``jit_cache.JitCache``. Use ``JitCache`` instead, or
suppress with a reason when the dict holds no program.

The JAX rule's Pallas half (``pl.pallas_call`` sanctioned only in the
kernels/ registry package) has no counterpart: the port's kernels are
hand-written CUDA C++ built by ``nvcc`` into shared libraries and bound
with ``ctypes`` (``kernels/__init__.py``), so there is no traced kernel
builder to route.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint.engine import Finding, rule

_GRAPH_PATHS = frozenset({"torch.cuda.CUDAGraph", "torch.cuda.graph",
                          "torch.cuda.make_graphed_callables"})


def _jitcache_names(fctx: A.FileCtx) -> Set[str]:
    """Module-level names bound to a JitCache(...) instance."""
    out: Set[str] = set()
    for node in fctx.tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if A.call_tail(node.value) == "JitCache":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _resolve_callable(fctx: A.FileCtx, func: ast.AST
                      ) -> Tuple[str, str]:
    """(rel_path, func_name) a call target resolves to, best effort.
    Local names resolve to this file; ``X.fn`` resolves through the
    import alias map to the target module's path."""
    if isinstance(func, ast.Name):
        return fctx.rel, func.id
    if isinstance(func, ast.Attribute):
        if isinstance(func.value, ast.Name) \
                and func.value.id in fctx.imports:
            return A.module_rel(fctx.imports[func.value.id]), func.attr
        # self.method / other receivers: match by name in this file
        return fctx.rel, func.attr
    return "", ""


def _builder_closure(pctx) -> Dict[str, Set[int]]:
    """Per-file set of function/lambda node ids whose bodies are builder
    code for some JitCache (get_or_build builders, .put value
    expressions, and everything they call, package-wide)."""
    builder_nodes: Dict[str, Set[int]] = {f.rel: set()
                                          for f in pctx.files}
    work: List[Tuple[str, str]] = []
    seen: Set[Tuple[str, str]] = set()

    def seed_calls_in(fctx: A.FileCtx, node: ast.AST) -> None:
        for c in A.walk_calls(node):
            rel, name = _resolve_callable(fctx, c.func)
            if not name:
                continue
            key = (rel or fctx.rel, name)
            if key not in seen:
                seen.add(key)
                work.append(key)

    for fctx in pctx.files:
        caches = _jitcache_names(fctx)
        for call in A.file_calls(fctx):
            tail = A.call_tail(call)
            if tail == "put" and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id in caches \
                    and len(call.args) >= 2:
                val = call.args[1]
                for sub in ast.walk(val):
                    if isinstance(sub, ast.Lambda):
                        builder_nodes[fctx.rel].add(id(sub))
                builder_nodes[fctx.rel].add(id(val))
                seed_calls_in(fctx, val)
            elif tail == "get_or_build" and len(call.args) >= 2:
                arg = call.args[1]
                if isinstance(arg, ast.Lambda):
                    builder_nodes[fctx.rel].add(id(arg))
                    seed_calls_in(fctx, arg)
                elif isinstance(arg, ast.Name):
                    key = (fctx.rel, arg.id)
                    if key not in seen:
                        seen.add(key)
                        work.append(key)

    defs_cache: Dict[str, Dict[str, List[ast.AST]]] = {}
    while work:
        rel, name = work.pop()
        fctx = pctx.by_rel.get(rel)
        if fctx is None:
            continue
        if rel not in defs_cache:
            defs_cache[rel] = A.defs_by_name(fctx.tree)
        for node in defs_cache[rel].get(name, ()):
            if id(node) in builder_nodes[rel]:
                continue
            builder_nodes[rel].add(id(node))
            seed_calls_in(fctx, node)
    return builder_nodes


@rule("graph-direct",
      "a CUDA graph is built only in exec/fused.py, inside a builder "
      "reachable from the stage cache (JitCache get_or_build / put)")
def check_graph_direct(pctx):
    cfg = pctx.config
    home = getattr(cfg, "graph_home", "")
    builders = None
    for fctx in pctx.files:
        for call in A.file_calls(fctx):
            p = A.resolve_path(fctx, call.func)
            if p not in _GRAPH_PATHS:
                continue
            if fctx.rel == home:
                if builders is None:
                    builders = _builder_closure(pctx)
                file_builders = builders.get(fctx.rel, set())
                if any(id(a) in file_builders
                       for a in [call] + list(A.ancestors(call))):
                    continue
                where = "outside the stage cache's builders"
            else:
                where = f"outside {home or 'the graph home'}"
            yield Finding(
                "graph-direct", fctx.rel, call.lineno, call.col_offset + 1,
                f"`{p}` {where} — a CUDA graph pins a private memory pool "
                f"and its launches; build it through "
                f"exec/fused.run_program, whose stage cache bounds and "
                f"releases every graph, or suppress with a reason if the "
                f"graph is fixed and bounded by construction")


_DICTISH = ("dict", "OrderedDict", "defaultdict")


@rule("jit-module-cache",
      "module-level dict caches of built programs bypass the JitCache "
      "LRU bound")
def check_module_cache(pctx):
    cfg = pctx.config
    for fctx in pctx.files:
        if fctx.rel == cfg.jit_home:
            continue
        for stmt in fctx.tree.body:
            targets: List[ast.AST] = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value \
                    is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            is_dict = isinstance(value, ast.Dict) or (
                isinstance(value, ast.Call)
                and A.call_tail(value) in _DICTISH)
            if not is_dict:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and "cache" in t.id.lower():
                    yield Finding(
                        "jit-module-cache", fctx.rel, stmt.lineno, 1,
                        f"module-level dict cache `{t.id}` — built "
                        f"programs must live in a bounded JitCache "
                        f"(LRU + single-flight + stats); suppress with a "
                        f"reason if it does not hold built programs")
