"""The port's data-flow rules (the counterpart of
``spark_rapids_tpu.lint.rules_dataflow``), over ``lint/dataflow.py``'s
call graph and device-value taint:

``hidden-sync`` — inside the hot-path scopes (``exec/``, ``ops/``,
``kernels/``, ``columnar/``), a forcing operation (``dataflow.
forcing_kind``: ``.item()``, ``.tolist()``, ``.cpu()``, ``int()`` of a
tensor, ``torch.nonzero``, boolean-mask indexing, ``repeat_interleave``
without ``output_size``, an explicit ``synchronize()`` ...) applied to a
value that reaches from the card makes the host wait for every kernel
queued before it, and so stalls the queue the card works from. The
sanctioned drain points live in ``sync_allowlist`` with a written
reason; ``chip_smoke.py``'s ``sync_audit`` phase holds that list against
the syncs the main path takes on the card.

``handle-leak`` — the value a spillable registration returns
(``register_spillable``, ``<store>.register``) and the upload ring's
``place`` and ``start`` tokens must reach a ``close``/``release_*``/
``finish_*`` call, a context-manager scope, or escape into a tracked
container/return on SOME path — and not only on the exception path. A
handle that only GC frees holds device memory until the collector runs.

``capture-purity`` — the counterpart of ``trace-purity``. What runs
inside a CUDA graph capture runs once, at capture time, and every replay
repeats the captured kernels and nothing else. The roots are the ``fn``
handed to ``exec/fused.run_program`` and the statements between a
graph's ``capture_begin`` and ``capture_end`` (or inside a
``torch.cuda.graph(...)`` block); nothing reachable from them may take a
host sync (the forcing set), make a pageable host->device copy
(``torch.tensor``/``torch.as_tensor`` of host data onto the card, or
``.to(device)`` of an unpinned CPU tensor), read a clock, a conf key or
``random``/``np.random``/``torch.rand*`` without an explicit generator,
or assign module state. A sync or a pageable copy raises inside a
capture on the card; the others are baked into the graph and replayed
silently wrong.

``donation-safety`` has no counterpart: PyTorch donates no buffer to a
program (a graph replay copies each batch into the graph's static
inputs, and an eager program frees a batch when it is dropped), so no
buffer can be read after its donation.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint import dataflow as DF
from spark_rapids_tpu_torch.lint.engine import Finding, rule


def _allowlisted(fctx: A.FileCtx, node: ast.AST,
                 allowlist: Dict[str, str]) -> bool:
    """True when any enclosing function of ``node`` is an allowlist
    entry (``<rel>::<qualname>`` -> reason)."""
    if not allowlist:
        return False
    for fn in A.enclosing_functions(node):
        if isinstance(fn, ast.Lambda):
            continue
        if f"{fctx.rel}::{A.qualname(fn)}" in allowlist:
            return True
    return False


def _kernels_home(pctx) -> str:
    return pctx.config.scan_roots[0].rstrip("/") + "/kernels"


def _owning_def(node: ast.AST):
    """Innermost enclosing FunctionDef/AsyncFunctionDef, looking
    through lambdas (a lambda belongs to the def that wrote it)."""
    for a in A.enclosing_functions(node):
        if not isinstance(a, ast.Lambda):
            return a
    return None


def _forcing_sites(fctx: A.FileCtx, scope: ast.AST, owner, taint: DF.Taint,
                   tensor_taint: Optional[DF.Taint] = None):
    """(node, what) for each forcing operation in ``scope`` that belongs
    to the def ``owner`` (nested defs are their own units) and whose
    operand is a device value (an explicit synchronize always counts).
    ``tensor_taint``, when given, decides for the forcing shapes that
    only a tensor has (its methods, ``torch.*``, a mask index); ``int()``,
    ``float()``, ``bool()`` and ``np.asarray``, which take host values as
    well, keep ``taint``. ``int(np.asarray(c))`` reports once, at the
    inner copy."""
    for node in ast.walk(scope):
        if not isinstance(node, (ast.Call, ast.Subscript)):
            continue
        if _owning_def(node) is not owner:
            continue
        kind = DF.forcing_kind(fctx, node)
        if kind is None:
            continue
        op = kind.operand
        if op is not None:
            if isinstance(op, ast.Call) \
                    and DF.forcing_kind(fctx, op) is not None:
                continue
            t = taint if tensor_taint is None or kind.host_too \
                else tensor_taint
            if isinstance(node, ast.Subscript):
                # a mask index syncs only on a device tensor
                if not (t.expr(node.value) and t.expr(op)):
                    continue
            elif not t.expr(op):
                continue
        yield node, kind.what


# ---------------------------------------------------------------------------
# hidden-sync
# ---------------------------------------------------------------------------

@rule("hidden-sync",
      "device->host forcing ops on values reaching from the card are "
      "findings in the hot-path scopes unless allowlisted with a reason")
def check_hidden_sync(pctx):
    cfg = pctx.config
    hot = getattr(cfg, "hot_scope", ())
    allow = getattr(cfg, "sync_allowlist", {})
    cg = DF.callgraph(pctx)
    home = _kernels_home(pctx)
    for fctx in pctx.files:
        if not pctx.in_scope(fctx.rel, hot):
            continue
        for fn in ast.walk(fctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = DF.device_taint(fctx, fn, cg, home)
            for node, what in _forcing_sites(fctx, fn, fn, taint):
                if _allowlisted(fctx, node, allow):
                    continue
                yield Finding(
                    "hidden-sync", fctx.rel, node.lineno,
                    node.col_offset + 1,
                    f"{what} forces a device->host sync on a hot-path "
                    f"value — the host waits for every kernel queued "
                    f"before it; keep the value on the card (a lazily "
                    f"read device scalar, as metrics do) and read it at a "
                    f"sanctioned drain point, or add this function to "
                    f"sync_allowlist with a reason")


# ---------------------------------------------------------------------------
# handle-leak
# ---------------------------------------------------------------------------

_RELEASE_TAILS = ("close",)
_RELEASE_PREFIXES = ("release", "finish")
_CONTAINERS = (ast.Tuple, ast.List, ast.Set, ast.Dict, ast.Starred,
               ast.IfExp)


def _is_release_name(tail: Optional[str]) -> bool:
    return tail is not None and (
        tail in _RELEASE_TAILS
        or any(tail.startswith(p + "_") or tail == p
               for p in _RELEASE_PREFIXES))


def _is_handle_source(call: ast.Call, sources: Tuple[str, ...]) -> bool:
    """A bare source name matches the call's name; ``recv.name`` matches
    it on a receiver whose last name contains ``recv``; and
    ``<store>.register`` matches by its receiver."""
    tail = A.call_tail(call)
    if tail is None:
        return False
    recv = A.attr_path(call.func.value) \
        if isinstance(call.func, ast.Attribute) else None
    last = recv.rsplit(".", 1)[-1].lower() if recv is not None else None
    for src in sources:
        want_recv, _, name = src.rpartition(".")
        if name != tail:
            continue
        if not want_recv or (last is not None and want_recv.lower() in last):
            return True
    return tail == "register" and recv is not None \
        and "store" in recv.lower()


def _source_binding(call: ast.Call) -> Tuple[str, Optional[str]]:
    """Classify where a registration call's value goes: ('name', n) to
    track, ('ok', None) when it escapes/releases at the source
    (returned, passed on, context-managed, stored), ('dropped', None)
    for a bare expression statement."""
    node: ast.AST = call
    par = A.parent(node)
    while isinstance(par, _CONTAINERS):
        node, par = par, A.parent(par)
    if isinstance(par, ast.Assign):
        if node is par.value and len(par.targets) == 1 \
                and isinstance(par.targets[0], ast.Name):
            return "name", par.targets[0].id
        return "ok", None
    if isinstance(par, (ast.Return, ast.Yield, ast.Call, ast.withitem)):
        return "ok", None
    if isinstance(par, ast.Expr):
        return "dropped", None
    return "ok", None


def _handle_uses(fn: ast.AST, name: str, source: ast.Call
                 ) -> Tuple[List[ast.AST], List[ast.AST]]:
    """(releases, escapes) — Load uses of ``name`` that release the
    handle (`.close()`, `release_*`/`finish_*` calls, `with h`) or move
    its ownership (returned/yielded, passed to a call, stored into an
    attribute/subscript/alias, put in a container that is itself
    consumed). Plain reads (`h.get()`, `h.rows`) are neither."""
    releases: List[ast.AST] = []
    escapes: List[ast.AST] = []
    in_source = {id(n) for n in ast.walk(source)}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Name) and node.id == name
                and isinstance(node.ctx, ast.Load)):
            continue
        if id(node) in in_source:
            continue
        cur: ast.AST = node
        par = A.parent(cur)
        while isinstance(par, _CONTAINERS):
            cur, par = par, A.parent(par)
        if isinstance(par, ast.Attribute) and par.value is cur:
            gp = A.parent(par)
            if isinstance(gp, ast.Call) and gp.func is par:
                if _is_release_name(par.attr):
                    releases.append(node)
            continue  # attribute read: not a sink
        if isinstance(par, ast.Call):
            if _is_release_name(A.call_tail(par)):
                releases.append(node)
            else:
                escapes.append(node)
        elif isinstance(par, (ast.Return, ast.Yield)):
            escapes.append(node)
        elif isinstance(par, ast.Assign) and par.value is cur:
            escapes.append(node)  # alias / stored: ownership moved
        elif isinstance(par, ast.withitem) and par.context_expr is cur:
            releases.append(node)  # context manager closes it
    return releases, escapes


def _under_except(node: ast.AST) -> bool:
    return any(isinstance(a, ast.ExceptHandler)
               for a in A.ancestors(node))


@rule("handle-leak",
      "a spillable registration's handle and the upload ring's tokens "
      "must reach a close/release/finish call or escape to a tracked "
      "container — not be freed only by GC, and not only on the "
      "exception path")
def check_handle_leak(pctx):
    sources = tuple(getattr(pctx.config, "handle_sources",
                            ("register_spillable",)))
    for fctx in pctx.files:
        for call in A.file_calls(fctx):
            if not _is_handle_source(call, sources):
                continue
            fn = DF.enclosing_function(call)
            if fn is None or isinstance(fn, ast.Lambda):
                continue
            tail = A.call_tail(call)
            role, name = _source_binding(call)
            if role == "ok":
                continue
            if role == "dropped":
                yield Finding(
                    "handle-leak", fctx.rel, call.lineno,
                    call.col_offset + 1,
                    f"`{tail}(...)` result dropped — the handle/token it "
                    f"returns can only be freed by GC; bind it and close/"
                    f"release/finish it deterministically")
                continue
            releases, escapes = _handle_uses(fn, name, call)
            if not releases and not escapes:
                yield Finding(
                    "handle-leak", fctx.rel, call.lineno,
                    call.col_offset + 1,
                    f"`{name}` (from `{tail}`) is never closed, finished, "
                    f"released, or handed off — the handle leaks until "
                    f"GC; close it in a finally, or let it escape to the "
                    f"tracked container that owns it")
            elif all(_under_except(s) for s in releases + escapes):
                yield Finding(
                    "handle-leak", fctx.rel, call.lineno,
                    call.col_offset + 1,
                    f"`{name}` (from `{tail}`) is only released on the "
                    f"exception path — the success path leaks it to GC; "
                    f"close it in normal flow or a finally")


# ---------------------------------------------------------------------------
# capture-purity
# ---------------------------------------------------------------------------

_MUTATORS = frozenset({"append", "extend", "add", "update", "insert",
                       "remove", "discard", "clear", "pop", "popitem",
                       "setdefault", "appendleft", "extendleft"})
_IMPURE_HEADS = ("time.", "random.", "numpy.random.")
# clocks of the datetime module (its constructors are pure)
_CLOCKS = frozenset({"now", "today", "utcnow"})
# explicit generators: seeded by their caller, so deterministic
_GENERATORS = frozenset({"numpy.random.default_rng",
                         "numpy.random.Generator",
                         "numpy.random.RandomState", "random.Random"})
_TORCH_RANDOM = frozenset({"rand", "randn", "randint", "randperm",
                           "rand_like", "randn_like", "randint_like",
                           "bernoulli", "multinomial", "normal"})
_HOST_SOURCES = frozenset({"torch.from_numpy", "torch.tensor",
                           "torch.as_tensor"})


def _is_pinned(e: ast.AST) -> bool:
    return any((isinstance(n, ast.Call) and A.call_tail(n) == "pin_memory")
               or (isinstance(n, ast.keyword) and n.arg == "pin_memory")
               for n in ast.walk(e))


def _host_tensor_expr(fctx: A.FileCtx, e: ast.AST,
                      host_names: Set[str]) -> bool:
    """A CPU tensor by construction: ``torch.from_numpy(...)``, or a
    ``torch.tensor``/``as_tensor`` made without a device, or a name bound
    to one."""
    if isinstance(e, ast.Name):
        return e.id in host_names
    if isinstance(e, ast.Call) and A.resolve_path(fctx, e.func) \
            in _HOST_SOURCES:
        dev = DF.kwarg(e, "device")
        return dev is None or DF.is_cpu_literal(dev)
    return False


def _pageable_copies(fctx: A.FileCtx, fn: ast.AST):
    """(node, what) for each pageable host->device copy in ``fn``."""
    host_names: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _host_tensor_expr(fctx, node.value, host_names) \
                and not _is_pinned(node.value):
            host_names.add(node.targets[0].id)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        p = A.resolve_path(fctx, node.func)
        if p in ("torch.tensor", "torch.as_tensor"):
            dev = DF.kwarg(node, "device")
            if dev is not None and DF.is_device_arg(dev):
                yield node, f"`{p}(..., device=...)` (pageable " \
                            f"host->device copy)"
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in ("to", "cuda"):
            dev = DF.kwarg(node, "device") or (node.args[0] if node.args
                                             else None)
            to_device = f.attr == "cuda" or (
                dev is not None and DF.is_device_arg(dev))
            if to_device and _host_tensor_expr(fctx, f.value, host_names) \
                    and not _is_pinned(f.value):
                yield node, (f"`.{f.attr}(device)` of an unpinned CPU "
                             f"tensor (pageable host->device copy)")


def _purity_violations(fctx: A.FileCtx, fn: ast.AST, cg: DF.CallGraph,
                       home: str):
    """(node, what) impurities lexically inside ``fn`` (a def, a lambda or
    one statement of a capture window). Names bound in
    a lexically ENCLOSING function count as local: a closure accumulator
    made fresh per capture is deterministic bookkeeping; only module
    state survives between captures."""
    locals_ = DF.local_names(fn)
    for enc in A.enclosing_functions(fn):
        locals_ |= DF.local_names(enc)
    owner = fn if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        else _owning_def(fn)
    if owner is not None:
        # a function reached from a capture is handed the card's tensors
        taint = DF.device_taint(fctx, owner, cg, home)
        inputs = DF.device_taint(fctx, owner, cg, home,
                                 params_on_device=True)
        for node, what in _forcing_sites(fctx, fn, owner, taint, inputs):
            yield node, f"{what} (host sync)"
    yield from _pageable_copies(fctx, fn)
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            yield node, (f"`global {', '.join(node.names)}` "
                         f"(module-state mutation)")
        elif isinstance(node, ast.Call):
            p = A.resolve_path(fctx, node.func)
            if p is not None and p not in _GENERATORS and (any(
                    p.startswith(h) for h in _IMPURE_HEADS) or (
                    p.startswith("datetime.")
                    and p.rsplit(".", 1)[-1] in _CLOCKS)):
                yield node, f"`{p}(...)` (host clock/RNG)"
                continue
            if p is not None and p.startswith("torch.") \
                    and p.rsplit(".", 1)[-1] in _TORCH_RANDOM \
                    and DF.kwarg(node, "generator") is None:
                yield node, f"`{p}(...)` without a generator (RNG)"
                continue
            tail = A.call_tail(node)
            if tail == "get" and isinstance(node.func, ast.Attribute):
                recv = A.attr_path(node.func.value)
                if recv is not None \
                        and "conf" in recv.split(".")[-1].lower():
                    yield node, f"`{recv}.get(...)` (dynamic conf read)"
                    continue
            if tail in _MUTATORS and isinstance(node.func, ast.Attribute):
                root = DF.root_name(node.func.value)
                # a module alias's function (``I.add(a, b)``) is a call
                if root is not None and root not in locals_ \
                        and root not in fctx.imports:
                    yield node, (f"`{root}.{tail}(...)` (mutates "
                                 f"free state)")
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, (ast.Attribute, ast.Subscript)):
                    root = DF.root_name(t)
                    if root is not None and root not in locals_ \
                            and root != "self":
                        yield t, (f"assignment into `{root}` (mutates "
                                  f"free state)")


def _program_arg_roots(fctx: A.FileCtx, cg: DF.CallGraph,
                       arg: ast.AST) -> List[ast.AST]:
    """The function(s) a ``run_program`` ``fn`` argument can be: a
    lambda, a def, or the nested def a factory returns (inline
    ``_chain_program(...)`` or through a name bound to it)."""
    if isinstance(arg, ast.Lambda):
        return [arg]
    if isinstance(arg, ast.Name):
        infos = cg.resolve_name(fctx, arg.id) \
            or cg.factory_products(fctx, arg, arg.id)
        return [i.node for i in infos]
    if isinstance(arg, ast.Call):
        out = []
        for tgt in cg.resolve_call(fctx, arg):
            out.extend(i.node for i in cg.returned_defs(tgt))
        return out
    return []


def _capture_windows(fctx: A.FileCtx):
    """Each statement of a capture region in the file: the statements
    after ``X.capture_begin(...)`` up to the one holding ``X.capture_end()``
    in the same block (an except clause's capture_end, which ends a
    failed capture, does not end the window), and the bodies of
    ``with torch.cuda.graph(...)`` blocks."""
    for node in ast.walk(fctx.tree):
        if isinstance(node, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and A.resolve_path(fctx, it.context_expr.func)
                == "torch.cuda.graph" for it in node.items):
            yield from node.body
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, st in enumerate(stmts):
                if not (isinstance(st, ast.Expr)
                        and isinstance(st.value, ast.Call)
                        and A.call_tail(st.value) == "capture_begin"):
                    continue
                for later in stmts[i + 1:]:
                    if any(isinstance(c, ast.Call)
                           and A.call_tail(c) == "capture_end"
                           and not _under_except(c)
                           for c in ast.walk(later)):
                        break
                    yield later


@rule("capture-purity",
      "code reachable from a CUDA graph capture (run_program's fn, a "
      "capture_begin/capture_end window) must not sync, copy from "
      "pageable host memory, read clocks/RNG/conf or mutate module "
      "state — the capture would raise, or bake the value in")
def check_capture_purity(pctx):
    cfg = pctx.config
    allow = getattr(cfg, "purity_allowlist", {})
    cg = DF.callgraph(pctx)
    home = _kernels_home(pctx)
    roots: List[Tuple[A.FileCtx, ast.AST]] = []
    lambda_roots: List[Tuple[A.FileCtx, ast.AST]] = []
    window_roots: List[Tuple[A.FileCtx, ast.AST]] = []
    for fctx in pctx.files:
        for call in A.file_calls(fctx):
            if A.call_tail(call) != "run_program" or len(call.args) < 2:
                continue
            for node in _program_arg_roots(fctx, cg, call.args[1]):
                roots.append((fctx, node))
                if isinstance(node, ast.Lambda):
                    lambda_roots.append((fctx, node))
        for st in _capture_windows(fctx):
            roots.append((fctx, st))
            window_roots.append((fctx, st))
    reached = cg.reachable(roots)
    seen: Set[Tuple[str, int, int]] = set()

    def emit(fctx, label, node, what):
        key = (fctx.rel, node.lineno, node.col_offset)
        if key in seen:
            return None
        seen.add(key)
        return Finding(
            "capture-purity", fctx.rel, node.lineno, node.col_offset + 1,
            f"{what} inside `{label}`, which runs inside a CUDA graph "
            f"capture — a sync or a pageable copy raises there, and any "
            f"other host value is baked into the graph and replayed "
            f"unchanged; hoist it out of the captured body (compute it "
            f"before the capture and pass it in as an input)")

    for info in reached.values():
        if f"{info.rel}::{info.qualname}" in allow:
            continue
        for node, what in _purity_violations(info.fctx, info.node, cg,
                                             home):
            f = emit(info.fctx, info.qualname, node, what)
            if f is not None:
                yield f
    for fctx, lam in lambda_roots:
        if _allowlisted(fctx, lam, allow):
            continue
        for node, what in _purity_violations(fctx, lam, cg, home):
            f = emit(fctx, "<captured lambda>", node, what)
            if f is not None:
                yield f
    for fctx, stmt in window_roots:
        if _allowlisted(fctx, stmt, allow):
            continue
        owner = DF.enclosing_function(stmt)
        label = (A.qualname(owner) if owner is not None else "<module>") \
            + " (capture window)"
        for node, what in _purity_violations(fctx, stmt, cg, home):
            f = emit(fctx, label, node, what)
            if f is not None:
                yield f
