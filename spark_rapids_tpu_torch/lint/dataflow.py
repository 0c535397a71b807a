"""Interprocedural data-flow plumbing for the port's data-flow lint tier
(the counterpart of ``spark_rapids_tpu.lint.dataflow``), stdlib ``ast``
only:

* ``CallGraph`` — whole-package, cross-module call graph with targets
  resolved through import aliases (``X.fn`` follows the alias to the
  target module's defs; bare names and ``self.method`` match in-file),
  plus one factory hop: a call of a name bound to a factory's result
  (``stage = X.build_stage_fn(...)`` then ``stage(...)``) reaches the
  nested defs the factory returns. ``reachable`` closes over it for the
  capture-purity roots. Built once per lint run (``callgraph``).
* Reaching-definitions helpers — ``reads_after_call`` finds loads of a
  name on any forward path from a call (source order after the call,
  plus the back edge of an enclosing loop), with straight-line
  rebindings killing the flag.
* Device-value taint — ``device_taint`` runs a per-function fixed point
  seeding from what puts a tensor on the card: a ``torch.*`` factory or
  ``.to(...)``/``.cuda()`` handed a device that is not a literal
  ``"cpu"``, a kernel wrapper under ``kernels/``, a stage program's
  ``run`` or ``exec/fused.run_program``, a ``DeviceBatch`` or device
  column field; it propagates through assignments, loops, tensor methods
  and ``torch.*`` functions of tainted values. ``torch.from_numpy`` and
  tensors made without a device stay clean, so the rules built on it
  UNDER-approximate as the JAX package's do.
* The forcing set (``forcing_kind``): what pulls a device value to the
  host or waits for the card — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``np.asarray``/``np.array`` and
  ``int``/``float``/``bool`` of a tensor, ``torch.nonzero``/
  ``.nonzero()``, ``torch.unique``, ``masked_select``, boolean-mask
  indexing, ``repeat_interleave`` without ``output_size``, and
  ``torch.cuda.synchronize`` / ``Stream.synchronize`` /
  ``Event.synchronize``.

The JAX module's donating-program resolution has no counterpart: PyTorch
donates no buffer to a program (a CUDA graph copies each batch into its
static inputs), so nothing here feeds a donation-safety rule.

Everything is best-effort static resolution: dynamic dispatch, attribute
tables and cross-instance aliasing are invisible, so missed findings are
possible; false positives should be rare and carry an allowlist entry or
a reasoned suppression.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint import astutil as A


# ---------------------------------------------------------------------------
# Whole-package call graph
# ---------------------------------------------------------------------------

class FuncInfo:
    """One function/method definition somewhere in the package."""

    __slots__ = ("fctx", "rel", "node", "qualname")

    def __init__(self, fctx: A.FileCtx, node: ast.AST):
        self.fctx = fctx
        self.rel = fctx.rel
        self.node = node
        self.qualname = A.qualname(node)


class CallGraph:
    """Best-effort package call graph. Defs are indexed per file by
    bare name; a call target resolves to this file's defs (``foo(...)``,
    ``self.method(...)``) or, for ``X.fn(...)`` with ``X`` an import
    alias, to the aliased module's defs; a name bound to a factory call
    resolves to the nested defs that factory returns."""

    def __init__(self, pctx):
        self.pctx = pctx
        self.defs: Dict[Tuple[str, str], List[FuncInfo]] = {}
        self.infos: Dict[int, FuncInfo] = {}
        for fctx in pctx.files:
            for node in ast.walk(fctx.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    info = FuncInfo(fctx, node)
                    self.defs.setdefault((fctx.rel, node.name),
                                         []).append(info)
                    self.infos[id(node)] = info
        self._returned: Dict[int, List[FuncInfo]] = {}
        self._resolved: Dict[int, List[FuncInfo]] = {}
        # per file: name -> the single-name assignments from a call
        self._call_binds: Dict[str, Dict[str, List[ast.Assign]]] = {}
        self._launchers: Dict[str, Set[int]] = {}

    def resolve_name(self, fctx: A.FileCtx,
                     name: str) -> List[FuncInfo]:
        """A bare name: a def in this file, or a from-import
        (``from pkg.mod import fn`` maps ``fn`` -> ``pkg.mod.fn`` in the
        alias table) followed to its home."""
        got = self.defs.get((fctx.rel, name))
        if got:
            return got
        dotted = fctx.imports.get(name)
        if dotted and "." in dotted:
            mod, _, attr = dotted.rpartition(".")
            return self.defs.get((A.module_rel(mod), attr), [])
        return []

    def resolve_call(self, fctx: A.FileCtx,
                     call: ast.Call) -> List[FuncInfo]:
        got = self._resolved.get(id(call))
        if got is None:
            got = self._resolved[id(call)] = self._resolve(fctx, call)
        return got

    def _resolve(self, fctx: A.FileCtx, call: ast.Call) -> List[FuncInfo]:
        f = call.func
        if isinstance(f, ast.Name):
            got = self.resolve_name(fctx, f.id)
            if got:
                return got
            return self.factory_products(fctx, call, f.id)
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) \
                    and f.value.id in fctx.imports:
                rel = A.module_rel(fctx.imports[f.value.id])
                got = self.defs.get((rel, f.attr))
                if got:
                    return got
            # in-file method resolution ONLY for self/cls receivers: a
            # bare-name match on any `obj.foo()` would collide with
            # unrelated same-named defs
            if isinstance(f.value, ast.Name) \
                    and f.value.id in ("self", "cls"):
                return self.defs.get((fctx.rel, f.attr), [])
        return []

    def returned_defs(self, info: FuncInfo) -> List[FuncInfo]:
        """The defs nested in ``info`` that it returns by name (the
        ``def fn(...): ...; return fn`` factory shape)."""
        got = self._returned.get(id(info.node))
        if got is not None:
            return got
        nested = {n.name: n for n in ast.walk(info.node)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                  and n is not info.node}
        out = []
        for r in ast.walk(info.node):
            if isinstance(r, ast.Return) and isinstance(r.value, ast.Name) \
                    and enclosing_function(r) is info.node \
                    and r.value.id in nested:
                out.append(self.infos[id(nested[r.value.id])])
        self._returned[id(info.node)] = out
        return out

    def factory_products(self, fctx: A.FileCtx, at: ast.AST,
                         name: str) -> List[FuncInfo]:
        """What a name bound by ``name = factory(...)`` in a function
        enclosing ``at`` (or at module level) can be: the nested defs the
        factory returns."""
        binds = self._call_binds.get(fctx.rel)
        if binds is None:
            binds = self._call_binds[fctx.rel] = {}
            for node in ast.walk(fctx.tree):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            binds.setdefault(t.id, []).append(node)
        scopes = {id(s) for s in A.enclosing_functions(at)}
        for node in binds.get(name, ()):
            scope = enclosing_function(node)
            if scope is not None and id(scope) not in scopes:
                continue
            out = []
            for tgt in self.resolve_call(fctx, node.value):
                out.extend(self.returned_defs(tgt))
            if out:
                return out
        return []

    def launchers(self, kernels_home: str) -> Set[int]:
        """The kernel wrappers: defs under ``kernels_home`` that count a
        kernel launch (``count_launch``), closed over the defs there that
        call one. Their outputs live on the card."""
        home = kernels_home.rstrip("/") + "/"
        got = self._launchers.get(home)
        if got is not None:
            return got
        infos = [i for i in self.infos.values() if i.rel.startswith(home)]
        out: Set[int] = {id(i.node) for i in infos
                         if any(A.call_tail(c) == "count_launch"
                                for c in A.walk_calls(i.node))}
        changed = True
        while changed:
            changed = False
            for i in infos:
                if id(i.node) in out:
                    continue
                if any(id(t.node) in out
                       for c in A.walk_calls(i.node)
                       for t in self.resolve_call(i.fctx, c)):
                    out.add(id(i.node))
                    changed = True
        self._launchers[home] = out
        return out

    def reachable(self, roots: Iterable[Tuple[A.FileCtx, ast.AST]]
                  ) -> Dict[int, FuncInfo]:
        """Transitive closure from ``(fctx, fn-node)`` roots. Lambda
        roots seed their calls but only named defs are returned (a
        lambda's body is lexically part of whatever walks it)."""
        out: Dict[int, FuncInfo] = {}
        seen: Set[int] = set()
        work = list(roots)
        while work:
            fctx, node = work.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            info = self.infos.get(id(node))
            if info is not None:
                out[id(node)] = info
            for call in A.walk_calls(node):
                for tgt in self.resolve_call(fctx, call):
                    if id(tgt.node) not in seen:
                        work.append((tgt.fctx, tgt.node))
        return out


def callgraph(pctx) -> CallGraph:
    """The run's call graph, built once and shared by every rule."""
    cg = getattr(pctx, "_df_callgraph", None)
    if cg is None:
        cg = pctx._df_callgraph = CallGraph(pctx)
    return cg


# ---------------------------------------------------------------------------
# Position / scope helpers
# ---------------------------------------------------------------------------

def pos_of(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def root_name(expr: ast.AST) -> Optional[str]:
    """Base Name of a Name/Attribute/Subscript/Starred chain:
    ``b.columns`` -> ``b``; None for anything rootless."""
    cur = expr
    while isinstance(cur, (ast.Attribute, ast.Subscript, ast.Starred)):
        cur = cur.value
    return cur.id if isinstance(cur, ast.Name) else None


def local_names(fn: ast.AST) -> Set[str]:
    """Names BOUND inside a function/lambda: parameters, every Store
    target, nested defs, local imports. A Load of anything outside this
    set reads free state (closure or module)."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            out.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            if not isinstance(node, ast.Lambda):
                out.add(node.name)
            out |= local_names(node)
        elif isinstance(node, ast.Name) \
                and isinstance(node.ctx, ast.Store):
            out.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out.add((a.asname or a.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            out.add(node.name)
    return out


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    fns = A.enclosing_functions(node)
    return fns[0] if fns else None


def _outermost_loop_within(node: ast.AST,
                           stop: ast.AST) -> Optional[ast.AST]:
    loop = None
    for a in A.ancestors(node):
        if a is stop:
            break
        if isinstance(a, (ast.For, ast.AsyncFor, ast.While)):
            loop = a
    return loop


def _stores_of(scope: ast.AST, name: str) -> List[Tuple[int, int]]:
    return sorted(pos_of(n) for n in ast.walk(scope)
                  if isinstance(n, ast.Name)
                  and isinstance(n.ctx, ast.Store) and n.id == name)


def reads_after_call(fn: ast.AST, call: ast.Call,
                     name: str) -> List[ast.Name]:
    """Loads of ``name`` inside ``fn`` that sit on a forward path from
    ``call``: after it in source order, or anywhere in the call's
    outermost enclosing loop (the back edge runs the read AFTER the
    call on the next iteration). A rebinding of the name between the
    call and the read kills the flag — including a rebinding in the
    calling statement itself (``x = f(x)``) and the loop's own
    iteration target."""
    cpos = pos_of(call)
    for a in A.ancestors(call):
        if isinstance(a, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in a.targets):
            return []
        if isinstance(a, ast.stmt):
            break
    kills = _stores_of(fn, name)
    loop = _outermost_loop_within(call, fn)
    loop_ids = {id(n) for n in ast.walk(loop)} if loop is not None \
        else set()
    loop_kills = _stores_of(loop, name) if loop is not None else []
    in_call = {id(n) for n in ast.walk(call)}
    out: List[ast.Name] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Name) and node.id == name
                and isinstance(node.ctx, ast.Load)):
            continue
        if id(node) in in_call:
            continue
        rpos = pos_of(node)
        if rpos > cpos:
            if not any(cpos < k <= rpos for k in kills):
                out.append(node)
        elif id(node) in loop_ids:
            if not any(k > cpos for k in loop_kills) \
                    and not any(k < rpos for k in loop_kills):
                out.append(node)
    return sorted(out, key=pos_of)


# ---------------------------------------------------------------------------
# The forcing set
# ---------------------------------------------------------------------------

# methods of a tensor that pull its value to the host (what they are
# called on must be a device value)
_FORCING_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                              "unique", "masked_select"})
# torch functions that size their output from the data (their first
# argument must be a device value)
_FORCING_TORCH = frozenset({"torch.nonzero", "torch.unique",
                            "torch.masked_select", "torch.argwhere"})
_FORCING_BUILTINS = frozenset({"int", "float", "bool"})
_NP_COPIES = frozenset({"numpy.asarray", "numpy.array"})
# explicit waits for the card: forcing whatever they are called on
_WAITS = frozenset({"torch.cuda.synchronize"})
# a batch's and a column's boolean masks (an index by one is a mask index)
_MASK_FIELDS = frozenset({"active", "validity"})


def is_cpu_literal(e: ast.AST) -> bool:
    if isinstance(e, ast.Constant):
        return e.value == "cpu"
    if isinstance(e, ast.Call) and A.call_tail(e) == "device" \
            and e.args and isinstance(e.args[0], ast.Constant):
        return e.args[0].value == "cpu"
    return False


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class Forcing:
    """One forcing shape: ``what`` names it in a message; ``operand`` is
    the expression that must be a device value (None: it forces whatever
    it is called on, as an explicit synchronize does); ``host_too`` marks
    the shapes that take host values as well (``int()``, ``np.asarray``)."""

    __slots__ = ("what", "operand", "host_too")

    def __init__(self, what: str, operand: Optional[ast.AST],
                 host_too: bool = False):
        self.what = what
        self.operand = operand
        self.host_too = host_too


def forcing_kind(fctx: A.FileCtx, node: ast.AST) -> Optional[Forcing]:
    """The device->host forcing shape of a call or a subscript, if any."""
    if isinstance(node, ast.Subscript):
        # boolean-mask indexing: the result's size is the mask's count
        if isinstance(node.ctx, ast.Load) and is_mask_expr(node.slice):
            return Forcing("boolean-mask indexing", node.slice)
        return None
    if not isinstance(node, ast.Call):
        return None
    p = A.resolve_path(fctx, node.func)
    f = node.func
    if p in _WAITS:
        return Forcing("torch.cuda.synchronize()", None)
    if p in _NP_COPIES and node.args:
        return Forcing("np.asarray", node.args[0], host_too=True)
    if p in _FORCING_TORCH and node.args:
        return Forcing(f"{p}()", node.args[0])
    if p == "torch.repeat_interleave" and node.args \
            and kwarg(node, "output_size") is None:
        return Forcing("torch.repeat_interleave() without output_size",
                       node.args[0])
    if isinstance(f, ast.Name) and f.id in _FORCING_BUILTINS \
            and len(node.args) == 1 and not node.keywords:
        return Forcing(f"{f.id}()", node.args[0], host_too=True)
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "synchronize" and not node.args:
        return Forcing(".synchronize()", None)
    if f.attr in _FORCING_METHODS and not (f.attr == "item"
                                           and node.args):
        return Forcing(f".{f.attr}()", f.value)
    if f.attr == "repeat_interleave" and kwarg(node, "output_size") is None:
        return Forcing(".repeat_interleave() without output_size", f.value)
    if f.attr == "to":
        dev = kwarg(node, "device") or (node.args[0] if node.args else None)
        if dev is not None and is_cpu_literal(dev):
            return Forcing('.to("cpu")', f.value)
    return None


def is_mask_expr(e: ast.AST) -> bool:
    """An index expression that is a boolean mask by its shape: a
    comparison, ``~m``, ``a & b`` / ``a | b`` of masks, or a batch's
    ``active`` / a column's ``validity``."""
    if isinstance(e, ast.Compare):
        return True
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
        return is_mask_expr(e.operand) or isinstance(
            e.operand, (ast.Name, ast.Attribute))
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd,
                                                      ast.BitOr)):
        return is_mask_expr(e.left) or is_mask_expr(e.right)
    return isinstance(e, ast.Attribute) and e.attr in _MASK_FIELDS


# ---------------------------------------------------------------------------
# Device-value taint (hidden-sync substrate)
# ---------------------------------------------------------------------------

_FACTORIES = frozenset({
    "empty", "zeros", "ones", "full", "arange", "tensor", "as_tensor",
    "rand", "randn", "randint", "randperm", "linspace", "eye", "empty_strided"})
# metadata of a tensor: reading it is host-side
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "layout", "requires_grad", "itemsize"})
_META_CALLS = frozenset({"numel", "size", "dim", "element_size",
                         "is_pinned", "data_ptr", "stride",
                         "is_contiguous", "nbytes", "get_device",
                         "record_stream", "len", "isinstance", "type",
                         "id", "repr", "str", "hash"})
# the fields of a DeviceBatch or a device column that hold device tensors
_DEVICE_FIELDS = frozenset({"active", "data", "validity", "chars",
                            "lengths", "hi", "lo", "starts"})
# names only a DeviceBatch uses, whatever the receiver is known to be: a
# batch's row count as a device scalar
_DEVICE_ONLY_FIELDS = frozenset({"_num_rows_dev", "row_count_lazy"})
# what runs a stage program or a kernel and returns its device outputs
_PROGRAM_CALLS = frozenset({"run_program"})
_JIT_ROUTE_TAILS = ("get", "put", "get_or_build")


def is_device_arg(e: ast.AST) -> bool:
    """A ``device=`` / ``.to(...)`` argument that names a device other
    than a literal CPU: a string such as ``"cuda"``, ``torch.device(x)``,
    or a name whose last part says device (``device``, ``dev``,
    ``b.device``)."""
    if is_cpu_literal(e):
        return False
    if isinstance(e, ast.Constant):
        return isinstance(e.value, str)
    if isinstance(e, ast.Call):
        return A.call_tail(e) == "device"
    p = A.attr_path(e)
    return p is not None and "dev" in p.rsplit(".", 1)[-1].lower()


def _annotation_is_device(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return "DeviceBatch" in text or ("Device" in text and "Column" in text)


class Taint:
    """Per-function device-value facts: ``names`` hold device tensors
    (or containers of them), ``objects`` hold DeviceBatches or device
    columns, ``programs`` are stage programs bound from a cache."""

    def __init__(self, fctx: A.FileCtx, fn: ast.AST,
                 cg: Optional[CallGraph], kernels_home: str,
                 params_on_device: bool = False):
        self.fctx = fctx
        self.cg = cg
        self.kernels_home = kernels_home.rstrip("/") + "/"
        self.names: Set[str] = set()
        self.objects: Set[str] = set()
        self.programs: Set[str] = set()
        self.sanitized: Set[str] = set()
        cls = A.enclosing_class(fn)
        if cls is not None and cls.name.startswith("Device") \
                and positional_params(fn)[:1] == ["self"]:
            self.objects.add("self")
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(args.posonlyargs) + list(args.args) \
                    + list(args.kwonlyargs):
                if _annotation_is_device(a.annotation):
                    self.objects.add(a.arg)
                elif params_on_device and a.arg not in ("self", "cls"):
                    self.names.add(a.arg)
        self._solve(fn)

    # -- expressions --------------------------------------------------------

    def is_object(self, e: ast.AST) -> bool:
        """A DeviceBatch / device column: a known name, its ``columns``
        or ``fields`` (indexed or not), or a ``Device*(...)`` value."""
        if isinstance(e, ast.Name):
            return e.id in self.objects
        if isinstance(e, ast.Subscript):
            return self.is_object(e.value)
        if isinstance(e, ast.Attribute) and e.attr in ("columns", "fields",
                                                       "child"):
            return self.is_object(e.value)
        if isinstance(e, ast.Call):
            tail = A.call_tail(e)
            return tail is not None and tail.startswith("Device") \
                and not tail.startswith("DeviceStore")
        return False

    def _device_call(self, call: ast.Call) -> bool:
        p = A.resolve_path(self.fctx, call.func)
        f = call.func
        tail = A.call_tail(call)
        if p is not None and p.startswith("torch.") \
                and not p.startswith("torch.cuda."):
            name = p.rsplit(".", 1)[-1]
            dev = kwarg(call, "device")
            if name in _FACTORIES and dev is not None \
                    and is_device_arg(dev):
                return True
            if name == "from_numpy":
                return False
            # any other torch function of a device value (including the
            # *_like factories, which inherit their input's device)
            return any(self.expr(a) for a in A.call_args(call))
        if tail in _PROGRAM_CALLS:
            return True
        if isinstance(f, ast.Name) and f.id in self.programs:
            return True
        if isinstance(f, ast.Attribute):
            if f.attr == "cuda" and not call.args:
                return True
            if f.attr == "to":
                dev = kwarg(call, "device") or (call.args[0] if call.args
                                              else None)
                if dev is not None and is_device_arg(dev):
                    return True
            if f.attr == "run" and isinstance(f.value, ast.Name) \
                    and f.value.id in self.programs:
                return True
            if f.attr in _DEVICE_ONLY_FIELDS:
                return True
            # a method of a device tensor is a device tensor (a batch's
            # or a column's methods answer host questions)
            if f.attr not in _META_CALLS and not self.is_object(f.value) \
                    and self.expr(f.value):
                return True
        if self.cg is not None:
            launchers = self.cg.launchers(self.kernels_home)
            if any(id(t.node) in launchers
                   for t in self.cg.resolve_call(self.fctx, call)):
                return True  # a kernel wrapper: its outputs are on the card
        return False

    def expr(self, e: ast.AST) -> bool:
        """Whether ``e`` evaluates to (or holds) a device value."""
        if isinstance(e, ast.Name):
            return e.id in self.names or e.id in self.objects
        if isinstance(e, ast.Attribute):
            if e.attr in _META_ATTRS:
                return False
            if e.attr in _DEVICE_ONLY_FIELDS:
                return True
            if self.is_object(e.value):
                return e.attr in _DEVICE_FIELDS
            return self.expr(e.value)
        if isinstance(e, ast.Subscript):
            return self.expr(e.value)
        if isinstance(e, ast.Call):
            if forcing_kind(self.fctx, e) is not None:
                return False  # a host value from here on
            tail = A.call_tail(e)
            if tail in _META_CALLS:
                return False
            if self._device_call(e):
                return True
            # an unknown call of a device value: best guess, its result
            # lives on the card too (a helper computing on tensors)
            if A.resolve_path(self.fctx, e.func) is None \
                    or not isinstance(e.func, ast.Attribute):
                return any(self.expr(a) for a in A.call_args(e))
            return False
        if isinstance(e, (ast.BinOp,)):
            return self.expr(e.left) or self.expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.expr(v) for v in e.values)
        if isinstance(e, ast.Compare):
            return self.expr(e.left) or any(self.expr(c)
                                             for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.expr(e.body) or self.expr(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.expr(x) for x in e.elts)
        if isinstance(e, ast.Starred):
            return self.expr(e.value)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.expr(e.elt) or any(self.expr(g.iter)
                                           for g in e.generators)
        if isinstance(e, ast.NamedExpr):
            return self.expr(e.value)
        return False

    # -- the fixed point ----------------------------------------------------

    def _bind(self, target: ast.AST, tainted: bool, obj: bool,
              host: bool) -> bool:
        changed = False
        for n in ast.walk(target):
            if not (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)):
                continue
            if host:
                if n.id not in self.sanitized:
                    self.sanitized.add(n.id)
                    self.names.discard(n.id)
                    changed = True
                continue
            if obj and n.id not in self.objects:
                self.objects.add(n.id)
                changed = True
            if tainted and n.id not in self.names \
                    and n.id not in self.sanitized:
                self.names.add(n.id)
                changed = True
        return changed

    def _program_binding(self, node: ast.Assign) -> None:
        """``prog = CACHE.get(...)`` / ``prog, miss = CACHE.get_or_build(
        ...)``: ``prog`` is a stage program."""
        v = node.value
        if not (isinstance(v, ast.Call)
                and A.call_tail(v) in _JIT_ROUTE_TAILS
                and isinstance(v.func, ast.Attribute)
                and isinstance(v.func.value, ast.Name)
                and "CACHE" in v.func.value.id.upper()):
            return
        for t in node.targets:
            name = None
            if isinstance(t, ast.Name):
                name = t.id
            elif isinstance(t, ast.Tuple) and t.elts \
                    and isinstance(t.elts[0], ast.Name):
                name = t.elts[0].id
            if name:
                self.programs.add(name)

    def _solve(self, fn: ast.AST) -> None:
        stmts = [n for n in ast.walk(fn)
                 if (isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                    ast.For, ast.AsyncFor, ast.NamedExpr,
                                    ast.comprehension, ast.withitem))
                     or _is_fill(n))
                 and _owner(n) is fn]
        for n in stmts:
            if isinstance(n, ast.Assign):
                self._program_binding(n)
        changed = True
        while changed:
            changed = False
            for n in stmts:
                if _is_fill(n):
                    # xs.append(v) / xs.extend(vs): xs holds what it got
                    recv = n.func.value
                    if any(self.expr(a) for a in n.args) \
                            and recv.id not in self.names:
                        self.names.add(recv.id)
                        changed = True
                    continue
                if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                                  ast.NamedExpr)):
                    v = n.value
                    if v is None:
                        continue
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                    host = isinstance(v, ast.Call) \
                        and forcing_kind(self.fctx, v) is not None
                elif isinstance(n, (ast.For, ast.AsyncFor,
                                    ast.comprehension)):
                    v, targets, host = n.iter, [n.target], False
                else:  # withitem
                    if n.optional_vars is None:
                        continue
                    v, targets, host = n.context_expr, [n.optional_vars], \
                        False
                if isinstance(v, (ast.Tuple, ast.List)) and len(targets) == 1 \
                        and isinstance(targets[0], (ast.Tuple, ast.List)) \
                        and len(targets[0].elts) == len(v.elts):
                    # a, b = x, y: element by element
                    for t, e in zip(targets[0].elts, v.elts):
                        changed |= self._bind(t, self.expr(e),
                                              self.is_object(e), False)
                    continue
                tainted = not host and self.expr(v)
                obj = not host and self.is_object(v)
                for t in targets:
                    if isinstance(n, (ast.Assign, ast.AnnAssign,
                                      ast.NamedExpr)) \
                            and not isinstance(t, (ast.Name, ast.Tuple,
                                                   ast.List)):
                        continue  # an attribute/subscript store
                    changed |= self._bind(t, tainted, obj, host)


def _is_fill(node: ast.AST) -> bool:
    """``name.append(...)`` / ``extend`` / ``insert`` / ``add`` on a
    plain name: the container takes on what it is filled with."""
    return isinstance(node, ast.Call) \
        and isinstance(node.func, ast.Attribute) \
        and node.func.attr in ("append", "extend", "insert", "add") \
        and isinstance(node.func.value, ast.Name)


def _owner(node: ast.AST) -> Optional[ast.AST]:
    """The def a statement belongs to, looking through lambdas and
    comprehensions (a nested def is its own unit)."""
    for a in A.ancestors(node):
        if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return a
    return None


def positional_params(fn: ast.AST) -> List[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    return [a.arg for a in list(args.posonlyargs) + list(args.args)]


def device_taint(fctx: A.FileCtx, fn: ast.AST,
                 cg: Optional[CallGraph] = None,
                 kernels_home: str = "spark_rapids_tpu_torch/kernels",
                 params_on_device: bool = False) -> Taint:
    """The device-value facts of one function (``Taint``). Parameters
    are NOT tainted (callers own that knowledge), except the ones
    annotated as a DeviceBatch or device column and a device class's
    ``self``, whose device fields are — and, with ``params_on_device``,
    every parameter (a function reached from a capture is handed the
    card's tensors)."""
    return Taint(fctx, fn, cg, kernels_home, params_on_device)
