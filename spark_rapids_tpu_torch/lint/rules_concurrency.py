"""Rule family 3 — concurrency lint over the lock-acquisition graph.

Scope: memory.py, resource.py, jit_cache.py, serve/* — the shared
mutable core PR 7's review pass hand-audited. Locks are identified by
attribute path (``DeviceStore._lock``, ``AdmissionController._cv``,
``module._NAME``); acquisition = a ``with <lock>:`` statement.

``lock-order``      — nested acquisitions define directed edges; a
                      cycle in the global graph means two code paths
                      take the same locks in opposite orders (ABBA).
                      One level of same-file interprocedural edges is
                      followed (``with A: self.m()`` where ``m``
                      acquires B).
``lock-blocking-call`` — holding a critical lock (DeviceStore /
                      semaphore / scheduler / jit-cache), flag calls
                      that can park the whole process: socket ops,
                      ``time.sleep``, device allocation/dispatch
                      entrypoints, and ``.wait()`` on a DIFFERENT
                      known lock.
``check-then-act``  — ``if k (not) in self.d: self.d[k] = ...`` on a
                      shared dict outside any ``with`` lock block, in
                      a class that owns a lock: the classic racy
                      get-or-create PR 7 fixed by hand in the server.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint.engine import Finding, rule

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "cond"}
_SOCKET_BLOCKING = {"accept", "recv", "recv_into", "connect",
                    "sendall"}


def _mod_name(fctx: A.FileCtx) -> str:
    return os.path.splitext(os.path.basename(fctx.rel))[0]


def _collect_locks(fctx: A.FileCtx) -> Dict[str, str]:
    """lock id -> kind. ``self.X = threading.Lock()`` in class C gives
    ``C.X``; module-global assignments give ``module.NAME``."""
    locks: Dict[str, str] = {}
    mod = _mod_name(fctx)
    for node in ast.walk(fctx.tree):
        if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call):
            continue
        tail = A.call_tail(node.value)
        if tail not in _LOCK_CTORS:
            continue
        for t in node.targets:
            p = A.attr_path(t)
            if p is None:
                continue
            if p.startswith("self."):
                cls = A.enclosing_class(node)
                if cls is not None:
                    locks[f"{cls.name}.{p[5:]}"] = _LOCK_CTORS[tail]
            elif "." not in p:
                locks[f"{mod}.{p}"] = _LOCK_CTORS[tail]
    return locks


def _lock_id(fctx: A.FileCtx, locks: Dict[str, str],
             expr: ast.AST) -> Optional[str]:
    """Resolve a with-context / receiver expression to a lock id."""
    p = A.attr_path(expr)
    if p is None:
        return None
    if p.startswith("self."):
        cls = A.enclosing_class(expr)
        if cls is not None:
            lid = f"{cls.name}.{p[5:]}"
            if lid in locks:
                return lid
        return None
    lid = f"{_mod_name(fctx)}.{p}"
    return lid if lid in locks else None


def _func_acquires(locks: Dict[str, str], fctx: A.FileCtx,
                   fn: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With):
            for item in node.items:
                lid = _lock_id(fctx, locks, item.context_expr)
                if lid is not None:
                    out.add(lid)
    return out


class _Graph:
    def __init__(self):
        # (from, to) -> first site (rel, line, detail)
        self.edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add(self, a: str, b: str, rel: str, line: int,
            detail: str) -> None:
        if a != b and (a, b) not in self.edges:
            self.edges[(a, b)] = (rel, line, detail)

    def cycles(self) -> List[List[str]]:
        """Minimal reporting: find 2-node cycles plus any longer cycle
        via DFS (small graphs — a handful of locks)."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_pairs = set()
        for (a, b) in self.edges:
            if (b, a) in self.edges and (b, a) not in seen_pairs:
                seen_pairs.add((a, b))
                out.append([a, b, a])
        # longer cycles
        def dfs(start, node, path, visited):
            for nxt in adj.get(node, ()):
                if nxt == start and len(path) > 2:
                    out.append(path + [start])
                    return
                if nxt not in visited and len(path) < 6:
                    dfs(start, nxt, path + [nxt], visited | {nxt})
        for start in adj:
            dfs(start, start, [start], {start})
        # dedup rotations
        uniq, keys = [], set()
        for c in out:
            k = frozenset(c)
            if k not in keys:
                keys.add(k)
                uniq.append(c)
        return uniq


def _scoped(pctx):
    for fctx in pctx.files:
        if pctx.in_scope(fctx.rel, pctx.config.concurrency_scope):
            yield fctx


@rule("lock-order",
      "inconsistent lock acquisition order (potential ABBA deadlock) "
      "across memory/resource/serve/jit_cache")
def check_lock_order(pctx):
    graph = _Graph()
    for fctx in _scoped(pctx):
        locks = _collect_locks(fctx)
        if not locks:
            continue
        by_name = A.defs_by_name(fctx.tree)
        acquires = {}
        for name, nodes in by_name.items():
            for n in nodes:
                acquires[id(n)] = (_func_acquires(locks, fctx, n), name)

        def visit(node, held: List[str]):
            if isinstance(node, ast.With):
                ids = []
                for item in node.items:
                    lid = _lock_id(fctx, locks, item.context_expr)
                    if lid is not None:
                        for h in held:
                            graph.add(h, lid, fctx.rel, node.lineno,
                                      f"with {h} held, acquires {lid}")
                        ids.append(lid)
                for child in node.body:
                    visit(child, held + ids)
                return
            if isinstance(node, ast.Call) and held:
                tail = A.call_tail(node)
                for target in by_name.get(tail, ()):
                    # self.m() / module fn(): one interprocedural level
                    inner, _nm = acquires[id(target)]
                    for lid in inner:
                        for h in held:
                            graph.add(h, lid, fctx.rel, node.lineno,
                                      f"call {tail}() acquires {lid} "
                                      f"while holding {h}")
            for child in ast.iter_child_nodes(node):
                # don't descend into nested defs with the held set —
                # their bodies run later, not under this lock
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    visit(child, [])
                else:
                    visit(child, held)

        visit(fctx.tree, [])
    for cyc in graph.cycles():
        edges = list(zip(cyc, cyc[1:]))
        site = graph.edges.get(edges[0])
        rel, line = (site[0], site[1]) if site else ("", 1)
        order = " -> ".join(cyc)
        yield Finding(
            "lock-order", rel or pctx.config.scan_roots[0], line, 1,
            f"inconsistent lock order: {order} — two paths acquire "
            f"these locks in opposite orders (ABBA deadlock window)")


@rule("lock-blocking-call",
      "blocking call while holding a DeviceStore/scheduler-critical "
      "lock stalls every task in the process")
def check_blocking(pctx):
    cfg = pctx.config
    critical = set(cfg.critical_locks)
    entry = set(cfg.alloc_entrypoints)
    for fctx in _scoped(pctx):
        locks = _collect_locks(fctx)
        if not locks:
            continue

        def visit(node, held: List[str]):
            if isinstance(node, ast.With):
                ids = [lid for item in node.items
                       if (lid := _lock_id(fctx, locks,
                                           item.context_expr))
                       is not None]
                for child in node.body:
                    visit(child, held + ids)
                return
            crit = [h for h in held if h in critical]
            if isinstance(node, ast.Call) and crit:
                tail = A.call_tail(node)
                path = A.resolve_path(fctx, node.func)
                bad = None
                if path == "time.sleep":
                    bad = "time.sleep"
                elif tail in _SOCKET_BLOCKING:
                    bad = f"socket .{tail}()"
                elif tail in entry:
                    bad = f"device dispatch `{tail}`"
                elif tail == "wait" and isinstance(node.func,
                                                  ast.Attribute):
                    rid = _lock_id(fctx, locks, node.func.value)
                    if rid is not None and rid not in held:
                        bad = f"wait on a different lock ({rid})"
                if bad is not None:
                    yield_findings.append(Finding(
                        "lock-blocking-call", fctx.rel, node.lineno,
                        node.col_offset + 1,
                        f"{bad} while holding {', '.join(crit)} — "
                        f"move the blocking work outside the lock "
                        f"(the jit_cache get_or_build pattern)"))
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    visit(child, [])
                else:
                    visit(child, held)

        yield_findings: List[Finding] = []
        visit(fctx.tree, [])
        for f in yield_findings:
            yield f


def _dict_attrs(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            val = node.value
            is_dict = isinstance(val, ast.Dict) or (
                isinstance(val, ast.Call)
                and A.call_tail(val) in ("dict", "OrderedDict",
                                         "defaultdict"))
            if not is_dict:
                continue
            for t in node.targets:
                p = A.attr_path(t)
                if p is not None and p.startswith("self."):
                    out.add(p[5:])
    return out


def _mentions_attr(expr: ast.AST, attrs: Set[str]) -> Optional[str]:
    for n in ast.walk(expr):
        p = A.attr_path(n)
        if p is not None and p.startswith("self.") and p[5:] in attrs:
            return p[5:]
    return None


@rule("check-then-act",
      "racy get-or-create on a shared dict outside the owning lock")
def check_then_act(pctx):
    for fctx in _scoped(pctx):
        locks = _collect_locks(fctx)
        for cls in [n for n in ast.walk(fctx.tree)
                    if isinstance(n, ast.ClassDef)]:
            cls_locks = {lid for lid in locks
                         if lid.startswith(cls.name + ".")}
            if not cls_locks:
                continue
            dicts = _dict_attrs(cls)
            if not dicts:
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.If):
                    continue
                # test must be a membership check on a shared dict
                tested = None
                for cmp in ast.walk(node.test):
                    if isinstance(cmp, ast.Compare) and any(
                            isinstance(op, (ast.In, ast.NotIn))
                            for op in cmp.ops):
                        tested = _mentions_attr(cmp, dicts)
                if tested is None:
                    continue
                # body (or else) must write the same dict
                writes = False
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.Assign, ast.AugAssign)):
                        tg = sub.targets if isinstance(
                            sub, ast.Assign) else [sub.target]
                        for t in tg:
                            if isinstance(t, ast.Subscript) and \
                                    _mentions_attr(t.value,
                                                   {tested}):
                                writes = True
                if not writes:
                    continue
                # any enclosing with on a class lock?
                guarded = False
                for anc in A.ancestors(node):
                    if isinstance(anc, ast.With):
                        for item in anc.items:
                            if _lock_id(fctx, locks,
                                        item.context_expr) is not None:
                                guarded = True
                if guarded:
                    continue
                yield Finding(
                    "check-then-act", fctx.rel, node.lineno,
                    node.col_offset + 1,
                    f"check-then-act on shared dict `self.{tested}` "
                    f"outside a lock — two threads can both miss and "
                    f"both insert; hold the owning lock (or use "
                    f"setdefault under it)")
