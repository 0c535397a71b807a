"""Retry coverage (the JAX linter's family 1, over the port).

Every device allocation, upload and kernel launch in the retry scope
(exec/*, columnar/transfer.py, columnar/device.py) must run under the
OOM protocol (retry.py): the upload halves and the kernel wrappers by
name, and in the operators every torch allocator handed a ``device=``.
A site is covered lexically inside a closure handed to
``with_retry`` / ``with_split_retry`` / ``io_with_retry`` (directly or
through the module-local call graph), or in an allowlisted site whose
config entry carries a written reason.

The check is lexical + module-local-transitive on purpose: dynamic
"some caller three modules up wraps me" coverage is exactly the
hand-audit this rule replaces. Sites that are genuinely covered
non-locally are the allowlist (protocol implementation layer) or a
per-line suppression with a reason.
"""

from __future__ import annotations

import ast
from typing import Set

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint.engine import Finding, rule


def _covered_nodes(fctx: A.FileCtx, wrappers) -> Set[int]:
    """ids of function/lambda nodes whose bodies execute under a retry
    combinator: closures passed to a wrapper (positionally or by
    name), closed transitively over module-local calls — with_retry
    re-runs the whole closure, so everything it calls is in scope."""
    covered: Set[int] = set()
    covered_names: Set[str] = set()
    by_name = A.defs_by_name(fctx.tree)
    for call in A.file_calls(fctx):
        if A.call_tail(call) not in wrappers:
            continue
        for arg in A.call_args(call):
            if isinstance(arg, ast.Lambda):
                covered.add(id(arg))
            elif isinstance(arg, ast.Name):
                covered_names.add(arg.id)
    node_of = {}
    for name, nodes in by_name.items():
        for n in nodes:
            node_of[id(n)] = n
            if name in covered_names:
                covered.add(id(n))
    # transitive closure over module-local calls
    work = True
    all_funcs = [n for ns in by_name.values() for n in ns]
    lambdas = [n for n in ast.walk(fctx.tree)
               if isinstance(n, ast.Lambda)]
    while work:
        work = False
        for fn in all_funcs + lambdas:
            if id(fn) not in covered:
                continue
            for call in A.walk_calls(fn):
                t = A.call_tail(call)
                for target in by_name.get(t, ()):
                    if id(target) not in covered:
                        covered.add(id(target))
                        work = True
    return covered


def _inside_wrapper_arg(call: ast.Call, wrappers) -> bool:
    """The call expression itself sits inside an argument of a retry
    combinator call (e.g. ``with_retry(partial(finish_upload, x))``)."""
    for anc in A.ancestors(call):
        if isinstance(anc, ast.Call) and A.call_tail(anc) in wrappers:
            return True
        if isinstance(anc, ast.stmt):
            return False
    return False


def _device_alloc(fctx: A.FileCtx, call: ast.Call, cfg) -> bool:
    """A torch allocator (``torch.empty(..., device=d)`` and its kin)
    handed an explicit device: memory on the card when ``d`` is one."""
    return (any(fctx.rel.startswith(s) for s in cfg.alloc_scope)
            and A.resolve_path(fctx, call.func) in cfg.alloc_calls
            and any(kw.arg == "device" for kw in call.keywords))


@rule("retry-coverage",
      "device allocation/dispatch sites must run under "
      "with_retry/with_split_retry/io_with_retry (PR-4 protocol)")
def check_retry_coverage(pctx):
    cfg = pctx.config
    wrappers = set(cfg.retry_wrappers)
    entry = set(cfg.alloc_entrypoints)
    for fctx in pctx.files:
        if not pctx.in_scope(fctx.rel, cfg.retry_scope):
            continue
        covered = _covered_nodes(fctx, wrappers)
        for call in A.file_calls(fctx):
            tail = A.call_tail(call)
            if tail not in entry and not _device_alloc(fctx, call, cfg):
                continue
            enclosing = A.enclosing_functions(call)
            if any(id(fn) in covered for fn in enclosing):
                continue
            if _inside_wrapper_arg(call, wrappers):
                continue
            allowed = False
            for fn in enclosing:
                if isinstance(fn, ast.Lambda):
                    continue
                key = f"{fctx.rel}::{A.qualname(fn)}"
                if key in cfg.retry_allowlist:
                    allowed = True
                    break
            if allowed:
                continue
            yield Finding(
                "retry-coverage", fctx.rel, call.lineno,
                call.col_offset + 1,
                f"`{tail}` allocates/dispatches on device outside the "
                f"OOM retry protocol — wrap the site in "
                f"with_retry/with_split_retry (docs/robustness.md) or "
                f"allowlist it with a reason")
