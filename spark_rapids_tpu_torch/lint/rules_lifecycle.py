"""Rule family 5 — cancellation discipline over the serving tier's
blocking waits (docs/serving.md "Query lifecycle").

``cancel-checkpoint``: in the lifecycle-critical scope (serve/,
retry.py, jit_cache.py — the modules whose waits the query lifecycle
layer audited by hand), a blocking wait must either pass a BOUNDED
timeout (so the enclosing loop can re-check its CancelToken) or go
through a CancelToken-aware lifecycle helper
(``lifecycle.cancellable_sleep`` / ``lifecycle.cancellable_wait`` —
which are, by construction, not the flagged raw primitives). Flagged
primitives:

- ``<cond-or-event>.wait()`` with no timeout (positional or keyword)
  — an unbounded park no cancel can reach;
- direct ``time.sleep(...)`` — even a bounded backoff sleep ignores
  the token; the lifecycle helper slices and re-checks;
- blocking queue gets with no ``timeout=``: zero-argument ``.get()``
  and explicit ``.get(block=True)`` (``dict.get()`` always takes a
  key and has no ``block`` kwarg, so neither form is a dict lookup;
  ``block=False`` is non-blocking and exempt). The positional form
  ``q.get(True)`` is indistinguishable from ``d.get(True)`` at the
  AST and is out of the rule's reach — spell the kwarg.

This is the machine gate behind the lifecycle tentpole: a NEW wait
site added to the serving tier cannot silently become uncancellable.
"""

from __future__ import annotations

import ast

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint.engine import Finding, rule


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _bounded_wait(call: ast.Call) -> bool:
    """A ``.wait`` call is bounded when it passes a non-None timeout
    positionally or by keyword."""
    for a in call.args:
        if not _is_none(a):
            return True
    for kw in call.keywords:
        if kw.arg == "timeout" and not _is_none(kw.value):
            return True
    return False


@rule("cancel-checkpoint",
      "blocking waits in the lifecycle-critical scope must pass a "
      "bounded timeout or use a CancelToken-aware lifecycle helper")
def check_cancel_checkpoints(pctx):
    cfg = pctx.config
    for fctx in pctx.files:
        if not pctx.in_scope(fctx.rel, cfg.cancel_scope):
            continue
        for node in ast.walk(fctx.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = A.call_tail(node)
            path = A.resolve_path(fctx, node.func)
            if path == "time.sleep":
                yield Finding(
                    "cancel-checkpoint", fctx.rel, node.lineno,
                    node.col_offset + 1,
                    "direct time.sleep in the lifecycle-critical "
                    "scope — a cancelled/timed-out query sleeps "
                    "through its deadline; use "
                    "lifecycle.cancellable_sleep (docs/serving.md "
                    "'Query lifecycle')")
            elif tail == "wait" and isinstance(node.func,
                                              ast.Attribute):
                if not _bounded_wait(node):
                    yield Finding(
                        "cancel-checkpoint", fctx.rel, node.lineno,
                        node.col_offset + 1,
                        "unbounded .wait() in the lifecycle-critical "
                        "scope — no cancellation can reach a parked "
                        "thread; pass a bounded timeout and re-check "
                        "the CancelToken in the loop, or use "
                        "lifecycle.cancellable_wait")
            elif tail == "get" and isinstance(node.func,
                                              ast.Attribute):
                has_timeout = any(
                    kw.arg == "timeout" and not _is_none(kw.value)
                    for kw in node.keywords)
                block_true = any(
                    kw.arg == "block"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                block_false = any(
                    kw.arg == "block"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is False
                    for kw in node.keywords)
                blocking_queue_get = (not node.args
                                      and not block_false) or block_true
                if blocking_queue_get and not has_timeout:
                    yield Finding(
                        "cancel-checkpoint", fctx.rel, node.lineno,
                        node.col_offset + 1,
                        "blocking queue .get() without timeout= parks "
                        "forever in the lifecycle-critical scope — "
                        "pass timeout= and checkpoint on Empty "
                        "(docs/serving.md 'Query lifecycle')")
