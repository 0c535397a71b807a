"""Shared AST plumbing for tpu-lint (stdlib only).

One parse per file, parent pointers threaded through the tree, import
alias resolution, and the suppression-comment scanner. Rule modules
build on these so every rule sees the same view of a file.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterator, List, Optional, Tuple

_PARENT = "_tpulint_parent"

# suppression grammar (docs/linting.md): a comment containing
#   tpu-lint: disable=rule-a(reason text),rule-b(other reason)
# suppresses the named rules on that physical line; a standalone
# comment line suppresses the NEXT line (for statements too long to
# carry the reason inline). The reason is MANDATORY — a bare
# `disable=rule` is itself reported (bad-suppression) — and may not
# contain parentheses. Parsing is ANCHORED: items must be a strict
# comma-separated list, so prose after the list (or parens inside a
# reason) fails the whole comment cleanly instead of registering
# fragments of it as bogus rules.
SUPPRESS_RE = re.compile(r"tpu-lint:\s*disable=(?P<items>.*)")
ITEM_RE = re.compile(r"([A-Za-z][A-Za-z0-9_-]*)\s*(?:\(([^()]*)\))?\s*")


class FileCtx:
    """One parsed source file: tree with parent links, import alias
    map, and parsed suppressions."""

    def __init__(self, root: str, rel: str):
        self.root = root
        self.rel = rel.replace(os.sep, "/")
        self.path = os.path.join(root, rel)
        with open(self.path, "r", encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.rel)
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                setattr(child, _PARENT, node)
        # alias -> full dotted target ("jnp" -> "jax.numpy",
        # "R" -> "spark_rapids_tpu.retry",
        # "JitCache" -> "spark_rapids_tpu.jit_cache.JitCache")
        self.imports: Dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    self.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        # line -> [(rule, reason)] and invalid-suppression records
        self.suppressions: Dict[int, List[Tuple[str, str]]] = {}
        self.bad_suppressions: List[Tuple[int, str]] = []
        self._scan_suppressions()

    # -- suppressions ------------------------------------------------------

    def _scan_suppressions(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.source).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = SUPPRESS_RE.search(tok.string)
            if m is None:
                continue
            line = tok.start[0]
            # a comment-only line applies to the next source line
            standalone = tok.line[:tok.start[1]].strip() == ""
            target = line + 1 if standalone else line
            items = m.group("items").strip()
            if not items:
                self.bad_suppressions.append(
                    (line, "empty tpu-lint disable list"))
                continue
            parsed, bad = self._parse_items(items)
            if bad is not None:
                self.bad_suppressions.append((line, bad))
                continue  # malformed list: suppress NOTHING
            for name, reason in parsed:
                if reason is None or not reason.strip():
                    self.bad_suppressions.append(
                        (line, f"suppression of `{name}` carries no "
                               f"reason — write disable={name}(why)"))
                    continue
                self.suppressions.setdefault(target, []).append(
                    (name, reason.strip()))

    @staticmethod
    def _parse_items(items: str):
        """Anchored parse of `rule(reason),rule(reason)`; returns
        (parsed, error). Any trailing prose or parens inside a reason
        is an error for the WHOLE comment — fragments of free text
        must never register as rules."""
        parsed = []
        pos = 0
        while pos < len(items):
            m = ITEM_RE.match(items, pos)
            if m is None or m.end() == pos:
                return [], (f"malformed tpu-lint disable list at "
                            f"{items[pos:][:40]!r} — expected "
                            f"rule-name(reason)[, ...]; reasons may "
                            f"not contain parentheses")
            parsed.append((m.group(1), m.group(2)))
            pos = m.end()
            if pos < len(items):
                if items[pos] != ",":
                    return [], (f"unexpected text after suppression "
                                f"list: {items[pos:][:40]!r}")
                pos += 1
                while pos < len(items) and items[pos].isspace():
                    pos += 1
        return parsed, None

    def suppressed(self, rule: str, line: int) -> bool:
        return any(r == rule for r, _ in self.suppressions.get(line, []))

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


# -- tree helpers ----------------------------------------------------------

def parent(node: ast.AST) -> Optional[ast.AST]:
    return getattr(node, _PARENT, None)


def ancestors(node: ast.AST) -> Iterator[ast.AST]:
    cur = parent(node)
    while cur is not None:
        yield cur
        cur = parent(cur)


def enclosing_functions(node: ast.AST) -> List[ast.AST]:
    """Enclosing FunctionDef/AsyncFunctionDef/Lambda nodes,
    innermost first."""
    return [a for a in ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))]


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    for a in ancestors(node):
        if isinstance(a, ast.ClassDef):
            return a
    return None


def qualname(node: ast.AST) -> str:
    """Dotted name of a def node within its module
    (``Class.method`` / ``outer.inner``); lambdas render as
    ``<lambda>``."""
    parts: List[str] = []
    for n in [node] + list(ancestors(node)):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            parts.append(n.name)
        elif isinstance(n, ast.Lambda):
            parts.append("<lambda>")
        elif isinstance(n, ast.ClassDef):
            parts.append(n.name)
    return ".".join(reversed(parts))


def attr_path(expr: ast.AST) -> Optional[str]:
    """Dotted path of a Name/Attribute chain ("self._lock",
    "R.with_retry"); None for anything more dynamic."""
    parts: List[str] = []
    cur = expr
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name):
        return None
    parts.append(cur.id)
    return ".".join(reversed(parts))


def call_tail(call: ast.Call) -> Optional[str]:
    """Final name of the called expression (`R.with_retry(...)` ->
    "with_retry", `foo(...)` -> "foo")."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def resolve_path(fctx: FileCtx, expr: ast.AST) -> Optional[str]:
    """attr_path with the leading alias resolved through the file's
    imports: ``jnp.stack`` -> ``jax.numpy.stack``."""
    p = attr_path(expr)
    if p is None:
        return None
    head, _, rest = p.partition(".")
    base = fctx.imports.get(head, head)
    return f"{base}.{rest}" if rest else base


def call_args(call: ast.Call) -> List[ast.AST]:
    return list(call.args) + [kw.value for kw in call.keywords]


def walk_calls(node: ast.AST) -> Iterator[ast.Call]:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            yield n


def file_calls(fctx: "FileCtx") -> List[ast.Call]:
    """Every Call node in the file, in ``ast.walk`` order, computed
    once per file: ~a dozen rules iterate the whole tree's calls, and
    re-walking 100+ trees per rule dominated the engine wall."""
    cached = getattr(fctx, "_file_calls", None)
    if cached is None:
        cached = fctx._file_calls = list(walk_calls(fctx.tree))
    return cached


def defs_by_name(tree: ast.AST) -> Dict[str, List[ast.AST]]:
    out: Dict[str, List[ast.AST]] = {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(n.name, []).append(n)
    return out


def module_rel(dotted: str) -> str:
    """Dotted module name -> repo-relative path candidate
    (``spark_rapids_tpu.ops.exprs`` -> ``spark_rapids_tpu/ops/exprs.py``)."""
    return dotted.replace(".", "/") + ".py"
