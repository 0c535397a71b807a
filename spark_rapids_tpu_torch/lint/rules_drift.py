"""Drift rules (the JAX linter's family 4, over the port's tables;
docs/torch/observability.md).

``metric-key``  — every literal (or metrics-constant) key passed to
                  ``create`` / ``timed`` / ``timed_wall`` must resolve
                  via ``describe_metric`` (exact entry or registered
                  prefix family), and every metric-name constant in
                  metrics.py must be described. Dynamic f-string keys
                  are invisible to the AST — the one remaining runtime
                  smoke in tests/test_profile.py guards those.
``conf-key``    — every whole-string ``spark.rapids.*`` literal in the
                  package must be a registered conf.py key (registered
                  through ``conf_registrar``, conf.py's ``_entry``; prefix
                  literals ending in '.' are exempt — they are
                  namespace matches, not keys).
``span-scope``  — every ``trace.span(...)`` open must be the context
                  expression of a ``with`` (an unclosed span corrupts
                  the B/E nesting of the whole lane).
``span-kind``   — every LITERAL span/instant kind recorded in the
                  package (``trace.span``/``trace.instant`` calls, and
                  the ``qt.add``/``qt.mark`` convention over the
                  active trace) must appear in trace.py's
                  ``SPAN_CATALOG``/``INSTANT_CATALOG``, so flight-
                  recorder dumps and trace files can never carry a
                  vocabulary the documentation doesn't (metric-mirror
                  spans are dynamic ``<Exec>.<metric>`` names and are
                  covered by ``metric-key`` instead).
``prom-family`` — every Prometheus family name the telemetry endpoint
                  emits (telemetry/prometheus.py ``_emit_server``
                  sites) must be a key of ``SERVER_FAMILY_HELP`` (the
                  table the observability doc renders) and match the
                  ``srt_[a-z0-9_]+`` naming rule; engine-metric
                  families are derived from registry keys, whose
                  describe_metric coverage the renderer enforces at
                  runtime (srt_undescribed_metric_keys must be 0).
``tuning-action`` — every action the TuningController constructs
                  (literal first argument of a ``_new_action`` call in
                  telemetry/tuning.py) must be an ``ACTION_CATALOG``
                  key, and every ``spark.rapids.*`` knob declared in
                  the catalog must be a registered conf key — the
                  self-tuning loop can only ever actuate the declared,
                  documented vocabulary (docs/tuning.md renders from
                  the same dict).
``docs-drift``  — docs/torch/configs.md, supported_ops.md,
                  observability.md and tuning.md must match `tools docs`
                  regeneration byte for byte.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch.lint import astutil as A
from spark_rapids_tpu_torch.lint.engine import Finding, rule

_METRIC_SINKS = {"create", "timed", "timed_wall"}
# where `tools docs` writes the port's generated docs
DOCS_DIR = "docs/torch"
_CONF_KEY_RE = re.compile(r"^spark\.rapids\.[A-Za-z0-9_.]*[A-Za-z0-9_]$")


# -- metrics table (parsed from metrics.py, no import) ---------------------

def _module_str_constants(fctx: A.FileCtx) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for stmt in fctx.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Constant) and isinstance(
                stmt.value.value, str):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value.value
    return out


def _dict_keys(fctx: A.FileCtx, name: str,
               consts: Dict[str, str]) -> Optional[Set[str]]:
    for stmt in fctx.tree.body:
        if isinstance(stmt, ast.Assign) or isinstance(stmt,
                                                      ast.AnnAssign):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if not any(isinstance(t, ast.Name) and t.id == name
                       for t in targets):
                continue
            value = stmt.value
            if not isinstance(value, ast.Dict):
                return None
            keys: Set[str] = set()
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    keys.add(k.value)
                elif isinstance(k, ast.Name) and k.id in consts:
                    keys.add(consts[k.id])
            return keys
    return None


class _MetricTable:
    def __init__(self, pctx):
        cfg = pctx.config
        fctx = pctx.file(cfg.metrics_rel)
        self.ok = fctx is not None
        if not self.ok:
            return
        self.consts = _module_str_constants(fctx)
        self.exact = _dict_keys(fctx, "METRIC_DESCRIPTIONS",
                                self.consts) or set()
        self.prefixes = _dict_keys(fctx, "METRIC_PREFIX_DESCRIPTIONS",
                                   self.consts) or set()
        self.metrics_rel = cfg.metrics_rel
        self.metrics_mod = os.path.splitext(
            cfg.metrics_rel.replace("/", "."))[0]

    def describes(self, key: str) -> bool:
        return key in self.exact or any(key.startswith(p)
                                        for p in self.prefixes)

    def resolve_arg(self, fctx: A.FileCtx,
                    arg: ast.AST) -> Optional[str]:
        """Literal, metrics-module attribute (M.OP_TIME) or imported
        constant -> the key string; None when dynamic."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        if isinstance(arg, ast.Attribute) and isinstance(arg.value,
                                                         ast.Name):
            base = fctx.imports.get(arg.value.id, arg.value.id)
            if base == self.metrics_mod and arg.attr in self.consts:
                return self.consts[arg.attr]
        if isinstance(arg, ast.Name):
            target = fctx.imports.get(arg.id)
            if target and target.startswith(self.metrics_mod + "."):
                cname = target[len(self.metrics_mod) + 1:]
                return self.consts.get(cname)
        return None


@rule("metric-key",
      "metric keys must resolve via metrics.describe_metric (exact "
      "entry or prefix family)")
def check_metric_keys(pctx):
    table = _MetricTable(pctx)
    if not table.ok:
        return
    mfctx = pctx.file(table.metrics_rel)
    # direction 1: every metric-name constant in metrics.py described
    for stmt in mfctx.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
                stmt.value, ast.Constant) and isinstance(
                stmt.value.value, str):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id.isupper() \
                        and not t.id.startswith("_") \
                        and not table.describes(stmt.value.value):
                    yield Finding(
                        "metric-key", mfctx.rel, stmt.lineno, 1,
                        f"metric constant {t.id} = "
                        f"{stmt.value.value!r} has no entry in "
                        f"METRIC_DESCRIPTIONS")
    # direction 2: every statically-resolvable key at a sink call site
    for fctx in pctx.files:
        if fctx.rel == table.metrics_rel:
            continue
        for call in A.file_calls(fctx):
            if A.call_tail(call) not in _METRIC_SINKS or not call.args:
                continue
            if not isinstance(call.func, ast.Attribute):
                continue
            key = table.resolve_arg(fctx, call.args[0])
            if key is None or table.describes(key):
                continue
            yield Finding(
                "metric-key", fctx.rel, call.lineno,
                call.col_offset + 1,
                f"metric key {key!r} does not resolve via "
                f"describe_metric — add it to METRIC_DESCRIPTIONS (or "
                f"a prefix family) in metrics.py")


@rule("conf-key",
      "spark.rapids.* string literals must be registered conf.py keys")
def check_conf_keys(pctx):
    registered: Set[str] = set()
    reg_nodes: Set[int] = set()
    for fctx in pctx.files:
        for call in A.file_calls(fctx):
            if A.call_tail(call) == pctx.config.conf_registrar \
                    and len(call.args) >= 1 \
                    and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str) \
                    and call.args[0].value.startswith("spark.rapids."):
                registered.add(call.args[0].value)
                reg_nodes.add(id(call.args[0]))
    if not registered:
        return  # no registry in this tree (fixture runs)
    for fctx in pctx.files:
        for node in ast.walk(fctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            if id(node) in reg_nodes:
                continue
            if not _CONF_KEY_RE.match(node.value):
                continue
            # skip docstrings and f-string fragments
            par = A.parent(node)
            if isinstance(par, ast.Expr) or isinstance(par,
                                                       ast.JoinedStr):
                continue
            if node.value not in registered:
                yield Finding(
                    "conf-key", fctx.rel, node.lineno,
                    node.col_offset + 1,
                    f"conf key literal {node.value!r} is not a "
                    f"registered conf.py entry — register it (or fix "
                    f"the typo); docs/configs.md is generated from "
                    f"the registry")


@rule("span-scope",
      "Tracer span opens must be with-scoped (unclosed spans corrupt "
      "the lane's B/E nesting)")
def check_span_scope(pctx):
    cfg = pctx.config
    trace_mod = os.path.splitext(cfg.trace_rel.replace("/", "."))[0]
    for fctx in pctx.files:
        if fctx.rel == cfg.trace_rel:
            continue
        for call in A.file_calls(fctx):
            if A.call_tail(call) != "span":
                continue
            if not isinstance(call.func, ast.Attribute):
                continue
            base = A.resolve_path(fctx, call.func.value)
            if base != trace_mod:
                continue
            par = A.parent(call)
            if isinstance(par, ast.withitem):
                continue
            yield Finding(
                "span-scope", fctx.rel, call.lineno,
                call.col_offset + 1,
                "trace span opened outside a `with` — every span must "
                "be with-scoped so its B/E pair always closes")


@rule("span-kind",
      "literal span/instant kinds must come from trace.py's "
      "SPAN_CATALOG / INSTANT_CATALOG (docs/observability.md)")
def check_span_kinds(pctx):
    cfg = pctx.config
    trace_mod = os.path.splitext(cfg.trace_rel.replace("/", "."))[0]
    tfctx = pctx.file(cfg.trace_rel)
    if tfctx is None:
        return
    consts = _module_str_constants(tfctx)
    span_kinds = _dict_keys(tfctx, "SPAN_CATALOG", consts)
    instant_kinds = _dict_keys(tfctx, "INSTANT_CATALOG", consts)
    if span_kinds is None or instant_kinds is None:
        return  # no catalogs in this tree (fixture runs)

    def _literal(call) -> Optional[str]:
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            return call.args[0].value
        return None

    for fctx in pctx.files:
        if fctx.rel == cfg.trace_rel:
            continue
        for call in A.file_calls(fctx):
            tail = A.call_tail(call)
            if tail in ("span", "instant"):
                if not isinstance(call.func, ast.Attribute) or \
                        A.resolve_path(fctx, call.func.value) != trace_mod:
                    continue
                catalog = span_kinds if tail == "span" else instant_kinds
            elif tail in ("add", "mark"):
                # the package convention: `qt = trace._ACTIVE` (or the
                # metrics-module mirror) — literal kinds recorded
                # through it are catalog members too
                f = call.func
                if not (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "qt"):
                    continue
                catalog = span_kinds if tail == "add" else instant_kinds
            else:
                continue
            kind = _literal(call)
            if kind is None or kind in catalog:
                continue
            which = ("SPAN_CATALOG" if catalog is span_kinds
                     else "INSTANT_CATALOG")
            yield Finding(
                "span-kind", fctx.rel, call.lineno,
                call.col_offset + 1,
                f"span kind {kind!r} is not in trace.py {which} — "
                f"add it (with a description) so dumps can't carry "
                f"undocumented vocabulary")


@rule("prom-family",
      "Prometheus families emitted by the telemetry endpoint must be "
      "SERVER_FAMILY_HELP entries named srt_[a-z0-9_]+")
def check_prom_families(pctx):
    cfg = pctx.config
    pfctx = pctx.file(cfg.prometheus_rel)
    if pfctx is None:
        return
    consts = _module_str_constants(pfctx)
    families = _dict_keys(pfctx, "SERVER_FAMILY_HELP", consts)
    if families is None:
        return
    name_re = re.compile(r"^srt_[a-z0-9_]+$")
    for name in sorted(families):
        if not name_re.match(name):
            yield Finding(
                "prom-family", pfctx.rel, 1, 1,
                f"family {name!r} violates the srt_[a-z0-9_]+ naming "
                f"rule")
    for call in A.walk_calls(pfctx.tree):
        if A.call_tail(call) != "_emit_server" or len(call.args) < 2:
            continue
        arg = call.args[1]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            yield Finding(
                "prom-family", pfctx.rel, call.lineno,
                call.col_offset + 1,
                "emitted family name must be a string literal (the "
                "SERVER_FAMILY_HELP table and the generated doc "
                "cannot cover a dynamic name)")
            continue
        if arg.value not in families:
            yield Finding(
                "prom-family", pfctx.rel, call.lineno,
                call.col_offset + 1,
                f"family {arg.value!r} has no SERVER_FAMILY_HELP "
                f"entry — add it (type + help) so the endpoint and "
                f"docs/observability.md stay in lockstep")


@rule("history-field",
      "query-history record fields must be HISTORY_FIELD_CATALOG "
      "entries (docs/observability.md 'Query history')")
def check_history_fields(pctx):
    cfg = pctx.config
    hfctx = pctx.file(cfg.history_rel)
    if hfctx is None:
        return
    consts = _module_str_constants(hfctx)
    catalog = _dict_keys(hfctx, "HISTORY_FIELD_CATALOG", consts)
    if catalog is None:
        return  # no catalog in this tree (fixture runs)
    name_re = re.compile(r"^[a-z][A-Za-z0-9]*$")
    for name in sorted(catalog):
        if not name_re.match(name):
            yield Finding(
                "history-field", hfctx.rel, 1, 1,
                f"history field {name!r} violates the camelCase "
                f"naming rule")

    def _check_key(node: ast.AST, lineno: int, col: int):
        if isinstance(node, ast.Constant) and isinstance(node.value,
                                                         str) \
                and node.value not in catalog:
            yield Finding(
                "history-field", hfctx.rel, lineno, col + 1,
                f"record field {node.value!r} has no "
                f"HISTORY_FIELD_CATALOG entry — add it (with a "
                f"description) so the on-disk schema and the "
                f"generated doc stay in lockstep")

    # record construction convention: the dict literal assigned to a
    # name `rec`, and every literal subscript store `rec["k"] = ...`
    for node in ast.walk(hfctx.tree):
        if isinstance(node, ast.AnnAssign):
            targets = [node.target]
            value = node.value
        elif isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        else:
            continue
        if isinstance(value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "rec"
                for t in targets):
            for k in value.keys:
                if k is not None:
                    yield from _check_key(k, k.lineno, k.col_offset)
        for t in targets:
            if isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name) and t.value.id == "rec":
                yield from _check_key(t.slice, t.lineno, t.col_offset)


def _action_catalog(fctx: A.FileCtx):
    """Parse ``ACTION_CATALOG`` from the tuning module's AST: the set
    of action names, and the knob strings each declares (the ``knob``
    value plus every ``knobs`` list member). Returns (names, knobs,
    lineno) or None when the module has no parseable catalog."""
    for stmt in fctx.tree.body:
        if isinstance(stmt, ast.AnnAssign):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Assign):
            targets = stmt.targets
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "ACTION_CATALOG"
                   for t in targets):
            continue
        value = stmt.value
        if not isinstance(value, ast.Dict):
            return None
        names: Set[str] = set()
        knobs: List[Tuple[str, int]] = []
        for k, v in zip(value.keys, value.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                names.add(k.value)
            if not isinstance(v, ast.Dict):
                continue
            for fk, fv in zip(v.keys, v.values):
                if not (isinstance(fk, ast.Constant)
                        and fk.value in ("knob", "knobs")):
                    continue
                elts = fv.elts if isinstance(fv, (ast.List,
                                                  ast.Tuple)) else [fv]
                for e in elts:
                    if isinstance(e, ast.Constant) and isinstance(
                            e.value, str):
                        knobs.append((e.value, e.lineno))
        return names, knobs, stmt.lineno
    return None


@rule("tuning-action",
      "TuningController actions must be ACTION_CATALOG entries and "
      "catalog conf knobs must be registered conf keys")
def check_tuning_actions(pctx):
    cfg = pctx.config
    tfctx = pctx.file(cfg.tuning_rel)
    if tfctx is None:
        return
    parsed = _action_catalog(tfctx)
    if parsed is None:
        return  # no catalog in this tree (fixture runs)
    names, knobs, cat_lineno = parsed
    # 1. every spark.rapids.* knob the catalog declares must be a
    # registered conf key (same registry walk as conf-key)
    registered: Set[str] = set()
    for fctx in pctx.files:
        for call in A.file_calls(fctx):
            if A.call_tail(call) == pctx.config.conf_registrar \
                    and len(call.args) >= 1 \
                    and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str) \
                    and call.args[0].value.startswith("spark.rapids."):
                registered.add(call.args[0].value)
    if registered:
        for knob, lineno in knobs:
            if knob.startswith("spark.rapids.") \
                    and knob not in registered:
                yield Finding(
                    "tuning-action", tfctx.rel, lineno, 1,
                    f"ACTION_CATALOG knob {knob!r} is not a "
                    f"registered conf.py key — the controller would "
                    f"actuate a conf nothing reads")
    # 2. every action the controller constructs resolves in the
    # catalog, and only through a literal name the table can cover
    for call in A.walk_calls(tfctx.tree):
        if A.call_tail(call) != "_new_action" or not call.args:
            continue
        arg = call.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            yield Finding(
                "tuning-action", tfctx.rel, call.lineno,
                call.col_offset + 1,
                "action name must be a string literal (the "
                "ACTION_CATALOG table and docs/tuning.md cannot cover "
                "a dynamic name)")
            continue
        if arg.value not in names:
            yield Finding(
                "tuning-action", tfctx.rel, call.lineno,
                call.col_offset + 1,
                f"action {arg.value!r} has no ACTION_CATALOG entry "
                f"(declared at line {cat_lineno}) — add it (verdict, "
                f"knob, bounds, doc) so code, lint and docs/tuning.md "
                f"share one vocabulary")


@rule("docs-drift",
      "generated docs must match `tools docs` regeneration")
def check_docs_drift(pctx):
    cfg = pctx.config
    if not cfg.check_docs:
        return
    # the generators come from the INSTALLED package on sys.path; for a
    # foreign --root tree they would describe the wrong code, so the
    # rule only runs on the tree the interpreter is actually importing
    from spark_rapids_tpu_torch.lint.engine import default_root
    if os.path.realpath(pctx.root) != os.path.realpath(default_root()):
        return
    docs_dir = os.path.join(pctx.root, DOCS_DIR)
    if not os.path.isdir(docs_dir):
        return
    # the one rule that imports the runtime: the generators ARE the
    # source of truth the docs must match (same order as `tools docs`)
    from spark_rapids_tpu_torch.tools import doc_generators
    for fname, gen in doc_generators():
        path = os.path.join(docs_dir, fname)
        rel = f"{DOCS_DIR}/{fname}"
        if not os.path.exists(path):
            yield Finding(
                "docs-drift", rel, 1, 1,
                f"{rel} is missing — generate it with "
                f"`python -m spark_rapids_tpu_torch.tools docs`")
            continue
        with open(path, "r", encoding="utf-8") as f:
            on_disk = f.read()
        if on_disk != gen():
            yield Finding(
                "docs-drift", rel, 1, 1,
                f"{rel} is stale — regenerate with "
                f"`python -m spark_rapids_tpu_torch.tools docs`")
