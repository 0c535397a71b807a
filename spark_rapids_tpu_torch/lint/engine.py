"""The port's lint engine (the JAX linter's, over the port's tree): file
collection, rule registry, suppression and baseline semantics,
JSON/human/GitHub rendering, CLI entry.

Exit-code contract (wired into `tools lint` and tier-1):
  0 — clean (no unsuppressed, unbaselined findings)
  1 — findings
  2 — internal error (a rule crashed, or the engine itself did)
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import time
import traceback
from typing import Callable, Dict, Iterable, List, Optional, Set

from spark_rapids_tpu_torch.lint.astutil import FileCtx
from spark_rapids_tpu_torch.lint.config import LintConfig, load_config

JSON_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    col: int
    message: str

    def fingerprint(self, line_text: str) -> str:
        # line-TEXT based (not line-number based) so unrelated edits
        # above a baselined finding don't churn the baseline file
        h = hashlib.sha256(
            f"{self.rule}|{self.path}|{line_text or self.message}"
            .encode("utf-8"))
        return h.hexdigest()[:16]


@dataclasses.dataclass
class Rule:
    name: str
    doc: str
    func: Callable


RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str):
    """Register a rule. The function receives the PackageContext and
    yields Findings."""
    def deco(func):
        RULES[name] = Rule(name, doc, func)
        return func
    return deco


class PackageContext:
    """Everything a rule needs: every scanned file parsed once, plus
    the config and root."""

    def __init__(self, root: str, config: LintConfig,
                 files: List[FileCtx]):
        self.root = root
        self.config = config
        self.files = files
        self.by_rel: Dict[str, FileCtx] = {f.rel: f for f in files}

    def file(self, rel: str) -> Optional[FileCtx]:
        return self.by_rel.get(rel)

    def in_scope(self, rel: str, scope: Iterable[str]) -> bool:
        return any(rel == s or (s.endswith("/") and rel.startswith(s))
                   for s in scope)


@dataclasses.dataclass
class LintResult:
    root: str
    findings: List[Finding]            # active (reported)
    suppressed: int
    baselined: int
    files: int
    internal_errors: List[str]
    pctx: Optional["PackageContext"] = None
    # findings matched by the baseline file (not reported, but
    # --fix-baseline must re-capture them or accepted debt would be
    # silently dropped from the rewritten file)
    baselined_findings: List[Finding] = dataclasses.field(
        default_factory=list)
    # baseline entries no longer matching ANY current finding: the debt
    # was paid but the entry lingers. Informational (exit stays 0) —
    # reported as `baseline-stale` notes and pruned by --fix-baseline.
    stale_baseline: List[dict] = dataclasses.field(default_factory=list)
    # per-rule wall seconds + the total analysis wall, so the data-flow
    # tier's cost is visible in --json and gated by time_budget_s
    rule_timings: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    wall_s: float = 0.0

    @property
    def clean(self) -> bool:
        return not self.findings and not self.internal_errors


def default_root() -> str:
    """Repo root = parent of the installed package directory."""
    import spark_rapids_tpu_torch
    return os.path.dirname(
        os.path.dirname(os.path.abspath(spark_rapids_tpu_torch.__file__)))


def collect_files(root: str, config: LintConfig) -> List[FileCtx]:
    out: List[FileCtx] = []
    for scan in config.scan_roots:
        base = os.path.join(root, scan)
        if os.path.isfile(base):
            out.append(FileCtx(root, scan))
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          root)
                    out.append(FileCtx(root, rel))
    return out


def _load_baseline(root: str, config: LintConfig) -> Dict[str, dict]:
    path = os.path.join(root, config.baseline)
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(root: str, config: LintConfig,
                   findings: List[Finding], pctx: PackageContext) -> str:
    """--fix-baseline: capture current findings as accepted debt.
    Stale entries (not in ``findings``) are pruned by construction.
    Churn guard: when the accepted-debt SET is unchanged — same
    fingerprints, which hash line TEXT, not line numbers — the file is
    left byte-identical, so edits that merely shift lines (or shrink a
    line's suppressed-rule set elsewhere) never rewrite line_hints."""
    path = os.path.join(root, config.baseline)
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        entries.append({
            "fingerprint": f.fingerprint(_line_text(pctx, f)),
            "rule": f.rule, "path": f.path, "line_hint": f.line,
            "message": f.message,
        })
    existing = _load_baseline(root, config)
    if existing and set(existing) == {e["fingerprint"]
                                      for e in entries}:
        return path
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": JSON_SCHEMA_VERSION, "findings": entries},
                  fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def _line_text(pctx: PackageContext, f: Finding) -> str:
    fctx = pctx.file(f.path)
    return fctx.line_text(f.line) if fctx is not None else ""


def run_lint(root: Optional[str] = None,
             config: Optional[LintConfig] = None) -> LintResult:
    t_start = time.perf_counter()
    root = root or default_root()
    config = config or load_config(root)
    files = collect_files(root, config)
    pctx = PackageContext(root, config, files)

    raw: List[Finding] = []
    internal: List[str] = []
    timings: Dict[str, float] = {}
    for r in RULES.values():
        t0 = time.perf_counter()
        try:
            raw.extend(r.func(pctx))
        except Exception:
            internal.append(
                f"rule {r.name} crashed:\n{traceback.format_exc()}")
        timings[r.name] = time.perf_counter() - t0
    # suppressions without a reason are findings themselves and are
    # not suppressible (otherwise the grammar could erase its own gate)
    for fctx in files:
        for line, msg in fctx.bad_suppressions:
            raw.append(Finding("bad-suppression", fctx.rel, line, 1,
                               msg))

    suppressed = 0
    unsuppressed: List[Finding] = []
    for f in raw:
        fctx = pctx.file(f.path)
        if f.rule != "bad-suppression" and fctx is not None \
                and fctx.suppressed(f.rule, f.line):
            suppressed += 1
        else:
            unsuppressed.append(f)

    baseline = _load_baseline(root, config)
    baselined: List[Finding] = []
    active: List[Finding] = []
    matched: Set[str] = set()
    for f in unsuppressed:
        fp = f.fingerprint(_line_text(pctx, f))
        if fp in baseline:
            baselined.append(f)
            matched.add(fp)
        else:
            active.append(f)
    # entries whose debt was paid (the finding is gone — fixed, or its
    # suppressed-rule set shrank) linger as dead weight and churn every
    # rewrite: surface them as informational `baseline-stale` notes so
    # --fix-baseline prunes them deliberately, not accidentally
    stale = [e for fp, e in sorted(baseline.items())
             if fp not in matched]
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(root=root, findings=active, suppressed=suppressed,
                      baselined=len(baselined), files=len(files),
                      internal_errors=internal, pctx=pctx,
                      baselined_findings=baselined,
                      stale_baseline=stale, rule_timings=timings,
                      wall_s=time.perf_counter() - t_start)


# -- rendering -------------------------------------------------------------

def render_json(result: LintResult,
                pctx: Optional[PackageContext] = None,
                budget: Optional[float] = None) -> str:
    findings = []
    for f in result.findings:
        findings.append({
            "rule": f.rule, "path": f.path, "line": f.line,
            "col": f.col, "message": f.message,
            "fingerprint": f.fingerprint(
                _line_text(pctx, f) if pctx is not None else ""),
        })
    if budget is None:
        # the config default; run_cli passes the effective budget so a
        # --time-budget override and the exit code agree with the JSON
        budget = (result.pctx.config.time_budget_s
                  if result.pctx is not None else None)
    return json.dumps({
        "version": JSON_SCHEMA_VERSION,
        "root": result.root,
        "clean": result.clean,
        "counts": {
            "findings": len(result.findings),
            "suppressed": result.suppressed,
            "baselined": result.baselined,
            "files": result.files,
        },
        "rules": sorted(RULES),
        "findings": findings,
        "staleBaseline": result.stale_baseline,
        "timings": {
            "perRule": {k: round(v, 4)
                        for k, v in sorted(result.rule_timings.items())},
            "totalSeconds": round(result.wall_s, 4),
            "budgetSeconds": budget,
        },
        "internalErrors": result.internal_errors,
    }, indent=2)


def render_human(result: LintResult) -> str:
    lines: List[str] = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: [{f.rule}] "
                     f"{f.message}")
    for e in result.stale_baseline:
        # informational: the debt was paid; exit code is unaffected
        lines.append(f"{e['path']}: note: [baseline-stale] entry "
                     f"`{e['rule']}` no longer matches any finding — "
                     f"run --fix-baseline to prune it")
    lines.append(
        f"tpu-lint: {len(result.findings)} finding(s), "
        f"{result.suppressed} suppressed, {result.baselined} baselined "
        f"({len(result.stale_baseline)} stale) "
        f"across {result.files} files "
        f"({len(RULES)} rules, {result.wall_s:.1f}s)")
    return "\n".join(lines)


def render_github(result: LintResult) -> str:
    """GitHub Actions workflow-command annotations: one ::error per
    finding (file/line/col land as inline PR annotations), ::notice
    for stale baseline entries, ::warning for internal errors."""

    def esc(s: str) -> str:
        # workflow-command data escapes (docs.github.com: % -> %25,
        # CR/LF -> %0D/%0A)
        return (s.replace("%", "%25").replace("\r", "%0D")
                .replace("\n", "%0A"))

    lines: List[str] = []
    for f in result.findings:
        lines.append(f"::error file={esc(f.path)},line={f.line},"
                     f"col={f.col},title=tpu-lint {esc(f.rule)}::"
                     f"{esc(f.message)}")
    for e in result.stale_baseline:
        lines.append(f"::notice file={esc(e['path'])},"
                     f"title=tpu-lint baseline-stale::baseline entry "
                     f"`{esc(e['rule'])}` no longer matches any "
                     f"finding — run --fix-baseline to prune it")
    for err in result.internal_errors:
        lines.append(f"::warning title=tpu-lint internal::{esc(err)}")
    lines.append(f"tpu-lint: {len(result.findings)} finding(s) across "
                 f"{result.files} files")
    return "\n".join(lines)


def changed_files(root: str, base: str) -> Optional[Set[str]]:
    """ROOT-relative paths changed vs ``base`` per
    ``git diff --name-only`` (plus untracked files, so a brand-new
    module is linted pre-commit too); None when git fails. ``git
    diff`` emits toplevel-relative paths, so when the lint root is
    nested inside the worktree they are re-based onto the root —
    otherwise the intersection with finding paths would be empty and
    the incremental mode would silently pass bad code."""
    try:
        # quotepath=off: default git octal-escapes non-ASCII paths
        # ("caf\303\251.py"), which would never match a finding path
        # and silently drop that file from the incremental gate
        out = subprocess.run(
            ["git", "-C", root, "-c", "core.quotepath=off", "diff",
             "--name-only", base],
            capture_output=True, text=True, timeout=30)
        if out.returncode != 0:
            return None
        prefix = ""
        pfx = subprocess.run(
            ["git", "-C", root, "rev-parse", "--show-prefix"],
            capture_output=True, text=True, timeout=30)
        if pfx.returncode == 0:
            prefix = pfx.stdout.strip()
        paths = {p.strip()[len(prefix):] for p in out.stdout.splitlines()
                 if p.strip() and p.strip().startswith(prefix)}
        extra = subprocess.run(
            ["git", "-C", root, "-c", "core.quotepath=off", "ls-files",
             "--others", "--exclude-standard"],
            capture_output=True, text=True, timeout=30)
        if extra.returncode == 0:
            # ls-files paths are already relative to the -C directory
            paths |= {p.strip() for p in extra.stdout.splitlines()
                      if p.strip()}
        return paths
    except Exception:
        return None


def run_cli(root: Optional[str] = None, as_json: bool = False,
            fix_baseline: bool = False, fmt: Optional[str] = None,
            changed_only: Optional[str] = None,
            time_budget: Optional[float] = None) -> int:
    """`tools lint` body. Exit contract: 0 clean / 1 findings /
    2 internal error — including a run whose wall exceeds the time
    budget (the gate must stay affordable, docs/linting.md).

    ``fmt``: "human" (default) / "json" / "github" (workflow-command
    annotations); ``as_json`` is the legacy spelling of fmt="json".
    ``changed_only``: a git base ref — findings are restricted to files
    in ``git diff --name-only <base>`` (+ untracked), while the
    ANALYSIS still covers the whole package so cross-module data-flow
    rules see true call graphs. ``time_budget``: override the
    config's ``time_budget_s``."""
    try:
        root = root or default_root()
        config = load_config(root)
        result = run_lint(root, config)
        if result.files == 0:
            # a wrong --root (or a renamed scan root) must not turn
            # the CI gate green by linting nothing
            print(f"tpu-lint: no files found under {root} "
                  f"(scan roots: {', '.join(config.scan_roots)})")
            return 2
        if result.internal_errors:
            for e in result.internal_errors:
                print(e)
            return 2
        if fix_baseline:
            # active findings PLUS still-live accepted debt: rewriting
            # with only the new findings would un-accept the old ones.
            # Stale entries are pruned by construction (they match no
            # current finding, so they are in neither list).
            keep = result.findings + result.baselined_findings
            path = write_baseline(root, config, keep, result.pctx)
            pruned = len(result.stale_baseline)
            print(f"tpu-lint: baselined {len(keep)} finding(s) into "
                  f"{path}"
                  + (f" ({pruned} stale entr"
                     f"{'y' if pruned == 1 else 'ies'} pruned)"
                     if pruned else ""))
            return 0
        if changed_only is not None:
            changed = changed_files(root, changed_only)
            if changed is None:
                print(f"tpu-lint: --changed-only: git diff "
                      f"--name-only {changed_only} failed under "
                      f"{root}")
                return 2
            result = dataclasses.replace(
                result,
                findings=[f for f in result.findings
                          if f.path in changed],
                stale_baseline=[e for e in result.stale_baseline
                                if e.get("path") in changed])
        budget = (time_budget if time_budget is not None
                  else config.time_budget_s)
        fmt = fmt or ("json" if as_json else "human")
        if fmt == "json":
            print(render_json(result, result.pctx, budget=budget))
        elif fmt == "github":
            print(render_github(result))
        else:
            print(render_human(result))
        if budget and result.wall_s > budget:
            import sys
            # stderr: the budget breach must not corrupt --json stdout
            print(f"tpu-lint: analysis wall {result.wall_s:.1f}s "
                  f"exceeded the {budget:.0f}s budget — the gate must "
                  f"stay affordable; profile the slow rule "
                  f"(--json timings.perRule) or raise time_budget_s "
                  f"in torch-lint.json", file=sys.stderr)
            return 2
        return 0 if result.clean else 1
    except Exception:
        traceback.print_exc()
        return 2
