"""The port's linter (``spark_rapids_tpu_torch/lint/``): fixture sources
for the rules both linters have get the same rule names and lines from
the JAX package's engine and the port's; the port's own rules (device
allocations in the operators, ``docs/torch/`` drift); the suppression
grammar, the baseline, ``--json``, ``--format=github``,
``--changed-only``, the time budget and the exit contract 0/1/2; and the
lint of the port itself, which reaches zero findings (this test is the
port's lint gate in tier-1)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from spark_rapids_tpu.lint import LintConfig as JLintConfig
from spark_rapids_tpu.lint import run_lint as jax_run_lint

from spark_rapids_tpu_torch.lint import (LintConfig, load_config,
                                         render_json, run_cli, run_lint)
from spark_rapids_tpu_torch.lint.engine import (RULES, default_root,
                                                write_baseline)

# the rules the two linters share with the same fixtures here (the jit and
# data-flow tiers are compared in test_torch_lint_dataflow.py)
SHARED = {"retry-coverage", "lock-order", "lock-blocking-call",
          "check-then-act", "metric-key", "conf-key", "span-scope",
          "span-kind", "prom-family", "history-field", "tuning-action",
          "cancel-checkpoint", "bad-suppression"}

# one scope layout for both engines over a neutral package "pkg"
_SCOPES = dict(
    scan_roots=("pkg",), retry_scope=("pkg/exec/",),
    alloc_entrypoints=("device_put", "finish_upload", "start_upload",
                       "finish_started", "upload_batch", "stack_batches"),
    retry_allowlist={}, concurrency_scope=("pkg/memory.py", "pkg/serve/"),
    critical_locks=("DeviceStore._lock", "TpuSemaphore._cv",
                    "AdmissionController._cv", "JitCache._lock"),
    cancel_scope=("pkg/serve/", "pkg/jit_cache.py"),
    metrics_rel="pkg/metrics.py", trace_rel="pkg/trace.py",
    prometheus_rel="pkg/telemetry/prometheus.py",
    history_rel="pkg/telemetry/history.py",
    tuning_rel="pkg/telemetry/tuning.py", check_docs=False)


def _tree(tmp_path, files):
    root = tmp_path / "fixture"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).lstrip("\n"))
    return str(root)


def _port_cfg(**over):
    kw = dict(_SCOPES, conf_registrar="conf", alloc_scope=())
    kw.update(over)
    return LintConfig(**kw)


def _jax_cfg():
    return JLintConfig(**_SCOPES)


def _found(result, rules=SHARED):
    return sorted((f.rule, f.path, f.line) for f in result.findings
                  if f.rule in rules)


_LOCKY = """
import threading
import time

class DeviceStore:
    def __init__(self):
        self._lock = threading.RLock()
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._cv = threading.Condition()
"""

FIXTURES = {
    "retry": {"pkg/exec/x.py": """
        from pkg import retry as R

        def bad(staged, device):
            return finish_upload(staged, device)

        def good(staged, device, conf):
            return R.with_retry(lambda: finish_upload(staged, device),
                                conf)

        def outer(src, conf):
            def upload_host(hb):
                return inner(hb)
            return R.with_split_retry(src, upload_host, conf)

        def inner(hb):
            return upload_batch(hb, 8)
    """, "pkg/other.py": """
        def out_of_scope(staged):
            return finish_upload(staged)
    """},
    "locks": {"pkg/memory.py": _LOCKY + """
    def one(self):
        with self._a:
            self.takes_b()

    def takes_b(self):
        with self._b:
            pass

    def two(self):
        with self._b:
            with self._a:
                pass

    def bad_sleep(self):
        with self._lock:
            time.sleep(0.1)

    def bad_dispatch(self, staged):
        with self._lock:
            return finish_upload(staged)

    def bad_wait(self):
        with self._lock:
            self._cv.wait()

    def fine(self):
        with self._cv:
            self._cv.wait()
    """},
    "check-then-act": {"pkg/serve/s.py": """
        import threading

        class Sessions:
            def __init__(self):
                self._lock = threading.Lock()
                self._by_tenant = {}

            def racy(self, k):
                if k not in self._by_tenant:
                    self._by_tenant[k] = object()
                return self._by_tenant[k]

            def guarded(self, k):
                with self._lock:
                    if k not in self._by_tenant:
                        self._by_tenant[k] = object()
                    return self._by_tenant[k]
    """},
    "drift": {
        "pkg/metrics.py": """
            OP_TIME = "opTime"
            ROGUE = "notDescribedConstant"
            METRIC_DESCRIPTIONS = {
                OP_TIME: "operator wall",
                "goodKey": "described",
            }
            METRIC_PREFIX_DESCRIPTIONS = {"perChip.": "per chip <N>"}
        """,
        "pkg/conf.py": """
            def conf(key):
                return key

            conf("spark.rapids.sql.fixture.enabled")
        """,
        "pkg/trace.py": """
            SPAN_CATALOG = {"fine": "a catalogued span"}
            INSTANT_CATALOG = {"mark": "a catalogued instant"}

            def span(*a, **k):
                pass

            def instant(*a, **k):
                pass
        """,
        "pkg/exec/x.py": """
            from pkg import metrics as M
            from pkg import trace as _trace

            GOOD = "spark.rapids.sql.fixture.enabled"
            BAD = "spark.rapids.sql.fixture.typo"
            PREFIX = "spark.rapids.sql.fixture."

            def use(metrics, qt):
                metrics.create("goodKey").add(1)
                metrics.create(M.OP_TIME).add(1)
                metrics.create("perChip.3").add(1)
                metrics.create("rogueLiteral").add(1)
                _trace.span("leaky")
                with _trace.span("fine"):
                    pass
                with _trace.span("uncatalogued"):
                    pass
                _trace.instant("mark")
                _trace.instant("stray")
                qt.add("rogueSpan", 0, 1)
        """},
    "cancel": {"pkg/serve/w.py": """
        import threading
        import time

        _CV = threading.Condition()

        def bad_wait():
            with _CV:
                _CV.wait()

        def bad_sleep():
            time.sleep(0.5)

        def bad_queue_get(q):
            return q.get()

        def bad_explicit_blocking_get(q):
            return q.get(block=True)

        def good_bounded_wait():
            with _CV:
                _CV.wait(timeout=0.05)

        def good_queue_get(q):
            return q.get(timeout=0.1)

        def fine_dict_get(d, k):
            return d.get(k)
    """, "pkg/jit_cache.py": """
        def bad(ev):
            ev.wait(timeout=None)
    """},
    "suppressions": {"pkg/serve/w.py": """
        import time

        def a():
            time.sleep(0.1)  # tpu-lint: disable=cancel-checkpoint(fixture backoff, bounded)

        def b():
            time.sleep(0.1)  # tpu-lint: disable=cancel-checkpoint

        def c():
            time.sleep(0.1)  # tpu-lint: disable=cancel-checkpoint(probe (one-shot) cap)

        def d():
            # tpu-lint: disable=cancel-checkpoint(fixture, next line)
            time.sleep(0.1)
    """},
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_same_findings_as_the_jax_engine(tmp_path, name):
    root = _tree(tmp_path, FIXTURES[name])
    jax = jax_run_lint(root, _jax_cfg())
    port = run_lint(root, _port_cfg())
    assert not port.internal_errors and not jax.internal_errors
    assert _found(port) == _found(jax)
    assert _found(port), "the fixture must fire"
    assert port.suppressed == jax.suppressed


def test_expected_findings_of_the_fixtures(tmp_path):
    """What the shared fixtures must find, spelled out (so an engine that
    finds nothing cannot pass the comparison above)."""
    want = {"retry": {("retry-coverage", 4)},
            "check-then-act": {("check-then-act", 9)},
            "cancel": {("cancel-checkpoint", n) for n in (8, 11, 14, 17)}
            | {("cancel-checkpoint", 2)}}
    for name, lines in want.items():
        r = run_lint(_tree(tmp_path / name, FIXTURES[name]), _port_cfg())
        assert {(f.rule, f.line) for f in r.findings} == lines, name
    r = run_lint(_tree(tmp_path / "locks", FIXTURES["locks"]), _port_cfg())
    assert {f.rule for f in r.findings} == {"lock-order",
                                            "lock-blocking-call"}
    assert sum(f.rule == "lock-blocking-call" for f in r.findings) == 3
    r = run_lint(_tree(tmp_path / "drift", FIXTURES["drift"]), _port_cfg())
    rules = sorted(f.rule for f in r.findings)
    # span-kind: "leaky", "uncatalogued", "stray" and "rogueSpan"
    assert rules == ["conf-key", "metric-key", "metric-key"] \
        + ["span-kind"] * 4 + ["span-scope"], rules
    r = run_lint(_tree(tmp_path / "sup", FIXTURES["suppressions"]),
                 _port_cfg())
    assert r.suppressed == 2
    assert sorted(f.rule for f in r.findings) == [
        "bad-suppression", "bad-suppression", "cancel-checkpoint",
        "cancel-checkpoint"]


def test_device_allocations_in_the_operators(tmp_path):
    """The port's own retry sites: a torch allocator handed a device= in
    an operator must run under the protocol; the same call without a
    device, or outside the operators, is not a site."""
    root = _tree(tmp_path, {"pkg/exec/x.py": """
        import torch
        from pkg import retry as R

        def bad(n, device):
            return torch.empty(n, device=device)

        def good(n, device, conf):
            return R.with_retry(lambda: torch.zeros(n, device=device), conf)

        def host(n):
            return torch.empty(n)

        def launch(kw):
            return groupby_table(kw)
    """, "pkg/ops/y.py": """
        import torch

        def helper(n, device):
            return torch.arange(n, device=device)
    """})
    r = run_lint(root, _port_cfg(
        alloc_scope=("pkg/exec/",),
        alloc_entrypoints=("groupby_table",)))
    assert sorted((f.rule, f.path, f.line) for f in r.findings) == [
        ("retry-coverage", "pkg/exec/x.py", 5),
        ("retry-coverage", "pkg/exec/x.py", 14)]


def test_allowlist_entries_carry_reasons():
    cfg = LintConfig()
    for allow in (cfg.retry_allowlist, cfg.sync_allowlist,
                  cfg.purity_allowlist):
        assert allow
        for key, reason in allow.items():
            assert "::" in key and key.startswith("spark_rapids_tpu_torch/")
            assert len(reason.split()) >= 5, key


def test_docs_drift_finds_a_stale_doc(monkeypatch):
    """docs-drift holds docs/torch/ against the generators: a generator
    that changed is a finding on its file."""
    from spark_rapids_tpu_torch import tools as TL
    real = TL.doc_generators()
    monkeypatch.setattr(TL, "doc_generators", lambda: [
        (f, (lambda g=g: g() + "changed\n") if f == "tuning.md" else g)
        for f, g in real])
    r = run_lint(default_root(), load_config(default_root()))
    assert [(f.rule, f.path) for f in r.findings] == [
        ("docs-drift", "docs/torch/tuning.md")]


# ---------------------------------------------------------------------------
# engine: baseline, JSON, GitHub annotations, changed-only, budget
# ---------------------------------------------------------------------------

_BAD = """
    import time

    def a():
        time.sleep(0.5)
"""


def _bad_tree(tmp_path, rel="pkg/serve/x.py"):
    root = _tree(tmp_path, {rel: _BAD})
    with open(os.path.join(root, "torch-lint.json"), "w") as f:
        json.dump(dict({k: list(v) if isinstance(v, tuple) else v
                        for k, v in _SCOPES.items()},
                       conf_registrar="conf"), f)
    return root


def test_config_file_overrides(tmp_path):
    root = _bad_tree(tmp_path)
    cfg = load_config(root)
    assert cfg.scan_roots == ("pkg",) and cfg.check_docs is False
    assert len(run_lint(root, cfg).findings) == 1


def test_baseline_semantics_and_fix_baseline(tmp_path):
    root = _bad_tree(tmp_path)
    cfg = load_config(root)
    r = run_lint(root, cfg)
    assert len(r.findings) == 1 and r.baselined == 0
    path = write_baseline(root, cfg, r.findings, r.pctx)
    assert os.path.basename(path) == "torch-lint-baseline.json"
    data = json.load(open(path))
    assert data["version"] == 1 and len(data["findings"]) == 1
    r2 = run_lint(root, cfg)
    assert r2.clean and r2.baselined == 1
    # line-TEXT keyed: an edit above the site does not churn it
    p = os.path.join(root, "pkg/serve/x.py")
    open(p, "w").write("import os  # shift\n" + open(p).read())
    assert run_lint(root, cfg).clean
    # the debt paid: the entry goes stale, the run stays clean
    open(p, "w").write("def a():\n    return 1\n")
    r3 = run_lint(root, cfg)
    assert r3.clean and [e["rule"] for e in r3.stale_baseline] == [
        "cancel-checkpoint"]


def test_json_output_schema(tmp_path, capsys):
    root = _bad_tree(tmp_path)
    r = run_lint(root, load_config(root))
    out = json.loads(render_json(r, r.pctx))
    assert out["version"] == 1 and out["clean"] is False
    assert set(out["counts"]) == {"findings", "suppressed", "baselined",
                                  "files"}
    assert set(out["findings"][0]) == {"rule", "path", "line", "col",
                                       "message", "fingerprint"}
    assert sorted(out["rules"]) == sorted(RULES)
    assert run_cli(root=root, as_json=True) == 1
    t = json.loads(capsys.readouterr().out)["timings"]
    assert t["budgetSeconds"] == 60.0 and set(t["perRule"]) == set(RULES)


def test_github_format_annotations(tmp_path, capsys):
    root = _bad_tree(tmp_path)
    assert run_cli(root=root, fmt="github") == 1
    out = capsys.readouterr().out
    err = [ln for ln in out.splitlines() if ln.startswith("::error")]
    assert len(err) == 1
    assert err[0].startswith("::error file=pkg/serve/x.py,line=4,col=5,"
                             "title=tpu-lint cancel-checkpoint::")


def test_time_budget_exit(tmp_path, capsys):
    root = _bad_tree(tmp_path)
    open(os.path.join(root, "pkg/serve/x.py"), "w").write("X = 1\n")
    assert run_cli(root=root) == 0
    capsys.readouterr()
    assert run_cli(root=root, time_budget=1e-9) == 2
    assert "exceeded" in capsys.readouterr().err


def test_changed_only_filters_to_git_diff(tmp_path, capsys):
    root = _bad_tree(tmp_path, "pkg/serve/old.py")
    open(os.path.join(root, "pkg/serve/new.py"), "w").write(
        textwrap.dedent(_BAD))
    git = ["git", "-C", root, "-c", "user.email=t@t", "-c", "user.name=t"]
    subprocess.run(git + ["init", "-q"], check=True)
    subprocess.run(git + ["add", "pkg/serve/old.py", "torch-lint.json"],
                   check=True)
    subprocess.run(git + ["commit", "-qm", "seed"], check=True)
    assert run_cli(root=root) == 1
    full = capsys.readouterr().out
    assert "old.py" in full and "new.py" in full
    assert run_cli(root=root, changed_only="HEAD") == 1
    changed = capsys.readouterr().out
    assert "new.py" in changed and "old.py:" not in changed
    assert run_cli(root=root, changed_only="no-such-ref") == 2


# ---------------------------------------------------------------------------
# the port itself: zero findings, every suppression reasoned
# ---------------------------------------------------------------------------

def test_the_port_is_lint_clean():
    root = default_root()
    cfg = load_config(root)
    assert cfg.check_docs and cfg.scan_roots == ("spark_rapids_tpu_torch",)
    r = run_lint(root, cfg)
    assert r.internal_errors == []
    assert r.findings == [], "\n".join(
        f"{f.path}:{f.line} [{f.rule}] {f.message}" for f in r.findings)
    assert r.suppressed > 0 and r.baselined == 0
    assert r.files > 50
    assert not os.path.exists(os.path.join(root, cfg.baseline))


def test_cli_exit_contract(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def lint(*args):
        return subprocess.run(
            [sys.executable, "-m", "spark_rapids_tpu_torch.tools", "lint",
             *args], capture_output=True, text=True, env=env,
            cwd=default_root(), timeout=300)
    out = lint("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["clean"] is True
    bad = _bad_tree(tmp_path / "bad")
    out = lint("--root", bad)
    assert out.returncode == 1 and "cancel-checkpoint" in out.stdout
    assert lint("--root", bad, "--fix-baseline").returncode == 0
    assert lint("--root", bad).returncode == 0
    broken = _bad_tree(tmp_path / "broken")
    open(os.path.join(broken, "pkg/serve/x.py"), "w").write("def b(:\n")
    assert lint("--root", broken).returncode == 2
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    out = lint("--root", empty)
    assert out.returncode == 2 and "no files found" in out.stdout
