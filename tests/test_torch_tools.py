"""The port's tools (``spark_rapids_tpu_torch/tools.py``) held against the
JAX package's on the CPU: the ``qualify`` and ``profile`` reports for the
same queries (operator names read ``Tpu`` as ``Torch``, the device
"TPU" as "GPU"), the offline reports over event logs and Chrome traces
that the JAX package wrote (``qualify_log``, ``profile_log``,
``analyze_trace``, ``critical_path``, ``exclusive_times``, ``hotspots``),
and every CLI command's exit code on missing and empty paths. Reports
are compared as text, exactly."""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket

import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import Q1, lineitem_arrays, lineitem_fields
from spark_rapids_tpu import tools as JTOOLS
from spark_rapids_tpu import trace as JTR
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import tools as TOOLS
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

# a query the JAX package keeps partly on its CPU (LIKE with a '_'
# wildcard), so the placement has a fallback with its reason
Q_FALLBACK = ("SELECT l_returnflag, count(*) AS c FROM lineitem "
              "WHERE l_linestatus LIKE '_' GROUP BY l_returnflag "
              "ORDER BY l_returnflag")
QUERIES = {"q1": Q1, "fallback": Q_FALLBACK}


def to_port(text: str) -> str:
    """A JAX report over a live query as the port words it: its
    operators' names and the device."""
    return (text.replace("Tpu", "Torch").replace("TPU", "GPU")
            .replace("docs/kernels.md", "docs/torch/kernels.md"))


def port_words(text: str) -> str:
    """A JAX report over a file the JAX package wrote as the port words
    it: the file's names stay, the reports name the device "GPU"."""
    return text.replace("TPU", "GPU").replace("docs/kernels.md",
                                              "docs/torch/kernels.md")


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tools") / "lineitem")
    os.makedirs(d)
    tbl = host_batch_to_arrow(host_batch_from_numpy(
        lineitem_fields(), lineitem_arrays(3000)))
    for i in range(2):
        pq.write_table(tbl.slice(i * 1500, 1500),
                       os.path.join(d, f"part-{i}.parquet"),
                       row_group_size=1500)
    return d


def _jax(conf=None):
    return TpuSparkSession(dict(conf or {},
                                **{"spark.rapids.sql.enabled": "true"}))


def _port(conf=None):
    return TorchSparkSession(dict(conf or {}), device="cpu")


def _with_view(s, lineitem):
    s.read.parquet(lineitem).createOrReplaceTempView("lineitem")
    return s


@pytest.mark.parametrize("q", list(QUERIES))
def test_qualify_report_equals_the_jax_package(lineitem, q):
    j, p = _with_view(_jax(), lineitem), _with_view(_port(), lineitem)
    try:
        jr = JTOOLS.qualify_sql(j, QUERIES[q])
        pr = TOOLS.qualify_sql(p, QUERIES[q])
    finally:
        j.stop()
        p.stop()
    assert pr.device_ops == [to_port(o) for o in jr.device_ops]
    assert pr.cpu_ops == [(to_port(n), list(r)) for n, r in jr.cpu_ops]
    assert pr.op_coverage == jr.op_coverage
    head = "\nphysical plan:\n"
    assert pr.format().split(head)[0] == \
        to_port(jr.format().split(head)[0])
    if q == "fallback":
        assert pr.cpu_ops and pr.op_coverage < 1.0


@pytest.mark.parametrize("q", list(QUERIES))
def test_profile_report_equals_the_jax_package(lineitem, q):
    """The same rows and the same device operators, in order; each
    package's own metric registries are under them."""
    j, p = _with_view(_jax(), lineitem), _with_view(_port(), lineitem)
    try:
        jr = JTOOLS.profile(j, j.sql(QUERIES[q]))
        pr = TOOLS.profile(p, p.sql(QUERIES[q]))
    finally:
        j.stop()
        p.stop()
    assert pr.rows == jr.rows > 0
    assert [n for n, _m in pr.operators] == \
        [to_port(n) for n, _m in jr.operators]
    text = pr.format()
    assert text.startswith("=== GPU Profile Report ===\noutput rows: ")
    assert any(m.get("numOutputRows") for _n, m in pr.operators)


# ---------------------------------------------------------------------------
# offline reports over files the JAX package wrote
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_files(lineitem, tmp_path_factory):
    base = str(tmp_path_factory.mktemp("jaxfiles"))
    ev, tr = os.path.join(base, "events"), os.path.join(base, "traces")
    JTR.reset_tracing()
    s = _with_view(_jax({"spark.rapids.sql.eventLog.dir": ev,
                         "spark.rapids.sql.trace.enabled": "true",
                         "spark.rapids.sql.trace.dir": tr}), lineitem)
    try:
        for sql in QUERIES.values():
            s.sql(sql).collect()
    finally:
        s.stop()
        JTR.reset_tracing()
    traces = sorted(os.path.join(tr, f) for f in os.listdir(tr))
    assert len(traces) == 2
    return {"events": ev, "traces": tr, "trace_files": traces}


def test_qualify_log_over_a_jax_event_log(jax_files):
    got = TOOLS.qualify_log(jax_files["events"])
    assert got == port_words(JTOOLS.qualify_log(jax_files["events"]))
    assert "queries: 2" in got


def test_profile_log_over_a_jax_event_log(jax_files):
    got = TOOLS.profile_log(jax_files["events"])
    assert got == port_words(JTOOLS.profile_log(jax_files["events"]))


@pytest.mark.parametrize("i", [0, 1])
def test_trace_analysis_over_a_jax_trace(jax_files, i):
    path = jax_files["trace_files"][i]
    assert TOOLS.analyze_trace(path) == JTOOLS.analyze_trace(path)
    spans = TR.load_trace(path)["spans"]
    jspans = JTR.load_trace(path)["spans"]
    assert TOOLS.critical_path([dict(s) for s in spans]) == \
        JTOOLS.critical_path([dict(s) for s in jspans])
    assert TOOLS.exclusive_times([dict(s) for s in spans]) == \
        JTOOLS.exclusive_times([dict(s) for s in jspans])
    assert TOOLS.chip_occupancy(spans) == JTOOLS.chip_occupancy(jspans)
    assert TOOLS.format_trace_report(path) == \
        port_words(JTOOLS.format_trace_report(path))


def test_hotspots_over_jax_traces(jax_files):
    files = jax_files["trace_files"]
    assert TOOLS.hotspots_report(files, top=40) == \
        port_words(JTOOLS.hotspots_report(files, top=40))


def test_hotspots_flags_untuned_dispatches_by_bucket(lineitem, tmp_path):
    """The port's own trace: each groupbyHash dispatch span carries its
    bucket and tuned flag, so the report splits them and flags the
    untuned ones, as the JAX report does."""
    tr = str(tmp_path / "traces")
    TR.reset_tracing()
    s = _with_view(_port({"spark.rapids.sql.trace.enabled": "true",
                          "spark.rapids.sql.trace.dir": tr}), lineitem)
    try:
        s.sql(Q1).collect()
    finally:
        s.stop()
        TR.reset_tracing()
    files = [os.path.join(tr, f) for f in os.listdir(tr)]
    rep = TOOLS.hotspots_report(files, top=60)
    assert "kernelDispatch[groupbyHash@" in rep
    assert "kernelDispatch[decodeFused@" in rep
    assert "(untuned)" in rep


# ---------------------------------------------------------------------------
# the CLI: exit codes equal the JAX CLI's
# ---------------------------------------------------------------------------

def _rc(main, argv):
    """A CLI run's exit code (an argparse error's SystemExit code too),
    or the name of the exception it raised."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            return main(list(argv))
    except SystemExit as e:
        return e.code
    except Exception as e:  # compared by type across the two CLIs
        return type(e).__name__


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cases(tmp):
    missing = os.path.join(tmp, "missing")
    empty = os.path.join(tmp, "empty")
    os.makedirs(empty, exist_ok=True)
    dead = str(_dead_port())
    return {
        "trace-missing": ["trace", missing],
        "trace-empty": ["trace", empty],
        "trace-none": ["trace"],
        "hotspots-missing": ["hotspots", missing],
        "hotspots-empty": ["hotspots", empty],
        "profile-missing": ["profile", missing + ".json"],
        "profile-empty": ["profile", empty],
        "qualify-log-empty": ["qualify", "--log", empty],
        "profile-log-empty": ["profile", "--log", empty],
        "qualify-none": ["qualify"],
        "history-missing": ["history", missing],
        "history-empty": ["history", empty],
        "history-none": ["history"],
        "doctor-missing": ["doctor", "q1", "--history", missing],
        "doctor-empty": ["doctor", "q1", "--history", empty],
        "doctor-all-empty": ["doctor", "--all", "--history", empty],
        "doctor-none": ["doctor"],
        "tuning-missing": ["tuning", missing],
        "tuning-empty": ["tuning", empty],
        "tuning-bad-epoch": ["tuning", empty, "--pin", "7"],
        "bench-diff-missing": ["bench-diff", missing, missing],
        "bench-diff-empty-dir": ["bench-diff", missing, empty],
        "bench-diff-none": ["bench-diff"],
        "lint-empty-root": ["lint", "--root", empty],
        "top-none": ["top"],
        "top-not-a-port": ["top", "x:y"],
        "serve-client-no-port": ["serve-client", "SELECT 1"],
        "serve-client-dead": ["serve-client", "--port", dead, "SELECT 1"],
        "bad-command": ["nope"],
    }


CASE_NAMES = list(_cases("/nonexistent"))


@pytest.mark.parametrize("case", CASE_NAMES)
def test_cli_exit_codes_equal_the_jax_cli(tmp_path, case):
    argv = _cases(str(tmp_path))[case]
    assert _rc(TOOLS._main, argv) == _rc(JTOOLS._main, argv), argv


def test_cli_docs_writes_the_four_files(tmp_path):
    out = str(tmp_path / "docs")
    assert _rc(TOOLS._main, ["docs", "--out", out]) == 0
    assert sorted(os.listdir(out)) == ["configs.md", "observability.md",
                                       "supported_ops.md", "tuning.md"]


def test_generated_docs_are_the_committed_ones():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for fname, gen in TOOLS.doc_generators():
        with open(os.path.join(root, "docs", "torch", fname)) as f:
            assert f.read() == gen(), fname


def test_cli_qualify_live_on_the_cpu(lineitem):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = TOOLS._main(["qualify", Q1, "--view", f"lineitem={lineitem}",
                          "--device", "cpu"])
    assert rc == 0
    text = out.getvalue()
    assert text.startswith("=== GPU Qualification Report ===")
    assert "  + TorchHashAggregateExec" in text or \
        "  + TorchFusedStage" in text


def test_cli_profile_live_and_over_files(lineitem, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert TOOLS._main(["profile", Q1, "--view",
                            f"lineitem={lineitem}", "--device", "cpu"]) == 0
    assert out.getvalue().startswith("=== GPU Profile Report ===")
    d = str(tmp_path / "prof")
    s = _with_view(_port({"spark.rapids.sql.profile.enabled": "true",
                          "spark.rapids.sql.profile.dir": d}), lineitem)
    try:
        s.sql(Q1).collect()
    finally:
        s.stop()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert TOOLS._main(["profile", d]) == 0
    assert "TorchHashAggregateExec" in out.getvalue()


def test_cli_history_json_over_port_records(lineitem, tmp_path):
    h = str(tmp_path / "hist")
    s = _with_view(_port({"spark.rapids.sql.telemetry.history.dir": h}),
                   lineitem)
    try:
        s.sql(Q1).collect()
    finally:
        s.stop()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert TOOLS._main(["history", h, "--json"]) == 0
    assert json.loads(out.getvalue())["records"] == 1


def test_cli_has_every_jax_command_and_defaults_to_the_card():
    ap = TOOLS._parser()
    assert ap.parse_args(["qualify"]).device == "cuda"
    for cmd in TOOLS.COMMANDS:
        assert ap.parse_args([cmd]).command == cmd
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            ap.parse_args(["nope"])
    assert len(TOOLS.COMMANDS) == 14
