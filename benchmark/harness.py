"""One run of one cell: the data from the seed, the program's set-up and
warm-up, the measured window, the check of every query's rows against
the plain reference, and the result line.

Everything particular to a cell is found by name: the configuration's
file (``configs/``), its generator (``generators/``), the traffic mix
(``traffic/``), the entry the mix drives (``entries/``), the query's
reference (``reference/``) and each metric's reader (``metrics/``).
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import parquet_data
import traffic_gen

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the JAX side of the repository: none of it may be loaded by a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "spark_rapids_tpu")
# a query still running this long after the window closed never came
LATE_S = 90.0
# the flight recorder's spans a thread in a traced run: enough for a
# whole window (the program's default keeps the last 4,096)
TRACE_RING_SPANS = 2_000_000
# the device trace covers the window's first this many seconds (all of
# a shorter window): the profiler lost the end of a whole 51 s window of
# four q3 streams, and one started while the streams run records late
TRACE_SECONDS = 20.0


class CellError(RuntimeError):
    pass


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The workload, its configuration's file, its traffic mix and the
    metrics it reports (``end_to_end`` and ``per_layer`` entries)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload named {name!r}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(ROOT, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    def here(m) -> bool:
        return name in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if here(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return {"workload": w, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


class Query:
    """One query a stream sent: its binding, the host clock at submission
    and at its last row, its rows or its error, and what the entry
    reported beside them."""

    __slots__ = ("stream", "phase", "binding", "t0", "t1", "rows", "error",
                 "extras", "verdict")

    def __init__(self, stream: int, phase: str, binding: dict):
        self.stream, self.phase, self.binding = stream, phase, binding
        self.t0 = self.t1 = None
        self.rows = self.error = self.verdict = None
        self.extras: dict = {}

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


class Run:
    """What the metric readers read: the window's queries, its bounds on
    the host clock, set-up, the device trace, the entry's counters at the
    window's start and end, the data, and the reference's state."""

    def __init__(self, spec: dict, seconds: float):
        self.spec = spec
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seconds = seconds
        self.queries: List[Query] = []
        self.t_window = self.t_close = None
        self.setup_s = None
        self.device_trace = None
        # host-clock bounds of the device trace (None: no trace)
        self.t_trace = self.t_trace_end = None
        self.host_spans: list = []
        self.counters_start: dict = {}
        self.counters_end: dict = {}
        self.peak_window_bytes = None
        self.peak_bytes = 0
        self.window_captures = 0
        self.views: Dict[str, str] = {}
        self.data: dict = {}
        self.reference = None
        self.reference_state = None

    @property
    def window(self) -> List[Query]:
        """Every query sent in the window, finished or not."""
        return [q for q in self.queries if q.phase == "window"]

    @property
    def completed(self) -> List[Query]:
        """The window's queries that returned their rows inside it."""
        return [q for q in self.window if q.t1 is not None
                and q.error is None and q.t1 <= self.t_close]


def _drive(entry, plans, queries: List[Query], phase: str,
           streams: List[int], count: Optional[int] = None,
           until: Optional[list] = None, go: threading.Event = None):
    """Run ``streams`` as threads, each a closed loop: ``count`` queries,
    or as many as it can start before ``until[0]`` (a host-clock time set
    when ``go`` is set)."""
    lock = threading.Lock()

    def loop(i: int) -> None:
        call = entry.client(i)
        if go is not None:
            go.wait()
        n = 0
        while (n < count) if count is not None \
                else (time.perf_counter() < until[0]):
            binding = next(plans[i]["bindings"], None)
            if binding is None:
                raise CellError(f"stream {i} ran out of bindings")
            q = Query(i, phase, binding)
            with lock:
                queries.append(q)
            text = traffic_gen.render(plans[i]["template"], binding)
            q.t0 = time.perf_counter()
            try:
                q.rows, q.extras = call(text, binding)
            except Exception as e:  # noqa: BLE001 - a failed query counts
                q.error = f"{type(e).__name__}: {e}"
            q.t1 = time.perf_counter()
            n += 1
    def guarded(i: int) -> None:
        try:
            loop(i)
        except BaseException as e:  # noqa: BLE001 - re-raised by _join
            threading.current_thread().failure = e
    threads = [threading.Thread(target=guarded, args=(i,), daemon=True,
                                name=f"bench-stream-{i}") for i in streams]
    for t in threads:
        t.failure = None
        t.start()
    return threads


def _join(threads, deadline: float) -> None:
    """Wait for every stream until ``deadline``; a stream that failed
    outside a query fails the run. One still running is left: its query
    never returned."""
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    for t in threads:
        if t.failure is not None:
            raise CellError(f"{t.name}: {t.failure!r}") from t.failure


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, scale: float = 1.0,
             bench: Optional[dict] = None, make_entry=None) -> dict:
    """One run; returns the result line as a dict. ``device`` is
    ``torch.device("cuda", 0)`` in every benchmark run (tests pass the
    CPU and a ``scale`` below 1). ``make_entry(conf, views, device,
    streams, trace, data)`` stands something else in the program's place
    (the control); by default the traffic's entry drives the program."""
    import torch
    spec = cell_spec(bench or load_benchmark(), cell)
    config, traffic = spec["config"], spec["traffic"]
    run = Run(spec, seconds)
    on_card = torch.device(device).type == "cuda"
    seed &= (1 << 64) - 1
    tmp = tempfile.mkdtemp(prefix="bench-data-")
    try:
        run.data = parquet_data.generate(config, seed, scale)
        run.views = parquet_data.write_tables(config, run.data, tmp)
        conf = dict(config["conf"])
        if trace:
            conf.update({"spark.rapids.sql.trace.enabled": "true",
                         "spark.rapids.sql.trace.mode": "ring",
                         "spark.rapids.sql.trace.ringSpans":
                             str(TRACE_RING_SPANS)})
        streams = int(traffic["streams"])
        if make_entry is None:
            entry = parquet_data.load_module(
                "entries", traffic["entry"]).Entry(conf, run.views, device,
                                                  streams, trace)
        else:
            entry = make_entry(conf, run.views, device, streams, trace,
                               run.data)
        try:
            _measure(run, entry, seed, trace, on_card, t_start)
        finally:
            # the program's state goes before the reference runs
            entry.close()
            del entry
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
        return _finish(run, trace, on_card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _measure(run: Run, entry, seed: int, trace: bool, on_card: bool,
             t_start: float) -> None:
    import torch
    traffic = run.traffic
    streams = int(traffic["streams"])
    plans = [{"template": traffic["template"], "bindings": b}
             for b in traffic_gen.stream_bindings(traffic, seed, streams)]
    # warm-up: one query alone (it builds and captures), then every
    # stream at once (the shapes concurrency adds)
    _join(_drive(entry, plans, run.queries, "warmup", [0], count=1),
          time.perf_counter() + 600)
    warm = int(traffic["warmup_per_stream"])
    _join(_drive(entry, plans, run.queries, "warmup", list(range(streams)),
                 count=warm), time.perf_counter() + 600)
    go, until = threading.Event(), [0.0]
    threads = _drive(entry, plans, run.queries, "window",
                     list(range(streams)), until=until, go=go)
    capture = None
    if trace:
        run.counters_start = entry.counters()
        if on_card:
            from device_trace import Capture
            capture = Capture()
            capture.start()
    peak_before = 0
    if on_card:
        torch.cuda.synchronize()
        peak_before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    from spark_rapids_tpu_torch.exec import fused
    captures = fused.GRAPH_COUNTS["captures"]
    run.t_window = time.perf_counter()
    run.setup_s = run.t_window - t_start
    until[0] = run.t_close = run.t_window + run.seconds
    go.set()
    if capture is not None:
        time.sleep(max(0.0, min(run.t_close, run.t_window + TRACE_SECONDS)
                       - time.perf_counter()))
        capture.stop()
        run.t_trace, run.t_trace_end = (m / 1e9 for m in capture.marks)
    _join(threads, run.t_close + LATE_S)
    if capture is not None:
        from device_trace import DeviceTrace
        run.device_trace = DeviceTrace(capture.events(), capture.marks)
    run.window_captures = fused.GRAPH_COUNTS["captures"] - captures
    if on_card:
        torch.cuda.synchronize()
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(peak_before, run.peak_window_bytes)
    if trace:
        run.counters_end = entry.counters()
        from spark_rapids_tpu_torch import trace as program_trace
        ring = program_trace.ring_active()
        run.host_spans = ring.snapshot().spans if ring is not None else []


def _finish(run: Run, trace: bool, on_card: bool) -> dict:
    """Check every query against the reference, then read the metrics."""
    import torch
    ref = parquet_data.load_module("reference", run.traffic["query"])
    run.reference = ref
    run.reference_state = ref.prepare(run.data)
    want: dict = {}
    for q in run.queries:
        if q.t1 is None:
            q.verdict = "never returned"
        elif q.error is not None:
            q.verdict = q.error
        else:
            key = tuple(sorted(q.binding.items()))
            if key not in want:
                want[key] = ref.rows(run.reference_state, q.binding)
            q.verdict = ref.compare(q.rows, want[key])
    errors = sum(q.t1 is None or q.error is not None for q in run.queries)
    wrong = sum(q.verdict is not None for q in run.queries) - errors
    checks = {"wrong_results": {"value": wrong, "limit": 0},
              "errors": {"value": errors, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in run.spec["per_layer" if trace else "end_to_end"]:
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(0) if on_card
                       else "cpu"),
              "count": int(run.spec["workload"]["chips"]),
              "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": correct,
           "attempted": len(run.queries),
           "failed": sum(q.verdict is not None for q in run.queries),
           "metrics": metrics, "device": device}
    if trace and run.device_trace is not None:
        from device_trace import top
        dt = run.device_trace
        device["busy_s"] = dt.busy_s
        device["window_s"] = dt.window_s
        out["breakdown"] = {
            "device_ops": [[k[:120], v] for k, v in top(dt.op_seconds())],
            "idle_gaps": top(dt.idle_by_host_span(
                [s for s in run.host_spans
                 if s[2] >= dt.w0 - dt.offset
                 and s[1] <= dt.w1 - dt.offset]))}
    # what warmed up inside the window (there should be nothing): stage
    # graphs captured, and in a traced run the program's cache misses
    builds: dict = {}
    for sp in run.host_spans:
        if sp[0] == "compile" and run.t_window * 1e9 <= sp[1] \
                <= run.t_close * 1e9:
            cache = (sp[6] or {}).get("cache", "?")
            builds[cache] = builds.get(cache, 0) + 1
    print(f"window: {run.window_captures} graph captures; cache misses "
          f"{builds}", file=sys.stderr)
    bad = [q for q in run.queries if q.verdict is not None]
    for q in bad[:3]:
        print(f"query {q.phase} stream {q.stream} {q.binding}: {q.verdict}",
              file=sys.stderr)
    out["checks"] = checks
    return out


def metric_reader(name: str):
    """The reader of the metric ``name``: ``metrics/<name>.py``, or, for
    a name ``<base>.<suffix>`` with no file of its own, the reader of
    ``<base>`` (``latency_p90_s.<cell>`` is read by ``latency_p90_s.py``)."""
    parts = name.split(".")
    for k in range(len(parts), 1, -1):
        try:
            return parquet_data.load_module("metrics", ".".join(parts[:k]))
        except LookupError:
            pass
    return parquet_data.load_module("metrics", parts[0])


def forbidden_modules() -> List[str]:
    """Modules of the JAX side loaded in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))
