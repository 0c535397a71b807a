"""Persistent per-kernel launch autotuner (the counterpart of
``spark_rapids_tpu.kernels.autotune``).

The winning launch parameters of a kernel are a property of (kernel,
capacity bucket, card): they do not change between runs on one machine.
This module sweeps a small bounded grid once per such key, validates
every candidate against its oracle before it times it, and keeps the
winner in a crash-safe JSON-lines table, so a server against a warm
table never tunes again:

- ``params_for(conf, kernel, cap)`` is the one entry point. A table hit
  returns the recorded winner with no device work; a miss sweeps only
  when ``spark.rapids.sql.kernel.autotune.enabled`` is on (off =
  read-only: recorded winners still apply) and within the budget
  (``...autotune.budgetMs``). Untuned keys return ``{}``: the kernel's
  own launch.
- a candidate that fails its oracle, or that the kernel refuses to
  launch, is rejected (counted), never timed and never recorded: a
  table can make a kernel slower, never wrong. The default candidate
  ``{}`` comes first in every grid; if it fails, the sweep raises.
- a sweep whose best candidate is the default is recorded with
  ``applied: false``: remembered, so it does not sweep again, with the
  defaults in force.
- the table (``kernel-autotune.jsonl`` under ``...autotune.dir``) is
  append-only, one fsynced JSON object a line; the loader skips and
  counts lines it cannot parse (a torn append costs one entry), and the
  last entry for a key wins. An empty dir keeps the table in memory.

The key's device is ``torch.cuda.get_device_name(device)`` ("cpu" on the
host), so an entry that the JAX package wrote for a TPU never applies to
the card. The grids are the launch knobs of the CUDA kernels:

- groupbyHash (``csrc/groupby_hash.cu``): ``slotsMult`` scales the
  global table's slots (``kernels.table_slots``), ``blockRows`` sets the
  rows each block walks and with it the grid, ``laneGroups`` divides the
  entries of each block's shared-memory table
  (``groupby_hash.local_table_entries``). The JAX grid's six entries, in
  its order.
- decodeFused (``csrc/decode_fused.cu``): ``rowsPerThread`` 1 or 4 (the
  kernel's own choice is 1 or 2 by batch size), the counterpart of the
  JAX ``charChunk``: registers against parallelism, the same bytes.

Validation never runs the plain version of a kernel: a groupbyHash
candidate is held against a numpy group-by on the host over a synthetic
batch at the bucket's capacity (the JAX ``autotune_probe``); a
decodeFused candidate byte for byte against the default launch over a
synthetic Parquet row group that covers every page class. Each
validated candidate's launch is then timed alone with CUDA events on the
sweeping thread's own stream (never a device-wide synchronise: another
thread may be capturing a graph), after one warm launch; ``defaultMs``
and ``bestMs`` are the card's milliseconds of one launch, the best of
``TIMED_LAUNCHES``. On the CPU the plain versions run and the times are
host walls.

Stats surface through ``jit_cache.cache_stats()['kernelAutotune']``
(JitCache-shaped: hits = table lookups that found an entry, misses =
sweeps).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import jit_cache as JC
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import trace as _trace

_FILE = "kernel-autotune.jsonl"
TIMED_LAUNCHES = 5
# about a millisecond of the card's clock: longer than one launch's
# host enqueue
_SPIN_CYCLES = 2_000_000

_LOCK = threading.Lock()
# dir conf value -> {(kernel, bucket, device): entry}; "" = memory-only
_TABLES: Dict[str, Dict[Tuple, dict]] = {}
_COUNTERS = {"hits": 0, "sweeps": 0, "loaded": 0, "rejected": 0,
             "torn": 0}
# one record a sweep of this process (the candidates, their outcomes and
# times, the winner), newest last; cleared by reset_for_tests
_SWEEP_LOG: List[dict] = []

# bounded grids; the first entry MUST be {} so the default is always
# validated and timed and a winner has a baseline
_GRIDS: Dict[str, List[dict]] = {
    "groupbyHash": [{}, {"blockRows": 1024}, {"blockRows": 2048},
                    {"laneGroups": 2}, {"slotsMult": 2},
                    {"blockRows": 1024, "laneGroups": 2}],
    "decodeFused": [{}, {"rowsPerThread": 1}, {"rowsPerThread": 4}],
}


def device_kind(device) -> str:
    """The table's device key: the card's name, "cpu" on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _bucket(cap: int) -> int:
    return int(cap)


def _path(dir_: str) -> str:
    return os.path.join(dir_, _FILE)


def _load_locked(dir_: str) -> Dict[Tuple, dict]:
    tbl: Dict[Tuple, dict] = {}
    if not dir_:
        return tbl
    try:
        with open(_path(dir_), "r", encoding="utf-8") as f:
            lines = f.readlines()
    except OSError:  # no table yet, or a dir that cannot hold one
        return tbl
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
            k = (str(e["kernel"]), int(e["bucket"]), str(e["device"]))
            dict(e["params"])
        except (ValueError, KeyError, TypeError):
            _COUNTERS["torn"] += 1
            continue
        tbl[k] = e
        _COUNTERS["loaded"] += 1
    return tbl


def _table(dir_: str) -> Dict[Tuple, dict]:
    with _LOCK:
        tbl = _TABLES.get(dir_)
        if tbl is None:
            tbl = _TABLES[dir_] = _load_locked(dir_)
        return tbl


def _record(dir_: str, key: Tuple, entry: dict) -> None:
    with _LOCK:
        _TABLES.setdefault(dir_, {})[key] = entry
        if not dir_:
            return
        try:
            os.makedirs(dir_, exist_ok=True)
            with open(_path(dir_), "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            # an unwritable dir keeps this process's winners in memory
            _trace.instant("autotuneTableUnwritable", dir=dir_,
                           error=type(e).__name__)


# ---------------------------------------------------------------------------
# timing: CUDA events on the sweeping thread's stream, host walls on the CPU
# ---------------------------------------------------------------------------

def _launch_ms(fn: Callable[[], object], device: torch.device) -> float:
    """One warm launch, then the best of ``TIMED_LAUNCHES`` launches, each
    timed alone: CUDA events on the current stream on the card (the wait
    is on the stop event, not the device), a host wall on the CPU."""
    fn()
    best = float("inf")
    for _ in range(TIMED_LAUNCHES):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            # a spin holds the stream while the host enqueues the launch,
            # so the events time the kernel, not the enqueue
            torch.cuda._sleep(_SPIN_CYCLES)
            e0.record(stream)
            fn()
            e1.record(stream)
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

class _GroupbyProbe:
    """A synthetic batch at the bucket's capacity (one int64 key of 50
    values with 10% nulls, 3 add lanes, a min and a max lane), its numpy
    group-by, and a candidate's launch and check against it."""

    def __init__(self, conf, cap: int, device: torch.device):
        rng = np.random.RandomState(5)
        self.conf, self.cap, self.device = conf, cap, device
        keys = rng.randint(0, 50, size=cap).astype(np.int64)
        valid = rng.rand(cap) < 0.9
        add = rng.randint(-1000, 1000, size=(3, cap)).astype(np.int64)
        mn = rng.randint(-1000, 1000, size=(1, cap)).astype(np.int64)
        mx = rng.randint(-1000, 1000, size=(1, cap)).astype(np.int64)
        h = (keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             ^ np.uint64(0x5BD1E995)).view(np.int64)

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.ins = (on(keys[:, None]), on(h), on(valid), on(add), on(mn),
                    on(mx))
        rows = np.nonzero(valid)[0]
        self.want_keys, first, inv = np.unique(
            keys[rows], return_index=True, return_inverse=True)
        self.want_first = rows[first]
        g = len(self.want_keys)
        self.want_add = np.zeros((g, 3), np.int64)
        np.add.at(self.want_add, inv, add[:, rows].T)
        self.want_min = np.full(g, np.iinfo(np.int64).max)
        np.minimum.at(self.want_min, inv, mn[0, rows])
        self.want_max = np.full(g, np.iinfo(np.int64).min)
        np.maximum.at(self.want_max, inv, mx[0, rows])
        self.keys = keys

    def launch(self, params: dict):
        from spark_rapids_tpu_torch.kernels import groupby_hash as KG
        slots = KR.table_slots(self.conf, self.cap,
                               int(params.get("slotsMult", 1)))
        return KG.groupby_table(
            *self.ins, slots, block_rows=int(params.get("blockRows", 0)),
            lane_groups=int(params.get("laneGroups", 1)))

    def check(self, out) -> bool:
        owner, add_out, min_out, max_out, overflow = (
            t.cpu().numpy() for t in out)
        if overflow[0]:
            return False
        used = owner >= 0
        rows = owner[used].astype(np.int64)
        order = np.argsort(self.keys[rows], kind="stable")
        return (np.array_equal(self.keys[rows][order], self.want_keys)
                and np.array_equal(rows[order], self.want_first)
                and np.array_equal(add_out[used][order], self.want_add)
                and np.array_equal(min_out[used][order, 0], self.want_min)
                and np.array_equal(max_out[used][order, 0], self.want_max))


def _write_decode_corpus(path: str, n: int, seed: int = 11) -> None:
    """One Parquet row group of ``n`` rows at ``path`` whose columns take
    every page class of the device decode: PLAIN, dictionary,
    DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY and BYTE_STREAM_SPLIT
    pages, nulls (definition levels), booleans, decimal128 FLBA and
    strings."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.1
    words = np.array([f"w{i}-{'x' * (i % 7)}" for i in range(23)])
    table = pa.table({
        "i64": pa.array(rng.integers(-(1 << 40), 1 << 40, n), mask=nulls),
        "i32d": pa.array(rng.integers(0, 97, n).astype(np.int32)),
        "dlt": pa.array(np.cumsum(rng.integers(-5, 50, n)), mask=nulls),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
        "f64": pa.array(rng.standard_normal(n), mask=nulls),
        "dec": pa.array(rng.integers(-10**9, 10**9, n)).cast(
            pa.decimal128(25, 2)),
        "sd": pa.array(words[rng.integers(0, 23, n)], mask=nulls),
        "sp": pa.array(words[rng.integers(0, 23, n)]),
        "sdl": pa.array(words[rng.integers(0, 23, n)], mask=nulls),
        "b": pa.array(rng.integers(0, 2, n) > 0, mask=nulls),
    })
    pq.write_table(
        table, path, row_group_size=max(n, 1),
        use_dictionary=["i32d", "sd"], data_page_size=1 << 16,
        column_encoding={"i64": "PLAIN", "dlt": "DELTA_BINARY_PACKED",
                         "f32": "BYTE_STREAM_SPLIT", "f64": "PLAIN",
                         "dec": "PLAIN", "sp": "PLAIN",
                         "sdl": "DELTA_LENGTH_BYTE_ARRAY", "b": "PLAIN"})


class _DecodeProbe:
    """The synthetic row group of ``n = 3/4`` of the bucket's rows staged
    at the bucket's capacity on the device, the default launch's output,
    and a candidate's launch and byte-for-byte check against it."""

    def __init__(self, cap: int, device: torch.device):
        import tempfile

        import pyarrow.parquet as pq

        from spark_rapids_tpu_torch.columnar import transfer as X
        from spark_rapids_tpu_torch.io import device_decode as DD
        from spark_rapids_tpu_torch.io import readers as RD
        from spark_rapids_tpu_torch.io.arrow_convert import \
            arrow_schema_to_sql
        n = max(1, cap * 3 // 4)
        with tempfile.TemporaryDirectory(prefix="srt-autotune-") as d:
            path = os.path.join(d, "corpus.parquet")
            _write_decode_corpus(path, n)
            unit = RD.plan_scan_units("parquet", [(path, {})])[0]
            enc = DD.plan_unit_encoded(unit, arrow_schema_to_sql(
                pq.ParquetFile(path).schema_arrow))
        if enc is None:
            raise KR.KernelError("decodeFused autotune: the corpus has no "
                                 "device-decoded column")
        staged = X.prepare_encoded_upload(enc, cap)
        self.n, self.cap, self.layout = staged[2], staged[3], staged[6]
        self.device = device
        self.words = torch.from_numpy(staged[4]).to(device)
        self.extras = [torch.from_numpy(np.ascontiguousarray(e)).to(device)
                       for e in staged[5]]
        self.want = None

    def launch(self, params: dict):
        from spark_rapids_tpu_torch.kernels import decode_fused as DF
        active, outs = DF.decode_fused(
            self.layout, self.cap, self.n, self.words, self.extras,
            rows_per_thread=int(params.get("rowsPerThread", 0)))
        return (active,) + tuple(outs)

    def check(self, out) -> bool:
        got = [t.cpu() for t in out]
        if self.want is None:  # the default launch is the reference
            self.want = got
            return True
        return len(got) == len(self.want) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes()
            for a, b in zip(got, self.want))


_PROBE_TYPES = {"groupbyHash": lambda conf, cap, dev: _GroupbyProbe(
                    conf, cap, dev),
                "decodeFused": lambda conf, cap, dev: _DecodeProbe(cap, dev)}


def _run_candidate(probe, params: dict) -> Tuple[bool, float]:
    """Validate one candidate against its oracle and, when it passes,
    time its launch: ``(ok, ms)``. A launch the kernel refuses
    (``KernelError``) fails validation. Module-level so tests can put a
    deliberately broken candidate in and see it rejected."""
    try:
        ok = probe.check(probe.launch(params))
    except KR.KernelError:
        return False, 0.0
    if not ok:
        return False, 0.0
    return True, _launch_ms(lambda: probe.launch(params), probe.device)


def _sweep(conf, kernel: str, cap: int, device: torch.device, dir_: str,
           key: Tuple) -> Tuple[dict, bool]:
    from spark_rapids_tpu_torch.conf import KERNEL_AUTOTUNE_BUDGET_MS
    budget_ms = int(conf.get(KERNEL_AUTOTUNE_BUDGET_MS))
    with _LOCK:
        _COUNTERS["sweeps"] += 1
    t0_ns = time.perf_counter_ns()
    default_ms: Optional[float] = None
    best_params: dict = {}
    best_ms: Optional[float] = None
    log = {"kernel": kernel, "bucket": _bucket(cap), "device": key[2],
           "candidates": []}
    # the sweep's own stream: its launches, copies and event waits never
    # touch the stream of a query, nor a graph another thread captures
    stream = (torch.cuda.Stream(device) if device.type == "cuda" else None)
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        factory = _PROBE_TYPES.get(kernel)
        probe = factory(conf, cap, device) if factory else None
        # the budget bounds the candidates, not the oracle's set-up
        t0 = time.perf_counter()
        for params in _GRIDS.get(kernel, [{}]):
            # the default always runs (the baseline); later candidates
            # stop once the budget is spent: a partial sweep still
            # records, so the budget bounds the cost of a key
            if default_ms is not None and \
                    (time.perf_counter() - t0) * 1000.0 > budget_ms:
                break
            ok, ms = (_run_candidate(probe, params) if probe is not None
                      else (False, 0.0))
            log["candidates"].append({"params": dict(params), "ok": ok,
                                      "ms": ms if ok else None})
            if not ok:
                if not params:
                    raise KR.KernelError(
                        f"{kernel} autotune: the default launch failed "
                        f"its oracle at capacity {cap}")
                with _LOCK:
                    _COUNTERS["rejected"] += 1
                continue
            if not params:
                default_ms = ms
            if best_ms is None or ms < best_ms:
                best_params, best_ms = dict(params), ms
    applied = bool(best_params)
    _record(dir_, key, {
        "kernel": kernel, "bucket": _bucket(cap), "device": key[2],
        "params": best_params, "applied": applied,
        "defaultMs": default_ms, "bestMs": best_ms, "ts": time.time()})
    log.update(winner=best_params, applied=applied, defaultMs=default_ms,
               bestMs=best_ms,
               seconds=(time.perf_counter_ns() - t0_ns) / 1e9)
    with _LOCK:
        _SWEEP_LOG.append(log)
    qt = _trace._ACTIVE
    if qt is not None:
        qt.add("autotuneSweep", t0_ns, time.perf_counter_ns(),
               chip=device.index, kernel=kernel, bucket=_bucket(cap),
               candidates=len(log["candidates"]), applied=applied)
    return (dict(best_params), True) if applied else ({}, False)


def params_for(conf, kernel: str, cap: int,
               device=None) -> Tuple[dict, bool]:
    """Tuned launch parameters for one (kernel, capacity bucket) on
    ``device`` (default: the current CUDA card): ``(params, tuned)``.
    ``params == {}`` is the kernel's own launch; ``tuned`` is True only
    when a recorded winner is in force (the hotspots report flags the
    others ``(untuned)``). Never call it inside a CUDA graph capture: a
    miss may sweep."""
    if conf is None:
        return {}, False
    from spark_rapids_tpu_torch.conf import (KERNEL_AUTOTUNE_DIR,
                                             KERNEL_AUTOTUNE_ENABLED)
    from spark_rapids_tpu_torch.sql.session import resolve_device
    dir_ = str(conf.get(KERNEL_AUTOTUNE_DIR) or "")
    device = resolve_device(device)
    key = (kernel, _bucket(cap), device_kind(device))
    ent = _table(dir_).get(key)
    if ent is not None:
        with _LOCK:
            _COUNTERS["hits"] += 1
        if ent.get("applied") and ent.get("params"):
            return dict(ent["params"]), True
        return {}, False
    if not bool(conf.get(KERNEL_AUTOTUNE_ENABLED)):
        return {}, False
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise KR.KernelError(f"{kernel} autotune: a sweep inside a CUDA "
                             "graph capture; resolve params_for first")
    return _sweep(conf, kernel, cap, device, dir_, key)


def stats() -> Dict[str, int]:
    """JitCache-shaped snapshot (the Prometheus renderer reads the
    size/capacity/hits/misses/evictions/contention keys of every
    ``cache_stats()`` entry)."""
    with _LOCK:
        size = sum(len(t) for t in _TABLES.values())
        return {"size": size, "capacity": 4096,
                "hits": _COUNTERS["hits"],
                "misses": _COUNTERS["sweeps"],
                "evictions": 0, "contention": 0,
                "sweeps": _COUNTERS["sweeps"],
                "loaded": _COUNTERS["loaded"],
                "rejected": _COUNTERS["rejected"],
                "torn": _COUNTERS["torn"]}


def sweep_log() -> List[dict]:
    """Every sweep of this process since the last reset: its candidates
    (params, oracle outcome, launch ms), the winner and ``applied``."""
    with _LOCK:
        return [dict(e) for e in _SWEEP_LOG]


def reset_for_tests() -> None:
    """Drop the in-memory tables, counters and sweep log (a process
    restart: the next ``params_for`` loads the table from disk again)."""
    with _LOCK:
        _TABLES.clear()
        _SWEEP_LOG.clear()
        for k in _COUNTERS:
            _COUNTERS[k] = 0


JC.register_stats_provider("kernelAutotune", stats)
