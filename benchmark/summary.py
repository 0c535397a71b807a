"""Arithmetic the metric readers share: percentiles over every query of
the window, per-query means of the program's counters, and a kernel's
share of its memory roofline."""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, List, Optional

import parquet_data

HERE = os.path.dirname(os.path.abspath(__file__))


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile by linear interpolation between closest ranks
    (``statistics.quantiles``' inclusive method)."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def finished(run) -> list:
    """The window's queries that ended inside it, failed ones too: the
    latencies of a window."""
    return [q for q in run.window
            if q.t1 is not None and q.t1 <= run.t_close]


def traced(run) -> list:
    """The window's queries that ran wholly inside the device trace: what
    a kernel's share of its roofline counts the work of. A query in
    flight at either end of the trace is left out, so its traced kernels
    count as time with no bytes, and the share can only read low."""
    return [q for q in run.window
            if q.t1 is not None and q.error is None
            and (run.t_trace is None or run.t_trace <= q.t0)
            and (run.t_trace_end is None or q.t1 <= run.t_trace_end)]


def latency_quantile(run, q: float) -> Optional[float]:
    lat = [x.latency_s for x in finished(run)]
    return quantile(lat, q) if lat else None


def counter_ms_per_query(run, key: str) -> Optional[float]:
    """A program counter (ns) as milliseconds a window query: the entry's
    process-wide counter over the window where it has one, else the sum
    of what each query reported."""
    done = [q for q in run.window if q.t1 is not None]
    if not done:
        return None
    if key in run.counters_end and key in run.counters_start:
        total = run.counters_end[key] - run.counters_start[key]
    else:
        vals = [q.extras[key] for q in done if key in q.extras]
        if not vals:
            return None
        total = sum(vals)
    return total / 1e6 / len(done)


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        peaks = json.load(f)
    return peaks[kind]["hbm_bytes_per_s"] if kind in peaks else None


def column_widths(run, columns: Iterable[str]) -> float:
    """The logical bytes a row of ``columns`` (each found in whichever
    table of the configuration holds it); strings by the mean UTF-8
    length of the first 100,000 generated values."""
    total = 0.0
    for c in columns:
        for table, spec in run.config["tables"].items():
            types = dict(map(tuple, spec["columns"]))
            if c in types:
                total += parquet_data.spark_width(
                    types[c], run.data[table][c][:100_000])
                break
        else:
            raise KeyError(f"no table holds column {c!r}")
    return total


def roofline_pct(run, symbols: Iterable[str], logical_bytes: float
                 ) -> Optional[float]:
    """100 x (``logical_bytes`` at the card's HBM peak) / the device time
    of the kernels whose names hold one of ``symbols`` as a whole word;
    None without a trace, a known card or such a kernel."""
    dt = run.device_trace
    if dt is None:
        return None
    import torch
    peak = hbm_bytes_per_s(torch.cuda.get_device_name(0))
    pat = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
    kernel_s = sum(dt.op_seconds(lambda n: pat.search(n) is not None)
                   .values())
    if peak is None or kernel_s <= 0 or logical_bytes <= 0:
        return None
    return 100.0 * (logical_bytes / peak) / kernel_s
