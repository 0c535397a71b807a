"""The device's side of a traced run: torch.profiler's CUDA activity over
the window, reduced to busy time, idle gaps and time by operation, and
the idle gaps labelled by the program's host spans.

The profiler's device clock and the host's ``perf_counter_ns`` are tied
by two markers: a ``torch.cuda._sleep`` kernel launched on an idle card
right after a host timestamp, at the window's start and at its end. The
offset is the mean of the two (device start - host timestamp); a launch
on an idle card starts within microseconds, far below the gaps that are
labelled.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"
# gaps shorter than this are counted, but not labelled one by one
LABEL_MIN_NS = 50_000


class Capture:
    """``start()`` before the window, ``stop()`` inside or after it; then
    ``events()``: the device events in between as ``(start_ns,
    duration_ns, name)``."""

    def __init__(self):
        self.marks: List[int] = []
        self._prof = None
        self._results = None

    def _mark(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._prof.__exit__(None, None, None)
        self._results = self._prof.profiler.kineto_results
        self._prof = None

    def events(self) -> List[Tuple[int, int, str]]:
        """Read after the window: the reading costs host time."""
        from torch.autograd import DeviceType
        return sorted((e.start_ns(), e.duration_ns(), e.name())
                      for e in self._results.events()
                      if e.device_type() == DeviceType.CUDA)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class DeviceTrace:
    """The reduction of one capture: the window is from the first marker's
    start to the last marker's end, in the device clock."""

    def __init__(self, events: List[Tuple[int, int, str]],
                 marks: List[int]):
        spins = [e for e in events if MARKER in e[2]]
        if len(spins) < 2 or len(marks) < 2:
            raise RuntimeError("the device trace lacks its two markers: "
                               "the profiler saw no device activity")
        self.w0, self.w1 = spins[0][0], spins[-1][0] + spins[-1][1]
        self.offset = ((spins[0][0] - marks[0])
                       + (spins[-1][0] - marks[-1])) // 2
        self.ops = [(s, d, n) for s, d, n in events
                    if s >= self.w0 and s + d <= self.w1
                    and MARKER not in n]
        self.busy = union([(s, s + d) for s, d, _n in self.ops])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def op_seconds(self, match=None) -> Dict[str, float]:
        """Device seconds by operation name (those ``match`` accepts)."""
        out: Dict[str, float] = defaultdict(float)
        for _s, d, n in self.ops:
            if match is None or match(n):
                out[n] += d / 1e9
        return dict(out)

    def gaps(self) -> List[Tuple[int, int]]:
        out, t = [], self.w0
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def idle_by_host_span(self, spans) -> Dict[str, float]:
        """Idle seconds by what the host was doing: each gap of at least
        ``LABEL_MIN_NS`` is shared evenly among the innermost program
        spans open at its middle, one a thread (``(no span)`` where none
        is); the shorter gaps are summed under their own label."""
        lanes = _lanes(spans)
        out: Dict[str, float] = defaultdict(float)
        for a, b in self.gaps():
            if b - a < LABEL_MIN_NS:
                out[f"(gaps under {LABEL_MIN_NS // 1000} us)"] += \
                    (b - a) / 1e9
                continue
            mid = (a + b) // 2 - self.offset
            labels = [k for k in (_at(lane, mid) for lane in lanes) if k]
            for k in labels or ["(no span)"]:
                out[k] += (b - a) / 1e9 / max(1, len(labels))
        return dict(out)


def _lanes(spans) -> list:
    """Per thread, the innermost open span as non-overlapping segments
    ``(starts, ends, kinds)``; ``spans`` are the program's
    ``(kind, t0_ns, t1_ns, thread, ...)`` records."""
    by_thread: Dict[int, list] = defaultdict(list)
    for s in spans:
        if s[2] > s[1]:
            by_thread[s[3]].append((s[1], s[2], s[0]))
    lanes = []
    for recs in by_thread.values():
        recs.sort(key=lambda r: (r[0], -r[1]))
        segs: list = []
        stack: list = []
        pos = recs[0][0]

        def emit(a, b, k):
            if b > a:
                segs.append((a, b, k))
        for t0, t1, kind in recs:
            while stack and stack[-1][0] <= t0:
                end, k = stack.pop()
                emit(pos, end, k)
                pos = max(pos, end)
            if stack:
                emit(pos, t0, stack[-1][1])
            pos = t0
            stack.append((min(t1, stack[-1][0]) if stack else t1, kind))
        while stack:
            end, k = stack.pop()
            emit(pos, end, k)
            pos = max(pos, end)
        lanes.append(([a for a, _b, _k in segs], [b for _a, b, _k in segs],
                      [k for _a, _b, k in segs]))
    return lanes


def _at(lane, t: int) -> Optional[str]:
    starts, ends, kinds = lane
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t < ends[i]:
        return kinds[i]
    return None


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
