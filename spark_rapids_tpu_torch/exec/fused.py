"""TorchFusedStageExec: whole-stage fusion of linear Torch*Exec chains (the
counterpart of ``spark_rapids_tpu.exec.fused``).

After the plan rewrite, ``fuse_stages`` collapses every maximal linear
chain of per-batch, shape-preserving operators —

    TorchFilterExec -> TorchProjectExec -> [partial TorchHashAggregateExec]

(and filter/project chains feeding sort/TopN/join build sides) — into ONE
``TorchFusedStageExec``, grouped as the JAX package groups them. The
chain runs as one stage program per batch (``run_program``), built once
per (chain structure, input shapes) and kept in a bounded LRU:

- On a CUDA device the program is captured once as a CUDA graph and then
  replayed, one ``cudaGraphLaunch`` a batch, where the unfused chain
  launches each operator's kernels one by one. Before the capture the
  program runs once eagerly on a side stream (that first run loads each
  kernel library's module and sets up sort and scan workspaces; its
  result is exact and is the first batch's output). A capture that fails
  raises: nothing falls back to eager execution.
- On the CPU the same composed function runs eagerly: it is the stage's
  plain version, and the cache counts its hits and misses alike.

A graph reads its inputs from static buffers and writes its outputs into
its private memory pool, so each replay first copies the batch into the
static inputs, and every output is copied out after it (an output that
is an input, like a filter's pass-through columns, is the batch's own
tensor): a consumer that holds every batch of a partition — the partial
aggregate's drain, a broadcast build, a sort — never sees a later replay
overwrite an earlier batch. Task threads (``taskParallelism``) and the
chips of an emulated mesh share one graph a key; whatever stream each
enqueues on, a run waits on the card for the previous run's copies out
(a CUDA event recorded after them) before it writes the static inputs,
so the lock orders the card's work and not only the host's enqueues.
A stage's literal tensors are built once for each device a batch
arrives on (``DeviceLiterals``): a batch on a second card meets its
literals there.

When the chain's top is a partial aggregate, the aggregate absorbs the
filter/project prelude into its own per-batch program
(``TorchHashAggregateExec.absorb_prelude``) and this node delegates
execution to it: either way the plan shows ONE fused node whose output
is the chain top's output.

Metrics: per-operator counts still report under each constituent exec
(each op's ``numOutputRows`` from the program's own per-step counts, and
``numOutputBatches``), plus ``fusedOps``, ``dispatchCount``,
``stageCompileTime`` (a new program's warm-up and capture wall) and the
cache's ``compileCacheHits``/``compileCacheMisses``. JAX's buffer
donation has no counterpart here: where the JAX package donates the
buffers of a fresh source's batches (the upload, the range), a graph
copies each batch into its static inputs, and an eager program frees
them when the batch is dropped. A range source fuses as the upload
does, so a range query fuses the stages the JAX package fuses.

Memory: each batch of a chain runs under ``with_split_retry`` (as the
JAX package's ``run_one`` does): an out-of-memory error in the warm-up,
the capture or a replay recovers and retries, then splits the batch in
half by rows; each half lands in a smaller capacity bucket, so it gets
its own key and capture. A build that fails caches nothing
(``JitCache.get_or_build``), and a failed capture releases its graph and
private pool before the error propagates. Each program records the
bytes its capture reserved (``pool_bytes``); the retry protocol's
recovery releases least-recently-used programs first
(``release_stage_programs``), since a cached graph holds memory that no
spill can free.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    flatten_columns,
                                                    rebuild_columns)
from spark_rapids_tpu_torch.conf import STAGE_FUSION_MAX_IN_FLIGHT, TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.exec.basic import TorchFilterExec, TorchProjectExec
from spark_rapids_tpu_torch.jit_cache import (JitCache, mirror_to_metrics,
                                             release_values)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.parallel.mesh import record_chip_dispatch
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P

STAGE_CACHE = JitCache("fusedStage")
# graphs captured and replayed since the last reset_graph_counts(), and
# the host nanoseconds spent in the replay calls (the graph launches)
GRAPH_COUNTS: Dict[str, int] = {"captures": 0, "replays": 0,
                                "replay_host_ns": 0}
# guards GRAPH_COUNTS: several query threads capture and replay at once
_GRAPH_COUNT_LOCK = threading.Lock()
# per thread and device: the side stream a program warms up and is
# captured on (a stream cannot hold two captures at once)
_SIDE = threading.local()

# fn(flat inputs) -> (flat outputs, host-side description of the outputs)
ProgramFn = Callable[[List[torch.Tensor]], Tuple[List[torch.Tensor], object]]


def reset_graph_counts() -> None:
    with _GRAPH_COUNT_LOCK:
        for k in GRAPH_COUNTS:
            GRAPH_COUNTS[k] = 0


def _bump_graph_counts(**deltas: int) -> None:
    with _GRAPH_COUNT_LOCK:
        for k, v in deltas.items():
            GRAPH_COUNTS[k] += v


def _side_stream(device: torch.device):
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device)
    return s


def _unique(flat: Sequence[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], List[int]]:
    """The distinct tensors of ``flat`` (by identity) and each position's
    index among them."""
    index: Dict[int, int] = {}
    uniq: List[torch.Tensor] = []
    pos: List[int] = []
    for t in flat:
        j = index.get(id(t))
        if j is None:
            j = index[id(t)] = len(uniq)
            uniq.append(t)
        pos.append(j)
    return uniq, pos


def input_signature(flat: Sequence[torch.Tensor]) -> Tuple:
    """What a program's key must hold beyond its structure: every input's
    shape and dtype (a capacity bucket, a string column's char cap, a
    64-bit or two-limb decimal), which inputs are one tensor (a program
    may read one tensor once for two columns), and the device. A CUDA
    graph replayed over other shapes would read past its buffers."""
    _uniq, pos = _unique(flat)
    return (str(flat[0].device),) + tuple(
        (tuple(t.shape), t.dtype, j) for t, j in zip(flat, pos))


class StageProgram:
    """One stage program: on a CUDA device a captured CUDA graph with its
    static input buffers; on the CPU the composed function itself."""

    def __init__(self, fn: ProgramFn):
        self.fn = fn
        self.graph = None
        self.kernels: List[str] = []  # kernel launches inside the graph
        self.meta = None
        self._static_in: List[torch.Tensor] = []
        self._static_out: List[torch.Tensor] = []
        self._out_from_input: List[Optional[int]] = []
        # device bytes the capture reserved: its static inputs and the
        # graph's private pool (0 on the CPU)
        self.pool_bytes = 0
        self._lock = threading.Lock()
        # recorded after the last run's copies out, on its stream: the
        # next run, on any stream, waits on it before it writes the
        # static inputs (None until the first replay)
        self._done: Optional[torch.cuda.Event] = None

    @classmethod
    def build(cls, fn: ProgramFn, flat_in: List[torch.Tensor]):
        """``(program, first outputs)``: the first run of ``fn`` over
        ``flat_in`` and, on a CUDA device, its capture."""
        prog = cls(fn)
        device = flat_in[0].device
        if device.type != "cuda":
            return prog, fn(flat_in)
        cur = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs, meta = fn(flat_in)
        side.synchronize()
        for t in outs:
            t.record_stream(cur)
        before = torch.cuda.memory_reserved(device)
        prog._capture(flat_in, side)
        prog.pool_bytes = max(0, torch.cuda.memory_reserved(device) - before)
        return prog, (outs, meta)

    def _capture(self, flat_in: List[torch.Tensor], side) -> None:
        uniq, pos = _unique(flat_in)
        self._static_in = [torch.empty(t.shape, dtype=t.dtype,
                                       device=t.device) for t in uniq]
        graph = torch.cuda.CUDAGraph()
        # thread_local: the upload ring's producer thread may allocate and
        # copy on its own stream while this thread captures
        with KR.recording_launches() as names, torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs, meta = self.fn([self._static_in[j] for j in pos])
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the original error is the one to report
                # leave nothing behind: the half-captured graph and its
                # private pool, and the static inputs
                try:
                    graph.reset()
                except RuntimeError:
                    pass
                self._static_in = []
                raise
            graph.capture_end()
        _bump_graph_counts(captures=1)
        self.graph = graph
        self.kernels = list(names)
        self.meta = meta
        self._static_out = list(outs)
        ids = {id(t): j for j, t in enumerate(self._static_in)}
        self._out_from_input = [ids.get(id(t)) for t in outs]

    def run(self, flat_in: List[torch.Tensor]):
        """``(flat outputs, meta)`` of one batch: a replay on the card (the
        outputs copied out of the graph's pool), the function on the
        CPU."""
        if self.fn is None:
            raise RuntimeError("stage program was released")
        if self.graph is None:
            return self.fn(flat_in)
        uniq, _pos = _unique(flat_in)
        with self._lock:
            cur = torch.cuda.current_stream(self._static_in[0].device)
            if self._done is not None:
                # the previous run may be on another stream, still
                # reading the static inputs or the graph's outputs
                cur.wait_event(self._done)
            for s, t in zip(self._static_in, uniq):
                s.copy_(t)
            t0 = time.perf_counter_ns()
            self.graph.replay()
            _bump_graph_counts(replay_host_ns=time.perf_counter_ns() - t0,
                               replays=1)
            KR.count_replay(self.kernels)
            copied: Dict[int, torch.Tensor] = {}
            outs = []
            for o, j in zip(self._static_out, self._out_from_input):
                if j is not None:
                    outs.append(uniq[j])
                    continue
                c = copied.get(id(o))
                if c is None:
                    c = copied[id(o)] = o.clone()
                outs.append(c)
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(cur)
        return outs, self.meta

    def release(self) -> None:
        """Drop the graph and its buffers, so its memory pool is freed,
        once the card has finished the last run: the static buffers go
        back to the allocator of the stream that made them, which does
        not know the run's stream."""
        with self._lock:
            if self._done is not None:
                self._done.synchronize()
            if self.graph is not None:
                self.graph.reset()
            self.graph = None
            self.fn = None
            self._static_in, self._static_out = [], []


def run_program(key, fn: ProgramFn, flat_in: List[torch.Tensor],
                metrics: M.MetricRegistry):
    """Run one stage program over ``flat_in``: built (warmed up and
    captured) on the first call for ``key`` and the inputs' signature,
    replayed after. ``fn`` must depend on nothing but its inputs and what
    ``key`` names. Counts ``dispatchCount``, the cache outcome and, for a
    new program, ``stageCompileTime``. With tracing on, the dispatch is
    one ``<owner>.dispatch`` span (``TorchFusedStageExec.dispatch`` or
    ``TorchHashAggregateExec.dispatch``): a replay's span carries the
    kernels its graph launched (``kernels=``), which pass through no
    wrapper and so take no ``kernelDispatch`` span of their own."""
    first = []

    def build():
        prog, out = StageProgram.build(fn, flat_in)
        first.append(out)
        return prog

    qt = TR._ACTIVE
    t0 = time.perf_counter_ns()
    prog, was_miss = STAGE_CACHE.get_or_build(
        (key, input_signature(flat_in)), build)
    out = first[0] if was_miss else prog.run(flat_in)
    if qt is not None:
        attrs = {"compile": bool(was_miss)}
        if not was_miss and prog.graph is not None and prog.kernels:
            attrs["kernels"] = list(prog.kernels)
        dev = flat_in[0].device if flat_in else None
        qt.add(f"{metrics.owner}.dispatch", t0, time.perf_counter_ns(),
               chip=dev.index if dev is not None and dev.type == "cuda"
               else None, **attrs)
    mirror_to_metrics(metrics, was_miss)
    metrics.create(M.DISPATCH_COUNT).add(1)
    if was_miss:
        metrics.create(M.STAGE_COMPILE_TIME).add(
            time.perf_counter_ns() - t0)
    return out


def release_stage_programs(everything: bool) -> int:
    """Release the least recently used half of the cached stage programs
    (rounded down: a lone program stays) or, when ``everything``, all of
    them, freeing their graphs' pools; returns the bytes their captures
    had reserved."""
    n = len(STAGE_CACHE) if everything else len(STAGE_CACHE) // 2
    if n == 0:
        return 0
    progs = STAGE_CACHE.pop_lru(n)
    freed = sum(p.pool_bytes for p in progs)
    release_values(progs)
    return freed


def flatten_literals(lits: Sequence[Sequence[Tuple[torch.Tensor, ...]]]
                     ) -> Tuple[List[torch.Tensor], Tuple]:
    """Groups of per-literal tensor tuples -> flat tensors and a layout
    (part of a program's key)."""
    flat = [t for group in lits for ts in group for t in ts]
    layout = tuple(tuple(len(ts) for ts in group) for group in lits)
    return flat, layout


def unflatten_literals(flat: Sequence[torch.Tensor], layout: Tuple
                       ) -> List[List[Tuple[torch.Tensor, ...]]]:
    out, i = [], 0
    for group in layout:
        g = []
        for n in group:
            g.append(tuple(flat[i:i + n]))
            i += n
        out.append(g)
    return out


class DeviceLiterals:
    """One execution's literal tensors, flattened, built once for each
    torch device a batch arrives on; ``layout`` (part of a program's key)
    does not depend on the device. Built first on ``device`` (the
    session's), so on one card, and on chips emulated on it, there is one
    entry, as before."""

    def __init__(self, groups_on: Callable[[torch.device], Sequence],
                 device: torch.device):
        self._groups_on = groups_on
        flat, self.layout = flatten_literals(groups_on(device))
        self._by_device: Dict[torch.device, List[torch.Tensor]] = {
            device: flat}
        self._lock = threading.Lock()

    def on(self, device: torch.device) -> List[torch.Tensor]:
        """The flat literal tensors on ``device``."""
        flat = self._by_device.get(device)
        if flat is not None:
            return flat
        with self._lock:
            flat = self._by_device.get(device)
            if flat is None:
                flat = self._by_device[device] = flatten_literals(
                    self._groups_on(device))[0]
            return flat


def bind_chain_steps(ops: List[TorchExec]) -> Tuple:
    """Bound ``(kind, exprs)`` steps for a filter/project chain. Each op
    still holds its original child link, so binding is identical to what
    the unfused operators do."""
    steps = []
    for op in ops:
        if isinstance(op, TorchFilterExec):
            steps.append(("filter", (E.bind_references(
                op.condition, op.child.output),)))
        elif isinstance(op, TorchProjectExec):
            steps.append(("project", tuple(P.bind_list(
                op.project_list, op.child.output))))
        else:
            raise TypeError(f"not a fusible chain op: {op!r}")
    return tuple(steps)


def count_steps(ops: Sequence[TorchExec], counts: Sequence) -> None:
    """Fan one batch's per-step row counts back to the chain's ops."""
    for op, n in zip(ops, counts):
        op.metrics.create(M.NUM_OUTPUT_ROWS).add(n)
        op.metrics.create(M.NUM_OUTPUT_BATCHES).add(1)


def _chain_program(steps, spec, layout, device) -> ProgramFn:
    stage = X.build_stage_fn(steps, device)
    n = sum(arity for _dt, arity in spec)

    def fn(flat):
        cols = rebuild_columns(spec, flat[:n])
        lits = unflatten_literals(flat[n + 1:], layout)
        cols, active, counts = stage(cols, flat[n], lits)
        out, ospec = flatten_columns(cols)
        return out + [active] + counts, ospec
    return fn


class TorchFusedStageExec(TorchExec):
    """One stage program for a linear operator chain.

    ``ops`` is the chain bottom-up (closest to the source first); the last
    entry may be a partial-mode TorchHashAggregateExec, which then absorbs
    the filter/project prelude and runs the stage itself."""

    def __init__(self, ops: List[TorchExec], child: TorchExec,
                 conf: TorchConf):
        from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
        super().__init__(conf, child.device)
        self.children = [child]
        self.fused_ops = list(ops)
        self.sink_agg: Optional[TorchHashAggregateExec] = None
        if isinstance(ops[-1], TorchHashAggregateExec):
            self.sink_agg = ops[-1]
            self.sink_agg.absorb_prelude(ops[:-1], child)
        self.metrics.create(M.FUSED_OPS).add(len(ops))

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.fused_ops[-1].output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        if self.sink_agg is None:
            return self._chain_partitions()
        agg = self.sink_agg

        def count(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    count_steps([agg], [b.row_count_lazy()])
                    yield b
            return run
        return [count(t) for t in agg.device_partitions()]

    def _chain_partitions(self) -> List[DevicePartitionThunk]:
        steps = bind_chain_steps(self.fused_ops)
        skey = X.stage_structural_key(steps)
        lits = DeviceLiterals(
            lambda d: X.stage_literal_values(steps, d), self.device)
        layout = lits.layout
        schema = self.schema
        has_filter = any(k == "filter" for k, _ in steps)
        window_n = max(1, int(self.conf.get(STAGE_FUSION_MAX_IN_FLIGHT)))
        metrics, ops = self.metrics, self.fused_ops

        def run_one(b: DeviceBatch) -> DeviceBatch:
            flat, spec = flatten_columns(b.columns)
            key = ("chain", skey, tuple((repr(dt), a) for dt, a in spec),
                   layout)
            # the stage cache's key holds the input's torch device: chips
            # emulated on one device share a graph, cards do not
            record_chip_dispatch(metrics, b)
            outs, ospec = run_program(
                key, _chain_program(steps, spec, layout, b.device),
                flat + [b.active] + lits.on(b.device), metrics)
            n = sum(a for _dt, a in ospec)
            counts = outs[n + 1:]
            count_steps(ops, counts)
            if has_filter:
                return DeviceBatch(schema, rebuild_columns(ospec, outs[:n]),
                                   outs[n], None, counts[-1], b.chip)
            return DeviceBatch(schema, rebuild_columns(ospec, outs[:n]),
                               outs[n], b._num_rows, b._num_rows_dev, b.chip)

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                # dispatch up to window_n batches ahead of the consumer;
                # the deque bounds the device memory they hold
                window: deque = deque()
                for b in thunk():
                    # an OOM retries, then splits the batch by rows: the
                    # pieces' outputs follow in row order
                    window.extend(R.with_split_retry(
                        b, run_one, self.conf, metrics))
                    while len(window) >= window_n:
                        yield window.popleft()
                while window:
                    yield window.popleft()
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        names = "+".join(op.simple_string().split()[0]
                         for op in self.fused_ops)
        return f"TorchFusedStage [{names}]"

    def tree_string(self, indent: int = 0) -> str:
        s = " " * indent + self.simple_string()
        for op in self.fused_ops:
            s += "\n" + " " * (indent + 2) + ": " + op.simple_string()
        for c in self.children:
            s += "\n" + c.tree_string(indent + 2)
        return s


# ---------------------------------------------------------------------------
# The fusion pass (runs at the end of apply_overrides)
# ---------------------------------------------------------------------------

def _fusible_chain_op(op) -> bool:
    """Per-batch, shape-preserving ops that may join a chain.
    Partition-context expressions carry per-partition state a stage
    program does not thread through, and an ANSI cast's errors are read
    by the unfused operator after its batch, as in the JAX package."""
    if isinstance(op, TorchFilterExec):
        exprs = [op.condition]
    elif isinstance(op, TorchProjectExec):
        exprs = list(op.project_list)
    else:
        return False
    return not X._needs_part_ctx(exprs) and not any(
        X.contains_ansi_cast(e) for e in exprs)


def _collect_chain(top) -> Tuple[List, Optional[TorchExec]]:
    """Maximal fusible chain starting at ``top`` going down the tree;
    returns (ops bottom-up, source). It never crosses anything that is
    not a fusible per-batch op (exchanges, transitions, coalesce,
    aggregates), so a stage cannot span a shuffle or a host boundary."""
    chain: List = []
    cur = top
    while _fusible_chain_op(cur):
        chain.append(cur)
        cur = cur.children[0]
    chain.reverse()
    return chain, (cur if chain else None)


def _agg_absorbable(agg) -> bool:
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    return (isinstance(agg, TorchHashAggregateExec)
            and agg.mode == "partial" and agg._prelude_ops is None)


def fuse_stages(plan: P.PhysicalPlan, conf: TorchConf) -> P.PhysicalPlan:
    """Top-down rewrite: each node first claims the maximal chain hanging
    below it (so inner sub-chains are never fused separately), then the
    recursion continues under the fused stage's source."""
    fused = _try_fuse(plan, conf)
    fused.children = [fuse_stages(c, conf) for c in fused.children]
    return fused


def _try_fuse(plan, conf):
    if _agg_absorbable(plan):
        chain, source = _collect_chain(plan.children[0])
        if chain:
            return TorchFusedStageExec(chain + [plan], source, conf)
        return plan
    if isinstance(plan, (TorchFilterExec, TorchProjectExec)):
        chain, source = _collect_chain(plan)
        # fusing a single op would just re-wrap its one program
        if len(chain) >= 2:
            return TorchFusedStageExec(chain, source, conf)
    return plan
