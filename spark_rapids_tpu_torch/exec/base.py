"""TorchExec base, the row/columnar transitions and the batch coalescer
(the counterparts of ``spark_rapids_tpu.exec.base``'s TpuExec,
TpuRowToColumnarExec, TpuColumnarToRowExec and TpuCoalesceBatchesExec).

Every TorchExec produces ``device_partitions()``: thunks yielding
``DeviceBatch``es on the exec's ``torch.device``, and owns a
``MetricRegistry`` as ``self.metrics``. A consumer reads a child through
``device_channel``, which counts each batch the child yields in its
``numOutputRows`` and ``numOutputBatches``. Partitions run one after another
on the device's current stream. An operator that holds batches across
yields registers them with the spill store (``register_spillable``).

The upload takes the device semaphore before its first device write
(``TorchColumnarToRowExec`` releases it when its partition ends or
fails) and runs under the retry protocol: an out-of-memory error while
issuing a copy or decoding recovers and retries, then degrades
(``_upload_degraded``: a HostBatch uploads in halves by rows). On a CUDA
device an EncodedBatch does not degrade: its row group is decoded by the
``decodeFused`` kernel or the error propagates, so the decode never moves
to the host. On the CPU it takes its host decode for that batch only,
counted in ``deviceDecodeOomFallbacks``, as the JAX package does. An OOM
while the ring issues a copy ahead
shrinks the ring: the older in-flight uploads complete first, then the
unit takes the synchronous protocol.

The mesh scan: while a mesh of two or more healthy chips is active the
upload hands a file scan the mesh's chips (``set_scan_mesh``); the scan
then returns one stream per chip (``partition_devices``), and each
stream's batches upload to that chip's device and carry its id
(``DeviceBatch.chip``). Each copy first passes the chip's dispatch
checkpoint (``retry.chip_checkpoint``): an injected or real chip failure
surfaces there as ``TorchChipFailure``, for the exchange's or the
collect's degrade loop.

Lifecycle checkpoints (``lifecycle.checkpoint``): each upload, each
batch the root transition downloads, and each wait on the upload ring's
queue; the ring's producer thread runs under the query's cancel token,
so a cancelled query stops at its next batch and its handles, permit
and producer are released on the way out.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import lifecycle as LC
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch import trace as _trace
from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    bucket_capacity,
                                                    concat_device)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import (METRICS_LEVEL,
                                         PARQUET_DEVICE_DECODE_MAX_IN_FLIGHT,
                                         TorchConf)
from spark_rapids_tpu_torch.resource import get_semaphore
from spark_rapids_tpu_torch.sql import physical as P

DevicePartitionThunk = Callable[[], Iterator[DeviceBatch]]


class TorchExec(P.PhysicalPlan):
    """Base of all device operators; rows reach the host only through
    the TorchColumnarToRowExec the rewrite puts on top."""

    def __init__(self, conf: TorchConf, device: torch.device):
        self.conf = conf
        self.device = device
        self.metrics = M.MetricRegistry(str(conf.get(METRICS_LEVEL)),
                                        owner=type(self).__name__)
        # created up front, so an operator that saw no rows reports 0
        self.metrics.create(M.NUM_OUTPUT_ROWS)
        self.metrics.create(M.NUM_OUTPUT_BATCHES)

    def device_partitions(self) -> List[DevicePartitionThunk]:
        raise NotImplementedError

    def register_spillable(self, store, batch: DeviceBatch):
        """Register a batch this operator holds across yields, with the
        operator as its owner (the store's per-operator ledger, this
        exec's ``peakDeviceMemory`` and ``spillBytes``)."""
        return store.register(batch, owner=type(self).__name__,
                              metrics=self.metrics)

    def counted_partitions(self) -> List[DevicePartitionThunk]:
        """``device_partitions`` with every yielded batch counted in
        ``numOutputRows`` and ``numOutputBatches``. A row count not yet
        known on the host is added as a device scalar and read back only
        when the metric is read, so counting never synchronises."""
        rows = self.metrics.create(M.NUM_OUTPUT_ROWS)
        batches = self.metrics.create(M.NUM_OUTPUT_BATCHES)

        def count(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    batches.add(1)
                    rows.add(b.row_count_lazy())
                    yield b
            return run
        return [count(t) for t in self.device_partitions()]


def device_channel(plan: P.PhysicalPlan) -> List[DevicePartitionThunk]:
    """A device child's partitions; anything else is a rewrite bug."""
    if not isinstance(plan, TorchExec):
        raise TypeError(
            f"device operator consuming non-device child "
            f"{plan.simple_string()}; the rewrite must insert "
            "TorchRowToColumnarExec")
    return plan.counted_partitions()


def _groups(batches: Iterator, goal_rows: int) -> Iterator:
    """The upload units of a partition: consecutive host batches
    coalesced up to ``goal_rows`` (as a list), and each EncodedBatch on
    its own, never coalesced, after the host batches pending before it."""
    from spark_rapids_tpu_torch.io.device_decode import EncodedBatch
    pending: List[HostBatch] = []
    rows = 0
    for b in batches:
        if isinstance(b, EncodedBatch):
            if pending:
                yield pending
                pending, rows = [], 0
            yield b
            continue
        if b.num_rows == 0:
            continue
        pending.append(b)
        rows += b.num_rows
        if rows >= goal_rows:
            yield pending
            pending, rows = [], 0
    if pending:
        yield pending


class TorchRowToColumnarExec(TorchExec):
    """CPU rows -> device batches. Coalesces consecutive host batches of
    a partition up to the goal row count and uploads each group through
    the packed codec (``columnar/transfer.py``). Its child is a host
    source or any operator the rewrite left on the CPU. Over a Parquet
    scan it also takes EncodedBatches (a row group's still-encoded pages)
    and decodes each on the device with ``decodeFused``.

    The upload ring (``spark.rapids.sql.format.parquet.deviceDecode.
    maxInFlight``, default 2): a producer thread reads, coalesces and
    packs each upload unit into a slot of a ``StagingRing`` (pinned host
    memory on a CUDA device) behind a bounded queue, while the task
    thread issues each unit's copy on the ring's copy stream up to
    ``depth`` units ahead of its decode. So batch k+1's bytes move while
    batch k decodes and computes, and batch k+2 is read and packed. At 1
    the producer thread runs without upload-ahead; at 0 everything runs
    on the task thread. With the key unset the ring runs only over a
    file scan partition of several units: a partition already in host
    memory has no read to overlap, and its packing holds the GIL
    against the task thread."""

    def __init__(self, child: P.PhysicalPlan, conf: TorchConf,
                 device: torch.device, goal_rows: Optional[int] = None):
        super().__init__(conf, device)
        self.children = [child]
        self.goal_rows = goal_rows or conf.batch_size_rows

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        # this transition is the scan's direct consumer: allow the scan to
        # hand it still-encoded Parquet pages (decided here, at execution
        # time, so no other consumer ever sees an EncodedBatch)
        if hasattr(self.child, "emit_encoded"):
            self.child.emit_encoded = True
        # the mesh scan handshake: one reader stream per chip, each
        # uploading to its own chip
        if hasattr(self.child, "set_scan_mesh"):
            from spark_rapids_tpu_torch.parallel.mesh import \
                mesh_scan_devices
            self.child.set_scan_mesh(mesh_scan_devices(self.conf))
        thunks = self.child.partitions()
        chips = list(getattr(self.child, "partition_devices", []))
        chips += [None] * (len(thunks) - len(chips))
        depths = self.ring_depths(len(thunks))

        def make(thunk: P.PartitionThunk, depth: int,
                 chip) -> DevicePartitionThunk:
            if depth <= 0:
                return lambda: self._run_sync(thunk, chip)
            return lambda: self._run_pipelined(thunk, depth, chip)
        return [make(t, d, c) for t, d, c in zip(thunks, depths, chips)]

    def _device_of(self, chip) -> torch.device:
        return self.device if chip is None else chip.device

    def ring_depths(self, n_parts: int) -> List[int]:
        """The upload ring's depth for each partition: the key's value
        where the session sets it, else its default over a file scan
        partition of more than one unit and 0 elsewhere."""
        depth = int(self.conf.get(PARQUET_DEVICE_DECODE_MAX_IN_FLIGHT))
        if self.conf.is_set(PARQUET_DEVICE_DECODE_MAX_IN_FLIGHT):
            return [depth] * n_parts
        units = getattr(self.child, "units_per_partition", None)
        if units is None:
            return [0] * n_parts
        return [depth if u > 1 else 0 for u in units()]

    def _run_sync(self, thunk: P.PartitionThunk,
                  chip=None) -> Iterator[DeviceBatch]:
        """maxInFlight 0: read, pack, copy and decode one unit at a time
        on the task thread."""
        from spark_rapids_tpu_torch.columnar.transfer import StagingRing
        ring = StagingRing(self._device_of(chip), 2)
        for unit in _groups(thunk(), self.goal_rows):
            yield from self._upload_sync(ring, *self._prepare(unit, ring),
                                         chip)

    def _run_pipelined(self, thunk: P.PartitionThunk, depth: int,
                       chip=None) -> Iterator[DeviceBatch]:
        """The producer thread and the upload-ahead ring. A producer
        error is raised on the task thread; a consumer that stops early
        (the generator closed) stops, drains and joins the producer."""
        from spark_rapids_tpu_torch.columnar.transfer import StagingRing
        # the producer holds at most one slot beside the queue's ``depth``
        ring = StagingRing(self._device_of(chip), depth + 2)
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        prefetch = self.metrics.create(M.SCAN_PREFETCH_TIME)

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            gen = thunk()
            try:
                for unit in _groups(gen, self.goal_rows):
                    if stop.is_set():
                        return
                    # mirrored as a scanPrefetch span, as in the JAX
                    # package (not the <owner>.<metric> mirror)
                    qt = _trace._ACTIVE
                    t0 = time.perf_counter_ns()
                    try:
                        prepared = self._prepare(unit, ring)
                    finally:
                        t1 = time.perf_counter_ns()
                        prefetch.add(t1 - t0)
                        if qt is not None:
                            qt.add("scanPrefetch", t0, t1,
                                   chip=ring.device.index)
                    if not put(("unit", prepared)):
                        return
                put(("done", None))
            except BaseException as e:  # raised again on the task thread
                put(("error", e))
            finally:
                # a closed consumer must not leave the scan mid-read: a
                # generator's close runs its cleanup
                if hasattr(gen, "close"):
                    gen.close()

        # the producer drains this partition's child for the task: where
        # the child is a host operator over a device subtree, the
        # transitions it crosses take and release the task's own permit
        task = get_semaphore(self.conf).current_task()
        # the query's cancel token follows the work onto the producer
        # thread (a thread-local cannot cross threads by itself)
        token = LC.current_token()

        def produce() -> None:
            with get_semaphore(self.conf).adopt(task), \
                    LC.token_scope(token):
                producer()

        def get_item():
            # a cancelled query must not park on the ring (the raise runs
            # the finally below, which stops and joins the producer)
            while True:
                try:
                    return q.get(timeout=LC.WAIT_SLICE_S)
                except queue.Empty:
                    LC.checkpoint("prefetch")

        t = threading.Thread(target=produce, daemon=True,
                             name="torch-upload-prefetch")
        t.start()
        inflight: List = []
        try:
            while True:
                kind, item = get_item()
                if kind == "done":
                    break
                if kind == "error":
                    raise item
                placed, src = item
                started = self._start_ahead(ring, placed, chip)
                if started is None:
                    # OOM issuing the copy ahead: shrink the ring (the
                    # older in-flight uploads complete and free their
                    # buffers), then the synchronous protocol
                    while inflight:
                        yield from self._finish(*inflight.pop(0), chip)
                    yield from self._upload_sync(ring, placed, src, chip)
                    continue
                inflight.append((started, src))
                self.metrics.create(M.UPLOAD_AHEAD_BATCHES).add(1)
                while len(inflight) >= depth:
                    yield from self._finish(*inflight.pop(0), chip)
            while inflight:
                yield from self._finish(*inflight.pop(0), chip)
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()

    def _prepare(self, unit, ring):
        """Stage one upload unit on the host and write it into a slot of
        ``ring``: ``(placed, source)``. The source (the HostBatch, or the
        EncodedBatch) rides along for the OOM fallback: at most one extra
        host reference per unit in flight."""
        from spark_rapids_tpu_torch.columnar.transfer import prepare_upload
        if isinstance(unit, list):
            whole = unit[0] if len(unit) == 1 else HostBatch.concat(unit)
        else:
            whole = unit  # an EncodedBatch stages as itself
        cap = bucket_capacity(max(1, whole.num_rows))
        with self.metrics.timed(M.PACK_TIME):
            return ring.place(prepare_upload(whole, cap, self.conf,
                                             ring.device)), whole

    def _start(self, ring, placed, chip=None):
        """Issue a placed unit's copy, counting it in
        ``pinnedStreamCopies`` when its slot is pinned and the copy runs
        on the ring's own stream, not the task's. The slot goes back to
        the ring only once the copy is issued. On the mesh scan the
        chip's dispatch checkpoint comes first."""
        get_semaphore(self.conf).acquire_if_necessary(self.metrics)
        if chip is not None:
            R.chip_checkpoint(self.conf, chip)
        started = ring.start(placed)
        if ring.cuda and placed.slot.buf.is_pinned() and \
                ring.stream != torch.cuda.current_stream(ring.device):
            self.metrics.create(M.PINNED_STREAM_COPIES).add(1)
        return started

    def _start_ahead(self, ring, placed, chip=None):
        """The ring's copy issued ahead of its decode (injection site
        ``upload``), or None on an out-of-memory error: the caller then
        shrinks the ring. Not retried here."""
        inj = R.get_fault_injector(self.conf)
        try:
            with _trace.span("uploadAhead", mode=placed.staged[0],
                             chip=(ring.device.index if chip is None
                                   else chip.id),
                             bytes=placed.nbytes):
                if inj is not None:
                    inj.on_alloc("upload")
                return self._start(ring, placed, chip)
        except Exception as e:
            if not R.is_oom_error(e):
                raise
            return None

    def _finish(self, started, src, chip=None) -> List[DeviceBatch]:
        """Decode a started upload under the retry protocol; when it runs
        out, the unit degrades (``_upload_degraded``). Each batch carries
        its stream's chip."""
        from spark_rapids_tpu_torch.columnar.transfer import finish_started
        # the per-upload cancellation point: the upload loop is the
        # highest-frequency batch loop of a plan
        LC.checkpoint("batch")
        try:
            with self.metrics.timed(M.COPY_TO_DEVICE_TIME):
                out = [R.with_retry(lambda: finish_started(started),
                                    self.conf, self.metrics,
                                    splittable=True)]
        except R.TorchRetryOOM:
            return self._upload_degraded(src, chip)
        if started.staged[0] == "encoded":
            KR.count_dispatch(self.metrics, "decodeFused")
            # the decode is one kernel a batch (the JAX package's XLA
            # chain bills its stage count here)
            self.metrics.create("deviceDecodePrograms").add(1)
        if chip is not None:
            for b in out:
                b.chip = chip.id
        return out

    def _upload_sync(self, ring, placed, src,
                     chip=None) -> List[DeviceBatch]:
        """The synchronous protocol: the copy issued under the retry
        protocol (injection site ``upload``; the slot stays this unit's
        until the copy is issued), then ``_finish``."""
        try:
            started = R.with_retry(lambda: self._start(ring, placed, chip),
                                   self.conf, self.metrics,
                                   splittable=True, site="upload")
        except R.TorchRetryOOM:
            ring.release(placed)
            return self._upload_degraded(src, chip)
        except R.TorchChipFailure:
            ring.release(placed)
            raise
        return self._finish(started, src, chip)

    def _upload_degraded(self, src, chip=None) -> List[DeviceBatch]:
        """OOM recovery for one upload unit: a HostBatch uploads in halves
        by rows, each half on its own (the consumer sees the halves in
        order, so rows do not change). An EncodedBatch on a CUDA device
        raises: swapping ``decodeFused`` for the pyarrow decode would move
        the row group's decode to the host. On the CPU, where the plain
        version decodes anyway, it takes the pyarrow host decode of its
        row group for this batch only, as the JAX package does. The
        replacement uploads keep the split-retry protocol, with injection
        suppressed."""
        from spark_rapids_tpu_torch.columnar.transfer import upload_batch
        from spark_rapids_tpu_torch.io.device_decode import EncodedBatch

        device = self._device_of(chip)

        def upload_host(hb: HostBatch) -> DeviceBatch:
            out = upload_batch(hb, bucket_capacity(max(1, hb.num_rows)),
                               device)
            if chip is not None:
                out.chip = chip.id
            return out

        if isinstance(src, EncodedBatch):
            if device.type != "cpu":
                raise R.TorchRetryOOM(
                    "out of memory decoding a row group on the device, "
                    "retries exhausted")
            if src.host_fallback is None:
                raise R.TorchRetryOOM(
                    "upload out of memory and the encoded batch has no "
                    "host decode attached")
            self.metrics.create(M.DEVICE_DECODE_OOM_FALLBACKS).add(1)
            with R.suppress_injection():
                hbs = [hb for hb in src.host_fallback() if hb.num_rows]
                return [d for hb in hbs
                        for d in R.with_split_retry(
                            hb, upload_host, self.conf, self.metrics,
                            split=R.split_host_batch)]
        return R.with_split_retry(src, upload_host, self.conf,
                                  self.metrics, split=R.split_host_batch,
                                  split_first=True)

    def simple_string(self):
        return "TorchRowToColumnar"


class TorchColumnarToRowExec(P.PhysicalPlan):
    """Device batches -> CPU rows, one batch ahead: batch k+1's
    compaction and copies into pinned host buffers are in flight on a
    copy stream while batch k converts on the host. It is the plan's root
    transition, or the child of an operator the rewrite left on the CPU,
    which reads it one partition at a time. There
    (``release_when_drained``) it closes its device subtree's store
    handles once every partition has been downloaded, so the device
    memory is free while the host operator works; the session closes any
    left at the query's end."""

    def __init__(self, child: TorchExec, conf: TorchConf,
                 release_when_drained: bool = False):
        self.children = [child]
        self.conf = conf
        self.metrics = M.MetricRegistry(str(conf.get(METRICS_LEVEL)),
                                        owner=type(self).__name__)
        self.release_when_drained = release_when_drained

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def partitions(self) -> List[P.PartitionThunk]:
        from spark_rapids_tpu_torch.columnar.device import (finish_to_host,
                                                            start_to_host)
        device = self.child.device

        def convert(tok) -> HostBatch:
            with self.metrics.timed(M.COPY_FROM_DEVICE_TIME):
                h = finish_to_host(tok)
            self.metrics.create(M.NUM_OUTPUT_ROWS).add(h.num_rows)
            return h

        sem = get_semaphore(self.conf)
        thunks = device_channel(self.child)
        left = [len(thunks)]
        lock = threading.Lock()

        def drained() -> None:
            with lock:
                left[0] -= 1
                done = left[0] == 0
            if done and self.release_when_drained:
                from spark_rapids_tpu_torch.memory import \
                    release_plan_handles
                release_plan_handles(self.child)

        def make(thunk: DevicePartitionThunk) -> P.PartitionThunk:
            def run() -> Iterator[HostBatch]:
                stream = torch.cuda.Stream(device) \
                    if device.type == "cuda" else None
                prev = None
                try:
                    for b in thunk():
                        LC.checkpoint("batch")
                        tok = start_to_host(b, stream)
                        if prev is not None:
                            yield convert(prev)
                        prev = tok
                    if prev is not None:
                        yield convert(prev)
                    drained()
                finally:
                    # the partition's device work is done or failed
                    sem.release_if_necessary()
            return run
        return [make(t) for t in thunks]

    def simple_string(self):
        return "TorchColumnarToRow"


class TorchCoalesceBatchesExec(TorchExec):
    """Concatenates small device batches up to the goal row count;
    ``require_single_batch`` makes one batch of the whole partition."""

    def __init__(self, child: TorchExec, conf: TorchConf,
                 device: torch.device, goal_rows: Optional[int] = None,
                 require_single_batch: bool = False):
        super().__init__(conf, device)
        self.children = [child]
        self.goal_rows = goal_rows or conf.batch_size_rows
        self.require_single_batch = require_single_batch

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                pending: List[DeviceBatch] = []
                rows = 0
                for b in thunk():
                    n = b.row_count()
                    if n == 0:
                        continue
                    pending.append(b)
                    rows += n
                    if not self.require_single_batch and \
                            rows >= self.goal_rows:
                        yield self._emit(pending)
                        pending, rows = [], 0
                if pending:
                    yield self._emit(pending)
            return run
        return [make(t) for t in device_channel(self.child)]

    def _emit(self, pending: List[DeviceBatch]) -> DeviceBatch:
        with self.metrics.timed(M.CONCAT_TIME):
            return concat_device(pending)

    def simple_string(self):
        goal = ("RequireSingleBatch" if self.require_single_batch
                else f"TargetSize({self.goal_rows})")
        return f"TorchCoalesceBatches {goal}"
