"""TorchShuffleExchangeExec and TorchBroadcastExchangeExec: in-process
device exchanges (the counterparts of ``spark_rapids_tpu.exec.exchange``'s
TpuShuffleExchangeExec and TpuBroadcastExchangeExec).

Hash partition ids are Spark's pmod(murmur3(keys, 42), n), hashed by the
murmur3 kernel on the card, so rows land in exactly the partitions CPU
Spark would use. Range partitioning ranks every row globally (an exact,
not sampled, equal-depth split) as the JAX package does. ``split_by_pid``
sorts a batch by partition id and slices each partition out at its own
capacity bucket. The exchange materializes once into a list per
partition, each piece retained in the spill store as a
``SpillableBatch`` (the exchange holds the whole dataset across yields);
an aborted materialization closes the handles it had registered. The
hash split runs under ``with_retry``. A range exchange stages its inputs
in the store while it ranks their keys; a spilled input comes back
compacted, so its partition ids are remapped (``realign_spilled_pids``).
A round-robin exchange (``repartition(n)`` without columns) deals each
batch's active rows over the partitions from a start that advances by
one a batch (``round_robin_pids``).

Adaptive execution (``adaptive.py``): every materialization records the
partitions' exact bytes and rows (``exchange_stats``, and the
``exchangeTotalBytes``, ``exchangeMaxPartitionBytes`` and
``exchangeMedianPartitionBytes`` metrics). An exchange whose consumer
takes any partition count (an aggregate or a sort sets
``allow_aqe_coalesce``) hands out adjacent partitions merged toward
``adaptive.targetPartitionBytes``, capped by the budget oracle's share
(``aqeCoalescedPartitions``).

Concurrent consumers and drains (``spark.rapids.sql.taskParallelism``),
as in the JAX package: the single-partition, hash and mesh paths drain
their child's partitions on that many pull threads (``_pull_split``),
each taking its device permit through this exchange's registry
(``semaphoreWaitTime``) and returning it when it ends, and each split
partition registered in the store on the pull thread the moment it
exists; results keep (input partition, batch) order, so no row moves.
The range and round-robin paths drain on one thread. Reduce tasks race
into ``_materialize``: it returns the caller's permit, then takes the
exchange's lock, so the child materializes once and every pull thread
can get a permit. At one task the drain runs on the calling thread,
which keeps its permit. A broadcast takes the permit first and its
build lock second, builds once and counts ``broadcastBuilds``; a
consumer that finds another building waits for it without a permit.

The mesh path (``spark.rapids.shuffle.mode=ici``, ``parallel/``): while a
mesh of two or more healthy chips is active, a hash exchange drains its
child's per-chip streams through ``_pull_split`` (on ``taskParallelism``
threads; emulated chips share one stage graph a shape, whose replays
``StageProgram.run`` orders across threads and streams), then
puts each batch in the slot of the chip it lives on (``batch_device``;
a stream whose batches carry no chip goes to slot ``stream % n``),
concatenates each slot on its chip and runs ``ici.mesh_exchange``
(``numIciExchanges``): partition ``p`` lands on chip ``p % n``. The
exchange takes ``collective_section`` once per attempt, inside
``with_retry``. A chip failure (``TorchChipFailure``, raised by the
per-chip checkpoints) demotes the chip and materializes again on the
surviving mesh (``retry.degrade_on_chip_failure``), down to the
in-process path. Adaptive coalescing and the adaptive join decisions
stay off on the mesh, as in the JAX package.

``spark.rapids.shuffle.mode=external``: every materialized partition is
downloaded, written as SRTB files into a fresh shared directory
(``parallel/external_shuffle.py``) and read back and uploaded
(``externalShuffleWriteTime``, ``externalShuffleReadTime``,
``externalShuffleBytes``).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.columnar.device import (
    DeviceBatch, bucket_capacity, concat_device, flatten_columns,
    rebuild_columns, sort_with_payload)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


def hash_partition_ids(exprs: List[E.Expression], batch: DeviceBatch,
                       num_partitions: int) -> torch.Tensor:
    """pmod(murmur3(keys, 42), n) per row — Spark HashPartitioning."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    key_cols = [X.dev_eval(e, ctx) for e in exprs]
    return H.partition_ids(key_cols, batch.capacity, num_partitions)


def round_robin_pids(active: torch.Tensor, start: int,
                     n: int) -> torch.Tensor:
    """Round-robin partition ids: the k-th active row of the batch goes
    to partition ``(k + start) mod n``."""
    rank = torch.cumsum(active.to(torch.int32), 0) - 1
    return torch.remainder(rank + start, n).to(torch.int32)


def range_key_columns(bound: List[E.Expression], batch: DeviceBatch):
    """The evaluated order-key columns of one batch."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    return [X.dev_eval(e, ctx) for e in bound]


def global_range_pids(order: List[E.SortOrder], keycols_per_batch,
                      actives: List[torch.Tensor], n: int
                      ) -> List[torch.Tensor]:
    """Equal-depth bucketing over the global sort-rank space; returns
    the per-batch partition-id tensors (the CPU engine's range
    assignment, same stable order)."""
    from spark_rapids_tpu_torch.columnar.device import DeviceStringColumn
    from spark_rapids_tpu_torch.ops import sort as S
    n_keys = len(keycols_per_batch[0])
    for ki in range(n_keys):
        cols = [kc[ki] for kc in keycols_per_batch]
        if isinstance(cols[0], DeviceStringColumn):
            cc = max(c.char_cap for c in cols)
            for bi, c in enumerate(cols):
                if c.char_cap < cc:
                    keycols_per_batch[bi][ki] = DeviceStringColumn(
                        c.dtype, torch.nn.functional.pad(
                            c.chars, (0, cc - c.char_cap)),
                        c.lengths, c.validity)
    keysets = []
    for kc in keycols_per_batch:
        subkeys = []
        for c, o in zip(kc, order):
            subkeys.extend(S.order_subkeys(c, o.ascending, o.nulls_first))
        keysets.append(subkeys)
    combined = [torch.cat([ks[i] for ks in keysets])
                for i in range(len(keysets[0]))]
    active = torch.cat(actives)
    _k, perm, _p = sort_with_payload([~active] + combined, [])
    ranks = torch.empty_like(perm)
    ranks[perm] = torch.arange(perm.shape[0], device=perm.device)
    total = torch.clamp(active.sum(), min=1)
    pids = torch.clamp((ranks * n) // total, max=n - 1).to(torch.int32)
    return list(torch.split(pids, [a.shape[0] for a in actives]))


def split_by_pid(batch: DeviceBatch, pids: torch.Tensor, n: int
                 ) -> List[Optional[DeviceBatch]]:
    """contiguousSplit: stable-sort rows by partition id (inactive rows
    sink), then slice each partition out at its own capacity bucket.
    One host sync (the counts) per input batch."""
    flat, spec = flatten_columns(batch.columns)
    key = torch.where(batch.active, pids, n).to(torch.int64)
    (sorted_key,), _order, sorted_flat = sort_with_payload([key], flat)
    counts = torch.bincount(sorted_key, minlength=n + 1)[:n].cpu().tolist()
    out: List[Optional[DeviceBatch]] = []
    off = 0
    for pid in range(n):
        cnt = int(counts[pid])
        if cnt == 0:
            out.append(None)
            continue
        cap = bucket_capacity(cnt)
        arrs = []
        for a in sorted_flat:
            part = a[off:off + cnt]
            if cap > cnt:
                part = torch.cat([part, torch.zeros(
                    (cap - cnt,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=a.device)])
            arrs.append(part)
        active = torch.arange(cap, device=batch.device) < cnt
        out.append(DeviceBatch(batch.schema, rebuild_columns(spec, arrs),
                               active, cnt))
        off += cnt
    return out


def hash_buckets(op: TorchExec, store, handles: List, bound_keys,
                 modulus: int) -> List[List]:
    """The planned out-of-core split (final aggregate, shuffled join):
    every handle's batch split into ``modulus`` spill-backed buckets by
    the exchange's murmur3 partition id of ``bound_keys``, registered by
    ``op``. Each input handle closes once split, so one source batch is
    on the card at a time."""
    buckets: List[List] = [[] for _ in range(modulus)]
    for h in handles:
        b = h.get()
        with op.metrics.timed(M.PARTITION_TIME):
            parts = R.with_retry(
                lambda b=b: split_by_pid(
                    b, hash_partition_ids(bound_keys, b, modulus), modulus),
                op.conf, op.metrics)
        KR.count_dispatch(op.metrics, "murmur3")
        h.close()
        for pid, part in enumerate(parts):
            if part is not None:
                buckets[pid].append(op.register_spillable(store, part))
    return buckets


def realign_spilled_pids(handle, pids: torch.Tensor, act: torch.Tensor):
    """``(batch, pids)``: re-promote a handle whose per-slot ``pids`` were
    computed against the registered layout. A spill round trip compacts
    the batch (active rows become a prefix, in order), so the pids are
    remapped through the same compaction. Shared by the range exchange
    and the out-of-core sort."""
    b = handle.get()
    if handle.ever_spilled or b.capacity != act.shape[0]:
        comp = torch.argsort((~act).to(torch.int8), stable=True)
        pids = pids[comp][:b.capacity]
    return b, pids


class TorchShuffleExchangeExec(TorchExec):
    def __init__(self, partitioning: P.Partitioning, child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.partitioning = partitioning
        self._cache: Optional[List[List[DeviceBatch]]] = None
        # reduce tasks race into _materialize under taskParallelism
        self._lock = threading.Lock()
        # set by the rewrite for consumers that take any partition count
        # (aggregate, sort): enables adaptive partition coalescing
        self.allow_aqe_coalesce = False
        # the realized per-partition sizes, captured at materialization
        self.exchange_stats = None

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def _task_threads(self) -> int:
        from spark_rapids_tpu_torch.conf import TASK_PARALLELISM
        return int(self.conf.get(TASK_PARALLELISM))

    def _pull_split(self, thunks: List[DevicePartitionThunk],
                    split_one) -> List[List]:
        """Drain the child's partitions, on ``taskParallelism`` threads
        when there are several, and split each batch with ``split_one``.
        The results keep (input partition, batch) order, so first and
        last stay deterministic. ``split_one`` registers whatever it
        keeps itself, so each piece is spillable the moment it exists,
        not after the whole child is drained."""
        n_threads = self._task_threads()
        if n_threads <= 1 or len(thunks) <= 1:
            # one thread: the drain keeps whatever permit this thread
            # holds
            return [[split_one(b) for b in t()] for t in thunks]
        from concurrent.futures import ThreadPoolExecutor

        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch.memory import (current_tenant,
                                                   tenant_scope)
        from spark_rapids_tpu_torch.resource import get_semaphore
        sem = get_semaphore(self.conf)
        token = LC.current_token()
        tenant = current_tenant()

        def pull(thunk: DevicePartitionThunk) -> list:
            try:
                with LC.token_scope(token), tenant_scope(tenant):
                    # the pull's permit wait is the exchange's, not the
                    # upload's it would otherwise be booked to
                    sem.acquire_if_necessary(self.metrics)
                    return [split_one(b) for b in thunk()]
            finally:
                # a pull thread never reaches a columnar-to-row
                # transition: it returns its permit here
                sem.release_if_necessary()

        # this thread may hold a permit from an earlier subtree: it goes
        # back before this thread waits on the pool, or the pull threads
        # could starve of permits
        sem.release_if_necessary()
        with ThreadPoolExecutor(min(n_threads, len(thunks)),
                                thread_name_prefix="torch-shuffle") as pool:
            return list(pool.map(pull, thunks))

    def _materialize(self) -> List[List]:
        """The partitions' handles, materialized once however many
        consumers race here; again after the session released them
        (``release_plan_handles``), should the plan run a second time."""
        from spark_rapids_tpu_torch.resource import release_current_thread
        if self._task_threads() > 1:
            # the caller's permit goes back before it waits on the lock:
            # were every task thread parked here holding one, the
            # materializing thread's pulls could never take a permit
            release_current_thread()
        with self._lock:
            if self._cache is not None and not any(
                    h.closed for part in self._cache for h in part):
                return self._cache
            with TR.span("exchangeMaterialize",
                         parts=self.partitioning.num_partitions):
                # a failed chip is demoted and the subtree runs again on
                # the surviving mesh, in-process once too few chips remain
                out = R.degrade_on_chip_failure(self._materialize_inner,
                                                self.metrics)
            from spark_rapids_tpu_torch.conf import SHUFFLE_MODE
            if str(self.conf.get(SHUFFLE_MODE)).lower() == "external":
                out = self._external_roundtrip(out)
            # the exchange statistics adaptive execution reads: exact
            # realized partition sizes, also kept as this node's metrics
            from spark_rapids_tpu_torch import adaptive as A
            self.exchange_stats = stats = A.capture_stats(out)
            self.metrics.create(M.EXCHANGE_TOTAL_BYTES).add(
                stats.total_bytes)
            self.metrics.create(M.EXCHANGE_MAX_PARTITION_BYTES).add(
                stats.max_bytes)
            self.metrics.create(M.EXCHANGE_MEDIAN_PARTITION_BYTES).add(
                stats.median_bytes)
            self._cache = out
            return out

    def _external_roundtrip(self, cache: List[List]) -> List[List]:
        """``shuffle.mode=external``: every partition downloaded, written
        as SRTB files into a fresh shared directory, and read back and
        uploaded (the host-staged transport's loopback)."""
        from spark_rapids_tpu_torch.columnar.transfer import upload_batch
        from spark_rapids_tpu_torch.conf import SHUFFLE_COMPRESSION_CODEC
        from spark_rapids_tpu_torch.memory import get_device_store
        from spark_rapids_tpu_torch.parallel import external_shuffle as XS
        codec = str(self.conf.get(SHUFFLE_COMPRESSION_CODEC))
        store = get_device_store(self.conf)
        sdir = XS.new_shuffle_dir()
        out: List[List] = []
        try:
            with TR.span("externalShuffle", parts=len(cache)):
                with self.metrics.timed("externalShuffleWriteTime"):
                    host_parts = []
                    for part in cache:
                        hbs = []
                        for h in part:
                            hbs.append(h.get().to_host())
                            h.close()
                        host_parts.append(hbs)
                    XS.write_map_output(sdir, "0", host_parts, codec)
                with self.metrics.timed("externalShuffleReadTime"):
                    for pid in range(len(cache)):
                        out.append([self.register_spillable(
                            store, R.with_retry(
                                lambda hb=hb: upload_batch(
                                    hb, bucket_capacity(max(1,
                                                            hb.num_rows)),
                                    self.device),
                                self.conf, self.metrics))
                            for hb in XS.read_partition(sdir, pid)])
            self.metrics.create("externalShuffleBytes").add(
                sum(os.path.getsize(os.path.join(sdir, f))
                    for f in os.listdir(sdir)))
        except BaseException:
            for part in cache + out:
                for h in part:
                    h.close()
            raise
        finally:
            shutil.rmtree(sdir, ignore_errors=True)
        return out

    def _materialize_inner(self) -> List[List]:
        from spark_rapids_tpu_torch.memory import get_device_store
        store = get_device_store(self.conf)
        p = self.partitioning
        n = p.num_partitions
        out: List[List] = [[] for _ in range(n)]

        def keep(pid: int, part: DeviceBatch) -> None:
            out[pid].append(self.register_spillable(store, part))

        mesh = isinstance(p, P.HashPartitioning) and self._mesh_eligible()
        # what the pull threads registered: closed with the rest if the
        # attempt aborts, whichever pull raised
        pulled: List = []

        def register(part: DeviceBatch):
            h = self.register_spillable(store, part)
            pulled.append(h)  # list.append is atomic under the GIL
            return h

        try:
            if isinstance(p, P.SinglePartitioning) or (n == 1 and not mesh):
                for per_part in self._pull_split(
                        device_channel(self.child),
                        lambda b: register(b) if b.row_count() else None):
                    out[0].extend(h for h in per_part if h is not None)
            elif mesh and self._materialize_mesh(p, n, keep):
                # False: the mesh lost chips to another thread's demotion
                # after the gate above, and the in-process branch runs
                pass
            elif isinstance(p, P.HashPartitioning):
                bound = P.bind_list(p.exprs, self.child.output)

                def split_one(b: DeviceBatch) -> list:
                    KR.count_dispatch(self.metrics, "murmur3")
                    # the split is pure over b: a retry re-runs it
                    with self.metrics.timed(M.PARTITION_TIME):
                        parts = R.with_retry(
                            lambda: split_by_pid(
                                b, hash_partition_ids(bound, b, n), n),
                            self.conf, self.metrics)
                    return [None if part is None else register(part)
                            for part in parts]

                for per_part in self._pull_split(device_channel(self.child),
                                                 split_one):
                    for handles in per_part:
                        for pid, h in enumerate(handles):
                            if h is not None:
                                out[pid].append(h)
            elif isinstance(p, P.RoundRobinPartitioning):
                start = 0
                for thunk in device_channel(self.child):
                    for b in thunk():
                        pids = round_robin_pids(b.active, start, n)
                        with self.metrics.timed(M.PARTITION_TIME):
                            parts = R.with_retry(
                                lambda b=b, pids=pids: split_by_pid(
                                    b, pids, n),
                                self.conf, self.metrics)
                        for pid, part in enumerate(parts):
                            if part is not None:
                                keep(pid, part)
                        start += 1
            elif isinstance(p, P.RangePartitioning):
                self._materialize_range(p, n, store, keep)
            else:
                raise NotImplementedError(
                    f"{type(p).__name__} is not ported yet to "
                    "spark_rapids_tpu_torch")
        except BaseException:
            # an aborted attempt leaves nothing registered in the store
            for h in pulled:
                h.close()
            for part in out:
                for h in part:
                    h.close()
            raise
        return out

    def _mesh_eligible(self) -> bool:
        """A mesh of two or more healthy chips is active (demoted chips
        shrink it; below two the in-process transport runs)."""
        from spark_rapids_tpu_torch.parallel.mesh import (healthy_mesh,
                                                          mesh_size)
        m = healthy_mesh()
        return m is not None and mesh_size(m) > 1

    def _materialize_mesh(self, p: P.HashPartitioning, n: int,
                          keep) -> bool:
        """The mesh path; False when fewer than two healthy chips remain
        (a concurrent demotion after the caller's gate)."""
        from spark_rapids_tpu_torch.columnar.device import batch_device
        from spark_rapids_tpu_torch.parallel.ici import mesh_exchange
        from spark_rapids_tpu_torch.parallel.mesh import (
            collective_section, healthy_mesh, mesh_size)
        mesh = healthy_mesh()
        if mesh is None or mesh_size(mesh) <= 1:
            return False
        n_dev = mesh_size(mesh)
        # the dispatch checkpoint of every chip before anything is
        # staged: a failed chip raises TorchChipFailure, and the degrade
        # loop in _materialize re-plans on the survivors
        for chip in mesh.chips:
            R.chip_checkpoint(self.conf, chip)
        bound = P.bind_list(p.exprs, self.child.output)
        # the per-chip streams drain on taskParallelism threads, so one
        # chip's host work overlaps another's work on the card
        drained = self._pull_split(device_channel(self.child), lambda b: b)
        with_dev = [(ti, b, batch_device(b))
                    for ti, per_part in enumerate(drained)
                    for b in per_part if b.row_count()]
        slot_of = {c.id: i for i, c in enumerate(mesh.chips)}
        resident = {d for _ti, _b, d in with_dev
                    if d is not None and d in slot_of}
        slots: List[List[DeviceBatch]] = [[] for _ in range(n_dev)]
        for ti, b, d in with_dev:
            if len(resident) >= 2 and d is not None and d in slot_of:
                slots[slot_of[d]].append(b)
            else:
                slots[ti % n_dev].append(b)
        schema = self.child.schema
        slot_batches = [concat_device(bs) if bs else
                        DeviceBatch.empty(schema, chip.device)
                        for bs, chip in zip(slots, mesh.chips)]
        del drained, with_dev, slots
        self.metrics.create("numIciExchanges").add(1)

        # the mutex per attempt, inside the retried thunk: the backoff
        # between attempts runs with it released, and partitionTime
        # never counts the wait for it
        def locked_exchange():
            with collective_section(self.conf), \
                    self.metrics.timed(M.PARTITION_TIME):
                for _chip in mesh.chips:
                    KR.count_dispatch(self.metrics, "murmur3")
                return mesh_exchange(slot_batches, bound, n, mesh,
                                     self.metrics)

        parts = R.with_retry(locked_exchange, self.conf, self.metrics)
        for pid, batches in enumerate(parts):
            for part in batches:
                keep(pid, part)
        return True

    def _materialize_range(self, p: P.RangePartitioning, n: int, store,
                           keep) -> None:
        """Two passes: the order keys of each batch are evaluated while
        the batch itself waits in the store, then all keys rank globally
        and each batch splits by its partition ids."""
        bound = P.bind_list([o.child for o in p.order], self.child.output)
        handles, keycols, actives = [], [], []
        try:
            for thunk in device_channel(self.child):
                for b in thunk():
                    if b.row_count() == 0:
                        continue
                    keycols.append(range_key_columns(bound, b))
                    actives.append(b.active)
                    handles.append(self.register_spillable(store, b))
            if not handles:
                return
            with self.metrics.timed(M.PARTITION_TIME):
                pids = R.with_retry(
                    lambda: global_range_pids(p.order, keycols, actives, n),
                    self.conf, self.metrics)
            for h, pid_t, act in zip(handles, pids, actives):
                b, pid_t = realign_spilled_pids(h, pid_t, act)
                with self.metrics.timed(M.PARTITION_TIME):
                    parts = R.with_retry(
                        lambda b=b, pid_t=pid_t: split_by_pid(b, pid_t, n),
                        self.conf, self.metrics)
                h.close()
                for pid, part in enumerate(parts):
                    if part is not None:
                        keep(pid, part)
        finally:
            for h in handles:
                h.close()

    def device_partitions(self) -> List[DevicePartitionThunk]:
        nparts = self.partitioning.num_partitions
        groups = [[i] for i in range(nparts)]
        if self._aqe_coalesce_eligible():
            groups = self._aqe_partition_groups(nparts)

        def make(pids: List[int]) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                mat = self._materialize()
                for pid in pids:
                    for h in mat[pid]:
                        yield h.get()
            return run
        return [make(g) for g in groups]

    def _aqe_coalesce_eligible(self) -> bool:
        from spark_rapids_tpu_torch import adaptive as A
        return (self.allow_aqe_coalesce
                and A.adaptive_enabled(self.conf)
                and not getattr(self.partitioning, "user_specified", False)
                and self.partitioning.num_partitions > 1
                and not self._mesh_eligible())

    def _aqe_partition_groups(self, nparts: int) -> List[List[int]]:
        """Adjacent materialized partitions merged toward
        ``adaptive.targetPartitionBytes`` (adjacency keeps a range
        partitioning's order). Only consumers that take any partition
        count opt in; a join's co-partitioned inputs never do. The sizes
        are the exchange statistics, so coalescing and skew detection
        weigh a partition alike. Under a device budget the target is
        capped at the budget oracle's operator share, so no consumer is
        handed a concatenation it could not hold."""
        from spark_rapids_tpu_torch import adaptive as A
        from spark_rapids_tpu_torch.memory import get_budget_oracle
        self._materialize()
        stats = self.exchange_stats
        target = A.target_partition_bytes(self.conf)
        oracle = get_budget_oracle(self.conf)
        if oracle.enabled:
            share = oracle.operator_share()
            if share < target:
                target = share
                self.metrics.create(M.BUDGET_PRESSURE_PEAK).set_max(
                    int(A.target_partition_bytes(self.conf) * 100
                        // max(1, share)))
        groups = A.coalesce_groups(stats.partition_bytes, target)
        if len(groups) < nparts:
            self.metrics.create(M.AQE_COALESCED_PARTITIONS).add(
                nparts - len(groups))
        return groups

    def simple_string(self):
        return f"TorchExchange {self.partitioning!r}"


class TorchBroadcastExchangeExec(TorchExec):
    """Device-resident broadcast: the build side concatenates on the card
    once (``concat_device`` compacts several batches to the bucket of
    their row count) and every consumer shares that one batch."""

    def __init__(self, child: TorchExec, conf: TorchConf,
                 device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self._lock = threading.Lock()
        self._built: Optional[DeviceBatch] = None

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def materialize_device(self) -> DeviceBatch:
        """The built batch, built once however many consumers ask
        (``broadcastBuilds`` counts the builds)."""
        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch.resource import (get_semaphore,
                                                     release_current_thread)
        sem = get_semaphore(self.conf)
        # the permit before the build lock, and never held while waiting
        # on it: a build whose subtree holds an exchange returns the
        # builder's permit and takes permits again for its pulls, which a
        # consumer parked on the lock with a permit would starve
        sem.acquire_if_necessary(self.metrics)
        while not self._lock.acquire(blocking=False):
            release_current_thread()
            while not self._lock.acquire(timeout=0.05):
                LC.checkpoint("broadcastBuild")
            self._lock.release()
            sem.acquire_if_necessary(self.metrics)
        try:
            if self._built is None:
                self.metrics.create("broadcastBuilds").add(1)
                try:
                    batches = [b for t in device_channel(self.child)
                               for b in t() if b._num_rows != 0]
                except BaseException:
                    # a build that fails returns the permit it took
                    release_current_thread()
                    raise
                self._built = (concat_device(batches) if batches else
                               DeviceBatch.empty(self.child.schema,
                                                 self.device))
            return self._built
        finally:
            self._lock.release()

    def device_partitions(self) -> List[DevicePartitionThunk]:
        return [lambda: iter([self.materialize_device()])]

    def simple_string(self):
        return "TorchBroadcastExchange"
