"""TorchSortExec / TorchTopNExec: per-partition device sort (the
counterparts of ``spark_rapids_tpu.exec.sort``'s TpuSortExec and
TpuTopNExec).

A partition's batches wait in the spill store with only their order keys
evaluated. A partition of at most ``batchSizeRows`` rows (or of one
batch) concatenates and sorts in one pass. A larger one takes the
out-of-core path (GpuOutOfCoreSortIterator, as the JAX package has it):
exact global ranks over the resident keys split every batch into
rank-contiguous sub-ranges of at most ``batchSizeRows`` rows, each
sub-range waits in the store, then is concatenated, sorted and emitted
in order, so the partition is never whole on the card; stable rank
splitting keeps the rows identical to one stable sort. TopN sorts the
concatenated partition and keeps the first n rows through the active
mask. Every sort runs under ``with_retry`` (a sort does not split by
rows: the out-of-core path is its split).
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (
    DeviceBatch, concat_device, mask_col, take_columns)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


def sorted_batch(order: List[E.SortOrder], bound: List[E.Expression],
                 batch: DeviceBatch, limit: int = -1) -> DeviceBatch:
    """Sort one device batch by `order` (keys pre-bound); the sorted
    rows form a prefix, cut to the first `limit` rows when it is >= 0."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    key_cols = [X.dev_eval(e, ctx) for e in bound]
    perm = S.sort_permutation(key_cols, order, batch.active)
    n = batch.row_count()
    if limit >= 0:
        n = min(n, limit)
    new_active = torch.arange(batch.capacity, device=batch.device) < n
    cols = [mask_col(c, new_active)
            for c in take_columns(batch.columns, perm)]
    return DeviceBatch(batch.schema, cols, new_active, n)


class TorchSortExec(TorchExec):
    def __init__(self, order: List[E.SortOrder], is_global: bool,
                 child: TorchExec, conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.order = order
        self.is_global = is_global

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def _limit(self) -> int:
        return -1

    def device_partitions(self) -> List[DevicePartitionThunk]:
        bound = P.bind_list([o.child for o in self.order],
                            self.child.output)
        limit = self._limit()

        goal = self.conf.batch_size_rows

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                if limit >= 0:
                    batches = [b for b in thunk() if b.row_count() != 0]
                    if batches:
                        whole = concat_device(batches)
                        with self.metrics.timed(M.SORT_TIME):
                            out = R.with_retry(
                                lambda: sorted_batch(self.order, bound,
                                                     whole, limit),
                                self.conf, self.metrics)
                        yield out
                    return
                yield from self._sort_partition(thunk, bound, goal)
            return run
        return [make(t) for t in device_channel(self.child)]

    def _sort_partition(self, thunk: DevicePartitionThunk, bound,
                        goal: int) -> Iterator[DeviceBatch]:
        from spark_rapids_tpu_torch.exec.exchange import range_key_columns
        from spark_rapids_tpu_torch.memory import get_device_store
        store = get_device_store(self.conf)
        handles, keycols, actives = [], [], []
        try:
            for b in thunk():
                if b.row_count() == 0:
                    continue
                keycols.append(range_key_columns(bound, b))
                actives.append(b.active)
                handles.append(self.register_spillable(store, b))
            if not handles:
                return
            total = sum(h.rows for h in handles)
            if len(handles) == 1 or total <= goal:
                keycols.clear()
                whole = concat_device([h.get() for h in handles])
                for h in handles:
                    h.close()
                with self.metrics.timed(M.SORT_TIME):
                    out = R.with_retry(
                        lambda: sorted_batch(self.order, bound, whole, -1),
                        self.conf, self.metrics)
                yield out
                return
            yield from self._out_of_core(store, handles, keycols, actives,
                                         total, goal, bound)
        finally:
            for h in handles:
                h.close()

    def _out_of_core(self, store, handles, keycols, actives, total: int,
                     goal: int, bound) -> Iterator[DeviceBatch]:
        """Rank-split external sort (GpuSortExec.scala:231): exact global
        ranks over the resident keys put each row in a rank-contiguous
        sub-range of at most ``goal`` rows; each sub-range is
        concatenated, sorted and emitted in order."""
        from spark_rapids_tpu_torch.exec.exchange import (global_range_pids,
                                                          realign_spilled_pids,
                                                          split_by_pid)
        n_sub = (total + goal - 1) // goal
        pids_per_batch = R.with_retry(
            lambda: global_range_pids(self.order, keycols, actives, n_sub),
            self.conf, self.metrics)
        keycols.clear()
        buckets: List[List] = [[] for _ in range(n_sub)]
        try:
            for h, pids, act in zip(handles, pids_per_batch, actives):
                b, pids = realign_spilled_pids(h, pids, act)
                parts = R.with_retry(
                    lambda b=b, pids=pids: split_by_pid(b, pids, n_sub),
                    self.conf, self.metrics)
                h.close()
                for pid, part in enumerate(parts):
                    if part is not None:
                        buckets[pid].append(
                            self.register_spillable(store, part))
            for pid in range(n_sub):
                if not buckets[pid]:
                    continue
                parts = [h.get() for h in buckets[pid]]
                whole = concat_device(parts)
                for h in buckets[pid]:
                    h.close()
                with self.metrics.timed(M.SORT_TIME):
                    out = R.with_retry(
                        lambda w=whole: sorted_batch(self.order, bound, w,
                                                     -1),
                        self.conf, self.metrics)
                yield out
        finally:
            for bucket in buckets:
                for h in bucket:
                    h.close()

    def simple_string(self):
        return f"TorchSort {self.order} global={self.is_global}"


class TorchTopNExec(TorchSortExec):
    """Sort + per-partition limit (TakeOrderedAndProject / GpuTopN)."""

    def __init__(self, n: int, order: List[E.SortOrder], child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(order, False, child, conf, device)
        self.n = n

    def _limit(self) -> int:
        return self.n

    def simple_string(self):
        return f"TorchTopN n={self.n} {self.order}"
