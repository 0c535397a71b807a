"""TorchSortExec / TorchTopNExec: per-partition device sort (the
counterparts of ``spark_rapids_tpu.exec.sort``'s TpuSortExec and
TpuTopNExec). A partition's batches concatenate and sort in one pass;
TopN then keeps the first n rows through the active mask. The
out-of-core rank-split path is not ported yet (a partition must fit on
the card).
"""

from __future__ import annotations

from typing import Iterator, List

import torch

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

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                batches = [b for b in thunk() if b.row_count() != 0]
                if batches:
                    yield sorted_batch(self.order, bound,
                                       concat_device(batches), limit)
            return run
        return [make(t) for t in device_channel(self.child)]

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
