"""Basic device operators: project, filter, range, union, expand and
limit (the counterparts of ``spark_rapids_tpu.exec.basic``'s
TpuProjectExec, TpuFilterExec, TpuRangeExec, TpuUnionExec,
TpuExpandExec, TpuLocalLimitExec and TpuGlobalLimitExec). Filters and
limits only flip the ``active`` mask; compaction happens at exchanges.
The range generates its values on the device, one ``arange`` a batch of
at most ``batchSizeRows`` rows, its column's validity the batch's active
mask itself; a union re-tags its children's partitions without a copy;
an expand projects each batch once per grouping set and concatenates
the blocks. Under stage
fusion (``exec/fused.py``, on by default) a chain of filters and
projects runs as one stage program and these operators' own
``device_partitions`` do not run; they are the unfused plan's
(``spark.rapids.sql.stageFusion.enabled=false``), a lone filter's or
project's, and those of a filter or project holding an ANSI cast or a
partition-context expression (``spark_partition_id()``,
``monotonically_increasing_id()``), which threads its partition's id and
running row count through its batches.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    DeviceColumn,
                                                    bucket_capacity,
                                                    concat_device)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T


class TorchProjectExec(TorchExec):
    def __init__(self, project_list: List[E.Expression], child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.project_list = project_list

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return [E.named_output(e) for e in self.project_list]

    def device_partitions(self) -> List[DevicePartitionThunk]:
        bound = P.bind_list(self.project_list, self.child.output)
        schema = self.schema
        needs_part = X._needs_part_ctx(bound)
        device, metrics = self.device, self.metrics

        def make(pid: int, thunk: DevicePartitionThunk
                 ) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                ctx = _part_ctx(pid, device) if needs_part else None
                for b in thunk():
                    with metrics.timed(M.OP_TIME):
                        cols = X.run_project(bound, b, part_ctx=ctx)
                    if needs_part:
                        ctx = _advance(ctx, b.active)
                    yield b.with_columns(schema, cols)
            return run
        return [make(i, t)
                for i, t in enumerate(device_channel(self.child))]

    def simple_string(self):
        return f"TorchProject {self.project_list}"


class TorchFilterExec(TorchExec):
    def __init__(self, condition: E.Expression, child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.condition = condition

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        bound = E.bind_references(self.condition, self.child.output)
        needs_part = X._needs_part_ctx([bound])
        device, metrics = self.device, self.metrics

        def make(pid: int, thunk: DevicePartitionThunk
                 ) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                ctx = _part_ctx(pid, device) if needs_part else None
                for b in thunk():
                    with metrics.timed(M.OP_TIME):
                        out = X.run_filter(bound, b, part_ctx=ctx)
                    if needs_part:
                        ctx = _advance(ctx, b.active)
                    yield out
            return run
        return [make(i, t)
                for i, t in enumerate(device_channel(self.child))]

    def simple_string(self):
        return f"TorchFilter {self.condition!r}"


def _part_ctx(pid: int, device: torch.device):
    """(partition id, rows of the partition before this batch) as device
    scalars, for spark_partition_id() and monotonically_increasing_id();
    the row count stays on the device across batches."""
    return (torch.full((), pid, dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def _advance(ctx, active: torch.Tensor):
    pid, start = ctx
    return pid, start + active.sum()


def _limit_mask(active: torch.Tensor, remaining: int) -> torch.Tensor:
    """The first ``remaining`` active rows."""
    rank = torch.cumsum(active.to(torch.int32), 0)
    return active & (rank <= remaining)


class TorchLocalLimitExec(TorchExec):
    """Keeps the first n active rows of each partition by masking."""

    def __init__(self, n: int, child: TorchExec, conf: TorchConf,
                 device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.n = n

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        n = self.n

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                remaining = n
                for b in thunk():
                    if remaining <= 0:
                        break
                    cnt = b.row_count()
                    if cnt <= remaining:
                        remaining -= cnt
                        yield b
                        continue
                    yield DeviceBatch(b.schema, b.columns,
                                      _limit_mask(b.active, remaining),
                                      remaining, chip=b.chip)
                    remaining = 0
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return f"TorchLocalLimit {self.n}"


class TorchGlobalLimitExec(TorchLocalLimitExec):
    """The same mask-based limit over the single post-exchange
    partition."""

    def simple_string(self):
        return f"TorchGlobalLimit {self.n}"


class TorchRangeExec(TorchExec):
    """``spark.range`` generated on the device: each partition a
    contiguous run of the values, in batches of at most
    ``batchSizeRows`` rows."""

    def __init__(self, output, start: int, end: int, step: int,
                 num_partitions: int, conf: TorchConf,
                 device: torch.device):
        super().__init__(conf, device)
        self.children = []
        self._output = output
        self.start, self.end, self.step = start, end, step
        self.num_partitions = max(1, num_partitions)

    @property
    def output(self):
        return self._output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        step = self.step
        total = max(0, (self.end - self.start + step
                        - (1 if step > 0 else -1)) // step)
        per = (total + self.num_partitions - 1) // self.num_partitions \
            if total else 0
        goal = self.conf.batch_size_rows
        schema = self.schema
        device = self.device

        def make(pidx: int) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                lo = pidx * per
                hi = min(total, lo + per)
                off = lo
                while off < hi:
                    n = min(goal, hi - off)

                    def chunk(n=n, off=off):
                        idx = torch.arange(bucket_capacity(n),
                                           dtype=torch.int64, device=device)
                        active = idx < n
                        data = torch.where(
                            active, (idx + off) * self.step + self.start, 0)
                        return data, active
                    # the chunk is this source's allocation: under the OOM
                    # protocol, as an upload is
                    data, active = R.with_retry(chunk, self.conf,
                                                self.metrics)
                    yield DeviceBatch(schema,
                                      [DeviceColumn(T.LongT, data, active)],
                                      active, n)
                    off += n
            return run
        return [make(i) for i in range(self.num_partitions)]

    def simple_string(self):
        return f"TorchRange ({self.start}, {self.end}, step={self.step})"


class TorchUnionExec(TorchExec):
    """UNION ALL: every child's partitions in child order, each batch
    re-tagged with this node's schema (no copy)."""

    def __init__(self, children: List[TorchExec], output, conf: TorchConf,
                 device: torch.device):
        super().__init__(conf, device)
        self.children = list(children)
        self._output = output

    @property
    def output(self):
        return self._output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        schema = self.schema

        def retag(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    yield DeviceBatch(schema, b.columns, b.active,
                                      b._num_rows, b._num_rows_dev, b.chip)
            return run
        return [retag(t) for c in self.children for t in device_channel(c)]

    def simple_string(self):
        return "TorchUnion"


class TorchExpandExec(TorchExec):
    """Grouping-sets expansion (rollup, cube): each input batch is
    projected once per grouping set (``spark_grouping_id`` is one of each
    projection's literals) and the blocks are concatenated."""

    def __init__(self, projections, output, child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.projections = projections
        self._output = output

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self._output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        bound = [P.bind_list(proj, self.child.output)
                 for proj in self.projections]
        schema = self.schema
        metrics = self.metrics

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    outs = []
                    for proj in bound:
                        with metrics.timed(M.OP_TIME):
                            cols = X.run_project(proj, b)
                        outs.append(b.with_columns(schema, cols))
                    if outs:
                        yield concat_device(outs)
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return f"TorchExpand [{len(self.projections)} sets]"
