"""TorchExec base + row/columnar transitions (the counterparts of
``spark_rapids_tpu.exec.base``'s TpuExec, TpuRowToColumnarExec and
TpuColumnarToRowExec).

Every TorchExec produces ``device_partitions()``: thunks yielding
``DeviceBatch``es on the exec's ``torch.device``. Partitions run one
after another on the device's current stream. The pipelined scan upload,
semaphore, spill store and retry protocol of the JAX package are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

import torch

from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.sql import physical as P

DevicePartitionThunk = Callable[[], Iterator[DeviceBatch]]


class TorchExec(P.PhysicalPlan):
    """Base of all device operators; rows reach the host only through
    the TorchColumnarToRowExec the rewrite puts on top."""

    def __init__(self, conf: TorchConf, device: torch.device):
        self.conf = conf
        self.device = device

    def device_partitions(self) -> List[DevicePartitionThunk]:
        raise NotImplementedError


def device_channel(plan: P.PhysicalPlan) -> List[DevicePartitionThunk]:
    """A device child's partitions; anything else is a rewrite bug."""
    if not isinstance(plan, TorchExec):
        raise TypeError(
            f"device operator consuming non-device child "
            f"{plan.simple_string()}; the rewrite must insert "
            "TorchRowToColumnarExec")
    return plan.device_partitions()


class TorchRowToColumnarExec(TorchExec):
    """CPU rows -> device batches: coalesces consecutive host batches of
    a partition up to the goal row count, then uploads each group at its
    capacity bucket. Over a Parquet scan it also takes EncodedBatches
    (a row group's still-encoded pages) and decodes each on the device
    with ``decodeFused``, one batch per row group, never coalesced; host
    batches pending before one are flushed first, to keep row order.
    The JAX package's pipelined upload-ahead ring and OOM host fallback
    are not ported yet."""

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
        from spark_rapids_tpu_torch.io.device_decode import EncodedBatch
        # this transition is the scan's direct consumer: allow the scan to
        # hand it still-encoded Parquet pages (decided here, at execution
        # time, so no other consumer ever sees an EncodedBatch)
        if hasattr(self.child, "emit_encoded"):
            self.child.emit_encoded = True

        def make(thunk: P.PartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                pending: List[HostBatch] = []
                rows = 0
                for b in thunk():
                    if isinstance(b, EncodedBatch):
                        if pending:
                            yield self._upload(pending)
                            pending, rows = [], 0
                        yield self._decode(b)
                        continue
                    if b.num_rows == 0:
                        continue
                    pending.append(b)
                    rows += b.num_rows
                    if rows >= self.goal_rows:
                        yield self._upload(pending)
                        pending, rows = [], 0
                if pending:
                    yield self._upload(pending)
            return run
        return [make(t) for t in self.child.partitions()]

    def _upload(self, batches: List[HostBatch]) -> DeviceBatch:
        whole = batches[0] if len(batches) == 1 else HostBatch.concat(
            batches)
        return DeviceBatch.from_host(whole, self.device)

    def _decode(self, enc) -> DeviceBatch:
        from spark_rapids_tpu_torch.columnar.device import bucket_capacity
        from spark_rapids_tpu_torch.columnar.transfer import (
            finish_encoded_upload, prepare_encoded_upload)
        cap = bucket_capacity(max(1, enc.num_rows))
        return finish_encoded_upload(prepare_encoded_upload(enc, cap),
                                     self.device)

    def simple_string(self):
        return "TorchRowToColumnar"


class TorchColumnarToRowExec(P.PhysicalPlan):
    """Device batches -> CPU rows (the plan's root transition)."""

    def __init__(self, child: TorchExec, conf: TorchConf):
        self.children = [child]
        self.conf = conf

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def partitions(self) -> List[P.PartitionThunk]:
        def make(thunk: DevicePartitionThunk) -> P.PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in thunk():
                    yield b.to_host()
            return run
        return [make(t) for t in self.child.device_partitions()]

    def simple_string(self):
        return "TorchColumnarToRow"
