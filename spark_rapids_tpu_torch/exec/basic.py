"""Basic device operators: project and filter (the counterparts of
``spark_rapids_tpu.exec.basic``'s TpuProjectExec and TpuFilterExec).
Filters only flip the ``active`` mask; compaction happens at exchanges.
Stage fusion (``exec/fused.py``) is not ported: each runs on its own.
"""

from __future__ import annotations

from typing import Iterator, List

import torch

from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


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

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    yield b.with_columns(schema, X.run_project(bound, b))
            return run
        return [make(t) for t in device_channel(self.child)]

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

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    yield X.run_filter(bound, b)
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return f"TorchFilter {self.condition!r}"
