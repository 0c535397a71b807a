"""TorchGenerateExec: explode and posexplode, with their outer forms,
over device array columns (the counterpart of
``spark_rapids_tpu.exec.generate.TpuGenerateExec``).

Each batch: the rows' effective counts (the array's length, at least 1
under ``outer``, 0 for an inactive row) prefix-sum into output offsets;
every output position finds its parent row by a search over the
cumulative counts, gathers the parent's columns (an array column keeps
its pool) and reads its element from the pool at start + ordinal. The
output capacity is static: the element pool's capacity, plus the row
capacity under ``outer``; its row count stays a device scalar. Nothing
here reads a value on the host, but for one case: an explode above
another reads an array whose pool the rows below share (each output row
of the lower explode keeps its parent's arrays), so the pool's capacity
does not bound its output, and its count is read to size it.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (DeviceArrayColumn,
                                                    DeviceBatch,
                                                    DeviceColumn,
                                                    bucket_capacity,
                                                    take_columns)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T


def is_device_generate(gen: E.Expression, conf=None,
                       device=None) -> Optional[str]:
    """None when the generator runs on the device, else the JAX
    package's reason (``exec/generate.py`` ``is_device_generate``)."""
    if not isinstance(gen, E.Explode):
        return (f"generator {type(gen).__name__} has no device "
                "implementation")
    child = gen.children[0]
    dt = child.data_type
    if not isinstance(dt, T.ArrayType):
        return "explode input must be an array"
    if isinstance(dt.element_type, (T.ArrayType, T.MapType, T.StructType)):
        return "nested-of-nested explode runs on CPU"
    r = X._type_support(dt.element_type)
    if r:
        return f"array element: {r}"
    if not isinstance(child, E.AttributeReference):
        return "explode over computed arrays runs on CPU"
    return None


def explode_batch(b: DeviceBatch, ordinal: int, position: bool,
                  outer: bool, shared_pool: bool = False) -> List:
    """The exploded columns of one batch (the parent columns, then the
    position where asked, then the element), their active mask and the
    output row count, a device scalar. ``shared_pool``: rows of the
    array may share pool elements, so the output is sized from the
    count, read on the host."""
    cols = b.columns
    arr = cols[ordinal]
    assert isinstance(arr, DeviceArrayColumn)
    active = b.active
    cap = active.shape[0]
    pool_cap = arr.child.capacity
    dev = active.device
    real_len = torch.where(arr.validity & active, arr.lengths, 0) \
        .to(torch.int64)
    eff = torch.clamp(real_len, min=1) if outer else real_len
    eff = torch.where(active, eff, 0)
    cum = torch.cumsum(eff, 0)
    total = cum[-1]
    if shared_pool:
        total = int(total)
        out_cap = bucket_capacity(max(1, total))
    else:
        out_cap = pool_cap + (cap if outer else 0)
    pos_out = torch.arange(out_cap, dtype=torch.int64, device=dev)
    parent = torch.clamp(torch.searchsorted(cum, pos_out, right=True),
                         max=cap - 1)
    elem = pos_out - (cum[parent] - eff[parent])
    active_out = pos_out < total
    is_real = active_out & (elem < real_len[parent])
    out_cols = take_columns(cols, parent, valid_at=active_out)
    if position:
        out_cols.append(DeviceColumn(
            T.IntegerT, torch.where(is_real, elem, 0).to(torch.int32),
            is_real))
    src = torch.clamp(arr.starts[parent].to(torch.int64) + elem, 0,
                      pool_cap - 1)
    out_cols.append(take_columns([arr.child], src, valid_at=is_real)[0])
    return out_cols, active_out, total


def explodes_below(plan) -> bool:
    """Whether a generate lies in ``plan``'s subtree: its output rows
    keep their parents' arrays, so rows above it may share an array's
    pool elements."""
    return any(isinstance(p, TorchGenerateExec) or explodes_below(p)
               for p in getattr(plan, "children", ()))


class TorchGenerateExec(TorchExec):
    def __init__(self, generator: E.Explode,
                 gen_output: List[E.AttributeReference], child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.generator = generator
        self.gen_output = gen_output

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + list(self.gen_output)

    def device_partitions(self) -> List[DevicePartitionThunk]:
        gen = self.generator
        bound = E.bind_references(gen.children[0], self.child.output)
        assert isinstance(bound, E.BoundReference)
        ordinal, position, outer = bound.ordinal, gen.position, gen.outer
        shared = explodes_below(self.child)
        schema = self.schema
        metrics = self.metrics

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    with metrics.timed(M.OP_TIME):
                        cols, active, total = R.with_retry(
                            lambda b=b: explode_batch(
                                b, ordinal, position, outer, shared),
                            self.conf, metrics)
                    if shared:  # the count was read on the host
                        yield DeviceBatch(schema, cols, active, total,
                                          chip=b.chip)
                    else:
                        yield DeviceBatch(schema, cols, active, None,
                                          total, b.chip)
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return f"TorchGenerate {self.generator!r}"
