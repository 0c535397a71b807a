"""Broadcast nested-loop join on the host (the counterpart of
``spark_rapids_tpu.sql.nested_loop``; the reference's
GpuBroadcastNestedLoopJoinExecBase). The planner emits it for an inner
or cross join without equi-keys. It has no device rule in either
package, so the rewrite always leaves it on the CPU, with transitions
around it; its children may run on the device.

The right side materializes once; each left batch pairs with every right
row and the condition filters the pairs. Inner and cross only, as in the
JAX package: another join type raises.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


class CpuBroadcastNestedLoopJoinExec(P.PhysicalPlan):
    def __init__(self, join_type: str, condition: Optional[E.Expression],
                 left: P.PhysicalPlan, right: P.PhysicalPlan,
                 output: List[E.AttributeReference]):
        self.children = [left, right]
        self.join_type = join_type
        self.condition = condition
        self._output = output

    @property
    def output(self):
        return self._output

    def partitions(self) -> List[P.PartitionThunk]:
        left, right = self.children
        rb = [b for t in right.partitions() for b in t() if b.num_rows]
        rwhole = HostBatch.concat(rb) if rb else \
            HostBatch.empty(P._struct_of(right.output))
        cond = None
        if self.condition is not None:
            cond = E.bind_references(
                self.condition, list(left.output) + list(right.output))

        def make(lt: P.PartitionThunk) -> P.PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in lt():
                    if not b.num_rows:
                        continue
                    nl, nr = b.num_rows, rwhole.num_rows
                    li = np.repeat(np.arange(nl, dtype=np.int64), nr)
                    ri = np.tile(np.arange(nr, dtype=np.int64), nl)
                    pairs = P._gather_pair(b, rwhole, li, ri, self.schema)
                    if cond is not None and len(li):
                        pr = cond.eval(pairs)
                        keep = pr.validity & pr.data.astype(bool)
                        pairs = pairs.take(np.nonzero(keep)[0])
                    if self.join_type in ("inner", "cross"):
                        yield pairs
                    else:
                        raise NotImplementedError(
                            f"nested loop {self.join_type}")
            return run
        return [make(t) for t in left.partitions()]

    def simple_string(self):
        return (f"BroadcastNestedLoopJoin {self.join_type} "
                f"cond={self.condition!r}")
