"""CpuWindowExec: the window plan node (the counterpart of
``spark_rapids_tpu.sql.window_exec.CpuWindowExec``).

The node holds the window expressions (each an ``Alias`` over a
``WindowExpression``), the partition spec and the order spec, and
appends one column per window expression to its child's output. The
planner puts a hash exchange on the partition spec below it (a
single-partition exchange when the spec is empty); the overrides
convert it to ``TorchWindowExec`` (``exec/window.py``). Host evaluation
is the CPU fallback's, which is not ported yet.
"""

from __future__ import annotations

from typing import List

from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


class CpuWindowExec(P.PhysicalPlan):
    def __init__(self, window_exprs: List[E.Expression],
                 partition_spec: List[E.Expression],
                 order_spec: List[E.SortOrder], child: P.PhysicalPlan):
        self.children = [child]
        self.window_exprs = window_exprs  # Alias(WindowExpression)
        self.partition_spec = partition_spec
        self.order_spec = order_spec

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + [E.named_output(e)
                                          for e in self.window_exprs]

    def simple_string(self):
        return (f"Window {self.window_exprs} part={self.partition_spec} "
                f"order={self.order_spec}")
