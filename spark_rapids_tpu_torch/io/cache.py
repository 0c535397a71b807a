"""df.cache(): a Parquet-compressed in-memory cache (the port's copy of
``spark_rapids_tpu.io.cache``; the reference's
ParquetCachedBatchSerializer).

``df.cache()`` stores each partition's batches as snappy Parquet bytes in
host memory, decoded back on demand. Materialisation is lazy, happens at
most once per relation under its lock, and leaves the relation lazy when
it fails. It runs inside the query that first reads the relation:

- a child that is only a host source (an in-memory table, a Parquet
  scan) is read on the host without a trip to the device; anything else
  runs its device plan and the plan's columnar-to-row transition;
- the task thread keeps the device permit it holds across the nested
  run (``TorchSemaphore.hold_across``), and the nested plan's store
  handles are released once its payloads are encoded, or when it fails;
- the nested plan is captured as a plan of its own
  (``start_capture``), and ``last_plan`` stays the outer query's.

The cache holds only host bytes, never a device handle. A payload is an
Arrow table of the batch's columns, so decimals, dates, timestamps,
strings and nested columns come back as the same storage values.
"""

from __future__ import annotations

import io
import threading
from typing import List, Optional

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.io.arrow_convert import (arrow_to_host_batch,
                                                     host_batch_to_arrow)
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import physical as P


class CachedRelation(L.LogicalPlan):
    """InMemoryRelation: holds parquet-compressed partition payloads."""

    def __init__(self, child: L.LogicalPlan, session):
        self.children = []  # leaf once materialized; child kept for lazy run
        self.child_plan = child
        self.session = session
        self._output = list(child.output)
        self._lock = threading.Lock()
        self._payloads: Optional[List[List[bytes]]] = None
        self.cached_bytes = 0
        self.materializations = 0
        self.materialize_seconds = 0.0

    @property
    def output(self):
        return self._output

    def simple_string(self):
        state = "materialized" if self._payloads is not None else "lazy"
        return f"InMemoryRelation [parquet-cached, {state}]"

    def materialize(self) -> List[List[bytes]]:
        with self._lock:
            if self._payloads is None:
                import time
                t0 = time.perf_counter()
                payloads = self.session.run_nested(self.child_plan, _encode)
                self.cached_bytes = sum(len(b) for p in payloads for b in p)
                self.materializations += 1
                self.materialize_seconds = time.perf_counter() - t0
                self._payloads = payloads
            return self._payloads


def _encode(batch: HostBatch) -> bytes:
    import pyarrow.parquet as pq
    buf = io.BytesIO()
    pq.write_table(host_batch_to_arrow(batch), buf, compression="snappy")
    return buf.getvalue()


def _decode(payload: bytes, schema) -> HostBatch:
    import pyarrow.parquet as pq
    tbl = pq.read_table(io.BytesIO(payload))
    return arrow_to_host_batch(tbl, schema)


class CpuCachedScanExec(P.PhysicalPlan):
    def __init__(self, rel: CachedRelation):
        self.children = []
        self.rel = rel

    @property
    def output(self):
        return self.rel.output

    def simple_string(self):
        return f"CachedScan [{len(self.rel._payloads or [])} partitions]"

    def partitions(self):
        payloads = self.rel.materialize()
        schema = self.schema

        def make(part: List[bytes]):
            def run():
                for payload in part:
                    yield _decode(payload, schema)
            return run
        return [make(p) for p in payloads]


def cache_plan(df) -> CachedRelation:
    plan = df.plan
    if isinstance(plan, CachedRelation):
        return plan
    return CachedRelation(plan, df.session)
