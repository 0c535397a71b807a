"""Entry ``session``: each stream is a thread with a
``TorchSparkSession`` of its own in this process, as a query server's
tenants have, and sends ``session.sql(text).collect()``.

Each session reads the configuration's tables as views over their
Parquet directories (``read.parquet``), under the configuration's conf
keys. With tracing on, every session records into the program's flight
recorder (``trace.mode=ring``), and each query reports its plan's
``deviceDecodeTime`` and ``semaphoreWaitTime`` (ns, summed over the
plan: ``metrics.plan_metrics``).
"""

from __future__ import annotations

PLAN_COUNTERS = ("deviceDecodeTime", "semaphoreWaitTime")


class Entry:
    def __init__(self, conf: dict, views: dict, device, streams: int,
                 trace: bool):
        from spark_rapids_tpu_torch.sql.session import TorchSparkSession
        self.trace = trace
        self.sessions = []
        for _ in range(streams):
            s = TorchSparkSession(dict(conf), device=device)
            for name, path in views.items():
                s.read.parquet(path).createOrReplaceTempView(name)
            self.sessions.append(s)

    def client(self, i: int):
        """Stream ``i``'s call: (text, binding) -> (rows, per-query
        extras). The program gets the text alone; the binding is for an
        entry that answers without it (the control)."""
        from spark_rapids_tpu_torch.metrics import plan_metrics
        s = self.sessions[i]

        def run(text: str, _binding: dict):
            rows = [tuple(r) for r in s.sql(text).collect()]
            if not self.trace:
                return rows, {}
            pm = plan_metrics(s.last_plan)
            return rows, {k: pm.get(k, 0) for k in PLAN_COUNTERS}
        return run

    def counters(self) -> dict:
        """Process-wide counters (none: each query reports its own)."""
        return {}

    def close(self) -> None:
        for s in self.sessions:
            s.stop()
        self.sessions = []
