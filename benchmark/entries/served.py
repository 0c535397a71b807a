"""Entry ``served``: one ``QueryServer`` started in this process on a
loopback port, the configuration's tables registered as views, and one
``ServeClient`` a stream, each stream a tenant of its own. The server
keeps its defaults (plan cache on, result cache off, the flight recorder
on). A query's rows are those the client decodes from the Arrow IPC
payload; its extras are the response header's ``queueWaitMs`` and
``execMs``.

The server-wide counters come through the ``metrics`` verb (Prometheus
text): the engine's ``deviceDecodeTime`` and ``semaphoreWaitTime`` as
seconds totals over every plan the server ran.
"""

from __future__ import annotations

import re

SERVER_COUNTERS = {
    "deviceDecodeTime": "srt_device_decode_time_seconds_total",
    "semaphoreWaitTime": "srt_semaphore_wait_time_seconds_total",
}


class Entry:
    def __init__(self, conf: dict, views: dict, device, streams: int,
                 trace: bool):
        from spark_rapids_tpu_torch.serve import QueryServer, ServeClient
        self.server = QueryServer({k: str(v) for k, v in conf.items()},
                                  host="127.0.0.1", port=0,
                                  device=device).start()
        for name, path in views.items():
            self.server.register_view(name, path)
        self.clients = [ServeClient(self.server.port, tenant=f"tenant{i}")
                        for i in range(streams)]

    def client(self, i: int):
        c = self.clients[i]

        def run(text: str, _binding: dict):
            batch, header = c.sql(text)
            return ([tuple(r) for r in batch.rows()],
                    {"queueWaitMs": header.get("queueWaitMs"),
                     "execMs": header.get("execMs")})
        return run

    def counters(self) -> dict:
        """The server's counters in ns, read through the metrics verb; a
        family the exposition lacks is left out."""
        from spark_rapids_tpu_torch.serve import ServeClient
        c = ServeClient(self.server.port, tenant="bench-scrape")
        try:
            text = c.metrics()
        finally:
            c.close()
        out = {}
        for key, family in SERVER_COUNTERS.items():
            vals = re.findall(rf"^{family}(?:{{[^}}]*}})? (\S+)$", text,
                              re.M)
            if vals:
                out[key] = sum(float(v) for v in vals) * 1e9
        return out

    def close(self) -> None:
        for c in self.clients:
            c.close()
        self.clients = []
        if not self.server.shutdown(60.0):
            raise RuntimeError("the query server did not drain")
