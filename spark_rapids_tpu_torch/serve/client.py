"""Client of the query server (the counterpart of
``spark_rapids_tpu.serve.client``; docs/serving.md).

One ``ServeClient`` holds one connection and runs one request at a
time (the protocol is strict request/response); concurrent load uses
one client per worker, which is exactly what the bench's concurrency
legs and the server's per-connection threading expect.
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.serve import protocol


class ServeError(Exception):
    """Server-side failure reported for one request."""


class ServeRejected(ServeError):
    """Admission refused (queue full / shutting down) — the
    backpressure signal; retry is the CLIENT's decision."""


class ServeCancelled(ServeError):
    """The query was cancelled (cancel verb, deadline, watchdog, or
    drain) — ``reason`` names which, ``where`` is ``queued`` or
    ``running``. A NORMAL protocol outcome: the stream stays
    synchronized, so the client is NOT marked broken and may submit
    the next query immediately (docs/serving.md 'Query lifecycle')."""

    def __init__(self, reason: str, where: str = ""):
        super().__init__(f"query cancelled ({reason})"
                         + (f" while {where}" if where else ""))
        self.reason = reason
        self.where = where


class ServeQuarantined(ServeError):
    """The query's plan signature is quarantined after consecutive
    runtime-fatal failures; it failed fast without executing
    (docs/serving.md 'Query lifecycle')."""


class ServeClient:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 tenant: str = "default", timeout: float = 300.0):
        self.host = host
        self.port = port
        self.tenant = tenant
        self._timeout = timeout
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._lock = threading.Lock()
        # once a transport error (timeout/OSError/corrupt frame) hits,
        # the request/response stream is desynchronized: a later call
        # could read the PREVIOUS query's late response. The client
        # refuses further use instead of silently mixing results.
        self._broken = False

    def reconnect(self) -> "ServeClient":
        """Re-establish the connection after a transport error marked
        this client broken: opens a fresh socket to the same host/port
        and clears the broken flag, so the caller resumes WITHOUT
        rebuilding tenant state by hand (sessions/views/ledgers are
        per TENANT on the server, not per connection). Any request
        still in flight on the old connection is cancelled by the
        server's disconnect monitor. Returns self."""
        with self._lock:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self._timeout)
            self._broken = False
        return self

    @property
    def broken(self) -> bool:
        return self._broken

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- requests ----------------------------------------------------------

    def _roundtrip(self, header: Dict,
                   payload: bytes = b"") -> Tuple[Dict, bytes]:
        try:
            with self._lock:
                if self._broken:
                    raise ServeError(
                        "connection desynchronized by an earlier "
                        "transport error; open a new client")
                protocol.send_msg(self._sock, header, payload)
                msg = protocol.recv_msg(self._sock)
        except protocol.ProtocolError as e:
            self._broken = True
            raise ServeError(f"corrupted server stream: {e}") from e
        except OSError as e:  # incl. socket.timeout
            self._broken = True
            raise ServeError(f"transport error: {e}") from e
        if msg is None:
            raise ServeError("server closed the connection")
        return msg

    def sql(self, text: str, tenant: Optional[str] = None,
            timeout_ms: Optional[int] = None,
            query_id: Optional[str] = None) -> Tuple[object, Dict]:
        """Execute SQL; returns ``(HostBatch, response header)``. The
        header carries rows/queueWaitMs/execMs/planCacheHit.
        ``timeout_ms`` sets a per-request deadline (wins over the
        server's serve.queryTimeoutMs confs); ``query_id`` names the
        query so ANOTHER connection can ``cancel`` it. Raises
        ServeRejected on admission rejection, ServeCancelled when the
        query was cancelled or timed out (the client stays usable),
        ServeQuarantined for a quarantined signature, ServeError on
        failure."""
        req = {"op": "sql", "sql": text,
               "tenant": tenant or self.tenant}
        if timeout_ms is not None:
            req["timeoutMs"] = int(timeout_ms)
        if query_id is not None:
            req["queryId"] = str(query_id)
        header, payload = self._roundtrip(req)
        status = header.get("status")
        if status == "rejected":
            raise ServeRejected(header.get("error", "rejected"))
        if status == "cancelled":
            # a normal, stream-synchronized outcome: must NOT mark the
            # client broken (docs/serving.md "Query lifecycle")
            raise ServeCancelled(header.get("reason", "cancel"),
                                 header.get("where", ""))
        if status == "quarantined":
            raise ServeQuarantined(
                header.get("error", "signature quarantined"))
        if status != "ok":
            raise ServeError(header.get("error", "unknown server error"))
        return protocol.ipc_to_batch(payload), header

    def cancel(self, query_id: Optional[str] = None,
               tenant: Optional[str] = None) -> int:
        """Cancel in-flight queries matching ``tenant`` and/or
        ``query_id`` (the `cancel` protocol verb; both None cancels
        everything in flight). Returns how many queries were newly
        cancelled; each returns ``status: cancelled`` on its own
        connection."""
        req = {"op": "cancel"}
        if tenant is not None:
            req["tenant"] = tenant
        if query_id is not None:
            req["queryId"] = str(query_id)
        header, _ = self._roundtrip(req)
        if header.get("status") != "ok":
            raise ServeError(header.get("error", "cancel failed"))
        return int(header.get("cancelled", 0))

    def collect(self, text: str,
                tenant: Optional[str] = None) -> List[tuple]:
        """Execute SQL and return rows as tuples (test/CLI sugar)."""
        batch, _ = self.sql(text, tenant=tenant)
        return [tuple(r) for r in batch.rows()]

    def register_view(self, name: str, path: str,
                      fmt: str = "parquet") -> None:
        header, _ = self._roundtrip({"op": "view", "name": name,
                                     "path": path, "fmt": fmt})
        if header.get("status") != "ok":
            raise ServeError(header.get("error", "view failed"))

    def stats(self) -> Dict:
        header, _ = self._roundtrip({"op": "stats"})
        if header.get("status") != "ok":
            raise ServeError(header.get("error", "stats failed"))
        return header["stats"]

    def metrics(self) -> str:
        """One Prometheus text scrape of the server (the `metrics`
        verb; `tools top` and the bench's scrape-latency leg poll
        this)."""
        header, payload = self._roundtrip({"op": "metrics"})
        if header.get("status") != "ok":
            raise ServeError(header.get("error", "metrics failed"))
        return payload.decode("utf-8")

    def ping(self) -> bool:
        header, _ = self._roundtrip({"op": "ping"})
        return header.get("status") == "ok"

    def shutdown(self) -> None:
        """Ask the server to shut down cleanly (in-flight queries
        drain); the connection is unusable afterwards."""
        self._roundtrip({"op": "shutdown"})
