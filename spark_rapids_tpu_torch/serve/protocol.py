"""Wire protocol of the query server (the counterpart of
``spark_rapids_tpu.serve.protocol``, byte for byte: either package's
client talks to either package's server; docs/serving.md).

One request/response pair per round trip over a local TCP socket:

    frame := MAGIC(4) | header_len(u32 BE) | payload_len(u32 BE)
             | header JSON (utf-8) | payload bytes

The header is a small JSON object (``op``/``status`` plus request or
response fields); the payload carries result batches as ONE Arrow IPC
stream (the interchange the engine already speaks at every host
boundary — io/arrow_convert.py), so any Arrow-capable client can read
results without this module.

Request ops: ``sql`` (fields: sql, tenant, optional ``timeoutMs`` — a
per-request deadline that wins over the server's
``serve.queryTimeoutMs`` confs — and optional ``queryId`` naming the
query so another connection can cancel it), ``cancel`` (optional
tenant and/or queryId selecting which in-flight queries to cancel;
response reports ``cancelled``: how many tokens newly cancelled),
``view`` (name, path, fmt), ``stats``, ``metrics`` (alias
``stats-stream``: one Prometheus text scrape per request, returned as
the frame PAYLOAD with ``contentType`` in the header — clients poll
it, `tools top` and Prometheus scrapers both ride this verb),
``ping``, ``shutdown`` (graceful drain: in-flight queries finish
within the drain deadline, stragglers are cancelled). The port's server
answers ``metrics`` with ``status: error`` until the observability slice
(ROADMAP A11b) brings its Prometheus exporter.
Responses carry ``status``
(ok | rejected | cancelled | quarantined | error) plus op-specific
fields; ``sql`` responses attach ``rows``, ``queueWaitMs``, ``execMs``,
``planCacheHit`` and the Arrow payload; a ``cancelled`` response
carries ``reason`` (cancel | deadline | disconnect | watchdog |
shutdown | injected) and ``where`` (queued | running) — see
docs/serving.md "Query lifecycle".
"""

from __future__ import annotations

import io
import json
import socket
import struct
from typing import Dict, Optional, Tuple

MAGIC = b"SRTS"
_HEAD = struct.Struct("!II")

# one frame's header or payload larger than this is a protocol error,
# not a request (a malformed/garbage connection must not make the
# server allocate gigabytes). The payload cap must be BELOW the u32
# length-field maximum or the guard is dead code.
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 30


class ProtocolError(Exception):
    pass


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a frame boundary."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf.extend(chunk)
    return bytes(buf)


def send_msg(sock: socket.socket, header: Dict,
             payload: bytes = b"") -> None:
    hb = json.dumps(header).encode("utf-8")
    sock.sendall(MAGIC + _HEAD.pack(len(hb), len(payload)) + hb + payload)


def recv_msg(sock: socket.socket) -> Optional[Tuple[Dict, bytes]]:
    """One (header, payload) frame; None on clean EOF between frames."""
    head = _recv_exact(sock, 4 + _HEAD.size)
    if head is None:
        return None
    if head[:4] != MAGIC:
        raise ProtocolError(f"bad frame magic {head[:4]!r}")
    hlen, plen = _HEAD.unpack(head[4:])
    if hlen > MAX_HEADER_BYTES or plen > MAX_PAYLOAD_BYTES:
        raise ProtocolError(f"oversized frame (header {hlen}, "
                            f"payload {plen})")
    hb = _recv_exact(sock, hlen)
    if hb is None:
        raise ProtocolError("connection closed before frame header")
    payload = _recv_exact(sock, plen) if plen else b""
    if plen and payload is None:
        raise ProtocolError("connection closed before frame payload")
    try:
        header = json.loads(hb.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        # malformed header bytes stay inside the ProtocolError contract
        # (the server drops the connection cleanly, the client reports
        # a ServeError — never a bare JSONDecodeError)
        raise ProtocolError(f"malformed frame header: {e}") from e
    if not isinstance(header, dict):
        raise ProtocolError(
            f"frame header must be a JSON object, got "
            f"{type(header).__name__}")
    return header, payload or b""


# ---------------------------------------------------------------------------
# Arrow IPC result payloads
# ---------------------------------------------------------------------------

def batch_to_ipc(batch) -> bytes:
    """HostBatch -> one Arrow IPC stream (schema + record batches)."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
    table = host_batch_to_arrow(batch)
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return sink.getvalue()


def ipc_to_batch(data: bytes):
    """Arrow IPC stream bytes -> HostBatch."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import arrow_to_host_batch
    with pa.ipc.open_stream(io.BytesIO(data)) as reader:
        table = reader.read_all()
    return arrow_to_host_batch(table)
