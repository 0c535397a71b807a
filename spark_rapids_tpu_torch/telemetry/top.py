"""A live terminal view over a running QueryServer (``run_top``)
(docs/observability.md "Live telemetry").

Polls the server's ``stats`` verb on an interval and renders a
refreshing table of tenants x {QPS, p50/p99 latency, queue wait, live
HBM, in-flight, rejected} above a global admission/cache line — the
`nvidia-smi`-shaped answer to "what is this server doing right now".
Per-tenant QPS is computed from the admitted-count delta between two
polls (the first frame shows lifetime averages)."""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20),
                      ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n}B"


def format_top(stats: Dict, prev: Optional[Dict] = None,
               interval: float = 0.0) -> str:
    """One rendered frame from a server ``stats`` dict (pure function —
    the CLI loop and the tests share it)."""
    adm = stats.get("admission", {})
    hbm = stats.get("tenantsHBM", {})
    lines = [
        f"spark-rapids-tpu serve {stats.get('host', '?')}:"
        f"{stats.get('port', '?')}  up {stats.get('uptimeSeconds', 0):.0f}s"
        f"  ok {stats.get('queriesOk', 0)}  err {stats.get('queriesErr', 0)}"
        f"  qps {stats.get('qps', 0):.2f}",
        f"admission: {adm.get('inFlight', 0)} in flight, "
        f"{adm.get('queued', 0)} queued "
        f"(max {adm.get('maxConcurrentQueries', '?')}/"
        f"{adm.get('maxQueued', '?')}), "
        f"{adm.get('admitted', 0)} admitted, "
        f"{adm.get('rejected', 0)} rejected, "
        f"{adm.get('throttledWaits', 0)} fair-share waits",
    ]
    # result/subplan cache hit rates (docs/caching.md): line present
    # only when the server runs with a cache enabled
    cache = stats.get("cache") or {}

    def _rate(cs: Dict) -> str:
        probes = cs.get("hits", 0) + cs.get("misses", 0)
        pct = 100.0 * cs.get("hits", 0) / probes if probes else 0.0
        return (f"{cs.get('hits', 0)}/{probes} hits ({pct:.0f}%), "
                f"{cs.get('entries', 0)} entries "
                f"{_fmt_bytes(cs.get('bytes', 0))}")

    if cache:
        parts = []
        if cache.get("result") is not None:
            parts.append(f"result {_rate(cache['result'])}")
        if cache.get("subplan") is not None:
            parts.append(f"subplan {_rate(cache['subplan'])}")
        lines.append("cache: " + "; ".join(parts))
    lines += [
        "",
        f"{'tenant':16s} {'qps':>7s} {'p50ms':>8s} {'p99ms':>8s} "
        f"{'waitP99':>8s} {'liveHBM':>9s} {'inFlt':>5s} {'rej':>5s}",
    ]
    prev_tenants = (prev or {}).get("admission", {}).get("tenants", {})
    uptime = max(1e-9, float(stats.get("uptimeSeconds", 0)) or 1e-9)
    tenants = adm.get("tenants", {})
    for name in sorted(set(tenants) | set(hbm)):
        t = tenants.get(name, {})
        lat = t.get("latencyMs", {})
        wait = t.get("queueWaitMs", {})
        admitted = t.get("admitted", 0)
        if prev is not None and interval > 0:
            qps = (admitted
                   - prev_tenants.get(name, {}).get("admitted", 0)) \
                / interval
        else:
            qps = admitted / uptime
        live = hbm.get(name, {}).get("liveBytes", 0)
        lines.append(
            f"{name[:16]:16s} {qps:7.2f} "
            f"{lat.get('p50', 0):8.1f} {lat.get('p99', 0):8.1f} "
            f"{wait.get('p99', 0):8.1f} {_fmt_bytes(live):>9s} "
            f"{t.get('inFlight', 0):5d} {t.get('rejected', 0):5d}")
    if not tenants and not hbm:
        lines.append("(no tenants yet)")
    return "\n".join(lines)


def run_top(port: int, host: str = "127.0.0.1", interval: float = 2.0,
            iterations: int = 0, once: bool = False) -> int:
    """The CLI loop: ``iterations`` frames (0 = until interrupted);
    ``once`` renders exactly one frame (scripting sugar for
    ``--once``). Returns 0; a server that goes away MID-POLL (drained,
    restarted, crashed) is a clean exit — message + code 0, never a
    raw socket traceback — while an initial connect failure stays an
    error (code 1)."""
    from spark_rapids_tpu_torch.serve import ServeClient
    if once:
        iterations = 1
    try:
        client = ServeClient(port, host=host)
    except OSError as e:
        print(f"cannot connect to {host}:{port}: {e}")
        return 1
    n = 0
    prev = None
    try:
        while True:
            try:
                stats = client.stats()
            except Exception as e:  # noqa: BLE001 - reported cleanly
                # mid-poll disappearance is the server's normal end of
                # life from a watcher's point of view: exit clean
                print(f"server at {host}:{port} went away: {e}")
                return 0
            frame = format_top(stats, prev=prev,
                               interval=interval if prev else 0.0)
            if n and sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")  # clear + home
            print(frame, flush=True)
            prev = stats
            n += 1
            if iterations and n >= iterations:
                return 0
            time.sleep(max(0.1, interval))
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()
