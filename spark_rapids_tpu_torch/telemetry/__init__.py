"""Live telemetry for the serving tier (the counterpart of
``spark_rapids_tpu.telemetry``; docs/observability.md "Live telemetry").

Per-query trace files and profiles (``trace.py``, ``profile.py``) are
opted into before a run. A long-lived multi-tenant QueryServer needs the
opposite: telemetry that is on by default, cheap enough never to turn
off, and able to reconstruct what just happened after the fact. The
pieces (the JAX package's command-line front ends, ``tools trace``,
``top``, ``history``, ``doctor``, ``tuning`` and ``bench-diff``, are not
ported yet, ROADMAP A11c; each module's functions are their library
form):

- **flight recorder** (ring.py): ``spark.rapids.sql.trace.mode=ring``
  keeps the last N spans/instants/counter samples per thread in a
  fixed-size lock-free ring behind the existing Tracer; ``dump_ring``
  writes the standard Chrome-trace JSON that ``trace.load_trace`` (and
  the JAX package's) reads;
- **trigger engine** (triggers.py): declarative slow-query / retry /
  HBM-watermark / queue-saturation triggers that emit rate-limited
  *slow-query bundles* (ring dump + profile artifact + server stats +
  the triggering condition) into ``spark.rapids.sql.telemetry.dir``;
- **metrics endpoint** (prometheus.py): the QueryServer's ``metrics``
  protocol verb and its HTTP twin (``start_metrics_http``) export
  the process metric registries + server stats in Prometheus text
  format, fed by a registry-delta aggregator whose counters stay
  monotone across plan lifetimes; ``top.format_top`` renders a live
  per-tenant terminal view over the same stats;
- **regression tracking** (bench_diff.py): ``bench_diff`` diffs
  two bench JSON outputs (headline walls + detail legs) against
  configurable thresholds with a machine-readable verdict and a
  nonzero exit on regression;
- **query history** (history.py): the persistent, bounded JSONL store
  of one record per finished query — the cross-run memory behind
  server warm-start (watchdog p99 + quarantine streaks survive
  restarts), per-tenant SLO burn tracking (``srt_slo_*`` families +
  the ``sloBurn`` trigger), ``format_history`` trends, and the
  doctor's auto-diagnosis (doctor.py) that names WHY a query
  was slow against its signature's historical baseline.
"""

from spark_rapids_tpu_torch.telemetry.ring import RingTrace, dump_ring  # noqa: F401
from spark_rapids_tpu_torch.telemetry import triggers  # noqa: F401
