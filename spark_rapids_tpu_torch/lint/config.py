"""The port's lint configuration (the counterpart of
``spark_rapids_tpu.lint.config``).

The defaults describe the port's own tree: its scopes, the allocation and
launch sites the retry rule tracks, the critical locks and the sanctioned
sites. A ``torch-lint.json`` at the repo root can merge overrides for the
file-based knobs (no runtime conf keys: lint config lives outside the
spark.rapids.* registry)::

    {
      "check_docs": false,
      "retry_allowlist": {"pkg/mod.py::fn": "why this site is exempt"},
      "baseline": "torch-lint-baseline.json"
    }

Every allowlist entry maps ``<repo-relative-path>::<qualname>`` to a
written reason, as the suppression grammar demands a reason.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

CONFIG_FILENAME = "torch-lint.json"

_PKG = "spark_rapids_tpu_torch/"
_PLAIN = ("runs on CPU tensors only; on the card the kernel launches "
          "instead, so this never syncs there")
_ORACLE = ("autotune oracle validation, not a query path: it runs once "
           "per (kernel, bucket, device) sweep and must resolve the "
           "bit-equality verdict before timing")
_C2R = ("the columnar-to-row download: the rows leave the card here, "
        "once per batch the consumer reads")

_SYNC_ALLOWLIST: Dict[str, str] = {
    _PKG + "exec/exchange.py::split_by_pid":
        "the ONE documented counts sync per input batch (contiguousSplit):"
        " partition row counts are attached so downstream consumers never "
        "re-sync",
    _PKG + "ops/join.py::device_join":
        "the ONE sizing sync per probe: all three scalars ride one "
        "stacked fetch, and the FK fast path (run_fast without a count) "
        "skips it entirely",
    _PKG + "exec/agg.py::TorchHashAggregateExec._run_partial":
        "pipelineDrainTime: every batch's group count and overflow flag "
        "of a partition read in one copy after the partition is drained",
    _PKG + "kernels/groupby_hash.py::groupby_table_plain": _PLAIN,
    _PKG + "kernels/join_probe.py::build_probe_plain": _PLAIN,
    _PKG + "ops/hashing.py::murmur3_columns": _PLAIN,
    _PKG + "columnar/transfer.py::_encoded_decode_body": _PLAIN,
    _PKG + "kernels/autotune.py::_launch_ms": _ORACLE,
    _PKG + "kernels/autotune.py::_GroupbyProbe.__init__": _ORACLE,
    _PKG + "kernels/autotune.py::_GroupbyProbe.check": _ORACLE,
    _PKG + "kernels/autotune.py::_DecodeProbe.__init__": _ORACLE,
    _PKG + "kernels/autotune.py::_DecodeProbe.check": _ORACLE,
    _PKG + "columnar/device.py::DeviceBatch.to_host": _C2R,
    _PKG + "columnar/device.py::finish_to_host": _C2R,
    _PKG + "columnar/device.py::_col_to_host": _C2R,
    _PKG + "columnar/device.py::_array_to_host": _C2R,
    _PKG + "columnar/transfer.py::StagingRing.place":
        "the upload ring's slot wait: a pinned slot is refilled only "
        "after the copy that last read it has completed",
    _PKG + "exec/fused.py::StageProgram.build":
        "the stage build's one side-stream synchronize, once per capture "
        "and never once per batch",
    _PKG + "exec/fused.py::StageProgram.release":
        "a cached graph's release (an LRU eviction or the retry "
        "protocol's recovery, never once per batch) waits for its last "
        "replay, which may run on another thread's stream, before the "
        "static buffers go back to the allocator",
    _PKG + "columnar/device.py::DeviceBatch.row_count":
        "the host row count a caller asks for (concatenation sizing, the "
        "coalescer's goal, empty-batch skips), read once and kept in "
        "_num_rows; the JAX package's row_count takes the same read, and "
        "operators count rows with row_count_lazy",
    _PKG + "parallel/ici.py::mesh_exchange":
        "the size-exchange handshake: one [n, n] per-(source, destination) "
        "counts read sizes the send blocks to the real occupancy before "
        "any block moves (the JAX package's own reason)",
    _PKG + "parallel/step.py::dryrun_multichip":
        "the dry run's check, not a query path: it reads the step's "
        "outputs once to hold them against a host reduction",
    _PKG + "ops/join.py::build_key_max_multiplicity":
        "the build side's key multiplicity, read once per broadcast build "
        "side: 1 certifies every stream chunk for the FK fast path with no "
        "per-chunk sizing read (the JAX package's sanctioned drain point, "
        "which prefetches it)",
}

_PURITY_ALLOWLIST: Dict[str, str] = {
    _PKG + "kernels/groupby_hash.py::groupby_table_plain": _PLAIN,
    _PKG + "ops/exprs.py::_literal_tensors":
        "dev_eval makes a literal's tensors here only for a literal that "
        "is not among the program's inputs, in eager evaluation; a stage "
        "program takes every literal as an input tensor "
        "(stage_literal_values), so no capture reaches it",
}


@dataclasses.dataclass
class LintConfig:
    # directories (relative to the lint root) scanned for *.py
    scan_roots: Tuple[str, ...] = ("spark_rapids_tpu_torch",)

    # -- retry-coverage ----------------------------------------------------
    # files whose device allocation and kernel launch sites must sit
    # inside the OOM retry protocol (retry.py)
    retry_scope: Tuple[str, ...] = (
        "spark_rapids_tpu_torch/exec/",
        "spark_rapids_tpu_torch/parallel/",
        "spark_rapids_tpu_torch/columnar/transfer.py",
        "spark_rapids_tpu_torch/columnar/device.py",
    )
    retry_wrappers: Tuple[str, ...] = (
        "with_retry", "with_split_retry", "io_with_retry")
    # device allocation / upload / kernel-launch entry points the rule
    # tracks: the upload protocol's halves, and the wrappers of the
    # hand-written kernels
    alloc_entrypoints: Tuple[str, ...] = (
        "finish_upload", "finish_started", "upload_batch",
        "groupby_table", "hash_groupby", "build_probe", "murmur3_columns",
        "decode_fused")
    # torch allocators the rule tracks when they are handed a device=,
    # in the operators (alloc_scope); the columnar helpers below them are
    # the batch programs the operators run, under the protocol there
    alloc_scope: Tuple[str, ...] = ("spark_rapids_tpu_torch/exec/",)
    alloc_calls: Tuple[str, ...] = (
        "torch.empty", "torch.zeros", "torch.full", "torch.ones",
        "torch.arange", "torch.tensor", "torch.empty_like",
        "torch.zeros_like", "torch.full_like")
    # "<rel>::<qualname>" -> reason. The protocol's own implementation
    # layer: the wrapped sites wrap their CALLERS, so the raw calls
    # inside them are the sanctioned copies.
    retry_allowlist: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "spark_rapids_tpu_torch/columnar/transfer.py::upload_batch":
                "composition of the upload's halves; every call site "
                "runs it under with_retry or with_split_retry",
            "spark_rapids_tpu_torch/exec/basic.py::_part_ctx":
                "two 0-d scalars made once a partition, before its batch "
                "loop (spark_partition_id and the row offset)",
            "spark_rapids_tpu_torch/columnar/transfer.py::decode_staged":
                "the decode of a staged token, reached only through "
                "finish_upload and finish_started, whose callers wrap "
                "them in with_retry",
            "spark_rapids_tpu_torch/parallel/ici.py::mesh_exchange":
                "runs under the exchange materializer's with_retry (the "
                "mesh path of exec/exchange.py), as in the JAX package",
            "spark_rapids_tpu_torch/columnar/device.py::DeviceBatch"
            ".from_host":
                "the test and tool entry that uploads one HostBatch; "
                "every exec uploads through the ring's retry protocol",
        })

    # -- concurrency -------------------------------------------------------
    concurrency_scope: Tuple[str, ...] = (
        "spark_rapids_tpu_torch/memory.py",
        "spark_rapids_tpu_torch/resource.py",
        "spark_rapids_tpu_torch/jit_cache.py",
        "spark_rapids_tpu_torch/kernels/",
        "spark_rapids_tpu_torch/serve/",
    )
    # holding one of these, a blocking call is a stall for every task or
    # query in the process (the device store, the semaphore, the
    # scheduler and the stage-program cache)
    critical_locks: Tuple[str, ...] = (
        "DeviceStore._lock", "TorchSemaphore._cv",
        "AdmissionController._cv", "JitCache._lock")

    # -- cancellation discipline -------------------------------------------
    # files whose blocking waits must be cancellable: a bounded timeout
    # (re-checked in a loop) or a lifecycle-aware helper
    cancel_scope: Tuple[str, ...] = (
        "spark_rapids_tpu_torch/serve/",
        "spark_rapids_tpu_torch/retry.py",
        "spark_rapids_tpu_torch/jit_cache.py",
    )

    # -- compile discipline ------------------------------------------------
    # the bounded single-flight cache module (module dict caches of
    # built programs are sanctioned only here)
    jit_home: str = "spark_rapids_tpu_torch/jit_cache.py"
    # the one module that builds CUDA graphs, under run_program's stage
    # cache
    graph_home: str = "spark_rapids_tpu_torch/exec/fused.py"

    # -- data-flow tier ----------------------------------------------------
    # hot-path scopes where a hidden device->host sync stalls the host's
    # queue of work for the card
    hot_scope: Tuple[str, ...] = (
        "spark_rapids_tpu_torch/exec/",
        "spark_rapids_tpu_torch/ops/",
        "spark_rapids_tpu_torch/kernels/",
        "spark_rapids_tpu_torch/columnar/",
        "spark_rapids_tpu_torch/parallel/",
    )
    # "<rel>::<qualname>" -> reason: the SANCTIONED drain points, each a
    # deliberate sync the design is built around (an entry covers the
    # function and the defs nested in it). chip_smoke.py's sync_audit
    # phase holds this list against the syncs q1 and q3 take on the card.
    sync_allowlist: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(_SYNC_ALLOWLIST))
    # registration entry points whose returned handle must reach a
    # close/release_*/finish_* call or escape to a tracked container:
    # a bare name matches the call's name; "recv.name" matches it on a
    # receiver whose last name contains "recv" (the upload ring's
    # place and start, which stand where the JAX package's start_upload
    # stands); `<store>.register` is matched by receiver too
    handle_sources: Tuple[str, ...] = (
        "register_spillable", "ring.place", "ring.start")
    # "<rel>::<qualname>" -> reason for capture-purity exemptions
    purity_allowlist: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(_PURITY_ALLOWLIST))

    # -- drift -------------------------------------------------------------
    metrics_rel: str = "spark_rapids_tpu_torch/metrics.py"
    trace_rel: str = "spark_rapids_tpu_torch/trace.py"
    # the telemetry endpoint module whose SERVER_FAMILY_HELP table the
    # prom-family rule checks emissions against
    prometheus_rel: str = "spark_rapids_tpu_torch/telemetry/prometheus.py"
    # the query-history module whose HISTORY_FIELD_CATALOG the
    # history-field rule checks record construction against
    history_rel: str = "spark_rapids_tpu_torch/telemetry/history.py"
    # the feedback-control module whose ACTION_CATALOG the tuning-action
    # rule checks action construction against
    tuning_rel: str = "spark_rapids_tpu_torch/telemetry/tuning.py"
    # the call that registers a conf key (conf.py's ``_entry``)
    conf_registrar: str = "_entry"
    # generated docs compared against `tools docs` regeneration
    check_docs: bool = True

    # -- engine ------------------------------------------------------------
    baseline: str = "torch-lint-baseline.json"
    # total lint wall budget in seconds: `tools lint` exits 2 when a run
    # exceeds it
    time_budget_s: float = 60.0


def load_config(root: str) -> LintConfig:
    """Defaults, merged with an optional ``torch-lint.json`` at root."""
    cfg = LintConfig()
    path = os.path.join(root, CONFIG_FILENAME)
    if not os.path.exists(path):
        return cfg
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    for key in ("check_docs", "baseline", "jit_home", "graph_home",
                "metrics_rel", "trace_rel", "prometheus_rel", "history_rel",
                "tuning_rel", "conf_registrar", "time_budget_s"):
        if key in data:
            setattr(cfg, key, data[key])
    for key in ("scan_roots", "retry_scope", "retry_wrappers",
                "alloc_entrypoints", "alloc_scope", "alloc_calls",
                "concurrency_scope", "critical_locks", "cancel_scope",
                "hot_scope", "handle_sources"):
        if key in data:
            setattr(cfg, key, tuple(data[key]))
    for key in ("retry_allowlist", "sync_allowlist", "purity_allowlist"):
        if key in data:
            merged = dict(getattr(cfg, key))
            merged.update(data[key])
            setattr(cfg, key, merged)
    return cfg
