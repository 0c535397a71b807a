"""The port's AST-based invariant checker (the counterpart of
``spark_rapids_tpu.lint``), limited to the rules whose invariants the
port shares with the JAX package:

* ``retry-coverage`` — device allocation, upload and kernel-launch sites
  in exec/ and the upload codec run under the OOM retry protocol
  (``retry.with_retry`` / ``with_split_retry`` / ``io_with_retry``).
* ``lock-order`` / ``lock-blocking-call`` / ``check-then-act`` — the
  lock-acquisition graph of memory, resource, jit_cache, kernels and
  serve.
* ``metric-key`` / ``conf-key`` / ``span-scope`` / ``span-kind`` /
  ``prom-family`` / ``history-field`` / ``tuning-action`` /
  ``docs-drift`` — metric keys resolve in ``describe_metric``,
  ``spark.rapids.*`` literals are registered confs, spans are
  with-scoped and catalogued, the telemetry vocabularies are declared,
  and ``docs/torch/`` is what ``tools docs`` writes.
* ``cancel-checkpoint`` — blocking waits in serve/, retry.py and
  jit_cache.py stay cancellable.
* ``graph-direct`` / ``jit-module-cache`` — CUDA graphs are built only
  in exec/fused.py under the stage cache, and no module dict caches built
  programs outside jit_cache.py.
* ``hidden-sync`` / ``handle-leak`` / ``capture-purity`` — the
  interprocedural data-flow tier (``lint/dataflow.py``): no unallowlisted
  device->host sync in exec/, ops/, kernels/ and columnar/ (the
  ``sync_allowlist``, which ``chip_smoke.py``'s ``sync_audit`` phase holds
  against the syncs taken on the card), every spillable handle and
  upload-ring token deterministically released or escaped, and nothing
  reachable from a CUDA graph capture that syncs, copies from pageable
  memory, reads clocks, RNG or conf, or mutates module state.
* ``bad-suppression`` — every suppression carries a reason.

The JAX linter's ``donation-safety`` rule has no counterpart (PyTorch
donates no buffer: a graph replay copies each batch into its static
inputs), nor has the Pallas half of ``jit-direct`` (the port's kernels are
CUDA C++ bound with ``ctypes``).

CLI: ``python -m spark_rapids_tpu_torch.tools lint`` (exit 0 clean /
1 findings / 2 internal error). Per-line suppressions must carry a
reason, in the JAX linter's grammar:
``# tpu-lint: disable=rule-name(reason)``.

The package is stdlib-only (``ast`` + ``tokenize``); only the
``docs-drift`` rule imports the runtime doc generators.
"""

from spark_rapids_tpu_torch.lint.config import LintConfig, load_config
from spark_rapids_tpu_torch.lint.engine import (Finding, LintResult,
                                                default_root, render_human,
                                                render_json, run_cli,
                                                run_lint)

# rule modules self-register on import
from spark_rapids_tpu_torch.lint import rules_retry  # noqa: F401,E402
from spark_rapids_tpu_torch.lint import rules_jit  # noqa: F401,E402
from spark_rapids_tpu_torch.lint import rules_concurrency  # noqa: F401,E402
from spark_rapids_tpu_torch.lint import rules_drift  # noqa: F401,E402
from spark_rapids_tpu_torch.lint import rules_lifecycle  # noqa: F401,E402
from spark_rapids_tpu_torch.lint import rules_dataflow  # noqa: F401,E402

__all__ = ["LintConfig", "load_config", "Finding", "LintResult",
           "run_lint", "run_cli", "render_human", "render_json",
           "default_root"]
