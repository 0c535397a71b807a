"""Cross-query plan-rewrite cache (the counterpart of
``spark_rapids_tpu.plan_cache``; docs/serving.md).

Every ``plan_physical`` call re-runs the whole rewrite pipeline —
CPU planning, the overrides wrap/tag/convert walk, CBO, whole-stage
fusion — even when the server has seen the exact query shape seconds
earlier from another tenant. This module caches the FINISHED physical
plan per normalized logical-plan signature so a repeated shape skips
``apply_overrides``/CBO/fusion entirely, the way the stage cache already
skips a stage program's capture.

Two load-bearing pieces:

- ``plan_signature``: a structural encoding of the logical plan that
  normalizes expression ids (each submission of the same SQL text
  allocates fresh ids, so raw reprs never collide) while keeping
  literals, schemas, paths, and the session's explicit conf settings in
  the key — two plans share a signature only when they are the same
  query shape over the same data under the same configuration.
  LocalRelation data and other unhashable payloads key by object
  identity: equal-content-but-distinct data simply misses, never
  aliases wrongly.

- ``clone_plan``: cached templates are NEVER executed. Execution mutates
  plan nodes (exchange materialization caches, broadcast builds, join
  build-side device caches, metric registries), so every hit — and the
  miss that populates the cache — clones the pristine template: each
  node is shallow-copied with FRESH metric registries, locks, and
  mutable containers; fused-stage constituents are cloned with their
  stage so metric fan-back and the absorbed-prelude agg reference the
  clone, not the template. Node aliasing (reused broadcast subtrees)
  is preserved via an id-memo. Every attribute in which a run leaves
  device state (``RUN_STATE_ATTRS``: a broadcast's built batch, an
  exchange's materialized handles and statistics) starts empty in each
  clone, so no clone reads or pins another's device memory. Stage
  programs and their CUDA graphs stay shared, keyed as always by the
  stage cache.

The cache itself is a bounded-LRU ``JitCache`` ("planRewrite"), so it
shows up in ``cache_stats()``/bench ``detail.jitCaches`` with hit/miss
rates like every other compile cache, and thousands of distinct ad-hoc
shapes cannot pin plans without bound.
"""

from __future__ import annotations

import copy
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Tuple

from spark_rapids_tpu_torch.jit_cache import JitCache

# value: (physical template, RewriteReport) — both immutable once built
# (the template by the never-execute contract, the report by completion
# of apply_overrides)
PLAN_CACHE = JitCache("planRewrite")

_LOCK_TYPE = type(threading.Lock())
_RLOCK_TYPE = type(threading.RLock())

# attributes in which an execution leaves state on a node, each with the
# value a node that never ran holds: a clone starts from these, whatever
# the template (or a copied node) holds
RUN_STATE_ATTRS = {
    "_built": None,          # TorchBroadcastExchangeExec: the built batch
    "_cache": None,          # TorchShuffleExchangeExec: materialized handles
    "exchange_stats": None,  # the exchange statistics adaptive reads
    "overflow_reruns": 0,    # a partial aggregate's groupbyHash reruns
    "emit_encoded": False,   # set on a scan by its consumer at run time
}


# ---------------------------------------------------------------------------
# Signature
# ---------------------------------------------------------------------------

def signature_digest(signature: str) -> str:
    """Stable short identifier of a plan signature (sha1 hex). The
    lifecycle layer (watchdog p99 history, quarantine streaks) and the
    persistent query-history store key on THIS, not the full encoded
    plan string: the digest is compact enough to persist per record
    and survives restarts, while the plan cache itself keeps the full
    string (a digest collision must never alias two plans)."""
    import hashlib
    return hashlib.sha1(signature.encode()).hexdigest()


def plan_signature(plan, conf) -> str:
    """Normalized structural signature of a logical plan + the explicit
    session settings. Expression ids are renumbered in first-occurrence
    order (``expr_id`` attributes, wherever they appear), so two parses
    of the same SQL text agree; everything else — literals, data types,
    file paths, node parameters — is kept verbatim."""
    from spark_rapids_tpu_torch.sql import expressions as E
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.logical import LogicalPlan

    ids: Dict[int, int] = {}
    parts: List[str] = []

    def enc_val(v) -> str:
        if isinstance(v, (int, float, bool, bytes, type(None))):
            return repr(v)
        if isinstance(v, str):
            return repr(v)
        if isinstance(v, T.DataType):
            return repr(v)
        if isinstance(v, E.Expression):
            return enc_expr(v)
        if isinstance(v, (list, tuple)):
            return "[" + ",".join(enc_val(x) for x in v) + "]"
        if isinstance(v, dict):
            return "{" + ",".join(
                f"{k!r}:{enc_val(v[k])}"
                for k in sorted(v, key=str)) + "}"
        if isinstance(v, LogicalPlan):
            return enc_plan(v)
        # data payloads (HostBatch et al.) and unknown objects key by
        # IDENTITY: distinct objects never falsely match
        return f"<{type(v).__name__}@{id(v)}>"

    def enc_expr(e) -> str:
        frags = [type(e).__name__, "("]
        for k in sorted(vars(e)):
            if k == "children":
                continue
            v = vars(e)[k]
            if k == "expr_id":
                frags.append(f"@{ids.setdefault(v, len(ids))};")
            else:
                frags.append(f"{k}={enc_val(v)};")
        frags.append("|")
        frags.extend(enc_expr(c) for c in e.children)
        frags.append(")")
        return "".join(frags)

    def enc_plan(p) -> str:
        frags = [type(p).__name__, "("]
        for k in sorted(vars(p)):
            if k == "children":
                continue
            frags.append(f"{k}={enc_val(vars(p)[k])};")
        frags.append("|")
        frags.extend(enc_plan(c) for c in p.children)
        frags.append(")")
        return "".join(frags)

    parts.append(enc_plan(plan))
    parts.append("||conf:")
    # serve.* keys (tenant id, admission limits) do not affect
    # planning: excluding them lets tenants SHARE cache entries for the
    # same query shape — the whole point of a cross-query cache.
    # test.inject* keys are runtime fault SCHEDULES, not plan shape
    # (the rewrite never reads them): excluding them keeps one
    # signature per query shape across clean and injected runs, so the
    # quarantine streaks, watchdog p99 history, and the query-history
    # baselines `tools doctor` diffs against all key consistently.
    # adaptive.* keys gate RUNTIME replans over measured exchange
    # stats, not the static rewrite: excluding them keeps adaptive and
    # unadaptive runs of one shape on one signature, so they share
    # baselines/quarantine/doctor history and the doctor can attribute
    # a wall change to an aqeActions delta instead of a shape change
    # (serve.batchFusion.* rides the serve. prefix already excluded
    # above).
    # resultCache.*/subplanCache.* gate the serve-tier caches
    # (docs/caching.md), which never change what a plan computes — only
    # whether a byte-identical result is served from memory: excluding
    # them keeps cache-on and cache-off runs of one shape on one
    # signature, so they share doctor baselines and quarantine streaks.
    # kernel.autotune.* and the per-kernel tuning-parameter confs
    # (tableSlots, maxBuildRows) steer HOW a kernel runs — block
    # shapes, table capacity, sweep policy — never WHAT the plan
    # computes (bit-identity is the kernel tier's contract): excluding
    # them keeps tuned and untuned runs of one shape on one signature,
    # same rationale as test.inject* above.
    parts.append(";".join(
        f"{k}={v}" for k, v in sorted(
            (str(k), str(v)) for k, v in conf.settings.items())
        if not k.startswith((
            "spark.rapids.sql.serve.",
            "spark.rapids.sql.adaptive.",
            "spark.rapids.sql.resultCache.",
            "spark.rapids.sql.subplanCache.",
            # tpu-lint: disable=conf-key(prefix over the test.inject* key family, not a key literal)
            "spark.rapids.sql.test.inject",
            "spark.rapids.sql.kernel.autotune.",
            "spark.rapids.sql.kernel.groupbyHash.tableSlots",
            # tpu-lint: disable=conf-key(the JAX package's joinProbe key, left out of the signature as the JAX package leaves it out; the port registers and reads no such key)
            "spark.rapids.sql.kernel.joinProbe.maxBuildRows"))))
    return "".join(parts)


# ---------------------------------------------------------------------------
# Clone
# ---------------------------------------------------------------------------

def clone_plan(template):
    """A fresh executable instance of a cached physical-plan template:
    per-node shallow copies with fresh metric registries, locks, and
    mutable containers (execution-side in-place mutations — join
    build-side caches, exchange materialization state — must never
    write into the shared template). Reused subtrees (broadcast reuse
    collapses equal exchanges onto one instance) stay reused in the
    clone via the id-memo."""
    from spark_rapids_tpu_torch import metrics as M

    memo: Dict[int, Any] = {}

    def walk(p):
        hit = memo.get(id(p))
        if hit is not None:
            return hit
        q = copy.copy(p)
        memo[id(p)] = q
        for k, v in list(vars(q).items()):
            if k in ("children", "fused_ops", "metrics", "conf"):
                continue
            if isinstance(v, _LOCK_TYPE):
                setattr(q, k, threading.Lock())
            elif isinstance(v, _RLOCK_TYPE):
                setattr(q, k, threading.RLock())
            elif isinstance(v, OrderedDict):
                setattr(q, k, OrderedDict(v))
            elif isinstance(v, dict):
                setattr(q, k, dict(v))
            elif isinstance(v, list):
                setattr(q, k, list(v))
            elif isinstance(v, set):
                setattr(q, k, set(v))
        for k, fresh in RUN_STATE_ATTRS.items():
            if k in vars(q):
                setattr(q, k, fresh)
        reg = getattr(q, "metrics", None)
        if isinstance(reg, M.MetricRegistry):
            q.metrics = reg.clone_empty()
        fops = getattr(p, "fused_ops", None)
        if fops:
            # constituents clone WITH their stage: metric fan-back and
            # the absorbed-prelude agg must reference the clone's ops
            q.fused_ops = [walk(op) for op in fops]
        q.children = [walk(c) for c in p.children]
        if fops and getattr(q, "sink_agg", None) is not None:
            q.sink_agg = q.fused_ops[-1]
            if q.sink_agg._prelude_ops is not None:
                q.sink_agg._prelude_ops = q.fused_ops[:-1]
            q.sink_agg.children = list(q.children)
        return q

    return walk(template)


# ---------------------------------------------------------------------------
# Lookup (session.plan_physical's integration point)
# ---------------------------------------------------------------------------

# per-thread outcome of the latest lookup on THIS thread: the server's
# connection thread plans and executes a request synchronously, so this
# is the race-free way for it to report planCacheHit per response
# (a process-global hits-delta misattributes under concurrency)
_TLS = threading.local()


def last_lookup_was_hit() -> bool | None:
    """Whether the calling thread's most recent plan-cache lookup hit
    (None when no lookup happened on this thread)."""
    return getattr(_TLS, "hit", None)


def rebind_conf(plan, conf_obj) -> None:
    """Point every node of a cloned plan at the EXECUTING session's
    conf. The signature guarantees equality of every planning-relevant
    key, but the excluded families (serve.*, test.inject*) are read at
    EXECUTION time — a cached template built by a clean session must
    not silently strip another session's fault-injection schedule (or
    serve settings) from its clone."""
    if conf_obj is None:
        return
    seen = set()

    def walk(p):
        if id(p) in seen:
            return
        seen.add(id(p))
        if getattr(p, "conf", None) is not None:
            p.conf = conf_obj
        for op in getattr(p, "fused_ops", []):
            walk(op)
        for c in getattr(p, "children", []):
            walk(c)

    walk(plan)


def get_or_clone(signature: str, build,
                 conf_obj=None) -> Tuple[Any, Any, bool]:
    """The cached (clone, report) for ``signature``, building the
    template via ``build()`` — which must return ``(physical plan,
    rewrite report)`` — on a miss. SINGLE-FLIGHT via the underlying
    JitCache: concurrent cold misses of one shape run the rewrite
    pipeline once, the rest wait and clone the winner's template.
    Returns ``(fresh clone, report, was_miss)``; the template itself is
    never executed. ``conf_obj`` (the executing session's conf) rebinds
    the clone's per-node conf so execution-time reads of
    signature-excluded keys follow the EXECUTING session."""
    (template, report), was_miss = PLAN_CACHE.get_or_build(
        signature, build)
    _TLS.hit = not was_miss
    clone = clone_plan(template)
    rebind_conf(clone, conf_obj)
    return clone, report, was_miss


def stats() -> Dict[str, int]:
    return PLAN_CACHE.stats()


# ---------------------------------------------------------------------------
# Pre-warm (docs/tuning.md)
# ---------------------------------------------------------------------------

# signature digests the tuning controller (telemetry/tuning.py) flags
# compile-storm-prone:
# resident templates for these shapes are evicted LAST (the JitCache
# protector below), and the controller's start-of-server replay plans
# their recorded SQL so the template exists before the first client
# hits it. History records carry digests, not full signatures, so the
# protection set is digest-keyed.
_PREWARM_LOCK = threading.Lock()
_PREWARM_DIGESTS: set = set()


def _prewarm_protected(key) -> bool:
    return isinstance(key, str) and \
        signature_digest(key) in _PREWARM_DIGESTS


def set_prewarm_digests(digests) -> None:
    """Install the pre-warm protection set (the whole set each call —
    the controller owns the membership); empty clears protection."""
    with _PREWARM_LOCK:
        _PREWARM_DIGESTS.clear()
        _PREWARM_DIGESTS.update(str(d) for d in digests)
        active = bool(_PREWARM_DIGESTS)
    PLAN_CACHE.set_protector(_prewarm_protected if active else None)


def prewarm_digests() -> set:
    with _PREWARM_LOCK:
        return set(_PREWARM_DIGESTS)
