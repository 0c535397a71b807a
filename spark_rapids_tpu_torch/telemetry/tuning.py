"""History-driven feedback control: the server that tunes itself (the
counterpart of ``spark_rapids_tpu.telemetry.tuning``; docs/tuning.md).

The query history, the per-signature aggregates, the doctor's verdicts
and SLO burn tracking are the sensors; this module is the actuation.
The server embeds a :class:`TuningController`
(``spark.rapids.sql.serve.tuning.enabled``; requires
``telemetry.history.dir``) that, at server start and on a periodic
tick, scores the history through the ``signature_aggregates`` +
doctor-verdict pipeline and applies per-signature actions from the
declared :data:`ACTION_CATALOG`:

- ``compileStorm`` -> **prewarmCaches**: replay the signature's
  recorded SQL through the planning path at server start so the plan
  template exists before the first client hits it, and protect the
  entry from LRU eviction (``plan_cache.set_prewarm_digests``);
- ``retrySpill`` -> **limitConcurrency** (narrow that signature's
  admission concurrency — fewer copies of a spill-prone shape in
  flight means each gets more HBM headroom) and/or **seedOutOfCore**
  (turn the budget oracle on so joins/aggs partition up front,
  docs/out_of_core.md);
- ``kernelFallback``: no action. The JAX package flips the culprit
  kernel's enable conf here; the port has no kernel enable confs and no
  oracle fallback (a wrapper launches its kernel or raises), so its own
  queries never earn the verdict, and one read from a JAX-written
  history is left alone;
- SLO burn -> **tenantWeight**: shift the burning tenant's admission
  weight up so it gets a larger fair share.

Every action is BOUNDED (per-knob min/max clamps declared in the
catalog), LOGGED (a ``tuning`` record in the same history store — the
audit trail rides the store's durability), EXPORTED (``srt_tuning_*``
Prometheus families), INSPECTABLE (``format_tuning``; pin/revert by
epoch through the state file's control flags), and GUARDED: each applied action remembers the pre-action
p50/p99 baseline, and once ``serve.tuning.guardWindowQueries``
post-action finished records exist for its scope the controller diffs
observed p50/p99 against that baseline with the same relative-change
discipline ``bench_diff`` gates on — a regression past
``serve.tuning.revertThreshold`` auto-reverts the action and logs a
``revert`` record. ``site:tuning:N`` in the fault grammar injects a
deliberately harmful synthetic action at the Nth tick so the
observe-and-revert loop is deterministically testable.

State (action list, epoch counter, pre-warm ledger) persists in
``<history_dir>/tuning-state.json``: applied actions re-apply at the
next server start — a retry-storm shape admitted narrowly today is
admitted narrowly tomorrow — and pin/revert requests are control flags
the controller honors at its next tick, so a request never races the
live server's knob writes.

Tuning never changes what a query COMPUTES — only admission shaping,
cache residency and out-of-core planning, all of which are
bit-identity-preserving by their own contracts.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from spark_rapids_tpu_torch.conf import (SERVE_TUNING_ENABLED,
                                         SERVE_TUNING_GUARD_WINDOW,
                                         SERVE_TUNING_INTERVAL_S,
                                         SERVE_TUNING_MAX_ACTIONS,
                                         SERVE_TUNING_MAX_PREWARM,
                                         SERVE_TUNING_REVERT_THRESHOLD,
                                         TELEMETRY_HISTORY_DIR)
from spark_rapids_tpu_torch.telemetry.history import (STATUS_FINISHED,
                                                      STATUS_REVERT,
                                                      STATUS_TUNING,
                                                      build_tuning_record,
                                                      read_records, sig_digest,
                                                      store_for)

STATE_FILE = "tuning-state.json"
STATE_VERSION = 1

# Internal (non-conf) knobs an action may write. Everything else a
# catalog entry names must be a registered conf key
# (tests/test_torch_tuning.py checks both).
KNOB_SIGNATURE_CONCURRENCY = "signatureConcurrency"
KNOB_TENANT_WEIGHT = "tenantWeight"
KNOB_PREWARM = "prewarm"
INTERNAL_KNOBS = (KNOB_SIGNATURE_CONCURRENCY, KNOB_TENANT_WEIGHT,
                  KNOB_PREWARM)

# The declared action vocabulary: every action the controller
# constructs (`_new_action("<name>", ...)`) is a key here, and every
# `spark.rapids.*` knob below is a registered conf key. The JAX
# package's `kernelFallback` action is deliberately absent (the port has
# no kernel enable confs). Bounds are inclusive clamps on the written
# value (booleans clamp on
# 0/1); `verdict` is the doctor verdict (or `sloBurn`) that motivates
# the action.
ACTION_CATALOG: Dict[str, Dict[str, Any]] = {
    "prewarmCaches": {
        "verdict": "compileStorm",
        "knob": "prewarm",
        "min": 0, "max": 1,
        "doc": "add the signature to the pre-warm ledger: its recorded "
               "SQL replays through the planning path at server start "
               "(plan template built before the first client hits it) "
               "and the plan-cache entry is protected from LRU "
               "eviction; ledger size bounded by "
               "serve.tuning.maxPrewarm",
    },
    "limitConcurrency": {
        "verdict": "retrySpill",
        "knob": "signatureConcurrency",
        "min": 1, "max": 4,
        "doc": "cap the signature's concurrent admissions "
               "(AdmissionController per-signature limit): fewer "
               "copies of a spill-prone shape in flight means each "
               "gets more HBM headroom instead of riding the "
               "spill-and-retry loop",
    },
    "seedOutOfCore": {
        "verdict": "retrySpill",
        "knob": "spark.rapids.sql.outOfCore.enabled",
        "min": 0, "max": 1,
        "doc": "turn the budget oracle on server-wide so joins/aggs "
               "over-budget partition UP FRONT (docs/out_of_core.md) "
               "instead of discovering the overflow via retry storms",
    },
    "tenantWeight": {
        "verdict": "sloBurn",
        "knob": "tenantWeight",
        "min": 0.25, "max": 4.0,
        "doc": "raise the burning tenant's admission weight "
               "(AdmissionController fair-share cap scales by it) so "
               "the tenant missing its p99 objective gets a larger "
               "share of the in-flight budget",
    },
}

# how many distinct sql<->signature pairs the controller remembers for
# the prewarm ledger / admission hints (bounded: ad-hoc shapes must
# not grow it without limit)
_SQL_MAP_CAP = 256


# ---------------------------------------------------------------------------
# State file (the CLI's integration point)
# ---------------------------------------------------------------------------

def state_path(history_dir: str) -> str:
    return os.path.join(history_dir, STATE_FILE)


def load_state(history_dir: str) -> Dict[str, Any]:
    """The persisted controller state (empty skeleton when absent or
    unreadable — a torn write must not take the server down)."""
    try:
        with open(state_path(history_dir), encoding="utf-8") as f:
            st = json.load(f)
        if isinstance(st, dict) and isinstance(st.get("actions"), list):
            st.setdefault("version", STATE_VERSION)
            st.setdefault("epoch", 0)
            st.setdefault("prewarm", {})
            return st
    except (OSError, ValueError):
        pass
    return {"version": STATE_VERSION, "epoch": 0, "actions": [],
            "prewarm": {}}


def save_state(history_dir: str, state: Dict[str, Any]) -> None:
    """Atomic replace (tmp + rename): the CLI and a crashing server
    must never leave a half-written state file."""
    try:
        os.makedirs(history_dir, exist_ok=True)
        tmp = state_path(history_dir) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=1, default=str)
        os.replace(tmp, state_path(history_dir))
    except OSError:
        pass


def format_tuning(state: Dict[str, Any]) -> str:
    """The `tools tuning` table: one row per action, newest first."""
    acts = list(state.get("actions") or [])
    lines = ["=== TPU Tuning Controller ===",
             f"epoch {state.get('epoch', 0)}, "
             f"{len(acts)} action(s) on record", ""]
    if not acts:
        lines.append("no tuning actions recorded")
        return "\n".join(lines)
    lines.append(
        f"  {'epoch':>5s} {'action':17s} {'scope':18s} {'knob':24s} "
        f"{'old->new':14s} {'state':9s} flags")
    for a in sorted(acts, key=lambda a: -int(a.get("epoch", 0))):
        scope = str(a.get("scope") or "-")
        if len(scope) > 18:
            scope = scope[:15] + "..."
        flags = []
        if a.get("pinned"):
            flags.append("pinned")
        if a.get("revertRequested"):
            flags.append("revert-requested")
        if (a.get("evidence") or {}).get("injected"):
            flags.append("injected")
        ov = a.get("oldValue")
        delta = (("-" if ov is None else str(ov)) + "->"
                 + str(a.get("newValue")))
        lines.append(
            f"  {a.get('epoch', 0):5d} {a.get('action', '?'):17s} "
            f"{scope:18s} {str(a.get('knob') or '-'):24s} "
            f"{delta:14s} "
            f"{a.get('state', '?'):9s} {','.join(flags) or '-'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

class TuningController:
    """The feedback-control loop the QueryServer embeds.

    Collaborators are passed explicitly (never reached through the
    server object) so the controller is testable standalone:

    - ``admission``: an AdmissionController (set_signature_limit /
      signature_limit / set_tenant_weight / tenant_weight);
    - ``slo``: an SloTracker (or None) for the sloBurn action;
    - ``session_for(tenant)``: a session factory for the start-of-
      server pre-warm replay (None disables replay — the protection
      set still installs);
    - ``set_conf(key, value)`` / ``get_conf(key)``: server-wide conf
      write/read for conf-knob actions (out-of-core
      seeding); ``value=None`` removes the override.
    """

    def __init__(self, conf_obj, admission=None, slo=None,
                 session_for: Optional[Callable[[str], Any]] = None,
                 set_conf: Optional[Callable[[str, Any], None]] = None,
                 get_conf: Optional[Callable[[str], Any]] = None):
        self._conf = conf_obj
        self._admission = admission
        self._slo = slo
        self._session_for = session_for
        self._set_conf = set_conf
        self._get_conf = get_conf
        self._dir = str(conf_obj.get(TELEMETRY_HISTORY_DIR) or "")
        self._interval_s = float(conf_obj.get(SERVE_TUNING_INTERVAL_S))
        self._max_actions = int(conf_obj.get(SERVE_TUNING_MAX_ACTIONS))
        self._guard_window = int(conf_obj.get(SERVE_TUNING_GUARD_WINDOW))
        self._revert_threshold = float(
            conf_obj.get(SERVE_TUNING_REVERT_THRESHOLD))
        self._max_prewarm = int(conf_obj.get(SERVE_TUNING_MAX_PREWARM))
        self._lock = threading.RLock()
        self._state = load_state(self._dir) if self._dir else {
            "version": STATE_VERSION, "epoch": 0, "actions": [],
            "prewarm": {}}
        # sql <-> signature learning (observe()): digest -> {sql,
        # tenant} feeds the prewarm ledger; sql -> digest feeds the
        # admission hint (planning happens AFTER admission, so the
        # server can only shape admission for shapes it has seen)
        self._sig_sql: Dict[str, Dict[str, str]] = {}
        self._sql_sig: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (stats() -> srt_tuning_* families)
        self.ticks = 0
        self.actions_applied = 0
        self.actions_reverted = 0
        self.prewarm_replayed = 0
        self.last_scan_ts = 0.0

    @property
    def enabled(self) -> bool:
        return bool(self._dir) and bool(
            self._conf.get(SERVE_TUNING_ENABLED))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Re-apply persisted actions, replay the pre-warm ledger, run
        the start-of-server scan, then start the tick thread."""
        if not self.enabled:
            return
        with self._lock:
            self._reapply_persisted()
            self._replay_prewarm()
        self.tick()
        if self._interval_s > 0:
            self._thread = threading.Thread(
                target=self._tick_loop, name="srt-tuning-tick",
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def _tick_loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            self.tick()

    # -- learning hooks (the server's request path) ------------------------

    def observe(self, sql: str, signature: Optional[str],
                tenant: Optional[str] = None) -> None:
        """Learn one executed query's sql<->signature pairing (digest
        form). Bounded maps; never raises."""
        if not sql or not signature:
            return
        with self._lock:
            if len(self._sql_sig) >= _SQL_MAP_CAP:
                self._sql_sig.clear()
                self._sig_sql.clear()
            self._sql_sig[sql] = signature
            self._sig_sql[signature] = {"sql": sql,
                                        "tenant": tenant or "default"}

    def signature_hint(self, sql: str) -> Optional[str]:
        """The signature digest this sql planned to last time (None for
        never-seen text) — the admission layer's per-signature limits
        need the digest BEFORE planning resolves it."""
        with self._lock:
            return self._sql_sig.get(sql)

    # -- the scan tick -----------------------------------------------------

    def tick(self) -> None:
        """One control iteration: honor CLI control flags, judge
        applied actions against their guard windows, then scan the
        history for new evidence and apply up to maxActionsPerTick new
        actions. Never raises — tuning must not take the server down."""
        if not self.enabled:
            return
        try:
            with self._lock:
                self.ticks += 1
                self.last_scan_ts = time.time()
                self._merge_control_flags()
                records = read_records(self._dir)
                self._honor_revert_requests()
                self._evaluate_guardrails(records)
                budget = self._max_actions
                budget -= self._maybe_inject_harmful()
                if budget > 0:
                    self._scan_and_apply(records, budget)
                save_state(self._dir, self._state)
        except Exception:
            pass

    def _merge_control_flags(self) -> None:
        """Take `pinned` / `revertRequested` per epoch from the ON-DISK
        state: `tools tuning` writes those flags (possibly while this
        server runs), and honoring them here means the CLI never races
        the controller's own knob writes."""
        disk = load_state(self._dir)
        by_epoch = {int(a.get("epoch", 0)): a
                    for a in disk.get("actions", [])}
        for a in self._state["actions"]:
            d = by_epoch.get(int(a.get("epoch", 0)))
            if d is not None:
                a["pinned"] = bool(d.get("pinned"))
                a["revertRequested"] = bool(d.get("revertRequested"))

    def _honor_revert_requests(self) -> None:
        for a in self._state["actions"]:
            if a.get("state") in ("applied", "accepted") and \
                    a.get("revertRequested"):
                self._revert(a, why="operator revert via tools tuning")

    # -- action construction / application ---------------------------------

    def _new_action(self, action: str, scope: str, knob: str,
                    old_value, new_value,
                    evidence: Dict[str, Any]) -> Dict[str, Any]:
        """The ONE construction point for actions (the tpu-lint
        `tuning-action` rule pins the literal name passed here to
        ACTION_CATALOG). Clamps the new value to the catalog bounds,
        assigns the epoch, and validates the knob against the catalog
        declaration."""
        cat = ACTION_CATALOG[action]
        allowed = cat.get("knobs", [cat["knob"]])
        if knob not in allowed and knob not in INTERNAL_KNOBS:
            raise ValueError(f"knob {knob!r} not declared for "
                             f"action {action!r}")
        if isinstance(new_value, (int, float)) \
                and not isinstance(new_value, bool):
            clamped = min(cat["max"], max(cat["min"], new_value))
        else:
            # bool / conf-string values ("true"/"false") have no
            # numeric range; the [min, max] column documents them as
            # the 0/1 domain
            clamped = new_value
        self._state["epoch"] = int(self._state.get("epoch", 0)) + 1
        return {
            "epoch": self._state["epoch"],
            "action": action,
            "scope": scope,
            "knob": knob,
            "oldValue": old_value,
            "newValue": clamped,
            "evidence": evidence,
            "state": "applied",
            "pinned": False,
            "revertRequested": False,
            "appliedTs": time.time(),
        }

    def _active(self, action: str, scope: str) -> bool:
        return any(a.get("action") == action and a.get("scope") == scope
                   and a.get("state") in ("applied", "accepted")
                   for a in self._state["actions"])

    def _write_knob(self, act: Dict[str, Any], value) -> None:
        """Actuate one knob write (apply or revert). Internal knobs go
        to the admission controller / pre-warm ledger; conf knobs go
        through the server's conf hook."""
        knob = act["knob"]
        scope = act["scope"]
        if knob == KNOB_SIGNATURE_CONCURRENCY:
            if self._admission is not None:
                self._admission.set_signature_limit(
                    scope, None if value is None else int(value))
        elif knob == KNOB_TENANT_WEIGHT:
            tenant = scope.split(":", 1)[1] if ":" in scope else scope
            if self._admission is not None:
                self._admission.set_tenant_weight(
                    tenant, 1.0 if value is None else float(value))
        elif knob == KNOB_PREWARM:
            if value:
                # prefer the live sql<->signature map, but fall back
                # to the persisted entry: at server start the re-apply
                # runs before any query is observed, and the ledger's
                # recorded SQL must survive the restart (it IS the
                # replay input)
                info = self._sig_sql.get(scope) \
                    or self._state["prewarm"].get(scope) or {}
                self._state["prewarm"][scope] = {
                    "sql": info.get("sql", ""),
                    "tenant": info.get("tenant", "default")}
                # ledger bound: oldest entries drop first (dict order
                # is insertion order)
                while len(self._state["prewarm"]) > self._max_prewarm:
                    self._state["prewarm"].pop(
                        next(iter(self._state["prewarm"])))
            else:
                self._state["prewarm"].pop(scope, None)
            from spark_rapids_tpu_torch import plan_cache as PC
            PC.set_prewarm_digests(set(self._state["prewarm"]))
        else:
            if self._set_conf is not None:
                self._set_conf(knob, value)

    def _record(self, status: str, act: Dict[str, Any],
                old_value, new_value,
                evidence: Dict[str, Any]) -> None:
        store = store_for(self._conf)
        if store is None:
            return
        scope = act["scope"]
        sig = scope if not scope.startswith("tenant:") else None
        tenant = scope.split(":", 1)[1] \
            if scope.startswith("tenant:") else None
        store.append(build_tuning_record(
            status=status, action=act["action"], scope=scope,
            knob=act["knob"], old_value=old_value, new_value=new_value,
            evidence=evidence, epoch=act["epoch"], tenant=tenant,
            signature=sig))

    def _apply(self, act: Dict[str, Any]) -> None:
        self._write_knob(act, act["newValue"])
        self._state["actions"].append(act)
        self.actions_applied += 1
        self._record(STATUS_TUNING, act, act["oldValue"],
                     act["newValue"], act["evidence"])

    def _revert(self, act: Dict[str, Any], why: str,
                observed: Optional[Dict[str, Any]] = None) -> None:
        self._write_knob(act, act["oldValue"])
        act["state"] = "reverted"
        act["revertRequested"] = False
        act["revertedTs"] = time.time()
        self.actions_reverted += 1
        ev = {"why": why}
        if observed:
            ev["observed"] = observed
        ev["baseline"] = (act.get("evidence") or {}).get("baseline")
        self._record(STATUS_REVERT, act, act["newValue"],
                     act["oldValue"], ev)

    # -- persisted re-apply + pre-warm replay (server start) ---------------

    def _reapply_persisted(self) -> None:
        """Applied/accepted actions from the state file actuate again
        at start: the knobs live in server memory, the DECISIONS live
        on disk — a retry-storm shape admitted narrowly yesterday is
        admitted narrowly from query one today."""
        for a in self._state["actions"]:
            if a.get("state") in ("applied", "accepted") and \
                    not a.get("revertRequested"):
                try:
                    self._write_knob(a, a["newValue"])
                except Exception:
                    pass

    def _replay_prewarm(self) -> None:
        """Plan each pre-warm ledger entry's recorded SQL so the plan
        cache holds its template BEFORE the first client request (the
        compile-storm action's whole point). Best-effort per entry: a
        view that no longer exists skips, never fails the start."""
        from spark_rapids_tpu_torch import plan_cache as PC
        PC.set_prewarm_digests(set(self._state["prewarm"]))
        if self._session_for is None:
            return
        for digest, info in list(self._state["prewarm"].items()):
            sql = info.get("sql") or ""
            if not sql:
                continue
            try:
                s = self._session_for(info.get("tenant", "default"))
                # the port's session plans through the plan cache only
                # on request (its execute path asks)
                s.plan_physical(s.sql(sql).plan, use_plan_cache=True)
                self.prewarm_replayed += 1
                self._sql_sig[sql] = digest
                self._sig_sql[digest] = dict(info)
            except Exception:
                pass

    # -- guardrail ---------------------------------------------------------

    def _scope_walls(self, records: List[Dict[str, Any]],
                     scope: str, since: float) -> List[float]:
        """Post-action finished walls for an action's scope (signature
        digest or tenant:<id>), cache-served and control-plane records
        excluded — the same hygiene every baseline in the package
        applies."""
        tenant = scope.split(":", 1)[1] \
            if scope.startswith("tenant:") else None
        out = []
        for r in records:
            if r.get("status") != STATUS_FINISHED \
                    or r.get("resultCacheHit"):
                continue
            if float(r.get("ts", 0)) <= since:
                continue
            if tenant is not None:
                if r.get("tenant") != tenant:
                    continue
            elif r.get("signature") != scope:
                continue
            out.append(float(r.get("wallSeconds", 0.0)))
        return out

    def _evaluate_guardrails(self, records: List[Dict[str, Any]]
                             ) -> None:
        """Judge each applied, unpinned action once its guard window
        filled: relative change = (baseline - observed) / baseline for
        p50 and p99 (lower-is-better, the bench-diff discipline); a
        change below -revertThreshold on either reverts, otherwise the
        action graduates to accepted."""
        from spark_rapids_tpu_torch.lifecycle import percentile
        for a in self._state["actions"]:
            if a.get("state") != "applied" or a.get("pinned"):
                continue
            base = (a.get("evidence") or {}).get("baseline") or {}
            bp50 = float(base.get("p50", 0.0))
            bp99 = float(base.get("p99", 0.0))
            if bp50 <= 0:
                continue  # no pre-action baseline: nothing to diff
            walls = self._scope_walls(records, a["scope"],
                                      float(a.get("appliedTs", 0)))
            if len(walls) < max(1, self._guard_window):
                continue
            op50 = percentile(walls, 0.50)
            op99 = percentile(walls, 0.99)
            ch50 = (bp50 - op50) / bp50
            ch99 = (bp99 - op99) / bp99 if bp99 > 0 else 0.0
            observed = {"p50": round(op50, 6), "p99": round(op99, 6),
                        "windowQueries": len(walls),
                        "changeP50": round(ch50, 4),
                        "changeP99": round(ch99, 4)}
            if min(ch50, ch99) < -self._revert_threshold:
                self._revert(
                    a, why=(f"guardrail: post-action p50/p99 regressed "
                            f"past {self._revert_threshold:.0%}"),
                    observed=observed)
            else:
                a["state"] = "accepted"
                a["acceptedTs"] = time.time()
                a.setdefault("evidence", {})["accepted"] = observed

    # -- fault injection (site:tuning) --------------------------------------

    def _maybe_inject_harmful(self) -> int:
        """The ``site:tuning:N`` leg: at the scheduled tick, apply a
        deliberately HARMFUL synthetic action — a concurrency clamp
        whose recorded baseline is epsilon, so ANY observed wall reads
        as a regression and the guardrail must revert it. Returns the
        number of actions it spent from the tick budget."""
        from spark_rapids_tpu_torch.retry import get_fault_injector
        inj = get_fault_injector(self._conf)
        if inj is None or not inj.on_tuning_tick():
            return 0
        scope = next(iter(self._sig_sql), None) or "0" * 40
        try:
            old = self._admission.signature_limit(scope) \
                if self._admission is not None else None
            act = self._new_action(
                "limitConcurrency", scope, KNOB_SIGNATURE_CONCURRENCY,
                old, 1,
                {"injected": True,
                 "why": "site:tuning fault — synthetic harmful action "
                        "for guardrail testing",
                 "baseline": {"p50": 1e-9, "p99": 1e-9}})
            self._apply(act)
            return 1
        except Exception:
            return 0

    # -- history scoring ----------------------------------------------------

    def _newest_record(self, records: List[Dict[str, Any]],
                       digest: str) -> Dict[str, Any]:
        for r in reversed(records):
            if r.get("signature") == digest and \
                    r.get("status") == STATUS_FINISHED and \
                    not r.get("resultCacheHit"):
                return r
        return {}

    def _scan_and_apply(self, records: List[Dict[str, Any]],
                        budget: int) -> None:
        """Score the history (doctor batch scan + SLO evaluation) and
        apply up to ``budget`` new actions for verdicts the catalog
        maps; scopes that already carry a live action of the same kind
        are skipped (convergence, not oscillation)."""
        from spark_rapids_tpu_torch.telemetry.doctor import scan_signatures
        from spark_rapids_tpu_torch.telemetry.history import \
            signature_aggregates
        aggs = signature_aggregates(records)
        try:
            scans = scan_signatures(self._dir, top=16)
        except Exception:
            scans = []
        for d in scans:
            if budget <= 0:
                return
            if not d.get("regressed"):
                continue
            digest = d.get("signatureFull")
            if not digest:
                continue
            agg = aggs.get(digest) or {}
            baseline = {"p50": (d.get("baseline") or {}).get(
                "wallP50", agg.get("wallP50", 0.0)),
                "p99": agg.get("wallP99", 0.0)}
            verdict = d.get("verdict")
            if verdict == "compileStorm" and \
                    not self._active("prewarmCaches", digest):
                act = self._new_action(
                    "prewarmCaches", digest, KNOB_PREWARM, False, True,
                    {"verdict": verdict, "baseline": baseline,
                     "slowdown": d.get("slowdown")})
                self._apply(act)
                budget -= 1
            elif verdict == "retrySpill":
                if not self._active("limitConcurrency", digest) \
                        and budget > 0:
                    old = self._admission.signature_limit(digest) \
                        if self._admission is not None else None
                    new = 2 if old is None else max(1, int(old) - 1)
                    act = self._new_action(
                        "limitConcurrency", digest,
                        KNOB_SIGNATURE_CONCURRENCY, old, new,
                        {"verdict": verdict, "baseline": baseline,
                         "slowdown": d.get("slowdown"),
                         "retryRate": agg.get("retryRate")})
                    self._apply(act)
                    budget -= 1
                ooc_key = ACTION_CATALOG["seedOutOfCore"]["knob"]
                cur = self._get_conf(ooc_key) \
                    if self._get_conf is not None else None
                if budget > 0 and self._set_conf is not None and \
                        not self._active("seedOutOfCore", digest) and \
                        str(cur).lower() != "true":
                    act = self._new_action(
                        "seedOutOfCore", digest, ooc_key,
                        cur, "true",
                        {"verdict": verdict, "baseline": baseline,
                         "slowdown": d.get("slowdown")})
                    self._apply(act)
                    budget -= 1
            # a kernelFallback verdict takes no action: the port has
            # no kernel enable conf to flip
        # SLO burn -> tenant weight shift
        if self._slo is None or budget <= 0:
            return
        try:
            slo = self._slo.evaluate()
        except Exception:
            slo = {}
        for tenant, st in sorted(slo.items()):
            if budget <= 0:
                return
            if st.get("burnRatio", 0.0) < 0.5 or \
                    st.get("windowQueries", 0) < 3:
                continue
            scope = f"tenant:{tenant}"
            if self._active("tenantWeight", scope) or \
                    self._admission is None:
                continue
            old = self._admission.tenant_weight(tenant)
            walls = self._scope_walls(records, scope, 0.0)
            from spark_rapids_tpu_torch.lifecycle import percentile
            act = self._new_action(
                "tenantWeight", scope, KNOB_TENANT_WEIGHT,
                old, float(old) * 1.5,
                {"verdict": "sloBurn", "slo": st,
                 "baseline": {
                     "p50": round(percentile(walls, 0.50), 6),
                     "p99": round(percentile(walls, 0.99), 6)}})
            self._apply(act)
            budget -= 1

    # -- inspection ---------------------------------------------------------

    def actions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._state["actions"]]

    def stats(self) -> Dict[str, Any]:
        """The server-stats `tuning` section (the Prometheus renderer
        exports these as srt_tuning_* families)."""
        with self._lock:
            acts = self._state["actions"]
            by_name: Dict[str, int] = {}
            for a in acts:
                by_name[a.get("action", "?")] = \
                    by_name.get(a.get("action", "?"), 0) + 1
            return {
                "enabled": True,
                "epoch": int(self._state.get("epoch", 0)),
                "ticks": self.ticks,
                "actionsApplied": self.actions_applied,
                "actionsReverted": self.actions_reverted,
                "actionsByName": by_name,
                "activeActions": sum(
                    1 for a in acts
                    if a.get("state") in ("applied", "accepted")),
                "pinnedActions": sum(1 for a in acts
                                     if a.get("pinned")),
                "prewarmedSignatures": len(self._state["prewarm"]),
                "prewarmReplayed": self.prewarm_replayed,
                "lastScanTs": self.last_scan_ts,
            }
