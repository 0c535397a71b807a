"""TorchSparkSession: the SparkSession-shaped entry point of the port.

The counterpart of ``spark_rapids_tpu.sql.session.TpuSparkSession``,
trimmed to what the ported slices run: ``createDataFrame``, ``range``,
``read.parquet`` and temp views, ``sql``, the ``builder``, ``active()``
and ``stop()``, plan capture (``start_capture``,
``get_captured_plans``), and execution through the CPU
planner followed by the overrides rewrite onto torch device operators,
which leaves an operator on the host engine exactly where the JAX
package's rewrite keeps it on its CPU (``last_rewrite_report`` holds the
query's fallbacks and their reasons; ``spark.rapids.sql.explain`` prints
them). With ``spark.rapids.sql.enabled=false`` the CPU plan runs on the
host engine with no rewrite.
The operators run under the spill store and the OOM retry protocol
(``memory.py``, ``retry.py``); once a collect ends, or fails, every store
handle its plan registered is closed (``release_plan_handles``), so none
outlives its query, and the stores close at interpreter exit, removing
their disk files. ``last_plan`` is the plan as it executed: an adaptive
replan (a join demoted to a broadcast) rewires the join's stream side
while the plan runs, so the release and ``plan_metrics`` walk the
subtree that ran. A cached relation materialises inside the query that
first reads it (``run_nested``). Under
``spark.rapids.sql.udfCompiler.enabled`` the planner first rewrites
compilable ``F.udf`` lambdas into expressions (``udf_compiler.py``).
``stop()`` shuts the pandas-UDF worker pool down, as interpreter exit
does.

Serving (``serve/``): a session may carry a tenant
(``spark.rapids.sql.serve.tenantId``), whose ledger in the device store
every query's handles bill (``memory.stamp_plan_tenant``). Several
threads may run queries on one session at once, so what belongs to one
query is kept per thread too (``thread_last_plan``,
``thread_plan_signature``, ``thread_rewrite_report``). Under
``spark.rapids.sql.planCache.enabled`` the execute path looks the
query's signature up in the cross-query plan cache
(``plan_cache.get_or_clone``) and runs a clone of the cached template.
``execute_plan`` runs under the calling thread's lifecycle token: a
cancelled query closes its plan's handles and returns its permit, a
quarantined signature fails before touching the device, and each
finished query's wall feeds its signature's history. Around each query
``execute_plan`` opens and closes its span trace
(``spark.rapids.sql.trace.*``) and, once it ends, writes its profile
(``profile.*``), its event-log line (``eventLog.dir``), runs the
telemetry triggers' query-close check and appends its query-history
record (``telemetry.history.dir``), as the JAX package's does; a
cancelled, quarantined or failed query writes its event-log line and
history record too. A session that sets a ``telemetry.*`` key arms the
process trigger engine.

The device is an explicit ``torch.device`` threaded through every
operator. It is the CUDA card unless the caller asks for the CPU
(``device="cpu"``, which the tests use); a missing card raises rather
than silently running on the host.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Union

import torch

from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.dataframe import DataFrame
from spark_rapids_tpu_torch.sql.planner import Planner


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` -> the first CUDA card (raises without one); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSparkSession needs a CUDA device; pass device='cpu' "
                "to run the plain PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is absent")
    return dev


class RuntimeConfApi:
    """spark.conf facade."""

    def __init__(self, conf: TorchConf):
        self._conf = conf

    def set(self, key: str, value: Any) -> None:
        self._conf.set(key, value)

    def get(self, key: str, default: Any = None) -> Any:
        return self._conf.get_key(key, default)

    def unset(self, key: str) -> None:
        self._conf.settings.pop(key, None)


class TorchSparkSession:
    _active: Optional["TorchSparkSession"] = None
    _lock = threading.Lock()

    def __init__(self, conf: Optional[Dict[str, Any]] = None,
                 device: Union[None, str, torch.device] = None):
        from spark_rapids_tpu_torch.conf import SERVE_TENANT_ID
        self.conf_obj = TorchConf(conf)
        self.device = resolve_device(device)
        # the kernels built and probed once per process on a card
        from spark_rapids_tpu_torch import device_manager
        device_manager.initialize(self.conf_obj, self.device)
        # the serving tenant this session runs for (None outside serving)
        self.tenant: Optional[str] = \
            str(self.conf_obj.get(SERVE_TENANT_ID) or "") or None
        # per-thread state of the query a thread runs on this session
        self._tls = threading.local()
        # terminal outcomes other than success, by status
        self.terminal_counts: Dict[str, int] = {}
        self._terminal_lock = threading.Lock()
        # a session that sets any spark.rapids.sql.telemetry.* key arms
        # the process trigger engine's conf-less hooks (store watermark,
        # admission saturation, retry storm); others never disarm it
        from spark_rapids_tpu_torch.telemetry import triggers as _telemetry
        _telemetry.configure(self.conf_obj)
        self.last_profile_path: Optional[str] = None
        self.conf = RuntimeConfApi(self.conf_obj)
        self.catalog_views: Dict[str, L.LogicalPlan] = {}
        self.last_plan = None  # the executed physical plan, for tests
        self.last_rewrite_report = None  # the last query's RewriteReport
        self._plan_capture: List = []  # ExecutionPlanCaptureCallback twin
        self._capture_enabled = False
        self._assert_kernel_flags()
        # the previously active session is remembered, not clobbered:
        # stop() restores it
        self._stopped = False
        self._owns_mesh = False
        from spark_rapids_tpu_torch.conf import (SHUFFLE_ICI_DEVICES,
                                                 SHUFFLE_MODE)
        with TorchSparkSession._lock:
            self._prev_active = TorchSparkSession._active
            TorchSparkSession._active = self
            if str(self.conf_obj.get(SHUFFLE_MODE)).lower() == "ici":
                # the executor-plugin-init step: the shuffle mesh, once
                # per process, checked and set under the class lock so
                # two tenant sessions starting together never both build
                # (and later both tear down) it
                from spark_rapids_tpu_torch.parallel import mesh as PM
                if PM.get_active_mesh() is None:
                    n = int(self.conf_obj.get(SHUFFLE_ICI_DEVICES)) or None
                    PM.set_active_mesh(PM.build_mesh(
                        n, PM.visible_chips(self.device)))
                    self._owns_mesh = True

    class Builder:
        """``TorchSparkSession.builder.config(k, v).getOrCreate()``; the
        app name and master are accepted and ignored, as in the JAX
        package. ``getOrCreate`` resolves the device as the constructor
        does (the card, raising without one); its ``device`` argument
        gives the CPU to the tests."""

        def __init__(self):
            self._conf: Dict[str, Any] = {}

        def config(self, key: str, value: Any) -> "TorchSparkSession.Builder":
            self._conf[key] = value
            return self

        def appName(self, name: str) -> "TorchSparkSession.Builder":
            return self

        def master(self, m: str) -> "TorchSparkSession.Builder":
            return self

        def getOrCreate(self, device: Union[None, str, torch.device] = None
                        ) -> "TorchSparkSession":
            return TorchSparkSession(self._conf, device=device)

    builder = None  # set below

    @staticmethod
    def active() -> "TorchSparkSession":
        """The most recently created live session; a new one (on the
        card) when there is none."""
        if TorchSparkSession._active is None:
            TorchSparkSession._active = TorchSparkSession()
        return TorchSparkSession._active

    def stop(self) -> None:
        """Retire this session: ``active()`` returns the session that was
        active before it (skipping any already stopped), and the Python
        worker processes end (a later pandas UDF starts new ones). A
        session that activated the shuffle mesh tears it down."""
        with TorchSparkSession._lock:
            if self._owns_mesh:
                from spark_rapids_tpu_torch.parallel import mesh as PM
                PM.set_active_mesh(None)
                self._owns_mesh = False
            if TorchSparkSession._active is self:
                prev = self._prev_active
                while prev is not None and prev._stopped:
                    prev = prev._prev_active
                TorchSparkSession._active = prev
            self._stopped = True
        from spark_rapids_tpu_torch.python.pool import shutdown_worker_pool
        shutdown_worker_pool()

    # -- plan capture (ExecutionPlanCaptureCallback) -------------------------
    def start_capture(self) -> None:
        self._plan_capture.clear()
        self._capture_enabled = True

    def get_captured_plans(self) -> List:
        self._capture_enabled = False
        return list(self._plan_capture)

    # -- data sources ------------------------------------------------------
    def createDataFrame(self, data, schema=None,
                        num_partitions: int = 2) -> DataFrame:
        batch = _infer_batch(data, schema)
        np_ = max(1, min(num_partitions, max(1, batch.num_rows)))
        if np_ == 1 or batch.num_rows == 0:
            batches = [batch]
        else:
            per = (batch.num_rows + np_ - 1) // np_
            batches = [batch.slice(i * per, (i + 1) * per)
                       for i in range(np_)
                       if batch.slice(i * per, (i + 1) * per).num_rows > 0]
        rel = L.LocalRelation(batch.schema, batches, len(batches))
        return DataFrame(rel, self)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              numPartitions: int = 2) -> DataFrame:
        """``spark.range``: one long column ``id``, generated on the
        device."""
        if end is None:
            start, end = 0, start
        return DataFrame(L.Range(start, end, step, numPartitions), self)

    @property
    def read(self):
        from spark_rapids_tpu_torch.io.readers import DataFrameReader
        return DataFrameReader(self)

    def table(self, name: str) -> DataFrame:
        return DataFrame(
            L.SubqueryAlias(name, self.catalog_views[name.lower()]), self)

    def sql(self, query: str) -> DataFrame:
        from spark_rapids_tpu_torch.sql.parser import parse_sql
        return parse_sql(query, self)

    # -- execution ---------------------------------------------------------
    def _plan_cpu(self, plan: L.LogicalPlan):
        """The CPU physical plan, after the UDF compiler's rewrite."""
        from spark_rapids_tpu_torch import udf_compiler
        self._assert_kernel_flags()
        plan = udf_compiler.rewrite_plan(plan, self.conf_obj)
        return Planner(self.conf_obj, session=self).plan(plan)

    def plan_physical(self, plan: L.LogicalPlan, announce: bool = True,
                      use_plan_cache: bool = False):
        """CPU physical plan, then the rewrite onto device operators when
        ``spark.rapids.sql.enabled`` (its report in
        ``last_rewrite_report``; ``announce`` prints its explain
        lines). ``use_plan_cache`` (the execute path) consults the
        cross-query plan cache when ``spark.rapids.sql.planCache.enabled``:
        a repeated shape runs a clone of the cached template and skips
        the planner, the rewrite and fusion."""
        from spark_rapids_tpu_torch.conf import PLAN_CACHE_ENABLED
        if use_plan_cache and bool(self.conf_obj.get(PLAN_CACHE_ENABLED)):
            from spark_rapids_tpu_torch import lifecycle as LC
            from spark_rapids_tpu_torch import plan_cache as PC
            from spark_rapids_tpu_torch import udf_compiler
            self._assert_kernel_flags()
            lplan = udf_compiler.rewrite_plan(plan, self.conf_obj)
            # the device is part of the key: a CPU session's template
            # holds CPU operators
            sig = (PC.plan_signature(lplan, self.conf_obj)
                   + f"||device:{self.device}")
            # the digest keys the lifecycle (wall history, quarantine);
            # the cache keys on the whole string
            sig_key = PC.signature_digest(sig)
            self._tls.plan_signature = sig_key
            ltok = LC.current_token()
            if ltok is not None:
                ltok.signature = sig_key
            # single flight: concurrent cold misses of one shape run the
            # rewrite once; everyone executes a clone of the template
            physical, report, was_miss = PC.get_or_clone(
                sig, lambda: self._rewrite_fresh(lplan, announce),
                conf_obj=self.conf_obj)
            if not was_miss and report is not None and announce:
                # the building thread printed inside apply_overrides
                report.print_explain(self.conf_obj)
        else:
            self._tls.plan_signature = None
            physical, report = self._rewrite(self._plan_cpu(plan), announce)
        self.last_rewrite_report = report
        self._tls.rewrite_report = report
        if self._capture_enabled:
            self._plan_capture.append(physical)
        return physical

    def _rewrite_fresh(self, plan: L.LogicalPlan, announce: bool = True):
        """``(physical, report)`` of the whole pipeline over a logical
        plan the UDF compiler already rewrote: the plan cache's build
        callback, which touches no session state (it may run for another
        thread's identical query)."""
        physical = Planner(self.conf_obj, session=self).plan(plan)
        return self._rewrite(physical, announce)

    def thread_plan_signature(self) -> Optional[str]:
        """The calling thread's last plan-cache signature digest on this
        session (None when its last query planned without the cache)."""
        return getattr(self._tls, "plan_signature", None)

    def thread_rewrite_report(self):
        """The calling thread's last rewrite report on this session
        (``last_rewrite_report`` is the last any thread planned)."""
        return getattr(self._tls, "rewrite_report", None)

    def thread_last_plan(self):
        """The plan the calling thread last executed on this session
        (``last_plan`` is the last any thread executed)."""
        return getattr(self._tls, "last_plan", None)

    def _rewrite(self, physical, announce: bool = True):
        """``(plan, report)``: the rewrite of a CPU plan, or the CPU plan
        itself with no report when the engine is off."""
        from spark_rapids_tpu_torch.overrides import (RewriteReport,
                                                      apply_overrides)
        if not self.conf_obj.sql_enabled:
            return _reuse_broadcast_exchanges(physical), None
        report = RewriteReport()
        physical = apply_overrides(physical, self.conf_obj, self.device,
                                   report, announce)
        return _reuse_broadcast_exchanges(physical), report

    def _assert_kernel_flags(self) -> None:
        """Apply this session's process-wide kernel flags before planning
        and running a query (another session may have set others since):
        ``spark.rapids.sql.hasNans``, which the aggregate programs' keys
        carry (``ops.groupby.kernel_salt``)."""
        from spark_rapids_tpu_torch.conf import HAS_NANS
        from spark_rapids_tpu_torch.ops import groupby as G
        G.set_has_nans(bool(self.conf_obj.get(HAS_NANS)))

    def host_partitions(self, plan: L.LogicalPlan):
        """Partition thunks yielding the plan's output as HostBatches (the
        writer's input). A plan that is only a host source needs no trip
        to the device; anything else runs through the rewritten plan."""
        from spark_rapids_tpu_torch.overrides import HOST_SOURCES
        physical = self._plan_cpu(plan)
        if not isinstance(physical, HOST_SOURCES):
            physical, _report = self._rewrite(physical)
        return physical.partitions()

    def run_nested(self, plan: L.LogicalPlan, encode) -> List[List[Any]]:
        """Run ``plan`` inside a running query (a cached relation's
        materialisation) and return each partition's batches through
        ``encode``. Data already in host memory (an in-memory table, a
        cached relation) is read without a trip to the device; anything
        else, a Parquet scan included (its row groups decode on the
        device), runs its device plan. The plan is captured as a plan of
        its own, ``last_plan`` stays the running query's, the calling
        thread keeps its device permit across the run, and the plan's
        store handles are released once it ends or fails."""
        from spark_rapids_tpu_torch.io.cache import CpuCachedScanExec
        from spark_rapids_tpu_torch.memory import release_plan_handles
        from spark_rapids_tpu_torch.resource import get_semaphore
        from spark_rapids_tpu_torch.sql import physical as P
        physical = self._plan_cpu(plan)
        if not isinstance(physical, (P.CpuLocalScanExec, CpuCachedScanExec)):
            physical, _report = self._rewrite(physical)
        if self._capture_enabled:
            self._plan_capture.append(physical)
        try:
            with get_semaphore(self.conf_obj).hold_across():
                return [[encode(b) for b in thunk()]
                        for thunk in physical.partitions()]
        finally:
            release_plan_handles(physical)

    def execute_plan(self, plan: L.LogicalPlan) -> HostBatch:
        import time as _time

        from spark_rapids_tpu_torch import lifecycle as LC
        from spark_rapids_tpu_torch import memory as _mem
        from spark_rapids_tpu_torch import profile as PROF
        from spark_rapids_tpu_torch import retry as _retry
        from spark_rapids_tpu_torch import trace as TR
        from spark_rapids_tpu_torch.conf import (RESULT_CACHE_ENABLED,
                                                 SERVE_QUARANTINE_THRESHOLD,
                                                 SUBPLAN_CACHE_ENABLED,
                                                 TASK_PARALLELISM)
        from spark_rapids_tpu_torch.serve import result_cache as _RC
        # a profile's memory section covers this query: the store's
        # watermarks start again here (concurrent queries still share the
        # process store, as in the JAX package)
        if bool(self.conf_obj.get(PROF.PROFILE_ENABLED)):
            _mem.reset_store_peaks()
        # the injector exists before the first checkpoint, so a
        # site:cancel schedule counts from the query's start
        _retry.get_fault_injector(self.conf_obj)
        quar_thr = int(self.conf_obj.get(SERVE_QUARANTINE_THRESHOLD))
        sig = None
        physical = None
        report = None
        t_begin = _time.perf_counter()
        # the trace opens before planning, so stage captures and plan
        # rewrites are in it; a nested or concurrent query folds in
        tok = TR.begin_query(self.conf_obj)
        try:
            physical = self.plan_physical(plan, use_plan_cache=True)
            self.last_plan = physical
            self._tls.last_plan = physical
            sig = self.thread_plan_signature()
            report = self.thread_rewrite_report()
            if quar_thr > 0 and sig is not None and LC.is_quarantined(sig):
                # fail before touching the device: the signature already
                # failed quar_thr consecutive times
                raise LC.TorchQueryQuarantined(
                    sig, LC.quarantined_failures(sig))
            self._assert_kernel_flags()
            # every registry of this execution bills the session's tenant
            _mem.stamp_plan_tenant(physical, self.tenant)
            # the serve caches' fingerprints of every file the plan reads,
            # taken before the plan reads them: a file changed mid-query
            # then mismatches at lookup instead of going stale
            if (bool(self.conf_obj.get(RESULT_CACHE_ENABLED))
                    or bool(self.conf_obj.get(SUBPLAN_CACHE_ENABLED))):
                _RC.set_execution_fingerprints(
                    _RC.capture_fingerprints(physical))
            else:
                _RC.set_execution_fingerprints(None)
            # every plan drains its partitions on taskParallelism task
            # threads (the query's tenant, trace and cancel token follow)
            t0 = _time.perf_counter()
            with _mem.tenant_scope(self.tenant):
                result = physical.execute_collect(
                    int(self.conf_obj.get(TASK_PARALLELISM)))
            wall_s = _time.perf_counter() - t0
        except LC.TorchQueryCancelled as e:
            TR.end_query(self.conf_obj, tok, error=True)
            # never counts toward quarantine: not a runtime failure
            self._record_terminal(
                "timed-out" if e.reason == LC.REASON_DEADLINE
                else "cancelled", e.reason, physical, sig,
                _time.perf_counter() - t_begin)
            raise
        except LC.TorchQueryQuarantined:
            TR.end_query(self.conf_obj, tok, error=True)
            self._record_terminal("quarantined", None, physical, sig,
                                  _time.perf_counter() - t_begin)
            raise  # never ran: neither a failure nor a success
        except BaseException:
            TR.end_query(self.conf_obj, tok, error=True)
            if quar_thr > 0 and sig is not None:
                LC.record_runtime_failure(sig, quar_thr)
            self._record_terminal("failed", None, physical, sig,
                                  _time.perf_counter() - t_begin)
            raise
        finally:
            # a finished, failed or cancelled query's device memory frees
            # now, not at plan GC
            _mem.release_plan_handles(physical)
        trace_path = TR.end_query(self.conf_obj, tok, wall_s=wall_s,
                                  rows=result.num_rows)
        if sig is not None:
            # the watchdog's wall history; a success clears the streak
            LC.record_wall(sig, wall_s)
            if quar_thr > 0:
                LC.record_success(sig)
        self._observe_close(physical, report, sig, wall_s,
                            result.num_rows, trace_path)
        return result

    def _observe_close(self, physical, report, sig, wall_s: float,
                       rows: int, trace_path: Optional[str]) -> None:
        """The sinks of a finished query, in the JAX package's order: the
        profile, the event-log line (one query id for both), the
        telemetry triggers' query-close check (after the profile, so a
        bundle can name it), then the query-history record."""
        from spark_rapids_tpu_torch import event_log
        from spark_rapids_tpu_torch import memory as _mem
        from spark_rapids_tpu_torch import profile as PROF
        from spark_rapids_tpu_torch.conf import (EVENT_LOG_DIR,
                                                 TELEMETRY_HISTORY_DIR)
        from spark_rapids_tpu_torch.telemetry import history as _history
        from spark_rapids_tpu_torch.telemetry import triggers as _telemetry
        log_dir = str(self.conf_obj.get(EVENT_LOG_DIR))
        profiling = bool(self.conf_obj.get(PROF.PROFILE_ENABLED))
        history_on = bool(str(
            self.conf_obj.get(TELEMETRY_HISTORY_DIR) or ""))
        qid = event_log.next_query_id() \
            if (log_dir or profiling or history_on) else None
        self.last_profile_path = PROF.write_profile(
            self.conf_obj, physical, report, wall_s, rows, query_id=qid)
        self._tls.profile_path = self.last_profile_path
        if log_dir:
            store = _mem._STORE
            event_log.write_event(
                log_dir, id(self) & 0xFFFF, physical, report, wall_s, rows,
                store.stats() if store is not None else None,
                conf=self.conf_obj,
                memory_by_op=(store.owner_stats()
                              if store is not None else None),
                query_id=qid, tenant=self.tenant)
        _telemetry.on_query_end(
            self.conf_obj, wall_s, plan=physical, tenant=self.tenant,
            query_id=qid, profile_path=self.thread_profile_path())
        # the wire queryId wins when the server supplied one: the id the
        # client saw must resolve in the history
        wire_qid = self._wire_query_id()
        _history.record_query_close(
            self.conf_obj, status=_history.STATUS_FINISHED,
            signature=sig, tenant=self.tenant,
            query_id=(wire_qid if wire_qid is not None else qid),
            wall_s=wall_s, queue_wait_s=self._queue_wait(), rows=rows,
            physical=physical, report=report,
            profile_path=self.thread_profile_path(),
            trace_path=trace_path)

    @staticmethod
    def _queue_wait() -> float:
        """The calling thread's admission-queue wait (0 outside a served
        query): the lifecycle token records admission time."""
        from spark_rapids_tpu_torch import lifecycle as LC
        tok = LC.current_token()
        if tok is None or tok.admitted is None:
            return 0.0
        return max(0.0, tok.admitted - tok.started)

    @staticmethod
    def _wire_query_id():
        from spark_rapids_tpu_torch import lifecycle as LC
        tok = LC.current_token()
        return tok.query_id if tok is not None else None

    def thread_profile_path(self) -> Optional[str]:
        """The profile written by the calling thread's last query on this
        session (None when none): race-free when the server's threads
        share a tenant's session."""
        return getattr(self._tls, "profile_path", None)

    def _record_terminal(self, status: str, reason, physical, sig,
                         wall_s: float) -> None:
        """Count one non-finished outcome (cancelled, timed-out,
        quarantined, failed) and write it to the event log and the query
        history, so the two agree on query outcomes. Never raises: the
        original exception is already propagating."""
        with self._terminal_lock:
            self.terminal_counts[status] = \
                self.terminal_counts.get(status, 0) + 1
        try:
            from spark_rapids_tpu_torch import event_log
            from spark_rapids_tpu_torch import memory
            from spark_rapids_tpu_torch.conf import (EVENT_LOG_DIR,
                                                     TELEMETRY_HISTORY_DIR)
            from spark_rapids_tpu_torch.telemetry import history as _history
            log_dir = str(self.conf_obj.get(EVENT_LOG_DIR))
            history_on = bool(str(
                self.conf_obj.get(TELEMETRY_HISTORY_DIR) or ""))
            # one id for both sinks; the wire queryId wins when the
            # server supplied one
            qid = self._wire_query_id()
            if qid is None and (log_dir or history_on):
                qid = event_log.next_query_id()
            if log_dir:
                store = memory._STORE
                event_log.write_event(
                    log_dir, id(self) & 0xFFFF, physical, None, wall_s, 0,
                    store.stats() if store is not None else None,
                    conf=self.conf_obj, tenant=self.tenant,
                    query_id=qid, status=status, reason=reason)
            _history.record_query_close(
                self.conf_obj, status=status, reason=reason,
                signature=sig, tenant=self.tenant, query_id=qid,
                wall_s=wall_s, queue_wait_s=self._queue_wait(), rows=0,
                physical=physical)
        except Exception:
            pass  # observability must not mask the real failure

    def explain_string(self, plan: L.LogicalPlan, physical=None) -> str:
        """The logical and physical plans, then the rewrite's placement:
        every fallback with its reason, and under
        ``spark.rapids.sql.explain=ALL`` each operator placed on the GPU
        too. Planning here prints no explain lines of its own."""
        if physical is None:
            physical = self.plan_physical(plan, announce=False)
        out = f"== Logical ==\n{plan!r}\n== Physical ==\n{physical!r}"
        report = self.last_rewrite_report
        if report is not None:
            lines = report.format("ALL" if self.conf_obj.explain == "ALL"
                                  else "NOT_ON_GPU")
            if lines:
                out += f"\n== Placement ==\n{lines}"
        return out


class _BuilderFactory:
    def __get__(self, obj, objtype=None):
        return TorchSparkSession.Builder()


TorchSparkSession.builder = _BuilderFactory()


def _infer_batch(data, schema) -> HostBatch:
    if isinstance(data, HostBatch):
        return data
    if isinstance(schema, str):
        schema = _parse_ddl_schema(schema)
    if isinstance(data, dict):
        if schema is None:
            schema = T.StructType([
                T.StructField(k, _infer_type_from_values(v))
                for k, v in data.items()])
        return HostBatch.from_pydict(data, schema)
    rows = list(data)
    if schema is None or isinstance(schema, (list, tuple)):
        if not rows:
            raise ValueError("cannot infer schema from empty data")
        first = rows[0]
        if isinstance(first, dict):
            names = list(first.keys())
            cols = {n: [r.get(n) for r in rows] for n in names}
        else:
            names = (list(schema) if schema is not None
                     else [f"_{i + 1}" for i in range(len(first))])
            cols = {n: [r[i] for r in rows] for i, n in enumerate(names)}
        schema = T.StructType([
            T.StructField(n, _infer_type_from_values(cols[n]))
            for n in names])
        return HostBatch.from_pydict(cols, schema)
    cols = {f.name: [r[i] for r in rows]
            for i, f in enumerate(schema.fields)}
    return HostBatch.from_pydict(cols, schema)


def _infer_type_from_values(values: Iterable[Any]) -> T.DataType:
    import datetime
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return T.BooleanT
        if isinstance(v, int):
            return T.LongT
        if isinstance(v, float):
            return T.DoubleT
        if isinstance(v, str):
            return T.StringT
        if isinstance(v, datetime.datetime):
            return T.TimestampT
        if isinstance(v, datetime.date):
            return T.DateT
        if isinstance(v, bytes):
            return T.BinaryT
    return T.StringT


def _parse_ddl_schema(ddl: str) -> T.StructType:
    from spark_rapids_tpu_torch.sql.functions import (_parse_type,
                                                      split_top_level)
    fields = []
    for part in split_top_level(ddl):
        name, _, tp = part.strip().partition(" ")
        fields.append(T.StructField(name.strip(), _parse_type(tp.strip())))
    return T.StructType(fields)


def _reuse_broadcast_exchanges(plan):
    """Spark's ReuseExchange, as the JAX package does it: structurally
    equal broadcast subtrees of one plan collapse onto one node, so the
    build side materializes once however many joins read it
    (``broadcastBuilds``)."""
    from spark_rapids_tpu_torch.exec.exchange import \
        TorchBroadcastExchangeExec
    from spark_rapids_tpu_torch.sql import expressions as E
    from spark_rapids_tpu_torch.sql import physical as P

    seen: Dict[tuple, Any] = {}

    def params(p) -> tuple:
        # a node's parameters beyond simple_string: limits, ranges,
        # expression lists (their repr holds the ids); any other object
        # keys by identity, so equal but distinct objects are never
        # taken for one another (they just are not reused)
        out = []
        for k in sorted(vars(p)):
            if k in ("children", "conf", "metrics", "device") \
                    or k.startswith("_"):
                continue
            v = vars(p)[k]
            if isinstance(v, (int, str, bool, float, type(None))):
                out.append((k, v))
            elif isinstance(v, (list, tuple)) and all(
                    isinstance(x, (int, str, bool, float)) for x in v):
                out.append((k, tuple(v)))
            elif isinstance(v, E.Expression) or (
                    isinstance(v, (list, tuple)) and v and all(
                        isinstance(x, E.Expression) for x in v)):
                out.append((k, repr(v)))
            else:
                out.append((k, id(v)))
        return tuple(out)

    def sig(p) -> tuple:
        # simple_string alone is no identity (two equal-shaped scans
        # print alike): the output attributes' ids and the node's own
        # parameters are
        return (type(p).__name__, p.simple_string(), params(p),
                tuple((a.name, a.expr_id, repr(a.data_type))
                      for a in p.output),
                tuple(sig(c) for c in p.children))

    def walk(p):
        p.children = [walk(c) for c in p.children]
        if isinstance(p, (P.CpuBroadcastExchangeExec,
                          TorchBroadcastExchangeExec)):
            key = (type(p).__name__, sig(p.child))
            hit = seen.get(key)
            if hit is not None:
                return hit
            seen[key] = p
        return p

    return walk(plan)
