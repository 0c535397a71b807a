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
does. Telemetry, plan cache, lifecycle and serving hooks are not ported
yet.

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
        self.conf_obj = TorchConf(conf)
        self.device = resolve_device(device)
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
        with TorchSparkSession._lock:
            self._prev_active = TorchSparkSession._active
            TorchSparkSession._active = self

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
        worker processes end (a later pandas UDF starts new ones)."""
        with TorchSparkSession._lock:
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

    def plan_physical(self, plan: L.LogicalPlan, announce: bool = True):
        """CPU physical plan, then the rewrite onto device operators when
        ``spark.rapids.sql.enabled`` (its report in
        ``last_rewrite_report``; ``announce`` prints its explain
        lines)."""
        physical, self.last_rewrite_report = self._rewrite(
            self._plan_cpu(plan), announce)
        if self._capture_enabled:
            self._plan_capture.append(physical)
        return physical

    def _rewrite(self, physical, announce: bool = True):
        """``(plan, report)``: the rewrite of a CPU plan, or the CPU plan
        itself with no report when the engine is off."""
        from spark_rapids_tpu_torch.overrides import (RewriteReport,
                                                      apply_overrides)
        if not self.conf_obj.sql_enabled:
            return physical, None
        report = RewriteReport()
        return apply_overrides(physical, self.conf_obj, self.device,
                               report, announce), report

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
        from spark_rapids_tpu_torch.conf import TASK_PARALLELISM
        from spark_rapids_tpu_torch.memory import release_plan_handles
        from spark_rapids_tpu_torch.overrides import has_device_op
        physical = self.plan_physical(plan)
        self.last_plan = physical
        self._assert_kernel_flags()
        # a plan with a device operator drains its partitions on this
        # thread; only a host-only plan spreads them over task threads
        tasks = 1 if has_device_op(physical) else \
            int(self.conf_obj.get(TASK_PARALLELISM))
        try:
            return physical.execute_collect(tasks)
        finally:
            release_plan_handles(physical)

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
