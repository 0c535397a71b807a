"""ArrowEvalPython and MapInPandas: the engine side of the pandas UDF
path (the port's copy of ``spark_rapids_tpu.exec.python_exec``; the
reference's GpuArrowEvalPythonExec.scala:487 and GpuMapInPandasExec).

Only the UDFs' input columns travel to the Python worker (Arrow IPC
through the process pool of ``python/pool.py``); the result columns come
back as Arrow and join the batch again. On the device the rest of the
batch never leaves the card: the batch is compacted, so its active rows
form a prefix, just the input columns are downloaded, and the worker's
output uploads at the batch's capacity under the retry protocol, so the
result columns line up with the device-resident columns row for row.
Each exec is a stage boundary: stage fusion never crosses it. The CPU
nodes run on the host where the rewrite leaves them there (the engine
off, or a CPU child), through the same worker pool.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
# one IPC round trip, shared with the worker side: the framing and the
# table codec never diverge between the two processes
from spark_rapids_tpu_torch.python.worker import _read_table as _ipc_read
from spark_rapids_tpu_torch.python.worker import _write_table as _ipc_bytes
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T

PYTHON_EVAL_TIME = "pythonEvalTime"  # round trips through the worker


def _schema_ipc(schema) -> bytes:
    return _ipc_bytes(schema.empty_table())


class CpuArrowEvalPythonExec(P.PhysicalPlan):
    """Evaluates scalar pandas UDFs through the worker pool; output =
    child output + one column per UDF (ArrowEvalPythonExec)."""

    def __init__(self, udfs: List[E.Alias], child: P.PhysicalPlan,
                 conf: TorchConf):
        self.children = [child]
        self.udfs = udfs  # Alias(PandasUDF) each
        self.conf = conf
        self.metrics = M.MetricRegistry("essential",
                                        owner=type(self).__name__)

    @property
    def child(self) -> P.PhysicalPlan:
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + [E.named_output(u)
                                          for u in self.udfs]

    def _plan_payload(self, input_attrs) -> Tuple[Tuple, List[int], object]:
        """(worker payload, needed child column indices, Arrow input
        schema). Bound once per partition set."""
        import cloudpickle

        from spark_rapids_tpu_torch.io.arrow_convert import \
            sql_schema_to_arrow
        have = {a.expr_id: i for i, a in enumerate(input_attrs)}
        needed: List[int] = []
        arg_idxs: List[List[int]] = []
        fn_blobs: List[bytes] = []
        for u in self.udfs:
            f: E.PandasUDF = u.child  # type: ignore[assignment]
            idxs = []
            for c in f.children:
                assert isinstance(c, E.AttributeReference), \
                    "the extractor leaves plain attribute inputs"
                j = have[c.expr_id]
                if j not in needed:
                    needed.append(j)
                idxs.append(needed.index(j))
            arg_idxs.append(idxs)
            fn_blobs.append(cloudpickle.dumps(f.fn))
        out_schema = sql_schema_to_arrow(T.StructType(
            [T.StructField(u.name, u.data_type, True) for u in self.udfs]))
        in_schema = sql_schema_to_arrow(T.StructType(
            [T.StructField(input_attrs[j].name, input_attrs[j].data_type,
                           True) for j in needed]))
        payload = (fn_blobs, arg_idxs, _schema_ipc(out_schema))
        return payload, needed, in_schema

    def _run_udfs(self, hb_cols, n_rows: int, payload, in_schema, pool,
                  metrics) -> List:
        """Send the input columns, get one HostColumn per UDF back; the
        round trip counts in ``metrics``' ``pythonEvalTime``."""
        import pyarrow as pa

        from spark_rapids_tpu_torch.io.arrow_convert import (
            arrow_column_to_host, host_column_to_arrow)
        arrays = [host_column_to_arrow(c) for c in hb_cols]
        tbl = pa.Table.from_arrays(arrays, schema=in_schema) if arrays \
            else pa.table({"_": pa.nulls(n_rows, pa.int32())})
        with metrics.timed(PYTHON_EVAL_TIME):
            out = _ipc_read(pool.run("scalar", payload, _ipc_bytes(tbl)))
        return [arrow_column_to_host(out.column(i), u.data_type)
                for i, u in enumerate(self.udfs)]

    def partitions(self) -> List[P.PartitionThunk]:
        from spark_rapids_tpu_torch.python.pool import get_worker_pool
        payload, needed, in_schema = self._plan_payload(self.child.output)
        pool = get_worker_pool(self.conf)
        schema = self.schema

        def make(thunk: P.PartitionThunk) -> P.PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in thunk():
                    cols = self._run_udfs([b.columns[j] for j in needed],
                                          b.num_rows, payload, in_schema,
                                          pool, self.metrics)
                    yield HostBatch(schema, list(b.columns) + cols,
                                    b.num_rows)
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"ArrowEvalPython {[u.name for u in self.udfs]}"


class TorchArrowEvalPythonExec(TorchExec):
    """Device variant: the batch stays on the card; only the UDFs' input
    columns round-trip through the worker."""

    def __init__(self, cpu: CpuArrowEvalPythonExec, child: TorchExec,
                 conf: TorchConf, device):
        super().__init__(conf, device)
        self.children = [child]
        self.udfs = cpu.udfs
        self._cpu = cpu

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + [E.named_output(u)
                                          for u in self.udfs]

    def device_partitions(self) -> List[DevicePartitionThunk]:
        from spark_rapids_tpu_torch import retry as R
        from spark_rapids_tpu_torch.columnar.device import DeviceBatch
        from spark_rapids_tpu_torch.columnar.transfer import upload_batch
        from spark_rapids_tpu_torch.python.pool import get_worker_pool
        payload, needed, in_schema = self._cpu._plan_payload(
            self.child.output)
        pool = get_worker_pool(self.conf)
        schema = self.schema
        child_fields = list(self.child.schema.fields)
        res_schema = T.StructType([T.StructField(u.name, u.data_type, True)
                                   for u in self.udfs])

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    # compact so active rows form a prefix: the Python
                    # result rows then line up with device rows by index
                    b = compact(b)
                    sub = DeviceBatch(
                        T.StructType([child_fields[j] for j in needed]),
                        [b.columns[j] for j in needed], b.active,
                        b._num_rows, b._num_rows_dev)
                    with self.metrics.timed(M.COPY_FROM_DEVICE_TIME):
                        hb = sub.to_host()
                    cols = self._cpu._run_udfs(hb.columns, hb.num_rows,
                                               payload, in_schema, pool,
                                               self.metrics)
                    res = HostBatch(res_schema, cols, hb.num_rows)
                    with self.metrics.timed(M.COPY_TO_DEVICE_TIME):
                        up = R.with_retry(
                            lambda: upload_batch(res, b.capacity,
                                                 self.device),
                            self.conf, self.metrics)
                    yield DeviceBatch(schema,
                                      list(b.columns) + list(up.columns),
                                      b.active, hb.num_rows)
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return f"TorchArrowEvalPython {[u.name for u in self.udfs]}"


def compact(b):
    """The batch with its active rows moved to a prefix, in order."""
    from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                        compact_arrays,
                                                        flatten_rows,
                                                        with_row_arrays)
    active, rows = compact_arrays(b.active, flatten_rows(b.columns))
    return DeviceBatch(b.schema, with_row_arrays(b.columns, rows), active,
                       b._num_rows, b._num_rows_dev)


class CpuMapInPandasExec(P.PhysicalPlan):
    """DataFrame.mapInPandas through the worker pool (the
    GpuMapInPandasExec role)."""

    def __init__(self, fn, out_schema: T.StructType, child: P.PhysicalPlan,
                 conf: TorchConf, output=None):
        self.children = [child]
        self.fn = fn
        self._schema = out_schema
        # reuse the logical node's expr_ids when given: downstream
        # operators bind by id, fresh attributes would not resolve
        self._output = list(output) if output is not None else [
            E.AttributeReference(f.name, f.data_type, f.nullable)
            for f in out_schema.fields]
        self.conf = conf
        self.metrics = M.MetricRegistry("essential",
                                        owner=type(self).__name__)

    @property
    def child(self) -> P.PhysicalPlan:
        return self.children[0]

    @property
    def output(self):
        return self._output

    def _payload(self) -> Tuple:
        import cloudpickle

        from spark_rapids_tpu_torch.io.arrow_convert import \
            sql_schema_to_arrow
        return (cloudpickle.dumps(self.fn),
                _schema_ipc(sql_schema_to_arrow(self._schema)))

    def _map_batch(self, hb: HostBatch, payload, pool,
                   metrics) -> HostBatch:
        from spark_rapids_tpu_torch.io.arrow_convert import (
            arrow_to_host_batch, host_batch_to_arrow)
        with metrics.timed(PYTHON_EVAL_TIME):
            out = _ipc_read(pool.run("map", payload,
                                     _ipc_bytes(host_batch_to_arrow(hb))))
        return arrow_to_host_batch(out, self._schema)

    def partitions(self) -> List[P.PartitionThunk]:
        from spark_rapids_tpu_torch.python.pool import get_worker_pool
        payload = self._payload()
        pool = get_worker_pool(self.conf)

        def make(thunk: P.PartitionThunk) -> P.PartitionThunk:
            def run() -> Iterator[HostBatch]:
                for b in thunk():
                    yield self._map_batch(b, payload, pool, self.metrics)
            return run
        return [make(t) for t in self.child.partitions()]

    def simple_string(self):
        return f"MapInPandas {getattr(self.fn, '__name__', '<fn>')}"


class TorchMapInPandasExec(TorchExec):
    """Device variant: each batch downloads, maps in the worker and the
    result uploads again (the whole row set is the function's input,
    unlike the scalar path)."""

    def __init__(self, cpu: CpuMapInPandasExec, child: TorchExec,
                 conf: TorchConf, device):
        super().__init__(conf, device)
        self.children = [child]
        self._cpu = cpu

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self._cpu.output

    def device_partitions(self) -> List[DevicePartitionThunk]:
        from spark_rapids_tpu_torch import retry as R
        from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                            bucket_capacity)
        from spark_rapids_tpu_torch.columnar.transfer import upload_batch
        from spark_rapids_tpu_torch.python.pool import get_worker_pool
        payload = self._cpu._payload()
        pool = get_worker_pool(self.conf)

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                for b in thunk():
                    with self.metrics.timed(M.COPY_FROM_DEVICE_TIME):
                        hb = b.to_host()
                    out = self._cpu._map_batch(hb, payload, pool,
                                               self.metrics)
                    cap = bucket_capacity(max(1, out.num_rows))
                    with self.metrics.timed(M.COPY_TO_DEVICE_TIME):
                        up = R.with_retry(
                            lambda: upload_batch(out, cap, self.device),
                            self.conf, self.metrics)
                    yield up
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return self._cpu.simple_string().replace("MapInPandas",
                                                 "TorchMapInPandas")
