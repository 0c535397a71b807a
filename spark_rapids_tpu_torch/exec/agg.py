"""TorchHashAggregateExec: device group-by aggregation (the counterpart of
``spark_rapids_tpu.exec.agg.TpuHashAggregateExec``).

'partial' emits keys + buffer slots per input batch, 'final' merges the
buffers of a partition after the exchange and evaluates the results.
The partial update of an eligible aggregate (SUM/COUNT/MIN/MAX over
fixed-width keys and values) runs through the groupbyHash kernel; a
batch whose hash table overflowed re-runs on the sort-based partial
aggregate (``ops/groupby``), counted in ``overflow_reruns``. Everything
else — the final merge, and partial aggregates the kernel does not take
— is the sort-based path in plain PyTorch, as it is plain XLA in the JAX
package. Out-of-core staging, spill and retry are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceColumn, DeviceDecimal128Column,
    compact_arrays, concat_device, flatten_columns, mask_col,
    rebuild_columns, slice_compacted_to_bucket)
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.kernels import groupby_hash as KG
from spark_rapids_tpu_torch.ops import decimal_ops as DD
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import int128 as I
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T

_SUM_KINDS = {E.PRIM_COUNT: "count", E.PRIM_SUM: "sum",
              E.PRIM_SUM_NONNULL: "sum_nonnull"}
_DEVICE_FUNCS = (E.Sum, E.Count, E.Min, E.Max, E.Average)


def unsupported_agg_reason(grouping, aggregates) -> Optional[str]:
    """None when the aggregate runs on the device in this slice."""
    for g in grouping:
        r = X.unsupported_reason(g)
        if r:
            return f"grouping key: {r}"
    for e in aggregates:
        if isinstance(e, E.Alias) and isinstance(e.child,
                                                 E.AggregateExpression):
            func = e.child.func
            if e.child.is_distinct:
                return "DISTINCT aggregates are not ported yet"
            if not isinstance(func, _DEVICE_FUNCS):
                return (f"aggregate {type(func).__name__} is not ported "
                        "yet")
            for s in func.buffer_slots():
                if isinstance(s[1], (T.FloatType, T.DoubleType)) and \
                        s[2] != E.PRIM_COUNT:
                    return "floating-point aggregates are not ported yet"
                if isinstance(s[3], E.Expression):
                    r = X.unsupported_reason(s[3])
                    if r:
                        return r
        elif not isinstance(e, E.AttributeReference) and not (
                isinstance(e, E.Alias)
                and isinstance(e.child, E.AttributeReference)):
            return f"aggregate result expression {e!r} is not ported yet"
    return None


def dev_evaluate(func: E.AggregateFunction,
                 buffers: List[AnyDeviceColumn],
                 out_active: torch.Tensor) -> AnyDeviceColumn:
    """Device twin of AggregateFunction.evaluate over merged buffers."""
    if isinstance(func, (E.Sum, E.Min, E.Max)):
        return buffers[0]
    if isinstance(func, E.Count):
        b = buffers[0]
        data = torch.where(b.validity & out_active, b.data, 0)
        return DeviceColumn(T.LongT, data, out_active)
    if isinstance(func, E.Average):
        s, cnt = buffers[0], buffers[1]
        count = torch.where(cnt.validity, cnt.data, 0)
        nz = count > 0
        dec = func._child_decimal()
        if dec is not None:
            # HALF_UP(sum * 10^(s_res - s) / count) in 128-bit limbs
            res = func.data_type
            if isinstance(s, DeviceDecimal128Column):
                hi, lo = s.hi, s.lo
            else:
                hi, lo = I.from_i64(torch, s.data.to(torch.int64))
            hi, lo, over = DD.rescale_up(torch, hi, lo,
                                         max(res.scale - dec.scale, 0))
            qh, ql = I.div_halfup(torch, hi, lo, torch.where(nz, count, 1))
            validity = s.validity & nz & out_active & ~over \
                & I.fits_precision(torch, qh, ql, res.precision)
            return X.limbs_to_devcol(qh, ql, validity, res)
        validity = nz & out_active
        data = s.data.to(torch.float64) / torch.where(
            nz, count, 1).to(torch.float64)
        return DeviceColumn(T.DoubleT, torch.where(validity, data, 0.0),
                            validity)
    raise NotImplementedError(
        f"aggregate {type(func).__name__} is not ported yet")


class TorchHashAggregateExec(TorchExec):
    def __init__(self, grouping: List[E.AttributeReference],
                 aggregates: List[E.Expression], mode: str,
                 child: TorchExec, slots: Dict[int, List[P.AggSlot]],
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.grouping = grouping
        self.aggregates = aggregates
        self.mode = mode
        self.slots = slots
        # batches whose groupbyHash table overflowed and re-ran on the
        # sort-based partial aggregate
        self.overflow_reruns = 0

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return P.agg_output(self.grouping, self.aggregates, self.mode,
                            self.slots)

    def _agg_aliases(self):
        return [e for e in self.aggregates
                if isinstance(e, E.Alias)
                and isinstance(e.child, E.AggregateExpression)]

    def _bound_slot_sources(self) -> Tuple[List[E.Expression],
                                           List[Tuple[str, T.DataType]]]:
        """Per-slot (bound source expression, (prim, out_type))."""
        child_out = self.child.output
        srcs, prims = [], []
        for alias in self._agg_aliases():
            for s in self.slots[alias.expr_id]:
                if self.mode == "partial":
                    prim, src = s.update_prim, s.update_expr
                else:
                    prim, src = s.merge_prim, s.attr
                srcs.append(E.bind_references(src, child_out))
                prims.append((prim, s.dtype))
        return srcs, prims

    def _eval_inputs(self, batch: DeviceBatch):
        """Evaluated key columns and per-slot value columns; a source
        shared by several slots (sum(x) + avg(x)) is evaluated once."""
        key_bound = [E.bind_references(g, self.child.output)
                     for g in self.grouping]
        slot_srcs, prims = self._bound_slot_sources()
        ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
        key_cols = [X.dev_eval(e, ctx) for e in key_bound]
        uniq: Dict[tuple, AnyDeviceColumn] = {}
        vals = []
        for e in slot_srcs:
            k = X.expr_key(e)
            if k not in uniq:
                uniq[k] = X.dev_eval(e, ctx)
            vals.append(uniq[k])
        return key_cols, vals, prims

    def _compacted(self, cols: List[AnyDeviceColumn],
                   keep: torch.Tensor) -> DeviceBatch:
        flat, spec = flatten_columns(cols)
        new_active, outs = compact_arrays(keep, flat)
        out = DeviceBatch(self.schema, rebuild_columns(spec, outs),
                          new_active, int(keep.sum()))
        return slice_compacted_to_bucket(out)

    def _partial_kernel(self, batch: DeviceBatch):
        """The groupbyHash path: (compacted partial batch, overflow)."""
        key_cols, vals, prims = self._eval_inputs(batch)
        slots = KR.table_slots(self.conf, batch.capacity)
        entries = [(v, p, dt) for v, (p, dt) in zip(vals, prims)]
        self.metrics.create("kernelDispatchCount.groupbyHash").add(1)
        key_out, buffers, used, overflow = KG.hash_groupby(
            key_cols, entries, batch.active, slots)
        return self._compacted(list(key_out) + list(buffers), used), \
            overflow

    def _sort_path(self, batch: DeviceBatch, hashed: bool):
        """Sort-based aggregation: (key columns, buffers, out_active) at
        segment-end rows of the sorted layout."""
        key_cols, vals, prims = self._eval_inputs(batch)
        flat, spec = flatten_columns(key_cols + vals)
        build = G.build_segments_hashed if hashed else G.build_segments
        seg = build(key_cols, batch.active, payload=flat)
        sorted_cols = rebuild_columns(spec, seg.payload)
        keys_s = sorted_cols[:len(key_cols)]
        vals_s = sorted_cols[len(key_cols):]
        buffers: List[Optional[AnyDeviceColumn]] = [None] * len(prims)
        entries, entry_pos = [], []
        for i, ((p, dt), v) in enumerate(zip(prims, vals_s)):
            if p in _SUM_KINDS:
                entries.append((v, _SUM_KINDS[p], dt))
                entry_pos.append(i)
            elif p in (E.PRIM_MIN, E.PRIM_MAX):
                buffers[i] = G.seg_extreme(seg, v, p == E.PRIM_MIN)
            else:
                raise NotImplementedError(
                    f"aggregate primitive {p} is not ported yet")
        for i, c in zip(entry_pos, G.seg_sums_batched(seg, entries)):
            buffers[i] = c
        key_out = [mask_col(c, seg.out_active) for c in keys_s]
        return key_out, buffers, seg.out_active

    def _partial_sorted(self, batch: DeviceBatch) -> DeviceBatch:
        key_out, buffers, out_active = self._sort_path(batch, hashed=True)
        return self._compacted(key_out + buffers, out_active)

    def _final(self, batch: DeviceBatch) -> DeviceBatch:
        key_out, buffers, out_active = self._sort_path(batch, hashed=False)
        by_alias: Dict[int, List[AnyDeviceColumn]] = {}
        off = 0
        for a in self._agg_aliases():
            n = len(self.slots[a.expr_id])
            by_alias[a.expr_id] = buffers[off:off + n]
            off += n
        key_by_attr = {a.expr_id: kc for a, kc in
                       zip(self.grouping, key_out)}
        out_cols = []
        for e in self.aggregates:
            if isinstance(e, E.Alias) and isinstance(
                    e.child, E.AggregateExpression):
                out_cols.append(dev_evaluate(
                    e.child.func, by_alias[e.expr_id], out_active))
            elif isinstance(e, E.AttributeReference):
                out_cols.append(key_by_attr[e.expr_id])
            else:
                out_cols.append(key_by_attr[e.child.expr_id])
        return DeviceBatch(self.schema, out_cols, out_active, None)

    def _empty_global_result(self) -> DeviceBatch:
        cols: List[HostColumn] = []
        for e in self.aggregates:
            buffers = [HostColumn.nulls(1, s.dtype)
                       for s in self.slots[e.expr_id]]
            cols.append(e.child.func.evaluate(buffers))
        return DeviceBatch.from_host(HostBatch(self.schema, cols, 1),
                                     self.device)

    def device_partitions(self) -> List[DevicePartitionThunk]:
        grouped = len(self.grouping) > 0
        _srcs, prims = self._bound_slot_sources()
        use_kernel = KG.agg_kernel_eligible(self.mode, self.grouping, prims)

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                if self.mode == "partial":
                    yield from self._run_partial(thunk, use_kernel)
                    return
                batches = [b for b in thunk() if b.row_count() != 0]
                if not batches:
                    if not grouped:
                        yield self._empty_global_result()
                    return
                yield self._final(concat_device(batches))
            return run
        return [make(t) for t in device_channel(self.child)]

    def _run_partial(self, thunk: DevicePartitionThunk, use_kernel: bool
                     ) -> Iterator[DeviceBatch]:
        """Partial mode. Kernel outputs wait with their inputs until the
        partition is drained, then the overflow flags are read together;
        an overflowed batch's kernel output is discarded and the batch
        re-runs on the sort-based partial aggregate."""
        if not use_kernel:
            for b in thunk():
                yield self._partial_sorted(b)
            return
        pending = [(b,) + self._partial_kernel(b) for b in thunk()]
        if not pending:
            return
        flags = torch.cat([o for _b, _out, o in pending]).cpu().tolist()
        for (b, out, _o), ovf in zip(pending, flags):
            if ovf:
                self.overflow_reruns += 1
                yield self._partial_sorted(b)
            else:
                yield out

    def simple_string(self):
        return (f"TorchHashAggregate mode={self.mode} "
                f"keys={self.grouping} aggs={self.aggregates}")
