"""TorchHashAggregateExec: device group-by aggregation (the counterpart of
``spark_rapids_tpu.exec.agg.TpuHashAggregateExec``).

'partial' emits keys + buffer slots per input batch, 'final' merges the
buffers of a partition after the exchange and evaluates the results.
The partial update of an eligible aggregate (SUM/COUNT/MIN/MAX over
fixed-width keys and values, no float sums) runs through the groupbyHash
kernel; a
batch whose hash table overflowed re-runs on the sort-based partial
aggregate (``ops/groupby``), counted in ``overflow_reruns``. Everything
else — the final merge, and partial aggregates the kernel does not take
(a struct key, such as a time window, groups field-wise on it) — is the
sort-based path in plain PyTorch, as it is plain XLA in the JAX
package: float sums and averages through the segmented scan of
``ops/groupby``, first/last through its arg-min scan over row order,
stddev/variance from (n, sum, sum of squares) buffers finished by
``dev_evaluate``. A partition's partial results are merged into one
batch when they fit (``_run_partial``), as in the JAX package.

Under stage fusion a partial aggregate absorbs the filter/project chain
below it (``absorb_prelude``): the prelude, the key and value
expressions, the groupbyHash launch, the decode of the table's lanes and
the compaction run as ONE stage program per batch (``_update_program``,
a CUDA graph replay on the card, ``exec/fused.py``). Every program the
exec runs counts one ``dispatchCount``.

Memory, as in the JAX package: each partial batch runs under
``with_split_retry`` (an out-of-memory error recovers and retries, then
the batch splits in half by rows; the halves' partial results merge
downstream like any two batches), and the partial outputs, and the
kernel's inputs until their overflow flags are read, wait in the spill
store. The final aggregate stages its inputs in the store, merges them
in chunks of at most ``batchSizeRows`` rows (``_merge_bounded``) and
finishes under ``with_retry``. When the budget oracle says the staged
bytes are over the operator's share, the final aggregate runs out of
core (``_ooc_aggregate``): its inputs split by
``pmod(murmur3(grouping), modulus)`` into spill-backed buckets (the
murmur3 kernel on the card) aggregated one at a time, and a bucket still
over the share re-buckets at a doubled modulus.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceColumn, DeviceDecimal128Column,
    compact_arrays, concat_device, flatten_columns, mask_col,
    rebuild_columns, slice_compacted_to_bucket)
from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec import fused as F
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.kernels import autotune as AT
from spark_rapids_tpu_torch.kernels import groupby_hash as KG
from spark_rapids_tpu_torch.ops import decimal_ops as DD
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import int128 as I
from spark_rapids_tpu_torch.parallel.mesh import record_chip_dispatch
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T

_SUM_KINDS = {E.PRIM_COUNT: "count", E.PRIM_SUM: "sum",
              E.PRIM_SUM_NONNULL: "sum_nonnull"}
_FIRST_LAST = {E.PRIM_FIRST: (True, True), E.PRIM_LAST: (False, True),
               E.PRIM_FIRST_ANY: (True, False),
               E.PRIM_LAST_ANY: (False, False)}
_DEVICE_FUNCS = (E.Sum, E.Count, E.Min, E.Max, E.Average, E.First, E.Last,
                 E.CentralMomentAgg)


def _float_agg_allowed(conf) -> bool:
    if conf is None:
        return False
    from spark_rapids_tpu_torch.conf import ENABLE_FLOAT_AGG
    return bool(conf.get(ENABLE_FLOAT_AGG))


def is_device_agg(grouping, aggregates, conf=None,
                  device=None) -> Optional[str]:
    """None when the aggregate runs on the device, else the reason (the
    JAX package's ``is_device_agg``, reason for reason, then what this
    port does not run yet)."""
    from spark_rapids_tpu_torch import device_caps as DC
    for g in grouping:
        dt = g.data_type
        if isinstance(dt, T.StructType):
            # flat-field structs group on the device (a time window):
            # field-wise words, on the sort-based path
            r = X.type_reason(dt, X.STRUCT)
            if r:
                return f"grouping key: {r}"
            continue
        if isinstance(dt, (T.ArrayType, T.MapType)):
            return "nested grouping keys are not supported on TPU"
    for e in aggregates:
        if isinstance(e, E.Alias) and isinstance(e.child,
                                                 E.AggregateExpression):
            func = e.child.func
            if e.child.is_distinct:
                return "DISTINCT aggregates are not supported"
            if not isinstance(func, _DEVICE_FUNCS):
                return (f"aggregate {type(func).__name__} has no device "
                        "implementation")
            if isinstance(func, E.Average) \
                    and func._child_decimal() is None \
                    and not DC.float_div_exact(
                        device if device is not None else "cpu") \
                    and not _float_agg_allowed(conf):
                return ("device Average division is not bit-identical to "
                        "CPU on this backend (TPU f64 is emulated); set "
                        "spark.rapids.sql.variableFloatAgg.enabled=true "
                        "to allow")
            for s in func.buffer_slots():
                if not isinstance(s[3], E.Expression):
                    continue
                r = X.unsupported_reason(s[3], conf, device)
                if r:
                    return r
                if X.contains_ansi_cast(s[3]):
                    return "ANSI casts in aggregate inputs run on CPU"
    return None


def unsupported_agg_reason(grouping, aggregates, conf=None,
                           device=None) -> Optional[str]:
    """None when the aggregate runs on the device in this port."""
    r = is_device_agg(grouping, aggregates, conf, device)
    if r:
        return r
    for g in grouping:
        r = X.unsupported_reason(g, conf, device)
        if r:
            return f"grouping key: {r}"
    for e in aggregates:
        if isinstance(e, E.Alias) and isinstance(e.child,
                                                 E.AggregateExpression):
            continue
        if not isinstance(e, E.AttributeReference) and not (
                isinstance(e, E.Alias)
                and isinstance(e.child, E.AttributeReference)):
            return f"aggregate result expression {e!r} is not ported yet"
    return None


def dev_evaluate(func: E.AggregateFunction,
                 buffers: List[AnyDeviceColumn],
                 out_active: torch.Tensor) -> AnyDeviceColumn:
    """Device twin of AggregateFunction.evaluate over merged buffers."""
    if isinstance(func, (E.Sum, E.Min, E.Max, E.First, E.Last)):
        return buffers[0]
    if isinstance(func, E.Count):
        b = buffers[0]
        data = torch.where(b.validity & out_active, b.data, 0)
        return DeviceColumn(T.LongT, data, out_active)
    if isinstance(func, E.CentralMomentAgg):
        # M2 = sumsq - sum^2 / n, the host _finish's formula
        n = torch.where(buffers[0].validity, buffers[0].data, 0)
        s = buffers[1].data.to(torch.float64)
        sq = buffers[2].data.to(torch.float64)
        nf = n.to(torch.float64)
        m2 = torch.clamp(sq - (s * s) / torch.where(n > 0, nf, 1.0),
                         min=0.0)
        out = m2 / (nf - 1.0 if func.is_sample else nf)
        if func.is_stddev:  # a sample of one: 0/0, NaN as in Spark
            out = torch.sqrt(out)
        validity = (n > 0) & out_active
        return DeviceColumn(T.DoubleT, torch.where(validity, out, 0.0),
                            validity)
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


def _eval_values(ctx: X.Ctx, key_bound, slot_srcs):
    """Evaluated key columns and per-slot value columns; a source shared
    by several slots (sum(x) + avg(x)) is evaluated once."""
    key_cols = [X.dev_eval(e, ctx) for e in key_bound]
    uniq: Dict[tuple, AnyDeviceColumn] = {}
    vals = []
    for e in slot_srcs:
        k = X.expr_key(e)
        if k not in uniq:
            uniq[k] = X.dev_eval(e, ctx)
        vals.append(uniq[k])
    return key_cols, vals


def _sort_path(key_cols, vals, prims, active: torch.Tensor, hashed: bool):
    """Sort-based aggregation: (key columns, buffers, out_active) at
    segment-end rows of the sorted layout."""
    flat, spec = flatten_columns(key_cols + vals)
    build = G.build_segments_hashed if hashed else G.build_segments
    seg = build(key_cols, active, payload=flat)
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
        elif p in _FIRST_LAST:
            is_first, ignore_nulls = _FIRST_LAST[p]
            buffers[i] = G.seg_first_last(seg, v, is_first, ignore_nulls)
        else:
            raise NotImplementedError(
                f"aggregate primitive {p} is not ported yet")
    for i, c in zip(entry_pos, G.seg_sums_batched(seg, entries)):
        buffers[i] = c
    key_out = [mask_col(c, seg.out_active) for c in keys_s]
    return key_out, buffers, seg.out_active


def _update_program(kind: str, prelude_steps, key_bound, slot_srcs, prims,
                    slots: Optional[int], spec, layout,
                    device: torch.device, params: Optional[dict] = None,
                    tuned: bool = False) -> F.ProgramFn:
    """One batch's partial-mode program over flat inputs (columns, active,
    literal tensors): the absorbed filter/project prelude, the key and
    value expressions, then the groupbyHash table (``kind`` "kernel") or
    the sort-based aggregate ("sorted"; "merge" re-groups partial
    buffers), and the compaction of the groups to the front. Outputs:
    the compacted columns, their active mask, the group count and, for
    the kernel, its overflow flag, then the prelude's per-step row
    counts, all on the device: nothing here reads a value on the host.
    ``params`` are the kernel's tuned launch knobs for the batch's
    bucket (``tuned``: a recorded winner is in force)."""
    n = sum(arity for _dt, arity in spec)
    all_exprs = list(key_bound) + list(slot_srcs)

    def fn(flat):
        cols = rebuild_columns(spec, flat[:n])
        active = flat[n]
        lits = F.unflatten_literals(flat[n + 1:], layout)
        counts: List[torch.Tensor] = []
        if prelude_steps:
            cols, active, counts = X.trace_stage_steps(
                prelude_steps, cols, active, lits[:-1], device)
        ctx = X.Ctx(cols, active.shape[0], device, all_exprs, lits[-1])
        key_cols, vals = _eval_values(ctx, key_bound, slot_srcs)
        extra: List[torch.Tensor] = []
        if kind == "kernel":
            entries = [(v, p, dt) for v, (p, dt) in zip(vals, prims)]
            key_out, buffers, keep, overflow = KG.hash_groupby(
                key_cols, entries, active, slots, params, tuned)
            out_cols = list(key_out) + list(buffers)
            extra = [overflow]
        else:
            key_out, buffers, keep = _sort_path(key_cols, vals, prims,
                                                active, hashed=True)
            out_cols = key_out + buffers
        flat_o, ospec = flatten_columns(out_cols)
        new_active, outs = compact_arrays(keep, flat_o)
        return outs + [new_active, keep.sum()] + extra + counts, ospec
    return fn


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
        # sort-based partial aggregate, counted from every task thread
        self.overflow_reruns = 0
        self._reruns_lock = threading.Lock()
        # stage fusion (exec/fused.py): a filter/project prelude run
        # inside this exec's per-batch program
        self._prelude_ops = None
        self._prelude_steps = None
        self._prelude_bind_out = None

    def absorb_prelude(self, prelude_ops, source) -> None:
        """Absorb a fusible filter/project chain into this partial
        aggregate's per-batch program. ``source`` becomes the direct
        child; the aggregate's expressions keep binding against the chain
        top's output (the attributes they were resolved to)."""
        if self.mode != "partial":
            raise ValueError(f"only a partial aggregate absorbs a prelude, "
                             f"not mode {self.mode}")
        from spark_rapids_tpu_torch.exec.fused import bind_chain_steps
        self._prelude_ops = list(prelude_ops)
        self._prelude_steps = bind_chain_steps(self._prelude_ops)
        self._prelude_bind_out = prelude_ops[-1].output
        self.children = [source]

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

    def _bound_inputs(self, merge: bool = False):
        """``(key exprs, per-slot source exprs, per-slot (prim,
        out_type))``, bound. A partial update binds against its input (the
        absorbed prelude's output, where there is one) with the update
        primitives; ``merge`` (and the final mode) bind the slots'
        buffer attributes with the merge primitives, against this exec's
        own output for a merge of partial results."""
        if merge:
            bind = self.output
        elif self._prelude_bind_out is not None:
            bind = self._prelude_bind_out
        else:
            bind = self.child.output
        update = self.mode == "partial" and not merge
        srcs, prims = [], []
        for alias in self._agg_aliases():
            for s in self.slots[alias.expr_id]:
                prim, src = ((s.update_prim, s.update_expr) if update
                             else (s.merge_prim, s.attr))
                srcs.append(E.bind_references(src, bind))
                prims.append((prim, s.dtype))
        keys = [E.bind_references(g, bind) for g in self.grouping]
        return keys, srcs, prims

    def update_inputs(self, batch: DeviceBatch):
        """``(key columns, slot values, prims, active)`` of one batch's
        partial update after the absorbed prelude: what the groupbyHash
        kernel is handed, evaluated eagerly."""
        key_bound, slot_srcs, prims = self._bound_inputs()
        cols, active = batch.columns, batch.active
        if self._prelude_steps:
            cols, active, _n = X.trace_stage_steps(
                self._prelude_steps, cols, active,
                X.stage_literal_values(self._prelude_steps, batch.device),
                batch.device)
        ctx = X.Ctx(cols, batch.capacity, batch.device)
        key_cols, vals = _eval_values(ctx, key_bound, slot_srcs)
        return key_cols, vals, prims, active

    def _programs(self) -> dict:
        """Per execution: for the partial update and the merge of partial
        results, the bound inputs, the literal tensors (built once for
        each device a batch arrives on) and the program's structural
        key."""
        out = {}
        for merge in (False, True):
            key_bound, slot_srcs, prims = self._bound_inputs(merge)
            steps = None if merge else self._prelude_steps

            def groups_on(device, exprs=key_bound + slot_srcs, steps=steps):
                lits = [X.literal_values(exprs, device)]
                if steps:
                    lits = list(X.stage_literal_values(steps, device)) + lits
                return lits
            lits = F.DeviceLiterals(groups_on, self.device)
            layout = lits.layout
            # which slot sources _eval_values evaluates once for several
            # slots: it compares values, which the program key leaves out
            first: Dict[tuple, int] = {}
            shared = tuple(first.setdefault(X.expr_key(e), i)
                           for i, e in enumerate(slot_srcs))
            skey = (tuple(X.expr_key(e, program=True) for e in key_bound),
                    tuple(X.expr_key(e, program=True) for e in slot_srcs),
                    shared, tuple((p, repr(dt)) for p, dt in prims),
                    X.stage_structural_key(steps) if steps else None,
                    layout, G.kernel_salt())
            out["merge" if merge else "update"] = (
                steps, key_bound, slot_srcs, prims, lits, layout, skey)
        return out

    def _aggregate(self, batch: DeviceBatch, kind: str, programs: dict):
        """Run one partial-mode program (``kind`` "kernel", "sorted" or
        "merge") over ``batch``: ``(groups compacted to the front at the
        input's capacity, with the count as a device scalar; the
        kernel's overflow flag or None)``. A fused stage's sink runs it
        through the stage cache (a CUDA graph replay on the card);
        otherwise it runs eagerly. Either way it counts one
        ``dispatchCount``, as the JAX package's ``_aggregate_batch``
        does for each program it runs."""
        steps, key_bound, slot_srcs, prims, lits, layout, skey = \
            programs["merge" if kind == "merge" else "update"]
        flat, spec = flatten_columns(batch.columns)
        slots, params, tuned = None, {}, False
        if kind == "kernel":
            # the bucket's tuned launch knobs (the defaults when untuned),
            # resolved before any graph capture: a first lookup at a new
            # bucket may sweep the kernel; slotsMult scales the table
            # bound before the batch clamp
            params, tuned = AT.params_for(self.conf, "groupbyHash",
                                          batch.capacity, device=self.device)
            slots = KR.table_slots(self.conf, batch.capacity,
                                   int(params.get("slotsMult", 1)))
        fn = _update_program(kind, steps, key_bound, slot_srcs, prims,
                             slots, spec, layout, batch.device, params,
                             tuned)
        flat_in = flat + [batch.active] + lits.on(batch.device)
        if kind == "kernel":
            KR.count_dispatch(self.metrics, "groupbyHash")
        record_chip_dispatch(self.metrics, batch)
        t0 = time.perf_counter_ns()
        if self._prelude_ops is None:
            self.metrics.create(M.DISPATCH_COUNT).add(1)
            qt = TR._ACTIVE
            outs, ospec = fn(flat_in)
            if qt is not None:
                qt.add("TorchHashAggregateExec.dispatch", t0,
                       time.perf_counter_ns(), chip=TR.chip_of(batch),
                       mode=kind, compile=False,
                       kernel="groupbyHash" if kind == "kernel" else None,
                       bucket=batch.capacity if kind == "kernel" else None,
                       tuned=tuned if kind == "kernel" else None)
        else:
            # every tuned knob keys the captured graph: a replay runs the
            # launch it captured
            key = ("agg", kind, skey, slots, tuple(sorted(params.items())),
                   tuple((repr(dt), a) for dt, a in spec))
            outs, ospec = F.run_program(key, fn, flat_in, self.metrics)
        # the program's host enqueue wall (the JAX package's
        # computeAggTime, which it books without a span of its own)
        self.metrics.create(M.AGG_TIME).add(time.perf_counter_ns() - t0)
        n = sum(a for _dt, a in ospec)
        out = DeviceBatch(self.schema, rebuild_columns(ospec, outs[:n]),
                          outs[n], None, outs[n + 1], batch.chip)
        rest = outs[n + 2:]
        overflow = None
        if kind == "kernel":
            overflow, rest = rest[0], rest[1:]
        if steps:
            F.count_steps(self._prelude_ops, rest)
        return out, overflow

    def _group_buffers(self, batch: DeviceBatch):
        """Final-mode grouping of a batch of partial buffers by key:
        ``(keys by attribute id, buffers by alias id, active)``, one
        group per active row."""
        key_bound, slot_srcs, prims = self._bound_inputs()
        ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
        key_cols, vals = _eval_values(ctx, key_bound, slot_srcs)
        key_out, buffers, out_active = _sort_path(
            key_cols, vals, prims, batch.active, hashed=False)
        by_alias: Dict[int, List[AnyDeviceColumn]] = {}
        off = 0
        for a in self._agg_aliases():
            n = len(self.slots[a.expr_id])
            by_alias[a.expr_id] = buffers[off:off + n]
            off += n
        key_by_attr = {a.expr_id: kc for a, kc in
                       zip(self.grouping, key_out)}
        return key_by_attr, by_alias, out_active

    def _final(self, batch: DeviceBatch) -> DeviceBatch:
        key_by_attr, by_alias, out_active = self._group_buffers(batch)
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

    def _merge_buffers(self, batch: DeviceBatch) -> DeviceBatch:
        """Final mode: merge a batch of partial buffers by key, keeping
        the buffer layout (the child's columns), groups compacted to the
        front with their count read on the host."""
        by_id, by_alias, out_active = self._group_buffers(batch)
        for a in self._agg_aliases():
            by_id.update((s.attr.expr_id, c) for s, c in
                         zip(self.slots[a.expr_id], by_alias[a.expr_id]))
        cols = [by_id[a.expr_id] for a in self.child.output]
        flat, spec = flatten_columns(cols)
        active, outs = compact_arrays(out_active, flat)
        return DeviceBatch(self.child.schema, rebuild_columns(spec, outs),
                           active, int(out_active.sum()))

    def _merge_bounded(self, handles: List, store) -> DeviceBatch:
        """Final staging: merge chunks of buffer batches whose rows stay
        within ``batchSizeRows`` (aggregate.scala:224-245), round after
        round, the inputs and each round's results behind spillable
        handles, so the partition never has to fit on the card at once.
        When everything fits one chunk the batches concatenate and the
        final program merges them itself."""
        limit = max(self.conf.batch_size_rows, 2)
        if sum(h.rows for h in handles) <= limit:
            whole = concat_device([h.get() for h in handles])
            for h in handles:
                h.close()
            return whole
        while len(handles) > 1:
            merged: List = []
            i = 0
            while i < len(handles):
                chunk = [handles[i]]
                rows = handles[i].rows
                i += 1
                # at least 2 a chunk (progress), more while within limit
                while i < len(handles) and (
                        len(chunk) < 2
                        or rows + handles[i].rows <= limit):
                    rows += handles[i].rows
                    chunk.append(handles[i])
                    i += 1
                if len(chunk) == 1:
                    merged.append(chunk[0])
                    continue
                whole = concat_device([h.get() for h in chunk])
                self.metrics.create(M.DISPATCH_COUNT).add(1)
                out = R.with_retry(lambda w=whole: self._merge_buffers(w),
                                   self.conf, self.metrics)
                for h in chunk:
                    h.close()
                merged.append(self.register_spillable(
                    store, slice_compacted_to_bucket(out)))
            handles = merged
        final = handles[0].get()
        handles[0].close()
        return final

    def _finish_final(self, whole: DeviceBatch) -> DeviceBatch:
        self.metrics.create(M.DISPATCH_COUNT).add(1)
        return R.with_retry(lambda: self._final(whole), self.conf,
                            self.metrics)

    def _ooc_aggregate(self, store, handles: List, modulus: int, oracle,
                       depth: int) -> Iterator[DeviceBatch]:
        """Planned out-of-core final aggregate: the partition's buffer
        batches split by pmod(murmur3(grouping), modulus) into buckets,
        each merged and finished on its own. The modulus starts at the
        planned partitions times the co-partition count: the rows here
        already satisfy pmod(h, P) == pid, so a modulus dividing P would
        put every row in one bucket. A bucket whose bytes still exceed
        the share re-buckets at a doubled modulus, up to
        ``outOfCore.maxRecursion``; past it the retry protocol is the
        backstop."""
        from spark_rapids_tpu_torch.exec.exchange import hash_buckets
        TR.instant("oocAggPlan", modulus=modulus, depth=depth)
        # murmur3 of the grouping keys, never a range: a run of equal keys
        # never straddles two buckets
        buckets = hash_buckets(
            self, store, handles,
            P.bind_list(self.grouping, self.child.output), modulus)
        share = oracle.operator_share()
        for pid in range(modulus):
            bh = buckets[pid]
            if not bh:
                continue
            if sum(h.sizeof() for h in bh) > share \
                    and depth < oracle.max_recursion:
                self.metrics.create(M.PLANNED_OOC_ESCALATIONS).add(1)
                yield from self._ooc_aggregate(store, bh, modulus * 2,
                                               oracle, depth + 1)
                continue
            yield self._finish_final(self._merge_bounded(bh, store))

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
        if self.mode == "partial":
            programs = self._programs()
            use_kernel = KG.agg_kernel_eligible(
                self.mode, self.grouping, programs["update"][3])

        def make(thunk: DevicePartitionThunk,
                 co_parts: int) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                from spark_rapids_tpu_torch.memory import (get_budget_oracle,
                                                           get_device_store)
                store = get_device_store(self.conf)
                if self.mode == "partial":
                    yield from self._run_partial(thunk, use_kernel,
                                                 programs, store)
                    return
                handles = [self.register_spillable(store, b)
                           for b in thunk() if b.row_count() != 0]
                if not handles:
                    if not grouped:
                        yield self._empty_global_result()
                    return
                # planned out-of-core: staged bytes over the operator's
                # share bucket by the grouping keys' hash up front
                if grouped:
                    oracle = get_budget_oracle(self.conf)
                    if oracle.enabled:
                        n = oracle.plan_partitions(
                            sum(h.sizeof() for h in handles), self.metrics)
                        if n > 1:
                            yield from self._ooc_aggregate(
                                store, handles, n * max(1, co_parts),
                                oracle, depth=0)
                            return
                yield self._finish_final(
                    self._merge_bounded(handles, store))
            return run
        thunks = device_channel(self.child)
        return [make(t, len(thunks)) for t in thunks]

    def _run_partial(self, thunk: DevicePartitionThunk, use_kernel: bool,
                     programs: dict, store) -> Iterator[DeviceBatch]:
        """Partial mode, as the JAX package drains it. Each batch's
        program compacts its groups and leaves their count on the device,
        under ``with_split_retry``. The outputs wait in the spill store,
        the kernel's with their inputs, until the partition is drained;
        then every count and overflow flag is read in one copy. An
        overflowed batch's kernel output is discarded and the batch
        re-runs on the sort-based partial aggregate. The outputs are cut
        to their capacity buckets and, when several together fit in one
        batch, merged into one (the pre-shuffle reduction of
        aggregate.scala)."""
        kind = "kernel" if use_kernel else "sorted"

        def run_piece(piece: DeviceBatch):
            out, overflow = self._aggregate(piece, kind, programs)
            return piece, out, overflow

        def run_piece_sorted(piece: DeviceBatch):
            out, overflow = self._aggregate(piece, "sorted", programs)
            return piece, out, overflow

        pending = []
        for b in thunk():
            for piece, out, overflow in R.with_split_retry(
                    b, run_piece, self.conf, self.metrics):
                h_in = (self.register_spillable(store, piece)
                        if use_kernel else None)
                pending.append((h_in, self.register_spillable(store, out),
                                out._num_rows_dev, overflow))
        if not pending:
            return
        # the one host read of the partition: it waits for the device
        # work queued above (the JAX package's pipelineDrainTime)
        with self.metrics.timed_wall("pipelineDrainTime"):
            host = torch.cat(
                [cnt.reshape(1) for _i, _h, cnt, _o in pending]
                + [o.to(torch.int64) for _i, _h, _c, o in pending
                   if o is not None]).cpu().tolist()
        flags = host[len(pending):] or [0] * len(pending)
        shrunk = []
        for (h_in, h, _c, _o), n, ovf in zip(pending, host, flags):
            if ovf:
                with self._reruns_lock:
                    self.overflow_reruns += 1
                h.close()
                whole = h_in.get()
                h_in.close()
                for _p, out, _o2 in R.with_split_retry(
                        whole, run_piece_sorted, self.conf, self.metrics):
                    out._num_rows = out.row_count()
                    shrunk.append(self.register_spillable(
                        store, slice_compacted_to_bucket(out)))
                continue
            out = h.get()
            h.close()
            if h_in is not None:
                h_in.close()
            out._num_rows = n
            shrunk.append(self.register_spillable(
                store, slice_compacted_to_bucket(out)))
        total = sum(h.rows for h in shrunk)
        if len(shrunk) > 1 and total <= self.conf.batch_size_rows:
            whole = concat_device([h.get() for h in shrunk])
            for h in shrunk:
                h.close()
            merged, _o = R.with_retry(
                lambda: self._aggregate(whole, "merge", programs),
                self.conf, self.metrics)
            yield merged
            return
        for h in shrunk:
            b = h.get()
            h.close()
            yield b

    def simple_string(self):
        return (f"TorchHashAggregate mode={self.mode} "
                f"keys={self.grouping} aggs={self.aggregates}")
