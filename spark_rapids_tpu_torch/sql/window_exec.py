"""CpuWindowExec: the window plan node and its host evaluation (the
counterpart of ``spark_rapids_tpu.sql.window_exec.CpuWindowExec``).

The node holds the window expressions (each an ``Alias`` over a
``WindowExpression``), the partition spec and the order spec, and
appends one column per window expression to its child's output. The
planner puts a hash exchange on the partition spec below it (a
single-partition exchange when the spec is empty); the overrides
convert it to ``TorchWindowExec`` (``exec/window.py``) unless the JAX
package's tagging keeps it on the CPU, where it runs here.

For each partition group the rows are ordered by the order spec, and
each window expression computes its result in the original row order, so
the operator appends columns without permuting its input.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn

from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P
from spark_rapids_tpu_torch.sql import types as T


class CpuWindowExec(P.PhysicalPlan):
    def __init__(self, window_exprs: List[E.Expression],
                 partition_spec: List[E.Expression],
                 order_spec: List[E.SortOrder], child: P.PhysicalPlan):
        self.children = [child]
        self.window_exprs = window_exprs  # Alias(WindowExpression)
        self.partition_spec = partition_spec
        self.order_spec = order_spec

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + [E.named_output(e)
                                          for e in self.window_exprs]

    def partitions(self) -> List[P.PartitionThunk]:
        schema = self.schema

        def make(thunk: P.PartitionThunk) -> P.PartitionThunk:
            def run():
                batches = [b for b in thunk() if b.num_rows]
                if not batches:
                    return
                whole = (batches[0] if len(batches) == 1
                         else HostBatch.concat(batches))
                yield self._evaluate(whole, schema)
            return run
        return [make(t) for t in self.child.partitions()]

    # -- evaluation --------------------------------------------------------

    def _evaluate(self, batch: HostBatch, schema: T.StructType) -> HostBatch:
        child_out = self.child.output
        n = batch.num_rows
        # partition groups
        if self.partition_spec:
            key_cols = [E.bind_references(e, child_out).eval(batch)
                        for e in self.partition_spec]
            gids, n_groups, _rep = P.group_ids(key_cols, n)
        else:
            gids, n_groups = np.zeros(n, dtype=np.int64), 1
        # order composite keys (whole batch, sliced per group)
        composites = [P._composite_key(
            E.bind_references(o.child, child_out).eval(batch), o)
            for o in self.order_spec]

        out_cols = list(batch.columns)
        for alias in self.window_exprs:
            wx = alias.child
            assert isinstance(wx, E.WindowExpression)
            out_cols.append(self._eval_window(wx, batch, child_out, gids,
                                              n_groups, composites))
        return HostBatch(schema, out_cols, n)

    def _eval_window(self, wx: E.WindowExpression, batch: HostBatch,
                     child_out, gids: np.ndarray, n_groups: int,
                     composites: List[np.ndarray]) -> HostColumn:
        n = batch.num_rows
        dt = wx.data_type
        func = wx.func
        frame = wx.frame
        # order VALUES for value-bounded range frames (Spark RangeFrame:
        # exactly one numeric/date/timestamp order expression)
        order_vals: Optional[HostColumn] = None
        asc = True
        if frame.frame_type == "range" and not frame.is_unbounded_whole \
                and not frame.is_running:
            if len(self.order_spec) != 1:
                raise ValueError(
                    "RANGE frame with value offsets requires exactly "
                    "one ORDER BY expression")
            o = self.order_spec[0]
            odt = o.child.data_type
            # decimals rejected outright: int offsets against unscaled
            # storage would silently land at the wrong scale
            if not (T.is_integral(odt) or T.is_floating(odt)
                    or isinstance(odt, (T.DateType, T.TimestampType))):
                raise ValueError(
                    "RANGE frame offsets require a numeric/date/"
                    "timestamp ORDER BY expression, got "
                    f"{odt.simple_string}")
            order_vals = E.bind_references(o.child, child_out).eval(batch)
            asc = o.ascending
        # input values for aggregate/offset functions
        vals: Optional[HostColumn] = None
        if isinstance(func, E.AggregateExpression):
            agg = func.func
            if isinstance(agg, E.Count) and not agg.children:
                vals = HostColumn(
                    T.LongT, np.ones(n, dtype=np.int64),
                    np.ones(n, dtype=bool))
            else:
                src = agg.children[0]
                if isinstance(agg, E.Average):
                    src = E.Cast(src, T.DoubleT)
                vals = E.bind_references(src, child_out).eval(batch)
        elif isinstance(func, E.Lag):
            vals = E.bind_references(func.input, child_out).eval(batch)

        # storage_zeros: decimal128 outputs need the (n, 2) limb layout
        out_data = T.storage_zeros(dt, n)
        out_valid = np.zeros(n, dtype=bool)

        for g in range(n_groups):
            rows = np.nonzero(gids == g)[0]
            if not len(rows):
                continue
            if composites:
                order_local = np.lexsort(
                    [c[rows] for c in composites][::-1])
            else:
                order_local = np.arange(len(rows))
            sorted_rows = rows[order_local]
            m = len(sorted_rows)
            # peer boundaries (for rank/dense_rank/range frames)
            new_peer = np.ones(m, dtype=bool)
            if composites:
                eq = np.ones(m - 1, dtype=bool) if m > 1 else \
                    np.zeros(0, dtype=bool)
                for c in composites:
                    cv = c[sorted_rows]
                    eq &= cv[1:] == cv[:-1]
                new_peer[1:] = ~eq
            d, v = self._func_over_group(func, frame, vals, sorted_rows,
                                         new_peer, dt, order_vals, asc)
            out_data[sorted_rows] = d
            out_valid[sorted_rows] = v
        return HostColumn(dt, out_data, out_valid).normalized()

    def _func_over_group(self, func, frame: E.WindowFrame,
                         vals: Optional[HostColumn],
                         sorted_rows: np.ndarray, new_peer: np.ndarray,
                         dt: T.DataType,
                         order_vals: Optional[HostColumn] = None,
                         asc: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Result (data, validity) in sorted group order."""
        m = len(sorted_rows)
        if isinstance(func, E.RowNumber):
            return np.arange(1, m + 1, dtype=np.int32), np.ones(m, bool)
        if isinstance(func, E.DenseRank):
            return np.cumsum(new_peer).astype(np.int32), np.ones(m, bool)
        if isinstance(func, E.Rank):
            pos = np.arange(m)
            peer_start = np.maximum.accumulate(np.where(new_peer, pos, 0))
            return (peer_start + 1).astype(np.int32), np.ones(m, bool)
        if isinstance(func, E.NTile):
            k = func.n
            pos = np.arange(m)
            base, rem = divmod(m, k)
            # first `rem` buckets get base+1 rows
            big = rem * (base + 1)
            tile = np.where(pos < big, pos // max(base + 1, 1),
                            rem + (pos - big) // max(base, 1))
            return (tile + 1).astype(np.int32), np.ones(m, bool)
        if isinstance(func, E.Lag):
            off = func.offset if isinstance(func, E.Lag) and \
                not isinstance(func, E.Lead) else -func.offset
            src_pos = np.arange(m) - off
            ok = (src_pos >= 0) & (src_pos < m)
            safe = np.clip(src_pos, 0, m - 1)
            gd = vals.data[sorted_rows][safe]
            gv = vals.validity[sorted_rows][safe] & ok
            if func.default is not None:
                # the analyzer-level cast Spark inserts: one rounding
                # implementation (Cast's HALF_UP decimal rescale, limb
                # split included) shared with the device exec
                dflt = func.default
                if dflt.data_type != dt:
                    dflt = E.Cast(dflt, dt)
                dcol = dflt.eval(HostBatch(T.StructType([]), [], 1))
                if dcol.validity[0]:
                    # decimal128 data is (m, 2) limbs: lift the row mask
                    okb = ok[:, None] if gd.ndim == 2 else ok
                    gd = np.where(okb, gd, dcol.data[0])
                    gv = gv | ~ok
            if T.is_limb_decimal(dt):
                return gd.astype(np.int64), gv
            return gd.astype(T.numpy_dtype(dt)), gv
        if isinstance(func, E.AggregateExpression):
            return self._agg_over_group(func.func, frame, vals,
                                        sorted_rows, new_peer, dt,
                                        order_vals, asc)
        raise NotImplementedError(type(func).__name__)

    def _agg_over_group(self, agg: E.AggregateFunction,
                        frame: E.WindowFrame, vals: HostColumn,
                        sorted_rows: np.ndarray, new_peer: np.ndarray,
                        dt: T.DataType,
                        order_vals: Optional[HostColumn] = None,
                        asc: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        m = len(sorted_rows)
        v = vals.data[sorted_rows]
        ok = vals.validity[sorted_rows].astype(bool)
        # frame [lo_i, hi_i] inclusive bounds per sorted position
        pos = np.arange(m)
        if frame.is_unbounded_whole:
            lo = np.zeros(m, dtype=np.int64)
            hi = np.full(m, m - 1, dtype=np.int64)
        elif frame.frame_type == "range" and frame.is_running:
            # running with peers: frame end = last row of the peer group
            peer_id = np.cumsum(new_peer) - 1
            last_of_peer = np.zeros(peer_id.max() + 1, dtype=np.int64)
            np.maximum.at(last_of_peer, peer_id, pos)
            lo = np.zeros(m, dtype=np.int64)
            hi = last_of_peer[peer_id]
        elif frame.frame_type == "range":
            # VALUE-bounded range: [ov + lower, ov + upper] resolved by
            # binary search over the (partition-sorted) order values;
            # null-ordered rows frame their null peer block (Spark
            # RangeFrame semantics)
            ov = order_vals.data[sorted_rows].astype(np.float64) \
                if np.issubdtype(order_vals.data.dtype, np.floating) \
                else order_vals.data[sorted_rows].astype(np.int64)
            ook = order_vals.validity[sorted_rows].astype(bool)
            sgn = ov if asc else -ov
            # NaN order values: all NaNs are ordering-peers (Spark total
            # order), so NaN rows frame their peer block like nulls do
            # (a SEPARATE block — nulls and NaNs sort apart), and finite
            # rows' searches exclude them (NaN never falls in a finite
            # value interval; inside the search array it would break
            # searchsorted's sorted contract).
            orig_ook = ook
            if np.issubdtype(ov.dtype, np.floating):
                is_nan_row = orig_ook & np.isnan(ov)
                ook = ook & ~np.isnan(ov)
            else:
                is_nan_row = np.zeros(m, dtype=bool)
            nn = np.nonzero(ook)[0]  # contiguous block by sort order
            nn_start = int(nn[0]) if len(nn) else 0
            nn_vals = sgn[nn]  # ascending within the block
            low_off = frame.lower
            up_off = frame.upper
            lo = np.zeros(m, dtype=np.int64)
            hi = np.full(m, -1, dtype=np.int64)
            if len(nn):
                # offsets apply UNNEGATED in sign-normalized space: for
                # DESC, sgn = -ov ascends with sort position, and
                # [sgn+lower, sgn+upper] is exactly Spark's value frame
                if low_off is None:
                    lo_nn = np.full(len(nn), nn_start, dtype=np.int64)
                else:
                    lo_nn = nn_start + np.searchsorted(
                        nn_vals, nn_vals + low_off, "left")
                if up_off is None:
                    hi_nn = np.full(len(nn), nn_start + len(nn) - 1,
                                    dtype=np.int64)
                else:
                    hi_nn = nn_start + np.searchsorted(
                        nn_vals, nn_vals + up_off, "right") - 1
                lo[nn] = lo_nn
                hi[nn] = hi_nn
            nulls = np.nonzero(~orig_ook)[0]
            if len(nulls):  # null rows frame the whole null block
                lo[nulls] = nulls[0]
                hi[nulls] = nulls[-1]
            nans = np.nonzero(is_nan_row)[0]
            if len(nans):  # NaN rows frame the whole NaN block
                lo[nans] = nans[0]
                hi[nans] = nans[-1]
        else:  # rows frame
            lo = pos + (-(1 << 62) if frame.lower is None else frame.lower)
            hi = pos + ((1 << 62) if frame.upper is None else frame.upper)
            lo = np.clip(lo, 0, m)
            hi = np.clip(hi, -1, m - 1)
        out = np.zeros(m, dtype=T.numpy_dtype(dt))
        valid = np.zeros(m, dtype=bool)
        for i in range(m):
            l, h = int(lo[i]), int(hi[i])
            if h < l:
                if isinstance(agg, E.Count):
                    out[i], valid[i] = 0, True
                continue
            sl_ok = ok[l:h + 1]
            sl = v[l:h + 1][sl_ok]
            if isinstance(agg, E.Count):
                out[i], valid[i] = len(sl), True
                continue
            if isinstance(agg, (E.First, E.Last)) and not agg.ignore_nulls:
                j = l if isinstance(agg, E.First) else h
                out[i], valid[i] = v[j], ok[j]
                continue
            if len(sl) == 0:
                continue
            if isinstance(agg, E.Sum):
                out[i], valid[i] = sl.sum(), True
            elif isinstance(agg, E.Min):
                # Spark total order: NaN is greatest, so min skips NaNs
                if np.issubdtype(sl.dtype, np.floating):
                    nn = sl[~np.isnan(sl)]
                    out[i] = nn.min() if len(nn) else np.nan
                else:
                    out[i] = sl.min()
                valid[i] = True
            elif isinstance(agg, E.Max):
                # np.max already yields NaN when present (NaN greatest)
                if np.issubdtype(sl.dtype, np.floating) and \
                        np.isnan(sl).any():
                    out[i] = np.nan
                else:
                    out[i] = sl.max()
                valid[i] = True
            elif isinstance(agg, E.Average):
                out[i], valid[i] = sl.astype(np.float64).mean(), True
            elif isinstance(agg, E.First):
                out[i], valid[i] = sl[0], True
            elif isinstance(agg, E.Last):
                out[i], valid[i] = sl[-1], True
            else:
                raise NotImplementedError(type(agg).__name__)
        return out, valid

    def simple_string(self):
        return (f"Window {self.window_exprs} part={self.partition_spec} "
                f"order={self.order_spec}")
