"""TorchWindowExec: device window functions (the counterpart of
``spark_rapids_tpu.exec.window.TpuWindowExec``).

Per batch: rows sort by (partition keys, order keys) with the sort
words of ``ops/groupby`` and ``ops/sort`` (one stable lexsort,
``sort_with_payload``), the partition and peer boundaries become flags
and latches (``_layout``), and every window expression is computed with
segment ops and prefix scans in sorted row space:

- ranking: row_number, rank, dense_rank, ntile from the boundary flags;
- offset: lag and lead as shifted gathers inside the partition (strings
  and two-limb decimals included);
- aggregates sum, count, avg, min, max, first and last over the whole
  partition (the running value read at the partition's end row), over
  running frames (prefix scans; a RANGE frame reads its last peer row,
  Spark's default frame) and over bounded frames: ROWS frames and
  value-bounded RANGE frames (``_frame_bounds``, a galloping search over
  the partition's order values) as prefix differences for sum, count and
  avg, and a sparse table of winner positions for min and max
  (``_sparse_table_extreme``).

Running min/max is a segmented arg-min/max scan over (partition id,
rank words, winner position): ``ops.groupby.seg_scan_best``, the JAX
window's ``_seg_running_extreme``, the later of two tied rows winning;
so values round-trip bit for bit. The bounded frames' sparse table keeps
the earlier of two tied rows, as the JAX package's does. Float sums are
segmented scans (``ops.groupby.seg_running_sum``): the same additions in
the same order
on the CPU and on the card, not XLA's order, so a float window sum
matches the JAX package's to a stated tolerance. Results are gathered
back to the input's row order through the inverse permutation: the exec
appends columns without permuting its input.

A partition of more than ``batchSizeRows`` rows is key-batched
(``device_partitions``): its batches wait in the spill store, one stable
sort over their partition keys gives every row a chunk id that never
splits a partition-key group (``_key_chunk_ids``), and each chunk is
split out, concatenated and windowed on its own, so the partition never
has to be on the card at once. Each chunk runs under ``with_retry``.

The JAX package traces one XLA program per structure and capacity
bucket (its ``_WINDOW_FN_CACHE``). Here the window runs eagerly, one
CUDA kernel after another (no CUDA graph and no program cache), and
counts one ``dispatchCount`` a batch, as the JAX package's ``_run_batch``
does. It reads ``spark.rapids.sql.hasNans`` through ``rank_words`` at
call time, after the session applied it for the query, so the JAX
package's ``nan_scope`` (which pins the flag while XLA traces) has no
counterpart here.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceColumn, DeviceDecimal128Column,
    DeviceStringColumn, concat_device, make_column, mask_col, sort_key_i64,
    sort_with_payload, torch_dtype)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import sort as S
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T


def is_device_window(window_exprs: List[E.Expression],
                     partition_spec: List[E.Expression],
                     order_spec: List[E.SortOrder], conf: TorchConf,
                     device=None) -> Optional[str]:
    """None when the window runs on the device, else the reason (the JAX
    package's ``is_device_window``, reason for reason)."""
    from spark_rapids_tpu_torch import device_caps as DC
    from spark_rapids_tpu_torch.conf import ENABLE_FLOAT_AGG
    for e in partition_spec:
        dt = e.data_type
        if isinstance(dt, (T.ArrayType, T.MapType, T.StructType)):
            return f"window partition key type {dt} runs on CPU"
        r = X.unsupported_reason(e, conf, device)
        if r:
            return r
        if X.contains_ansi_cast(e):
            return "ANSI casts in window partition keys run on CPU"
    for o in order_spec:
        dt = o.child.data_type
        if isinstance(dt, (T.ArrayType, T.MapType, T.StructType)):
            return f"window order key type {dt} runs on CPU"
        r = X.unsupported_reason(o.child, conf, device)
        if r:
            return r
        if X.contains_ansi_cast(o.child):
            return "ANSI casts in window order keys run on CPU"
    for alias in window_exprs:
        wx = alias.child if isinstance(alias, E.Alias) else alias
        if not isinstance(wx, E.WindowExpression):
            return f"{type(wx).__name__} is not a window expression"
        func = wx.func
        frame = wx.frame
        if isinstance(func, (E.RowNumber, E.Rank, E.DenseRank, E.NTile)):
            continue
        if isinstance(func, E.Lag):  # covers Lead
            r = X.unsupported_reason(func.input, conf, device)
            if r:
                return r
            if X.contains_ansi_cast(func.input):
                return "ANSI casts in lag/lead inputs run on CPU"
            if func.default is not None:
                r = X.unsupported_reason(func.default, conf, device)
                if r:
                    return r
                if X.contains_ansi_cast(func.default):
                    return "ANSI casts in lag/lead defaults run on CPU"
                in_str = isinstance(func.input.data_type,
                                    (T.StringType, T.BinaryType))
                df_str = isinstance(func.default.data_type,
                                    (T.StringType, T.BinaryType))
                if in_str != df_str:
                    return ("lag/lead default type is incompatible with "
                            "the input type; runs on CPU")
            continue
        if isinstance(func, E.AggregateExpression):
            agg = func.func
            if func.is_distinct:
                return "DISTINCT window aggregates are not supported"
            if not isinstance(agg, (E.Sum, E.Count, E.Min, E.Max,
                                    E.Average, E.First, E.Last)):
                return (f"window aggregate {type(agg).__name__} has no "
                        "device implementation")
            if agg.children:
                src = agg.children[0]
                if isinstance(src.data_type, (T.StringType, T.BinaryType,
                                              T.DecimalType)):
                    return (f"window aggregate over {src.data_type} "
                            "runs on CPU")
                float_ok = bool(conf.get(ENABLE_FLOAT_AGG))
                if isinstance(agg, (E.Sum, E.Average)) \
                        and T.is_floating(src.data_type) and not float_ok:
                    return ("device float window sum/average may differ "
                            "from CPU due to addition ordering "
                            "(spark.rapids.sql.variableFloatAgg.enabled"
                            "=false)")
                if isinstance(agg, E.Average) and not DC.float_div_exact(
                        device if device is not None else "cpu") \
                        and not float_ok:
                    return ("device Average division is not bit-identical "
                            "to CPU on this backend; set spark.rapids.sql."
                            "variableFloatAgg.enabled=true to allow")
                r = X.unsupported_reason(src, conf, device)
                if r:
                    return r
                if X.contains_ansi_cast(src):
                    return "ANSI casts in window aggregates run on CPU"
            bounded = not (frame.is_unbounded_whole or frame.is_running)
            if bounded and not isinstance(agg, (E.Sum, E.Count, E.Average,
                                                E.Min, E.Max)):
                return (f"bounded {frame.frame_type} frames are device-"
                        "supported for sum/count/avg/min/max only")
            if bounded and frame.frame_type == "range":
                if len(order_spec) != 1:
                    return ("value-bounded RANGE frames need exactly one "
                            "ORDER BY expression")
                odt = order_spec[0].child.data_type
                if not (T.is_integral(odt) or T.is_floating(odt)
                        or isinstance(odt, (T.DateType, T.TimestampType))):
                    return ("value-bounded RANGE frames need a numeric/"
                            "date/timestamp ORDER BY expression")
            continue
        return f"window function {type(func).__name__} is not supported"
    return None


# ---------------------------------------------------------------------------
# Pieces over SORTED row space
# ---------------------------------------------------------------------------

def _prefix_in_part(x: torch.Tensor, start_of_row: torch.Tensor
                    ) -> torch.Tensor:
    """Inclusive prefix sum restarting at each partition's start (the
    sorted position ``start_of_row[i]``). Floats take the segmented scan
    (no cancellation against other partitions); integers one cumsum
    minus the prefix before the partition's start."""
    if x.is_floating_point():
        return G.seg_running_sum(start_of_row, x)
    prefix = torch.cumsum(x, 0)
    base = torch.where(start_of_row > 0,
                       prefix[torch.clamp(start_of_row - 1, min=0)],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return prefix - base


class _SortedLayout:
    """Everything the per-function pieces need, in sorted row space."""

    def __init__(self, perm, active_s, part_id, peer_id, pos, start_of_row,
                 end_of_row, peer_last, new_peer, part_size):
        self.perm = perm              # sorted position -> original row
        self.active_s = active_s
        self.part_id = part_id
        self.peer_id = peer_id
        self.pos = pos
        self.start_of_row = start_of_row  # partition start, per row
        self.end_of_row = end_of_row      # partition end (inclusive)
        self.peer_last = peer_last        # last row of the peer group
        self.new_peer = new_peer
        self.part_size = part_size        # rows in the row's partition
        self.order_val = None             # (values, valid, asc, nulls 1st)


def _latest_at_or_before(flag: torch.Tensor, pos: torch.Tensor
                         ) -> torch.Tensor:
    """Per row, the last flagged position at or before it (-1 if none)."""
    return torch.cummax(torch.where(flag, pos, -1), 0).values


def _first_at_or_after(flag: torch.Tensor, pos: torch.Tensor, cap: int
                       ) -> torch.Tensor:
    """Per row, the first flagged position at or after it (cap if
    none)."""
    return torch.flip(torch.cummin(torch.flip(
        torch.where(flag, pos, cap), [0]), 0).values, [0])


def _layout(part_keys: List[AnyDeviceColumn],
            order_specs: List[E.SortOrder],
            order_keys: List[AnyDeviceColumn],
            active: torch.Tensor) -> _SortedLayout:
    cap = active.shape[0]
    part_subkeys: List[torch.Tensor] = []
    for c in part_keys:
        part_subkeys.extend(G.grouping_subkeys(c))
    order_subkeys: List[torch.Tensor] = []
    for c, o in zip(order_keys, order_specs):
        order_subkeys.extend(S.order_subkeys(c, o.ascending, o.nulls_first))
    # significance: live rows first, then partition keys, then order keys
    sorted_keys, perm, _p = sort_with_payload(
        [~active] + part_subkeys + order_subkeys, [])
    active_s = ~sorted_keys[0]
    part_sorted = sorted_keys[1:1 + len(part_subkeys)]
    order_sorted = sorted_keys[1 + len(part_subkeys):]
    pos = torch.arange(cap, dtype=torch.int64, device=active.device)

    def boundaries(keys) -> torch.Tensor:
        new = torch.zeros(cap, dtype=torch.bool, device=active.device)
        new[:1].fill_(True)
        for ks in keys:
            new[1:] |= ks[1:] != ks[:-1]
        new[1:] |= active_s[1:] != active_s[:-1]
        return new

    new_part = boundaries(part_sorted)
    new_peer = new_part | boundaries(list(part_sorted) + list(order_sorted))
    part_id = torch.cumsum(new_part.to(torch.int64), 0) - 1
    peer_id = torch.cumsum(new_peer.to(torch.int64), 0) - 1
    # boundary latches: a partition's start is the last boundary at or
    # before the row, its end the next boundary at or after it
    start_of_row = _latest_at_or_before(new_part, pos)
    last = new_part.new_ones(1)
    end_of_row = _first_at_or_after(torch.cat([new_part[1:], last]), pos,
                                    cap)
    peer_last = _first_at_or_after(torch.cat([new_peer[1:], last]), pos,
                                   cap)
    part_size = end_of_row - start_of_row + 1
    return _SortedLayout(perm, active_s, part_id, peer_id, pos,
                         start_of_row, end_of_row, peer_last, new_peer,
                         part_size)


def _ranking(func, lay: _SortedLayout
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 data, validity) in sorted space."""
    if isinstance(func, E.RowNumber):
        return (lay.pos - lay.start_of_row + 1).to(torch.int32), \
            lay.active_s
    if isinstance(func, E.Rank):
        first = _latest_at_or_before(lay.new_peer, lay.pos)
        return (first - lay.start_of_row + 1).to(torch.int32), lay.active_s
    if isinstance(func, E.DenseRank):
        prefix = torch.cumsum(lay.new_peer.to(torch.int64), 0)
        base = prefix[lay.start_of_row.clamp(min=0)]
        return (prefix - base + 1).to(torch.int32), lay.active_s
    if isinstance(func, E.NTile):
        k = func.n
        m = lay.part_size
        p = lay.pos - lay.start_of_row
        base = m // k
        rem = m % k
        big = rem * (base + 1)
        tile = torch.where(
            p < big,
            torch.div(p, torch.clamp(base + 1, min=1), rounding_mode="floor"),
            rem + torch.div(p - big, torch.clamp(base, min=1),
                            rounding_mode="floor"))
        return (tile + 1).to(torch.int32), lay.active_s
    raise NotImplementedError(
        f"window function {type(func).__name__} is not ported yet")


def _offset_fn(func: E.Lag, val: AnyDeviceColumn, default_val,
               lay: _SortedLayout):
    """lag/lead as a shifted gather inside the partition: ``(arrays,
    validity)`` in sorted space. ``default_val`` holds the default
    column's arrays, read at the same positions as the JAX package reads
    them."""
    cap = lay.pos.shape[0]
    off = func.offset if not isinstance(func, E.Lead) else -func.offset
    src = lay.pos - off
    ok = (src >= lay.start_of_row) & (src <= lay.end_of_row) & lay.active_s
    src_orig = lay.perm[torch.clamp(src, 0, cap - 1)]
    if isinstance(val, DeviceStringColumn):
        chars = val.chars[src_orig]
        lengths = val.lengths[src_orig]
        validity = val.validity[src_orig] & ok
        if default_val is not None:
            dchars, dlengths, dvalid = default_val
            cc = max(chars.shape[1], dchars.shape[1])
            if chars.shape[1] < cc:
                chars = torch.nn.functional.pad(
                    chars, (0, cc - chars.shape[1]))
            if dchars.shape[1] < cc:
                dchars = torch.nn.functional.pad(
                    dchars, (0, cc - dchars.shape[1]))
            chars = torch.where(ok[:, None], chars, dchars)
            lengths = torch.where(ok, lengths, dlengths)
            validity = torch.where(ok, validity, dvalid & lay.active_s)
        chars = chars * validity[:, None].to(chars.dtype)
        lengths = torch.where(validity, lengths, 0)
        return (chars, lengths), validity
    if isinstance(val, DeviceDecimal128Column):
        hi = val.hi[src_orig]
        lo = val.lo[src_orig]
        validity = val.validity[src_orig] & ok
        if default_val is not None:
            dhi, dlo, dvalid = default_val
            hi = torch.where(ok, hi, dhi)
            lo = torch.where(ok, lo, dlo)
            validity = torch.where(ok, validity, dvalid & lay.active_s)
        return (torch.where(validity, hi, 0),
                torch.where(validity, lo, 0)), validity
    data = val.data[src_orig]
    validity = val.validity[src_orig] & ok
    if default_val is not None:
        dflt_data, dflt_valid = default_val
        data = torch.where(ok, data, dflt_data)
        validity = torch.where(ok, validity, dflt_valid & lay.active_s)
    data = torch.where(validity, data, torch.zeros(
        (), dtype=data.dtype, device=data.device))
    return (data,), validity


def _winner_value(val: DeviceColumn, lay: _SortedLayout,
                  win_pos: torch.Tensor, has: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The value at sorted position ``win_pos`` (per sorted row)."""
    cap = lay.pos.shape[0]
    orig = lay.perm[torch.clamp(win_pos, 0, cap - 1)]
    data = val.data[orig]
    validity = has & lay.active_s
    return torch.where(validity, data, torch.zeros(
        (), dtype=data.dtype, device=data.device)), validity


def _flag_or(mask: torch.Tensor, const: bool,
             other: torch.Tensor) -> torch.Tensor:
    """``const`` where ``mask``, else ``other`` (elementwise)."""
    return (mask | other) if const else (~mask & other)


def _frame_bounds(lay: _SortedLayout, frame: E.WindowFrame, cap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row inclusive [lo, hi] sorted positions of a BOUNDED frame.
    ROWS frames are position offsets; a value-bounded RANGE frame
    resolves [v + lower, v + upper] by a galloping search over the
    partition's sorted order values. Null-ordered rows frame their null
    peer block; NaN order values form their own peer block (Spark's total
    order: all NaNs equal and greatest)."""
    if frame.frame_type == "rows":
        lo = (lay.start_of_row if frame.lower is None
              else torch.maximum(lay.pos + frame.lower, lay.start_of_row))
        hi = (lay.end_of_row if frame.upper is None
              else torch.minimum(lay.pos + frame.upper, lay.end_of_row))
        return lo, hi
    ov_s, ook, asc, nulls_first = lay.order_val
    # sign-normalize so values ascend with the sorted position; widen
    # before negating (-int32.min overflows in int32)
    if ov_s.is_floating_point():
        sgn = ov_s.to(torch.float64)
        off_cast = float
        is_nan_v = torch.isnan(sgn)
    else:
        sgn = ov_s.to(torch.int64)
        off_cast = int
        is_nan_v = torch.zeros(cap, dtype=torch.bool, device=sgn.device)
    if not asc:
        sgn = -sgn

    def gallop(pred_at) -> torch.Tensor:
        """Last position p in [start - 1, end] whose prefix predicate
        still holds (monotone True -> False within the partition)."""
        idx = lay.start_of_row - 1
        for j in reversed(range(cap.bit_length() + 1)):
            nxt = idx + (1 << j)
            ok = (nxt <= lay.end_of_row) & pred_at(
                torch.clamp(nxt, 0, cap - 1))
            idx = torch.where(ok, nxt, idx)
        return idx

    def cmp(p, t, strict: bool):
        v = sgn[p]
        nl = ~ook[p]
        nn = is_nan_v[p]
        base = _flag_or(nn, not asc, (v < t) if strict else (v <= t))
        return _flag_or(nl, nulls_first, base)

    # a searchable row's value frame spans searchable positions only: the
    # leading block (nulls when nulls first, NaNs under DESC) and the
    # trailing block (nulls when nulls last, NaNs under ASC) stay out
    def leading(p):
        nl = ~ook[p]
        nn = is_nan_v[p]
        return (nl & nulls_first) | (nn & (not asc))

    def keep(p):
        nl = ~ook[p]
        nn = is_nan_v[p]
        return ~((nl & (not nulls_first)) | (nn & asc))

    if frame.lower is None:
        lo = gallop(leading) + 1
    else:
        t_lo = sgn + off_cast(frame.lower)
        lo = gallop(lambda p: cmp(p, t_lo, True)) + 1
    if frame.upper is None:
        hi = gallop(keep)
    else:
        t_hi = sgn + off_cast(frame.upper)
        hi = gallop(lambda p: cmp(p, t_hi, False))
    # null rows and NaN rows frame their whole peer block instead
    peer_first = _latest_at_or_before(lay.new_peer, lay.pos)
    peer_framed = ~ook | is_nan_v
    lo = torch.where(peer_framed, peer_first, lo)
    hi = torch.where(peer_framed, lay.peer_last, hi)
    return lo, hi


def _agg_window(agg: E.AggregateFunction, frame: E.WindowFrame,
                val: Optional[DeviceColumn], lay: _SortedLayout,
                out_type: T.DataType) -> Tuple[torch.Tensor, torch.Tensor]:
    """(data, validity) in sorted space for one windowed aggregate."""
    cap = lay.pos.shape[0]
    dev = lay.pos.device
    if val is not None:
        data_s = val.data[lay.perm]
        valid_s = val.validity[lay.perm] & lay.active_s
    else:  # count(*): every live row counts
        data_s = torch.ones(cap, dtype=torch.int64, device=dev)
        valid_s = lay.active_s
    ones = valid_s.to(torch.int64)

    def running(x):
        """Inclusive running value; a RANGE frame reads its last peer."""
        pp = _prefix_in_part(x, lay.start_of_row)
        return pp[lay.peer_last] if frame.frame_type == "range" else pp

    def whole(x):
        # the running total read at the partition's end row
        return _prefix_in_part(x, lay.start_of_row)[lay.end_of_row]

    def bounded(x):
        pp = _prefix_in_part(x, lay.start_of_row)
        lo, hi = _frame_bounds(lay, frame, cap)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        hi_v = pp[torch.clamp(hi, 0, cap - 1)]
        lo_base = torch.where(lo > lay.start_of_row,
                              pp[torch.clamp(lo - 1, 0, cap - 1)], zero)
        return torch.where(hi >= lo, hi_v - lo_base, zero)

    if frame.is_unbounded_whole:
        scan = whole
    elif frame.is_running:
        scan = running
    else:
        scan = bounded

    if isinstance(agg, E.Count):
        return scan(ones), lay.active_s

    if isinstance(agg, (E.Sum, E.Average)):
        acc_dt = (torch.float64 if isinstance(agg, E.Average)
                  else torch_dtype(out_type))
        zero = torch.zeros((), dtype=acc_dt, device=dev)
        x = torch.where(valid_s, data_s.to(acc_dt), zero)
        cnt = scan(ones)
        s = scan(x)
        validity = (cnt > 0) & lay.active_s
        if isinstance(agg, E.Average):
            d = s / torch.clamp(cnt, min=1).to(torch.float64)
        else:
            d = s
        return torch.where(validity, d, torch.zeros(
            (), dtype=d.dtype, device=dev)), validity

    if isinstance(agg, (E.Min, E.Max)):
        is_min = isinstance(agg, E.Min)
        # rank words in signed order (int64 words carry uint64 patterns)
        words = [sort_key_i64(w) for w in G.rank_words(
            DeviceColumn(val.dtype, data_s, valid_s))]
        if not (frame.is_unbounded_whole or frame.is_running):
            lo, hi = _frame_bounds(lay, frame, cap)
            win, has = _sparse_table_extreme(words, valid_s, lo, hi, cap,
                                             is_min)
            return _winner_value(val, lay, win, has)
        win, has = G.seg_scan_best(lay.part_id, words, valid_s, is_min)
        if frame.is_unbounded_whole:
            # the running winner at the partition's end row
            win, has = win[lay.end_of_row], has[lay.end_of_row]
        elif frame.frame_type == "range":
            win, has = win[lay.peer_last], has[lay.peer_last]
        return _winner_value(val, lay, win, has)

    if isinstance(agg, (E.First, E.Last)):
        is_first = isinstance(agg, E.First)
        if not agg.ignore_nulls:
            if frame.is_unbounded_whole:
                tgt = lay.start_of_row if is_first else lay.end_of_row
            elif is_first:
                tgt = lay.start_of_row
            else:  # a running last is the current row or its last peer
                tgt = (lay.peer_last if frame.frame_type == "range"
                       else lay.pos)
            orig = lay.perm[tgt]
            d = val.data[orig]
            v = val.validity[orig] & lay.active_s
            return torch.where(v, d, torch.zeros(
                (), dtype=d.dtype, device=dev)), v
        # ignore nulls: a running min/max over the positions of valid rows
        win, has = G.seg_scan_best(lay.part_id, [lay.pos + 1], valid_s,
                                   is_first)
        if frame.is_unbounded_whole:
            win, has = win[lay.end_of_row], has[lay.end_of_row]
        elif frame.frame_type == "range":
            win, has = win[lay.peer_last], has[lay.peer_last]
        return _winner_value(val, lay, win, has)

    raise NotImplementedError(
        f"window aggregate {type(agg).__name__} is not ported yet")


def _sparse_table_extreme(words: List[torch.Tensor], valid: torch.Tensor,
                          lo: torch.Tensor, hi: torch.Tensor, cap: int,
                          is_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded-interval min/max: the winner position over each row's
    inclusive interval [lo, hi] in sorted space, from a sparse table of
    winner positions (O(cap log cap) to build, two gathers a query; ties
    go to the earlier position, as in the JAX package). Intervals never
    cross a partition: callers clamp them to the row's partition.
    Returns (winner position, has winner)."""
    pos = torch.arange(cap, dtype=torch.int64, device=valid.device)

    def better(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        a_ok = p1 < cap
        b_ok = p2 < cap
        c1 = torch.clamp(p1, 0, cap - 1)
        c2 = torch.clamp(p2, 0, cap - 1)
        a_wins = torch.zeros(p1.shape, dtype=torch.bool, device=p1.device)
        decided = torch.zeros_like(a_wins)
        for w in words:
            w1 = w[c1]
            w2 = w[c2]
            gt = (w1 < w2) if is_min else (w1 > w2)
            lt = (w1 > w2) if is_min else (w1 < w2)
            a_wins = a_wins | (~decided & gt)
            decided = decided | gt | lt
        a_wins = torch.where(decided, a_wins, p1 <= p2)  # tie: earlier
        a_wins = ~b_ok | (a_ok & a_wins)
        return torch.where(a_wins, p1, p2)

    level = torch.where(valid, pos, cap)
    levels = [level]
    k = 1
    while (1 << k) <= cap:
        half = 1 << (k - 1)
        shifted = torch.cat([level[half:], torch.full(
            (half,), cap, dtype=torch.int64, device=level.device)])
        level = better(level, shifted)
        levels.append(level)
        k += 1
    tbl = torch.stack(levels)  # (L, cap): winner over [i, i + 2^k)

    length = torch.clamp(hi - lo + 1, min=1)
    # floor(log2(len)), exact in float64 for every len <= cap
    kq = torch.floor(torch.log2(length.to(torch.float64))).to(torch.int64)
    c_lo = torch.clamp(lo, 0, cap - 1)
    c_hi = torch.clamp(hi - (torch.ones_like(kq) << kq) + 1, 0, cap - 1)
    win = better(tbl[kq, c_lo], tbl[kq, c_hi])
    has = (hi >= lo) & (win < cap)
    return torch.where(has, win, 0), has


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def _key_chunk_ids(keycols_per_batch: List[List], actives: List[torch.Tensor],
                   goal: int, n_chunks: int) -> List[torch.Tensor]:
    """Per-batch chunk ids that never split a partition-key group: rows
    are ranked by key (one stable sort over the resident key columns),
    each group's chunk follows from the row count before its first row,
    and the ids map back through the inverse permutation. A single group
    larger than ``goal`` stays in one chunk."""
    n_keys = len(keycols_per_batch[0])
    for ki in range(n_keys):
        cols = [kc[ki] for kc in keycols_per_batch]
        if isinstance(cols[0], DeviceStringColumn):
            cc = max(c.char_cap for c in cols)
            for bi, c in enumerate(cols):
                if c.char_cap < cc:
                    keycols_per_batch[bi][ki] = DeviceStringColumn(
                        c.dtype, torch.nn.functional.pad(
                            c.chars, (0, cc - c.char_cap)),
                        c.lengths, c.validity)
    keysets = []
    for kc in keycols_per_batch:
        subkeys: List[torch.Tensor] = []
        for c in kc:
            subkeys.extend(S.order_subkeys(c, True, True))
        keysets.append(subkeys)
    combined = [torch.cat([ks[i] for ks in keysets])
                for i in range(len(keysets[0]))]
    active = torch.cat(actives)
    cap = active.shape[0]
    sorted_all, perm, _p = sort_with_payload([~active] + combined, [])
    active_s = ~sorted_all[0]
    pos = torch.arange(cap, dtype=torch.int64, device=active.device)
    boundary = torch.zeros(cap, dtype=torch.bool, device=active.device)
    for k in sorted_all[1:]:
        boundary[1:] |= k[1:] != k[:-1]
    boundary[:1].fill_(True)
    group_start = torch.cummax(torch.where(boundary, pos, 0), 0).values
    chunk_sorted = torch.clamp(group_start // goal, max=n_chunks - 1)
    chunk_sorted = torch.where(active_s, chunk_sorted, 0).to(torch.int32)
    chunk_orig = chunk_sorted[_inverse(perm)]
    return list(torch.split(chunk_orig, [a.shape[0] for a in actives]))


def _column_arrays(c: AnyDeviceColumn):
    """A default value's arrays as ``_offset_fn`` reads them."""
    if isinstance(c, (DeviceStringColumn, DeviceDecimal128Column)):
        return c.arrays()
    return (c.data, c.validity)


def window_batch(part_bound, order_specs, order_bound, items, all_exprs,
                 batch: DeviceBatch) -> List[Tuple[Tuple, torch.Tensor]]:
    """Every window item of one batch: ``[(arrays, validity)]`` in the
    batch's row order. ``items``: ("rank", func) | ("offset", func,
    src_i, default_i or None) | ("agg", agg, frame, src_i or None,
    out_type), indices into ``all_exprs``."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    part_cols = [X.dev_eval(e, ctx) for e in part_bound]
    order_cols = [X.dev_eval(e, ctx) for e in order_bound]
    lay = _layout(part_cols, list(order_specs), order_cols, batch.active)
    if any(it[0] == "agg" and it[2].frame_type == "range"
           and not (it[2].is_unbounded_whole or it[2].is_running)
           for it in items):
        oc = order_cols[0]
        lay.order_val = (oc.data[lay.perm],
                         oc.validity[lay.perm] & lay.active_s,
                         order_specs[0].ascending,
                         order_specs[0].nulls_first)
    inv = _inverse(lay.perm)  # original row -> sorted position
    outs = []
    for item in items:
        kind = item[0]
        if kind == "rank":
            d, v = _ranking(item[1], lay)
            outs.append(((d[inv],), v[inv]))
        elif kind == "offset":
            _k, func, src_i, dflt_i = item
            val = X.dev_eval(all_exprs[src_i], ctx)
            dflt = None
            if dflt_i is not None:
                dflt = _column_arrays(X.dev_eval(all_exprs[dflt_i], ctx))
            arrs, v = _offset_fn(func, val, dflt, lay)
            outs.append((tuple(a[inv] for a in arrs), v[inv]))
        else:
            _k, agg, frame, src_i, out_type = item
            val = (X.dev_eval(all_exprs[src_i], ctx)
                   if src_i is not None else None)
            d, v = _agg_window(agg, frame, val, lay, out_type)
            outs.append(((d[inv],), v[inv]))
    return outs


class TorchWindowExec(TorchExec):
    def __init__(self, window_exprs: List[E.Expression],
                 partition_spec: List[E.Expression],
                 order_spec: List[E.SortOrder], child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.window_exprs = window_exprs
        self.partition_spec = partition_spec
        self.order_spec = order_spec

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return list(self.child.output) + [E.named_output(e)
                                          for e in self.window_exprs]

    def _plan_items(self):
        """Bind everything and build the item descriptors."""
        child_out = self.child.output
        part_bound = tuple(E.bind_references(e, child_out)
                           for e in self.partition_spec)
        order_bound = tuple(E.bind_references(o.child, child_out)
                            for o in self.order_spec)
        extra: List[E.Expression] = []
        base = len(part_bound) + len(order_bound)

        def add(e: E.Expression) -> int:
            extra.append(E.bind_references(e, child_out))
            return base + len(extra) - 1

        items: List[Tuple] = []
        out_types: List[T.DataType] = []
        for alias in self.window_exprs:
            wx = alias.child
            func = wx.func
            if isinstance(func, (E.RowNumber, E.Rank, E.DenseRank,
                                 E.NTile)):
                items.append(("rank", func))
            elif isinstance(func, E.Lag):
                src_i = add(func.input)
                dflt_i = None
                if func.default is not None:
                    dflt = func.default
                    # full type equality: a decimal(3,2) default of a
                    # decimal(25,2) input still casts to the limb form
                    if dflt.data_type != func.input.data_type:
                        dflt = E.Cast(dflt, func.input.data_type)
                    dflt_i = add(dflt)
                items.append(("offset", func, src_i, dflt_i))
            else:
                agg = func.func
                src_i = add(agg.children[0]) if agg.children else None
                items.append(("agg", agg, wx.frame, src_i, wx.data_type))
            out_types.append(wx.data_type)
        all_exprs = part_bound + order_bound + tuple(extra)
        return part_bound, order_bound, items, all_exprs, out_types

    def _run_batch(self, batch: DeviceBatch, planned) -> DeviceBatch:
        part_bound, order_bound, items, all_exprs, out_types = planned
        self.metrics.create(M.DISPATCH_COUNT).add(1)
        with self.metrics.timed(M.OP_TIME):
            outs = window_batch(part_bound, self.order_spec, order_bound,
                                items, all_exprs, batch)
        new_cols: List[AnyDeviceColumn] = list(batch.columns)
        for (arrs, validity), dt in zip(outs, out_types):
            new_cols.append(mask_col(make_column(
                dt, tuple(arrs) + (validity,)), batch.active))
        return DeviceBatch(self.schema, new_cols, batch.active,
                           batch._num_rows, batch._num_rows_dev)

    def _window(self, batches: List[DeviceBatch], planned) -> DeviceBatch:
        """Concatenate one chunk's batches and window it, under retry."""
        return R.with_retry(
            lambda: self._run_batch(concat_device(batches), planned),
            self.conf, self.metrics)

    def device_partitions(self) -> List[DevicePartitionThunk]:
        goal = self.conf.batch_size_rows

        def make(thunk: DevicePartitionThunk) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                from spark_rapids_tpu_torch.exec.exchange import (
                    range_key_columns, realign_spilled_pids, split_by_pid)
                from spark_rapids_tpu_torch.memory import get_device_store
                store = get_device_store(self.conf)
                planned = self._plan_items()
                part_bound = list(planned[0])
                handles, keycols, actives = [], [], []
                buckets: List[List] = []
                try:
                    for b in thunk():
                        if b._num_rows == 0:
                            continue
                        if part_bound:
                            keycols.append(range_key_columns(part_bound, b))
                        actives.append(b.active)
                        handles.append(self.register_spillable(store, b))
                    if not handles:
                        return
                    total = sum(h.rows for h in handles)
                    if total <= goal or len(handles) == 1 or not part_bound:
                        # a small partition, or a global window: one batch
                        keycols.clear()
                        batches = [h.get() for h in handles]
                        for h in handles:
                            h.close()
                        yield self._window(batches, planned)
                        return
                    # key batching: every partition-key group lands whole
                    # in one chunk of about ``goal`` rows
                    n_chunks = max(1, (total + goal - 1) // goal)
                    pids_per_batch = R.with_retry(
                        lambda: _key_chunk_ids(keycols, actives, goal,
                                               n_chunks),
                        self.conf, self.metrics)
                    keycols.clear()
                    buckets = [[] for _ in range(n_chunks)]
                    for h, pids, act in zip(handles, pids_per_batch,
                                            actives):
                        b, pids = realign_spilled_pids(h, pids, act)
                        parts = R.with_retry(
                            lambda b=b, pids=pids: split_by_pid(
                                b, pids, n_chunks),
                            self.conf, self.metrics)
                        h.close()
                        for pid, part in enumerate(parts):
                            if part is not None:
                                buckets[pid].append(
                                    self.register_spillable(store, part))
                    for bucket in buckets:
                        if not bucket:
                            continue
                        batches = [h.get() for h in bucket]
                        for h in bucket:
                            h.close()
                        yield self._window(batches, planned)
                finally:
                    for h in handles:
                        h.close()
                    for bucket in buckets:
                        for h in bucket:
                            h.close()
            return run
        return [make(t) for t in device_channel(self.child)]

    def simple_string(self):
        return (f"TorchWindow {self.window_exprs} "
                f"part={self.partition_spec} order={self.order_spec}")
