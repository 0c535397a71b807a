"""Device equi-join on torch tensors (the counterpart of
``spark_rapids_tpu.ops.join``): count-then-gather over a sort of the
combined key set, plus the joinProbe hash-table route for small build
sides.

1. **Key plan** (``_key_plan``): the evaluated join keys of both sides
   stack into one key set that sorts by its comparison words (invalid
   rows sink); group extents give every left row its match count ``m``
   and the offset ``base`` of its key's first right row in ``order_r``
   (the valid right rows in key-sorted order, smallest row first within
   a key). Null keys never match (they leave the valid set), unless the
   key is null-safe (``<=>``), which adds a validity word.
2. **Count** (``_count``): offsets, total pairs, the largest ``m`` and,
   for right/full outer joins, the unmatched right rows.
3. **Gather**: ``_fast_gather`` when every stream row matches at most one
   build row (the FK/star shape: output keeps the left batch's layout);
   otherwise ``_gather`` expands pairs into a batch sized from one host
   read of ``(total, n_extra, max_m)``.

Semi/anti joins never expand: they only update the left batch's mask.

When the build side holds at most ``_MAX_BUILD_ROWS`` (8192) rows of
capacity and every key is a fixed-width-word type, the semi/anti
masks and the certified FK fast path run through the joinProbe kernel
(``kernels/join_probe.py``) instead of the sort. Torch raises on an
out-of-range gather index where ``jnp.take`` clamps, so every gather
index here is clamped or masked into range first.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceStringColumn, bucket_capacity,
    flatten_columns, make_column, rebuild_columns, take_columns, torch_dtype)
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T

# join types that expand to (left, right) pairs
PAIR_JOINS = ("inner", "cross", "left", "leftouter", "right", "rightouter",
              "full", "fullouter")
MASK_JOINS = ("leftsemi", "leftanti")
_LEFT_OUTER = ("left", "leftouter", "full", "fullouter")
_RIGHT_OUTER = ("right", "rightouter", "full", "fullouter")
_FAST_TYPES = ("inner", "left", "leftouter")
# largest build-side row capacity the joinProbe kernel takes: its table
# has twice as many slots (load factor <= 0.5), so every probe walk ends
# at an empty slot; bigger build sides keep the sort-based plan
_MAX_BUILD_ROWS = 8192
# a join exec's route counts are bumped from every task thread
_COUNTS_LOCK = threading.Lock()


def bump_count(counts: Dict[str, int], key: str) -> None:
    """Add one to ``counts[key]`` (a join exec's ``route_counts``), safe
    under the task threads that share the exec."""
    with _COUNTS_LOCK:
        counts[key] = counts.get(key, 0) + 1


def _pad_pair(a: AnyDeviceColumn, b: AnyDeviceColumn):
    """A pair of key columns with strings padded to one char capacity, so
    both emit the SAME word layout (``pack_string_words`` emits
    ceil(char_cap/8) words); other columns as they are."""
    if not isinstance(a, DeviceStringColumn):
        return a, b
    cc = max(a.char_cap, b.char_cap)
    return (DeviceStringColumn(a.dtype, X._pad_chars(a, cc), a.lengths,
                               a.validity),
            DeviceStringColumn(b.dtype, X._pad_chars(b, cc), b.lengths,
                               b.validity))


def _zip_columns(a_cols, b_cols, fn) -> List[AnyDeviceColumn]:
    """Column-wise ``fn(a_array, b_array)`` over the arrays of paired
    columns (strings first padded to one char capacity)."""
    out: List[AnyDeviceColumn] = []
    for a, b in zip(a_cols, b_cols):
        a, b = _pad_pair(a, b)
        out.append(make_column(a.dtype, [fn(x, y) for x, y in
                                         zip(a.arrays(), b.arrays())]))
    return out


def _concat_key_columns(kl: Sequence[AnyDeviceColumn],
                        kr: Sequence[AnyDeviceColumn]
                        ) -> List[AnyDeviceColumn]:
    """Stack left over right key columns (left rows first)."""
    return _zip_columns(kl, kr, lambda x, y: torch.cat([x, y]))


def _key_words(keys: Sequence[AnyDeviceColumn],
               null_safe: Sequence[bool]) -> List[torch.Tensor]:
    """Comparison words for evaluated key columns; null-safe keys get a
    validity word so null groups with null. One implementation shared by
    the key plan, the FK-uniqueness probe and the joinProbe route: they
    must agree on key equality."""
    words: List[torch.Tensor] = []
    for c, nsf in zip(keys, null_safe):
        if nsf:
            words.append(c.validity)
        words.extend(G.value_words(c))
    return words


def _group_extents(words: List[torch.Tensor], valid: torch.Tensor):
    """Sort rows by key words (invalid rows sink) and return
    ``(active_s, order, start, end)``: per-sorted-position group
    extents."""
    from spark_rapids_tpu_torch.columnar.device import sort_with_payload
    cap = valid.shape[0]
    sorted_all, order, _p = sort_with_payload([~valid] + words, [])
    active_s = ~sorted_all[0]
    boundary, is_end = G._boundaries(sorted_all[1:], active_s)
    pos = torch.arange(cap, device=valid.device)
    start = torch.cummax(torch.where(boundary, pos, -1), 0).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, pos, cap), [0]), 0).values, [0])
    return active_s, order, start, end


def _eval_side(keys, batch: DeviceBatch, null_safe: Sequence[bool]):
    """Evaluated key columns of one side and its valid set: active rows
    whose non-null-safe keys are all non-null (``<=>`` keys keep null
    rows in the match set)."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    cols = [X.dev_eval(e, ctx) for e in keys]
    valid = batch.active
    for c, nsf in zip(cols, null_safe):
        if not nsf:
            valid = valid & c.validity
    return cols, valid


def _eval_keys(lkeys, rkeys, left: DeviceBatch, right: DeviceBatch,
               null_safe: Sequence[bool]):
    """``(kl, kr, valid_l, valid_r)``: both sides' ``_eval_side``."""
    kl, valid_l = _eval_side(lkeys, left, null_safe)
    kr, valid_r = _eval_side(rkeys, right, null_safe)
    return kl, kr, valid_l, valid_r


def _key_plan(lkeys, rkeys, left: DeviceBatch, right: DeviceBatch,
              null_safe: Sequence[bool]):
    """Segment the combined key set and derive per-row match counts and
    offsets with prefix sums over the sorted layout. Returns ``(valid_r,
    m, base, order_r, cnt_l_at_r)``."""
    kl, kr, valid_l, valid_r = _eval_keys(lkeys, rkeys, left, right,
                                          null_safe)
    cap_l, cap_r = left.capacity, right.capacity
    cap_c = cap_l + cap_r
    dev = left.device
    valid_c = torch.cat([valid_l, valid_r])
    active_s, order, start, end = _group_extents(
        _key_words(_concat_key_columns(kl, kr), null_safe), valid_c)
    pos_c = torch.arange(cap_c, device=dev)
    is_left_s = order < cap_l
    left_valid_s = is_left_s & active_s
    right_valid_s = (~is_left_s) & active_s
    # two 1-D prefix sums: a cumsum down dim 0 of a (cap, 2) matrix runs
    # PyTorch's outer-dimension scan, one thread per column
    pref = torch.stack([torch.cumsum(left_valid_s.to(torch.int64), 0),
                        torch.cumsum(right_valid_s.to(torch.int64), 0)], 1)
    before = torch.where((start > 0)[:, None],
                         pref[torch.clamp(start - 1, min=0)], 0)
    at_end = pref[torch.clamp(end, 0, cap_c - 1)]
    cnt_l_s = at_end[:, 0] - before[:, 0]
    cnt_r_s = at_end[:, 1] - before[:, 1]
    base_r_s = before[:, 1]
    # combined row -> its sorted position, then per-row stats back in
    # original row order
    inv = torch.empty_like(order)
    inv[order] = pos_c
    m = torch.where(valid_l, cnt_r_s[inv[:cap_l]], 0)
    base = torch.where(valid_l, base_r_s[inv[:cap_l]], 0)
    cnt_l_at_r = torch.where(valid_r, cnt_l_s[inv[cap_l:]], 0)
    # order_r[j] = original right row of the j-th valid right row in
    # key-sorted order (base/m index into this)
    rkey_sorted = torch.where(right_valid_s, pos_c, cap_c)
    ord2 = torch.sort(rkey_sorted, stable=True).indices
    order_r = torch.clamp(order[ord2[:cap_r]] - cap_l, 0, cap_r - 1)
    return valid_r, m, base, order_r, cnt_l_at_r


def _count(left: DeviceBatch, right: DeviceBatch, lkeys, rkeys,
           join_type: str, null_safe: Sequence[bool]):
    """The count pass: ``(total_pairs, n_extra, max_m, m, offsets, base,
    order_r, extra_order, matched_r)``; the first three are 0-d device
    tensors."""
    valid_r, m, base, order_r, cnt_l_at_r = _key_plan(
        lkeys, rkeys, left, right, null_safe)
    if join_type in _LEFT_OUTER:
        m_eff = torch.where(left.active, torch.clamp(m, min=1), 0)
    else:
        m_eff = m
    offsets = torch.cumsum(m_eff, 0) - m_eff  # exclusive
    total_pairs = m_eff.sum()
    max_m = m.max()
    # matched-right mask: consumed by the right/full-outer extras here,
    # and accumulated across stream chunks by the exec's chunked outer
    # path
    matched_r = valid_r & (cnt_l_at_r > 0)
    cap_r = right.capacity
    if join_type in _RIGHT_OUTER:
        extra_r = right.active & ~matched_r
        n_extra = extra_r.to(torch.int64).sum()
        pos = torch.arange(cap_r, device=right.device)
        extra_order = torch.sort(torch.where(extra_r, pos, cap_r),
                                 stable=True).indices
    else:
        n_extra = torch.zeros((), dtype=torch.int64, device=right.device)
        extra_order = torch.zeros(cap_r, dtype=torch.int64,
                                  device=right.device)
    return (total_pairs, n_extra, max_m, m, offsets, base, order_r,
            extra_order, matched_r)


def _fast_gather(cols_r, active_l, m, base, order_r, join_type: str):
    """max_m <= 1 (FK/star-schema joins: every stream row matches at most
    one build row). The output keeps the LEFT batch's capacity and row
    order: left columns pass through untouched, the matched right row
    arrives by one gather, and inner joins shrink the active mask."""
    cap_r = order_r.shape[0]
    has = m > 0
    ri = order_r[torch.clamp(base, 0, cap_r - 1)]
    out_r = take_columns(cols_r, torch.where(has, ri, 0), valid_at=has)
    active = (active_l & has) if join_type in ("inner", "cross") \
        else active_l
    return out_r, active


def _where_cols(pick: torch.Tensor, a_cols, b_cols) -> List[AnyDeviceColumn]:
    """Column-wise ``where(pick, b, a)``."""
    return _zip_columns(a_cols, b_cols, lambda x, y: torch.where(
        pick.view(-1, *([1] * (x.dim() - 1))), y, x))


def _gather(out_cap: int, join_type: str, cols_l, cols_r, total_pairs,
            n_extra, m, offsets, base, order_r, extra_order):
    """The expanding gather: output slot ``s`` finds its left row by a
    search over the offsets, its k-th match through ``order_r``, and
    gathers both sides, with null right rows for unmatched outer rows
    and, for right/full outer joins, the unmatched right rows after the
    pairs with a null left side."""
    cap_l = m.shape[0]
    cap_r = order_r.shape[0]
    dev = m.device
    s = torch.arange(out_cap, dtype=torch.int64, device=dev)
    li = torch.clamp(torch.searchsorted(offsets, s, right=True) - 1,
                     0, cap_l - 1)
    k = s - offsets[li]
    in_pairs = s < total_pairs
    has_match = m[li] > 0
    ri_matched = order_r[torch.clamp(base[li] + k, 0, cap_r - 1)]
    right_valid = in_pairs & has_match
    ri = torch.where(right_valid, ri_matched, 0)
    out_l = take_columns(cols_l, torch.where(in_pairs, li, 0),
                         valid_at=in_pairs)
    out_r = take_columns(cols_r, ri, valid_at=right_valid)
    active = in_pairs
    if join_type in _RIGHT_OUTER:
        e = s - total_pairs
        is_extra = (s >= total_pairs) & (e < n_extra)
        ei = extra_order[torch.clamp(e, 0, cap_r - 1)]
        extra_cols = take_columns(cols_r, torch.where(is_extra, ei, 0),
                                  valid_at=is_extra)
        out_r = _where_cols(is_extra, out_r, extra_cols)
        active = active | is_extra
    return out_l, out_r, active


def _mask_sorted(left, right, lkeys, rkeys, join_type, null_safe):
    """Semi/anti over the key plan: ``m > 0`` / ``m == 0``."""
    _vr, m, _b, _o, _c = _key_plan(lkeys, rkeys, left, right, null_safe)
    if join_type == "leftsemi":
        return left.active & (m > 0)
    return left.active & (m == 0)


# ---------------------------------------------------------------------------
# the joinProbe route
# ---------------------------------------------------------------------------

def _align_string_caps(kl: Sequence[AnyDeviceColumn],
                       kr: Sequence[AnyDeviceColumn]):
    """Both sides' key columns with every string pair padded to one char
    capacity (``_pad_pair``)."""
    pairs = [_pad_pair(a, b) for a, b in zip(kl, kr)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _probe_kernel_eligible(lkeys, rkeys, cap_r: int) -> bool:
    """Static gate for the joinProbe kernel: the build side within
    ``_MAX_BUILD_ROWS``, every key a fixed-width-word type (floats keep
    the sort plan: their words are float-typed)."""
    from spark_rapids_tpu_torch.kernels.groupby_hash import _WORD_KEY_TYPES
    if not lkeys or len(lkeys) != len(rkeys):
        return False  # keyless (cross) shapes have no words to probe
    if cap_r > _MAX_BUILD_ROWS:
        return False
    return all(isinstance(e.data_type, _WORD_KEY_TYPES)
               for e in list(lkeys) + list(rkeys))


def probe_inputs(lkeys, rkeys, null_safe, left: DeviceBatch,
                 right: DeviceBatch):
    """The joinProbe kernel's arguments: evaluated keys in one word
    layout on both sides and the sort plan's exact valid sets. Returns
    ``(kw_r, valid_r, kw_l, valid_l)``."""
    from spark_rapids_tpu_torch.kernels.groupby_hash import pack_words_i64
    kl, kr, valid_l, valid_r = _eval_keys(lkeys, rkeys, left, right,
                                          null_safe)
    kl, kr = _align_string_caps(kl, kr)
    wl = _key_words(kl, null_safe)
    wr = _key_words(kr, null_safe)
    return (pack_words_i64(wr), valid_r.contiguous(), pack_words_i64(wl),
            valid_l.contiguous())


def _kernel_probe(lkeys, rkeys, null_safe, left: DeviceBatch,
                  right: DeviceBatch):
    """``(matched, first_row)`` per left row from the joinProbe kernel."""
    from spark_rapids_tpu_torch.kernels.join_probe import build_probe
    return build_probe(*probe_inputs(lkeys, rkeys, null_safe, left, right))


def build_key_max_multiplicity(right: DeviceBatch,
                               rkeys: Sequence[E.Expression],
                               null_safe: Sequence[bool]) -> int:
    """Largest number of build rows sharing one join key (0 when no valid
    keys); computed once per broadcast build side. 1 certifies every
    stream chunk for the FK fast path with no per-chunk sizing read."""
    kr, valid = _eval_side(rkeys, right, null_safe)
    active_s, _order, start, end = _group_extents(
        _key_words(kr, null_safe), valid)
    return int(torch.where(active_s, end - start + 1, 0).max())


def right_extras_batch(right: DeviceBatch, matched_any: torch.Tensor,
                       left_fields, out_schema: T.StructType
                       ) -> DeviceBatch:
    """Pair-layout batch of the UNMATCHED right rows (null left side):
    the final emission of a chunked right/full outer join, after every
    stream chunk ORed its matched mask into ``matched_any``."""
    keep = right.active & ~matched_any
    flat, spec = flatten_columns(right.columns)
    outs = []
    for a in flat:
        if a.dtype == torch.bool and a.dim() == 1:
            outs.append(a & keep)
        elif a.dim() == 2:
            outs.append(torch.where(keep[:, None], a, 0))
        else:
            outs.append(torch.where(keep, a, torch.zeros(
                (), dtype=a.dtype, device=a.device)))
    cap_r, dev = right.capacity, right.device
    off = torch.zeros(cap_r, dtype=torch.bool, device=dev)
    lcols = []
    for f in left_fields:
        dt = f.data_type
        if T.is_limb_decimal(dt):
            z = torch.zeros(cap_r, dtype=torch.int64, device=dev)
            lcols.append(make_column(dt, [z, z, off]))
        elif isinstance(dt, (T.StringType, T.BinaryType)):
            lcols.append(make_column(dt, [
                torch.zeros((cap_r, 8), dtype=torch.uint8, device=dev),
                torch.zeros(cap_r, dtype=torch.int32, device=dev), off]))
        else:
            lcols.append(make_column(dt, [torch.zeros(
                cap_r, dtype=torch_dtype(dt), device=dev), off]))
    return DeviceBatch(out_schema, lcols + rebuild_columns(spec, outs),
                       keep, None)


def device_join(left: DeviceBatch, right: DeviceBatch,
                lkeys: List[E.Expression], rkeys: List[E.Expression],
                join_type: str, out_schema: T.StructType,
                collect_matched_r: bool = False,
                null_safe: Sequence[bool] = (), fk_hint: bool = False,
                counts: Optional[Dict[str, int]] = None,
                metrics=None):
    """The equi-join of two device batches; keys are bound device
    expressions. Returns the joined batch (pair layout: left columns then
    right columns) or, for semi/anti, the masked left batch. With
    ``collect_matched_r`` returns ``(batch, matched_r)``, ``matched_r``
    the mask of right rows that matched any left row (None on the mask
    routes). ``counts["joinProbe"]`` counts the joins that took the
    kernel route, and so does ``kernelDispatchCount.joinProbe`` in
    ``metrics`` (the join exec's registry)."""
    ns = tuple(null_safe) or (False,) * len(lkeys)
    kern_ok = _probe_kernel_eligible(lkeys, rkeys, right.capacity)

    def dispatched():
        if counts is not None:
            bump_count(counts, "joinProbe")
        KR.count_dispatch(metrics, "joinProbe")

    if join_type in MASK_JOINS:
        if kern_ok:
            dispatched()
            matched, _ri = _kernel_probe(lkeys, rkeys, ns, left, right)
            new_active = left.active & (
                matched if join_type == "leftsemi" else ~matched)
        else:
            new_active = _mask_sorted(left, right, lkeys, rkeys, join_type,
                                      ns)
        out = DeviceBatch(left.schema, left.columns, new_active, None)
        return (out, None) if collect_matched_r else out

    if join_type not in PAIR_JOINS:
        raise NotImplementedError(
            f"join type {join_type} is not ported yet to "
            "spark_rapids_tpu_torch")

    if fk_hint and kern_ok and not collect_matched_r \
            and join_type in _FAST_TYPES:
        # certified-unique build keys + kernel: the probe IS the gather
        # map, with no count pass and no sizing read
        dispatched()
        matched, ri = _kernel_probe(lkeys, rkeys, ns, left, right)
        out_r = take_columns(right.columns,
                             torch.where(matched, ri, 0).to(torch.int64),
                             valid_at=matched)
        active = (left.active & matched) if join_type == "inner" \
            else left.active
        return DeviceBatch(out_schema, list(left.columns) + out_r, active,
                           None)

    (total_pairs, n_extra, max_m, m, offsets, base, order_r, extra_order,
     matched_r) = _count(left, right, lkeys, rkeys, join_type, ns)

    def run_fast(num_rows: Optional[int]):
        out_r, active = _fast_gather(right.columns, left.active, m, base,
                                     order_r, join_type)
        out = DeviceBatch(out_schema, list(left.columns) + out_r, active,
                          num_rows)
        return (out, matched_r) if collect_matched_r else out

    if fk_hint and join_type in _FAST_TYPES:
        # build keys certified unique: no sizing read at all
        return run_fast(None)

    # one host read for sizing
    sc = torch.stack([total_pairs, n_extra, max_m]).cpu().tolist()
    total = int(sc[0]) + int(sc[1])
    if int(sc[2]) <= 1 and join_type in _FAST_TYPES:
        return run_fast(total)
    out_cap = bucket_capacity(max(1, total))
    out_l, out_r, active = _gather(out_cap, join_type, left.columns,
                                   right.columns, total_pairs, n_extra, m,
                                   offsets, base, order_r, extra_order)
    out = DeviceBatch(out_schema, list(out_l) + list(out_r), active, total)
    return (out, matched_r) if collect_matched_r else out
