"""Sort-based segmented aggregation on torch tensors (the counterpart of
``spark_rapids_tpu.ops.groupby``): the final aggregate and the partial
re-run of a batch whose hash table overflowed.

1. Each key column becomes equality/order words (``grouping_subkeys``);
   int64 words carry the uint64 bit patterns the JAX package builds, so
   ``hash_subkey_words`` is bit-identical to its twin.
2. Rows sort by the words (``build_segments``, exact) or by one 63-bit
   hash of them (``build_segments_hashed``, partial modes only: a hash
   collision fragments a group, which the final stage re-groups).
3. Boundaries mark where any word changes; sums and counts are a cumsum
   minus the value at the segment start (``prefix_total``; counts ride
   the same int64 lane matrix as the sums in ``seg_sums_batched``), read
   at each segment's END row
   (``out_active`` marks exactly one row per group); min/max take the
   winning row of a segmented arg-min/max scan (``seg_scan_best``), the
   later of two tied rows, as in the JAX package.
4. Float sums never take the cumsum difference (cancellation against
   unrelated earlier segments): they run a segmented scan
   (``seg_running_sum``), and first/last take the winner of a segmented
   arg-min scan over the original row positions (``seg_scan_best``).
   Both are log-step (Hillis-Steele) scans with the segment start as
   the reset marker: the same additions in the same order on the CPU and
   on the card, no atomics, so a float result is deterministic. It is
   not XLA's ``associative_scan`` order, so float sums match the JAX
   package's to a stated relative tolerance, not bit for bit.

``spark.rapids.sql.hasNans`` false drops the is-NaN word of float keys
(``set_has_nans``, applied by the session before each query and part of
the aggregate programs' keys through ``kernel_salt``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceColumn, DeviceDecimal128Column,
    DeviceStringColumn, DeviceStructColumn, sort_key_i64, sort_with_payload, take_columns,
    torch_dtype)
from spark_rapids_tpu_torch.ops import int128 as I
from spark_rapids_tpu_torch.sql import types as T

_SIGN64 = -(1 << 63)


def _s64(v: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def rank_u64(col: DeviceColumn) -> torch.Tensor:
    """Order-preserving uint64 word (as int64 bits) of non-float data."""
    return col.data.to(torch.int64) ^ _SIGN64


# spark.rapids.sql.hasNans: False when the user asserts NaN-free float
# data, so float key words drop their is-NaN word
_HAS_NANS = True


def set_has_nans(v: bool) -> None:
    global _HAS_NANS
    _HAS_NANS = bool(v)


def kernel_salt() -> tuple:
    """Session flags that change a program's structure: part of the
    cached programs' keys."""
    return (_HAS_NANS,)


def rank_words(col: DeviceColumn) -> List[torch.Tensor]:
    """Order+equality words: floats become [is_nan, nan-zeroed value]
    (NaN greatest, all NaNs equal, -0.0 normalized by ``+ 0.0``), or the
    value alone under hasNans=false."""
    data = col.data
    if data.is_floating_point():
        if not _HAS_NANS:
            return [data + 0.0]
        nanf = torch.isnan(data)
        return [nanf, torch.where(nanf, torch.zeros_like(data), data) + 0.0]
    if data.dtype == torch.bool:
        return [data.to(torch.int64)]
    return [rank_u64(col)]


def limb_words(col: DeviceDecimal128Column) -> List[torch.Tensor]:
    """Signed-128 order == (sign-flipped hi, unsigned lo)."""
    return [col.hi ^ _SIGN64, col.lo]


def pack_string_words(c: DeviceStringColumn) -> List[torch.Tensor]:
    """Big-endian packed 8-byte words (uint64 bits in int64): word order
    == byte lexicographic order, with the length as tiebreak."""
    chars = c.chars
    cc = chars.shape[1]
    if cc % 8:
        chars = torch.nn.functional.pad(chars, (0, 8 - cc % 8))
    c64 = chars.to(torch.int64)
    words = []
    for k in range(chars.shape[1] // 8):
        word = torch.zeros(chars.shape[0], dtype=torch.int64,
                           device=chars.device)
        for j in range(8):
            word = word | (c64[:, 8 * k + j] << (56 - 8 * j))
        words.append(word)
    return words


def value_words(col: AnyDeviceColumn) -> List[torch.Tensor]:
    """Comparison words for any column type. A struct's are its fields'
    words, each field's prefixed by its validity: they order structs
    field-major, which is also exact equality."""
    if isinstance(col, DeviceStringColumn):
        return pack_string_words(col) + [col.lengths.to(torch.int64)]
    if isinstance(col, DeviceDecimal128Column):
        return limb_words(col)
    if isinstance(col, DeviceStructColumn):
        words: List[torch.Tensor] = []
        for f in col.fields:
            words.append(f.validity)
            words.extend(value_words(f))
        return words
    return rank_words(col)


def grouping_subkeys(col: AnyDeviceColumn) -> List[torch.Tensor]:
    """Words whose joint equality == Spark group-key equality; validity
    is included so null forms its own group."""
    if isinstance(col, DeviceStringColumn):
        return [col.validity, col.lengths] + pack_string_words(col)
    if isinstance(col, DeviceDecimal128Column):
        return [col.validity] + limb_words(col)
    if isinstance(col, DeviceStructColumn):
        return [col.validity] + value_words(col)
    return [col.validity] + rank_words(col)


_FNV64 = _s64(0xcbf29ce484222325)
_PRIME64 = 0x00000100000001B3
_MIX64 = _s64(0x9E3779B97F4A7C15)


def _hash_word_u64(w: torch.Tensor) -> torch.Tensor:
    """uint64 image (int64 bits) of one equality word; equal words map
    equal. Twin of the JAX package's ``_hash_word_u64``."""
    if w.dtype == torch.float32:
        return w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if w.dtype == torch.float64:
        a = w.to(torch.int64)
        b = (w * 65536.0).to(torch.int64)
        return (a * _MIX64) ^ b
    return w.to(torch.int64)  # bools and ints sign-extend, as astype does


def hash_subkey_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """FNV-style fold of equality words into one uint64 (int64 bits);
    int64 multiplication wraps exactly like uint64."""
    h = torch.full(words[0].shape, _FNV64, dtype=torch.int64,
                   device=words[0].device)
    for w in words:
        h = (h ^ _hash_word_u64(w)) * _PRIME64
    h = h ^ I._srl(h, 29)
    h = h * _MIX64
    return h ^ I._srl(h, 32)


class Segments:
    """Sorted-row-space segmentation; aggregates read their per-segment
    result at the segment's END row (``out_active``)."""

    def __init__(self, order, active_sorted, boundary, is_end,
                 payload=()):
        self.order = order
        self.active_sorted = active_sorted
        self.boundary = boundary
        self.is_end = is_end
        self.capacity = int(active_sorted.shape[0])
        self.out_active = is_end & active_sorted
        self.payload = payload
        pos = torch.arange(self.capacity, device=active_sorted.device)
        self.start_of_row = torch.cummax(
            torch.where(boundary, pos, -1), dim=0).values

    @property
    def seg_ids(self) -> torch.Tensor:
        return torch.cumsum(self.boundary.to(torch.int64), 0) - 1


def _boundaries(sorted_keys: Sequence[torch.Tensor],
                active_s: torch.Tensor):
    cap = active_s.shape[0]
    differs = torch.zeros(cap, dtype=torch.bool, device=active_s.device)
    for k in list(sorted_keys) + [active_s]:
        differs[1:] |= k[1:] != k[:-1]
    differs[:1].fill_(True)  # a fill, not a host-to-device copy
    is_end = torch.cat([differs[1:], differs.new_ones(1)])
    return differs, is_end


def build_segments(key_cols: Sequence[AnyDeviceColumn],
                   active: torch.Tensor,
                   payload: Sequence[torch.Tensor] = ()) -> Segments:
    """Exact segmentation: live rows first, then every key word."""
    subkeys: List[torch.Tensor] = []
    for c in key_cols:
        subkeys.extend(grouping_subkeys(c))
    keys_all, order, payload_s = sort_with_payload([~active] + subkeys,
                                                   payload)
    active_s = ~keys_all[0]
    boundary, is_end = _boundaries(keys_all[1:], active_s)
    return Segments(order, active_s, boundary, is_end, tuple(payload_s))


def build_segments_hashed(key_cols: Sequence[AnyDeviceColumn],
                          active: torch.Tensor,
                          payload: Sequence[torch.Tensor] = ()
                          ) -> Segments:
    """One sort by a 63-bit hash of the key words (live rows first), then
    exact boundaries from the gathered real words. Only for partial
    modes: a collision can fragment a group, never merge two."""
    subkeys: List[torch.Tensor] = []
    for c in key_cols:
        subkeys.extend(grouping_subkeys(c))
    if subkeys:
        h = I._srl(hash_subkey_words(subkeys), 1)
    else:  # global aggregate: one segment
        h = torch.zeros(active.shape[0], dtype=torch.int64,
                        device=active.device)
    # live rows take [-2^63, -1], padding 0: strictly after every live row
    word = torch.where(active, h + _SIGN64, 0)
    _s, order = torch.sort(word, stable=True)
    from spark_rapids_tpu_torch.ops.lanes import fused_take
    gathered = fused_take(list(payload) + subkeys + [active], order)
    payload_s = gathered[:len(payload)]
    active_s = gathered[-1]
    boundary, is_end = _boundaries(gathered[len(payload):-1], active_s)
    return Segments(order, active_s, boundary, is_end, tuple(payload_s))


def seg_sums_batched(seg: Segments, entries) -> List[AnyDeviceColumn]:
    """All sum/count-family aggregates in one int64 lane matrix: one
    cumsum, minus the prefix before each segment's start. ``entries``:
    ``(col_s, kind, out_type)`` with kind in {count, sum, sum_nonnull},
    ``col_s`` already in sorted row space."""
    if not entries:
        return []
    lanes: List[torch.Tensor] = []
    flanes: List[torch.Tensor] = []
    specs = []
    lane_of: dict = {}
    m32 = 0xFFFFFFFF

    def _lane(arr, tag, a) -> int:
        key = (id(arr), tag)
        li = lane_of.get(key)
        if li is None:
            li = len(lanes)
            lanes.append(a)
            lane_of[key] = li
        return li

    for col, kind, out_type in entries:
        valid = col.validity & seg.active_sorted
        if kind == "count":
            specs.append(("count", _lane(col.validity, "valid",
                                         valid.to(torch.int64))))
            continue
        has_lane = (_lane(col.validity, "valid", valid.to(torch.int64))
                    if kind == "sum" else None)
        if T.is_limb_decimal(out_type):
            if isinstance(col, DeviceDecimal128Column):
                hi, lo = col.hi, col.lo
            else:
                hi, lo = I.from_i64(torch, col.data.to(torch.int64))
            hi = torch.where(valid, hi, 0)
            lo = torch.where(valid, lo, 0)
            specs.append(("dec", (_lane(col, "dec0", lo & m32),
                                  _lane(col, "dec1", I._srl(lo, 32)),
                                  _lane(col, "dechi", hi)),
                          has_lane, out_type))
        elif T.is_floating(out_type):
            key = (id(col), "fval")
            fl = lane_of.get(key)
            if fl is None:
                fl = len(flanes)
                flanes.append(torch.where(valid, col.data.to(torch.float64),
                                          0.0))
                lane_of[key] = fl
            specs.append(("float", fl, has_lane, out_type))
        else:
            specs.append(("int", _lane(col, "ival", torch.where(
                valid, col.data.to(torch.int64), 0)), has_lane, out_type))
    itot = prefix_total(seg, torch.stack(lanes, dim=1)) if lanes else None
    ftot = prefix_total(seg, torch.stack(flanes, dim=1)) if flanes else None
    out: List[AnyDeviceColumn] = []
    out_active = seg.out_active
    for spec in specs:
        if spec[0] == "count":
            out.append(DeviceColumn(T.LongT, torch.where(
                out_active, itot[:, spec[1]], 0), out_active))
            continue
        kind, lane, has_lane, out_type = spec
        validity = out_active
        if has_lane is not None:
            validity = validity & (itot[:, has_lane] > 0)
        if kind == "dec":
            l0, l1, lh = lane
            s0, s1, shi = itot[:, l0], itot[:, l1], itot[:, lh]
            rhi, rlo = I.from_i64(torch, s0)
            h1, lo1 = I.mul_i64(torch, s1, torch.full_like(s1, 1 << 32))
            rhi, rlo = I.add(torch, rhi, rlo, h1, lo1)
            rhi = rhi + shi
            validity = validity & I.fits_precision(torch, rhi, rlo,
                                                   out_type.precision)
            out.append(DeviceDecimal128Column(
                out_type, torch.where(validity, rhi, 0),
                torch.where(validity, rlo, 0), validity))
        elif kind == "float":
            out.append(DeviceColumn(out_type, torch.where(
                validity, ftot[:, lane], 0.0).to(torch_dtype(out_type)),
                validity))
        else:
            out.append(DeviceColumn(out_type, torch.where(
                validity, itot[:, lane], 0).to(torch_dtype(out_type)),
                validity))
    return out


def _shifted(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """``x`` moved down ``d`` rows (row i holds x[i - d]); the first
    ``d`` rows hold ``fill``."""
    head = torch.full((d,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([head, x[:-d]], dim=0)


def seg_running_sum(seg_marker: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """Segmented inclusive running sum that resets where ``seg_marker``
    changes (``x`` is (rows,) or (rows, lanes)): a log-step scan, whose
    additions are the same on every device."""
    cap = x.shape[0]
    marker = seg_marker if x.dim() == 1 else seg_marker[:, None]
    d = 1
    while d < cap:
        same = _shifted(marker, d, -1) == marker
        x = torch.where(same, _shifted(x, d, 0) + x, x)
        d <<= 1
    return x


def prefix_total(seg: Segments, x: torch.Tensor) -> torch.Tensor:
    """Per-row running total restarting at segment starts (``x`` is
    (rows,) or (rows, lanes)); at END rows it is the segment total.
    Integers take one cumsum minus the prefix before each segment's
    start, which is exact; floats the segmented scan."""
    start = seg.start_of_row
    if x.is_floating_point():
        return seg_running_sum(start, x)
    if x.dim() == 1:
        pp = torch.cumsum(x, 0)
    else:
        # each lane scanned as the innermost dimension: CUDA's scan along
        # the outer dimension of a (rows, lanes) matrix took 1.27 s of
        # q1-double's 1.34 s device time on an H100
        pp = torch.cumsum(x.t().contiguous(), 1).t()
    has = start > 0 if x.dim() == 1 else (start > 0)[:, None]
    return pp - torch.where(has, pp[torch.clamp(start - 1, min=0)], 0)


def seg_scan_best(seg_marker: torch.Tensor, words: Sequence[torch.Tensor],
                  valid: torch.Tensor, is_min: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented running arg-min/max over multi-word ranks: for each
    sorted row, the position of the best valid row from its segment's
    start up to itself (lexicographic over ``words``, most significant
    first, each in signed order: ``sort_key_i64`` of a uint64-pattern
    word; on a tie the later row wins, as in the JAX package). Returns
    ``(winner position, has winner)``. A log-step scan, no scatter."""
    cap = seg_marker.shape[0]
    pos = torch.arange(cap, dtype=torch.int64, device=seg_marker.device)
    words = [w.to(torch.int64) if w.dtype == torch.bool else w
             for w in words]
    d = 1
    while d < cap:
        a_id = _shifted(seg_marker, d, -1)
        a_valid = _shifted(valid, d, False)
        a_p = _shifted(pos, d, 0)
        a_w = [_shifted(w, d, 0) for w in words]
        a_live = a_valid & (a_id == seg_marker)
        better = torch.zeros_like(a_live)
        eq = torch.ones_like(a_live)
        for wa, wb in zip(a_w, words):
            c = (wa < wb) if is_min else (wa > wb)
            better = better | (eq & c)
            eq = eq & (wa == wb)
        take_a = a_live & ((~valid) | better)
        valid = a_live | valid
        pos = torch.where(take_a, a_p, pos)
        words = [torch.where(take_a, wa, wb) for wa, wb in zip(a_w, words)]
        d <<= 1
    return pos, valid


def _winner_gather(seg: Segments, col_s: AnyDeviceColumn,
                   win_pos: torch.Tensor, won: torch.Tensor
                   ) -> AnyDeviceColumn:
    """The winning sorted position's row of ``col_s``; rows without a
    winner become null."""
    safe = torch.clamp(win_pos, 0, seg.capacity - 1)
    return take_columns([col_s], safe, valid_at=won)[0]


def seg_first_last(seg: Segments, col_s: AnyDeviceColumn, is_first: bool,
                   ignore_nulls: bool) -> AnyDeviceColumn:
    """first/last by original row order (Spark First/Last). With
    ``ignore_nulls`` False the first/last row itself is taken, null or
    not."""
    eligible = seg.active_sorted
    if ignore_nulls:
        eligible = eligible & col_s.validity
    rank = seg.order.to(torch.int64) + 1
    win, has = seg_scan_best(seg.start_of_row, [rank], eligible,
                             is_min=is_first)
    return _winner_gather(seg, col_s, win, has & seg.out_active)


def _descending(words: List[torch.Tensor]) -> List[torch.Tensor]:
    out = []
    for k in words:
        if k.dtype == torch.bool:
            out.append(~k)
        elif k.is_floating_point():
            out.append(-k)
        else:
            out.append(~k)
    return out


def seg_extreme(seg: Segments, col_s: AnyDeviceColumn, is_min: bool
                ) -> AnyDeviceColumn:
    """min/max by the winning row, so values round-trip untouched: the
    winner of ``seg_scan_best`` at each segment's end row. Rows of equal
    rank (-0.0 and 0.0, NaNs of different payloads) tie, and the later
    row wins, as in the JAX package."""
    valid_s = col_s.validity & seg.active_sorted
    words = [sort_key_i64(w) for w in value_words(col_s)]
    win, has = seg_scan_best(seg.start_of_row, words, valid_s, is_min)
    return _winner_gather(seg, col_s, win, has & seg.out_active)
