"""Single-pass hash-table partial group-by (CUDA, ``csrc/groupby_hash.cu``).

Replaces ``spark_rapids_tpu/kernels/groupby_hash.py`` ``_build_kernel`` and
``_build_kernel_tiled``: one open-addressed insert/combine pass over the
batch instead of a multi-word sort plus segmented scans, for the PARTIAL
aggregation update when every slot is in the SUM/COUNT/MIN/MAX family
over fixed-width data. Bound on the H100: bytes — the key words, hash,
validity and lane matrices read once, at 3.35 TB/s.

Lanes are lane-major, ``(n_lanes, cap)`` int64, so the kernel's loads of
one lane are contiguous across a warp. Each kernel block folds its rows
into a shared-memory table of ``local_table_entries`` entries before it
touches the global table; the sizing is plain Python, passed to the
kernel at launch.

Results equal the sort-based path by construction, as in the JAX
package: every accumulator lane is int64 (counts, integer and decimal
sums in the exact 32-bit-part encoding of ``seg_sums_batched``, min/max
over integer values), so the order in which atomics land cannot change a
bit; group keys are gathered from the batch by each group's first row;
partial-mode group order is not part of the contract (the final stage
re-groups), so table-slot order is invisible downstream.

A batch with more distinct groups than the table holds, or with a row
still unplaced after 64 probes, raises the overflow flag; the exec then
re-runs that batch on the sort-based partial aggregate and counts it
(``overflow_reruns``) — part of the algorithm, not error handling.

On CPU tensors ``groupby_table`` runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)
MAX_PROBES = 64
# shared memory for each kernel block (one block of 1024 threads per SM,
# within the 227 KB a block may use): its group table, and the owner
# words of a table of at most OWNER_CACHE_SLOTS slots
LOCAL_TABLE_BYTES = 200 * 1024
OWNER_CACHE_SLOTS = 4096

_EXTREME_PRIMS = {E.PRIM_MIN, E.PRIM_MAX}
_WORD_KEY_TYPES = (T.BooleanType, T.ByteType, T.ShortType,
                   T.IntegerType, T.LongType, T.DateType,
                   T.TimestampType, T.StringType, T.DecimalType)
_EXTREME_TYPES = (T.BooleanType, T.ByteType, T.ShortType,
                  T.IntegerType, T.LongType, T.DateType,
                  T.TimestampType)


def _extreme_type_ok(dt: T.DataType) -> bool:
    if isinstance(dt, _EXTREME_TYPES):
        return True
    return isinstance(dt, T.DecimalType) and dt.precision <= 18


def agg_kernel_eligible(mode: str,
                        grouping: Sequence[E.AttributeReference],
                        prims: Sequence[Tuple[str, T.DataType]]) -> bool:
    """Can the whole partial aggregation run through the kernel? All or
    nothing, as in the JAX package."""
    if mode != "partial" or not grouping:
        return False
    if not all(isinstance(g.data_type, _WORD_KEY_TYPES) for g in grouping):
        return False
    for prim, out_type in prims:
        if prim == E.PRIM_COUNT:
            continue
        if prim in (E.PRIM_SUM, E.PRIM_SUM_NONNULL):
            if T.is_floating(out_type):
                return False
            continue
        if prim in _EXTREME_PRIMS:
            if not _extreme_type_ok(out_type):
                return False
            continue
        return False
    return True


def pack_words_i64(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Equality words -> one ``(cap, K)`` int64 bit-image matrix."""
    from spark_rapids_tpu_torch.ops.lanes import _as_u64_bits
    return torch.stack([_as_u64_bits(w) for w in words], dim=1)


# ---------------------------------------------------------------------------
# lane planning: (col, prim, out_type) entries -> int64 lanes + decode
# ---------------------------------------------------------------------------

def plan_lanes(entries, active: torch.Tensor):
    """Encode every aggregation slot into int64 lanes, mirroring
    ``seg_sums_batched``'s exact encodings (32-bit decimal parts with a
    wraparound high limb) plus min/max lanes. Returns ``(add_lanes,
    min_lanes, max_lanes, decode)``; ``decode(add_out, min_out, max_out,
    used)`` rebuilds each slot's device column from the tables."""
    from spark_rapids_tpu_torch.columnar.device import (
        DeviceColumn as DC, DeviceDecimal128Column, torch_dtype)
    from spark_rapids_tpu_torch.ops import int128 as I
    add_lanes: List[torch.Tensor] = []
    min_lanes: List[torch.Tensor] = []
    max_lanes: List[torch.Tensor] = []
    specs: List[Tuple] = []
    lane_of: dict = {}
    m32 = 0xFFFFFFFF

    def _add(arr, tag, a) -> int:
        key = (id(arr), tag)
        li = lane_of.get(key)
        if li is None:
            li = len(add_lanes)
            add_lanes.append(a)
            lane_of[key] = li
        return li

    for col, prim, out_type in entries:
        valid = col.validity & active
        if prim == E.PRIM_COUNT:
            specs.append(("count", _add(col.validity, "valid",
                                        valid.to(torch.int64))))
            continue
        if prim in _EXTREME_PRIMS:
            is_min = prim == E.PRIM_MIN
            lane = torch.where(valid, col.data.to(torch.int64),
                               _I64_MAX if is_min else _I64_MIN)
            has = _add(col.validity, "valid", valid.to(torch.int64))
            kind_lanes = min_lanes if is_min else max_lanes
            specs.append(("min" if is_min else "max", len(kind_lanes), has,
                          out_type, col.data.dtype))
            kind_lanes.append(lane)
            continue
        has_lane = (_add(col.validity, "valid", valid.to(torch.int64))
                    if prim == E.PRIM_SUM else None)
        if T.is_limb_decimal(out_type):
            if isinstance(col, DeviceDecimal128Column):
                hi, lo = col.hi, col.lo
            else:
                hi, lo = I.from_i64(torch, col.data.to(torch.int64))
            hi = torch.where(valid, hi, 0)
            lo = torch.where(valid, lo, 0)
            l0 = _add(col, "dec0", lo & m32)
            l1 = _add(col, "dec1", I._srl(lo, 32))
            lh = _add(col, "dechi", hi)  # wraparound == mod-2^128 high
            specs.append(("dec", (l0, l1, lh), has_lane, out_type))
        else:
            specs.append(("int", _add(col, "ival", torch.where(
                valid, col.data.to(torch.int64), 0)), has_lane, out_type))

    def decode(add_out, min_out, max_out, used):
        outs = []
        for spec in specs:
            if spec[0] == "count":
                outs.append(DC(T.LongT, torch.where(
                    used, add_out[:, spec[1]], 0), used))
                continue
            if spec[0] in ("min", "max"):
                _k, li, has, out_type, dt = spec
                lane = (min_out if spec[0] == "min" else max_out)[:, li]
                validity = used & (add_out[:, has] > 0)
                outs.append(DC(out_type,
                               torch.where(validity, lane, 0).to(dt),
                               validity))
                continue
            kind, lane, has_lane, out_type = spec
            validity = used
            if has_lane is not None:
                validity = validity & (add_out[:, has_lane] > 0)
            if kind == "dec":
                l0, l1, lh = lane
                s0, s1, shi = add_out[:, l0], add_out[:, l1], \
                    add_out[:, lh]
                rhi, rlo = I.from_i64(torch, s0)
                h1, lo1 = I.mul_i64(torch, s1, torch.full_like(s1, 1 << 32))
                rhi, rlo = I.add(torch, rhi, rlo, h1, lo1)
                rhi = rhi + shi
                validity = validity & I.fits_precision(
                    torch, rhi, rlo, out_type.precision)
                outs.append(DeviceDecimal128Column(
                    out_type, torch.where(validity, rhi, 0),
                    torch.where(validity, rlo, 0), validity))
            else:
                acc = torch_dtype(out_type)
                outs.append(DC(out_type, torch.where(
                    validity, add_out[:, lane], 0).to(acc), validity))
        return outs

    return add_lanes, min_lanes, max_lanes, decode


# ---------------------------------------------------------------------------
# the table pass: kernel on the card, plain version on the host
# ---------------------------------------------------------------------------

def _lane_matrix(lanes: List[torch.Tensor], cap: int,
                 device: torch.device) -> torch.Tensor:
    """Lanes -> one lane-major ``(n_lanes, cap)`` int64 matrix."""
    if not lanes:
        return torch.zeros((0, cap), dtype=torch.int64, device=device)
    return torch.stack(lanes, dim=0)


def local_table_entries(n_lanes: int, slots: int) -> int:
    """Entries of each kernel block's shared-memory group table: the
    largest power of two, at most ``slots``, whose entries (8 bytes a
    lane plus a slot word and a first-row word) fit in
    ``LOCAL_TABLE_BYTES`` beside the block's cache of owner words (4
    bytes a slot, kept when ``slots <= OWNER_CACHE_SLOTS``); 0 when not
    even one entry fits (every group then goes to the global table)."""
    per_entry = 8 * n_lanes + 8
    budget = LOCAL_TABLE_BYTES - (4 * slots if slots <= OWNER_CACHE_SLOTS
                                  else 0)
    if per_entry > budget:
        return 0
    entries = 1
    while entries * 2 <= slots and entries * 2 * per_entry <= budget:
        entries *= 2
    return entries


def groupby_table_plain(kw, h, valid, add, mn, mx, slots: int):
    """Plain PyTorch version of the table pass: the same tables as the
    kernel (owner = first row per group, summed/min/max lanes, overflow
    flag), from the same lane-major ``(n, cap)`` lane matrices. Groups
    take their slots by linear probing in first-row order; a group
    beyond the table or further than 64 probes from its home slot
    overflows, as in the kernel."""
    device = kw.device
    T_ = slots
    rows = torch.nonzero(valid).flatten()
    owner = torch.full((T_,), -1, dtype=torch.int32, device=device)
    add_out = torch.zeros((T_, add.shape[0]), dtype=torch.int64,
                          device=device)
    min_out = torch.full((T_, mn.shape[0]), _I64_MAX, dtype=torch.int64,
                         device=device)
    max_out = torch.full((T_, mx.shape[0]), _I64_MIN, dtype=torch.int64,
                         device=device)
    overflow = torch.zeros(1, dtype=torch.int32, device=device)
    if rows.numel() == 0:
        return owner, add_out, min_out, max_out, overflow
    _u, gid = torch.unique(kw[rows], dim=0, return_inverse=True)
    n_groups = int(_u.shape[0])
    first = torch.full((n_groups,), rows.shape[0] + kw.shape[0],
                       dtype=torch.int64, device=device)
    first = first.scatter_reduce(0, gid, rows, reduce="amin")
    # sequential insertion in first-row order, on the host
    order = torch.argsort(first).cpu().numpy()
    first_np = first.cpu().numpy()
    home_np = (h[first] & (T_ - 1)).cpu().numpy()
    taken = np.zeros(T_, dtype=bool)
    slot_of = np.full(n_groups, -1, dtype=np.int64)
    ovf = False
    for g in order:
        s = int(home_np[g])
        for _p in range(MAX_PROBES):
            if not taken[s]:
                taken[s] = True
                slot_of[g] = s
                break
            s = (s + 1) & (T_ - 1)
        else:
            ovf = True
    placed = np.nonzero(slot_of >= 0)[0]
    slot_t = torch.from_numpy(slot_of).to(device)
    owner[slot_t[placed]] = torch.from_numpy(
        first_np[placed].astype(np.int32)).to(device)
    row_slot = slot_t[gid]
    ok = row_slot >= 0
    if not bool(ok.all()):
        ovf = True
    r_ok, s_ok = rows[ok], row_slot[ok]
    if add.shape[0]:
        add_out.index_add_(0, s_ok, add[:, r_ok].T)
    for j in range(mn.shape[0]):
        min_out[:, j].scatter_reduce_(0, s_ok, mn[j, r_ok], reduce="amin")
    for j in range(mx.shape[0]):
        max_out[:, j].scatter_reduce_(0, s_ok, mx[j, r_ok], reduce="amax")
    overflow[0] = int(ovf)
    return owner, add_out, min_out, max_out, overflow


def groupby_table(kw, h, valid, add, mn, mx, slots: int,
                  block_rows: int = 0, lane_groups: int = 1,
                  tuned: bool = False):
    """The partial group-by table pass: ``(owner int32[T], add_out,
    min_out, max_out int64[T, n], overflow int32[1])``; ``owner`` is -1
    for unused slots, else the group's first row. ``block_rows`` (the
    rows each kernel block walks; 0 = one a thread) and ``lane_groups``
    (the divisor of the shared-memory table's entries) are the
    autotuner's launch knobs: they change the launch, never a result,
    and the plain version has no launch to change. ``tuned`` marks the
    dispatch span of a launch that runs a recorded winner."""
    bucket = kw.shape[0]
    if not kw.is_cuda:
        # the plain version's call takes the kernel's span on the CPU
        t0 = KR.dispatch_start()
        out = groupby_table_plain(kw, h, valid, add, mn, mx, slots)
        if t0 is not None:
            KR.dispatch_end(t0, "groupbyHash", slots=slots, bucket=bucket,
                            tuned=tuned)
        return out
    ins = [kw, h, valid, add, mn, mx]
    KR.require_cuda(ins, "groupbyHash")
    n, K = kw.shape
    if kw.dtype != torch.int64 or h.dtype != torch.int64 \
            or valid.dtype != torch.bool:
        raise KR.KernelError("groupbyHash: kw/h int64 and valid bool")
    for lanes in (add, mn, mx):
        if lanes.dtype != torch.int64 or lanes.dim() != 2 \
                or lanes.shape[1] != n:
            raise KR.KernelError("groupbyHash: lanes (n, cap) int64")
    if slots & (slots - 1) or slots <= 0:
        raise KR.KernelError(f"groupbyHash: {slots} slots, not a power "
                             "of two")
    if n >= (1 << 31):
        raise KR.KernelError("groupbyHash: row index exceeds int32")
    n_add, n_min, n_max = add.shape[0], mn.shape[0], mx.shape[0]
    fn = KR.library("groupby_hash").groupby_hash_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, vp, vp, ci, vp, ci, vp, ci, vp, ci, ci, ci, ci,
                   vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    device = kw.device
    owner = torch.empty(slots, dtype=torch.int32, device=device)
    add_out = torch.empty((slots, n_add), dtype=torch.int64, device=device)
    min_out = torch.empty((slots, n_min), dtype=torch.int64, device=device)
    max_out = torch.empty((slots, n_max), dtype=torch.int64, device=device)
    overflow = torch.empty(1, dtype=torch.int32, device=device)
    t0 = KR.dispatch_start()
    KR.count_launch("groupbyHash")
    # the launch goes to the calling thread's current device: make
    # it the tensors' (a card other than 0 on a mesh)
    with KR.on_device(device):
        KR.check(fn(kw.data_ptr(), K, h.data_ptr(), valid.data_ptr(), n,
                    add.data_ptr(), n_add, mn.data_ptr(), n_min,
                    mx.data_ptr(), n_max, slots,
                    local_table_entries(n_add + n_min + n_max, slots)
                    // max(1, int(lane_groups)), int(block_rows),
                    owner.data_ptr(), add_out.data_ptr(), min_out.data_ptr(),
                    max_out.data_ptr(), overflow.data_ptr(),
                    KR.stream_handle(device)),
                 "groupbyHash launch")
    if t0 is not None:
        KR.dispatch_end(t0, "groupbyHash", chip=device.index, slots=slots,
                        bucket=bucket, tuned=tuned)
    return owner, add_out, min_out, max_out, overflow


def table_inputs(key_cols, entries, active: torch.Tensor):
    """Key words, hash and lane matrices of one batch, in the layout the
    table pass takes. Returns ``(kw, h, add, mn, mx, decode)``."""
    from spark_rapids_tpu_torch.ops import groupby as G
    subkeys: List[torch.Tensor] = []
    for c in key_cols:
        subkeys.extend(G.grouping_subkeys(c))
    kw = pack_words_i64(subkeys)
    h = G.hash_subkey_words(subkeys)
    add_l, min_l, max_l, decode = plan_lanes(entries, active)
    cap, dev = active.shape[0], active.device
    return (kw, h, _lane_matrix(add_l, cap, dev),
            _lane_matrix(min_l, cap, dev), _lane_matrix(max_l, cap, dev),
            decode)


def hash_groupby(key_cols, entries, active: torch.Tensor, slots: int,
                 params: Optional[dict] = None, tuned: bool = False):
    """Single-pass group-by: ``(key_out, buffers, used, overflow)``, all
    at capacity ``slots``. ``entries`` are ``(col, prim, out_type)``;
    callers pre-check ``agg_kernel_eligible``. Keys are gathered from
    the batch by each group's first row. ``params`` are the autotuner's
    launch knobs for this batch's bucket (``slotsMult`` is already in
    ``slots``)."""
    from spark_rapids_tpu_torch.columnar.device import take_columns
    cap = active.shape[0]
    params = params or {}
    kw, h, add, mn, mx, decode = table_inputs(key_cols, entries, active)
    owner, add_out, min_out, max_out, overflow = groupby_table(
        kw, h, active, add, mn, mx, slots,
        block_rows=int(params.get("blockRows", 0)),
        lane_groups=int(params.get("laneGroups", 1)), tuned=tuned)
    used = owner >= 0
    key_out = take_columns(key_cols,
                           owner.clamp(0, cap - 1).to(torch.int64),
                           valid_at=used)
    buffers = decode(add_out, min_out, max_out, used)
    return key_out, buffers, used, overflow
