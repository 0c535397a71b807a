"""The mesh all-to-all exchange (the counterpart of
``spark_rapids_tpu.parallel.ici``; the reference's UCX shuffle).

One process drives every chip of the mesh. A hash exchange over the
mesh, per its JAX twin:

  1. ``stack_batches``: each chip's slot (its resident batches,
     concatenated) is padded to the common capacity bucket on its chip,
     the string columns to the common character width (``meshStack``);
  2. every chip hashes its rows' keys with the murmur3 kernel, the
     partition id taken in the same launch (one launch per chip), and
     routes row ``i`` to chip ``pid % n``;
  3. the size exchange: each chip's per-destination row counts, read on
     the host as one ``[n, n]`` matrix (``meshSizeExchange``), size the
     send blocks to the largest count's bucket (``block_cap``) instead of
     a whole slot's capacity;
  4. ``all_to_all_rows``: each chip orders its rows stably by
     destination and lays them into ``n`` send blocks; block ``(s, d)``
     moves to chip ``d`` (``meshExchange``): between cards a peer copy
     ordered after the source stream's work, between emulated chips the
     same tensors;
  5. each chip lands the blocks it received, in source order, through
     ``exec.exchange.split_by_pid``: partition ``p`` lives on chip
     ``p % n``.

The rows of each partition, and their order, are the JAX mesh's: blocks
arrive in source-chip order and each block keeps its source's row
order. XLA's murmur3 chain there and the murmur3 kernel here are
bit-identical, so both route every row alike.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import trace as TR
from spark_rapids_tpu_torch.columnar.device import (
    AnyDeviceColumn, DeviceBatch, DeviceStringColumn, batch_device,
    batch_to_device, bucket_capacity, bucket_char_cap, copy_to_device,
    flatten_columns, rebuild_columns, row_arrays, with_row_arrays)
from spark_rapids_tpu_torch.jit_cache import JitCache, mirror_to_metrics
from spark_rapids_tpu_torch.parallel.mesh import (Chip, TorchMesh,
                                                  mesh_key, mesh_size)
from spark_rapids_tpu_torch.sql import expressions as E

# the exchange's per-shape routing plans, in the bounded cache every
# structural cache uses (listed in jit_cache.cache_stats())
_EXCHANGE_CACHE = JitCache("iciExchange")


# ---------------------------------------------------------------------------
# Row-block all-to-all (shared by the exchange and sum_count_step)
# ---------------------------------------------------------------------------

def _send_blocks(arrs: Sequence[torch.Tensor], active: torch.Tensor,
                 dest: torch.Tensor, n_dev: int, block: int):
    """One source chip's send blocks: every array laid out as
    ``[n_dev * block, ...]``, block ``d`` holding the active rows headed
    to chip ``d`` in their original order, zero padded; plus the
    per-destination counts (a device tensor)."""
    dev = active.device
    key = torch.where(active, dest.to(torch.int64), n_dev)
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key, minlength=n_dev + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(key.shape[0], device=dev)
    # inactive rows land on one trash row past the last block
    pos = torch.where(key_s < n_dev,
                      key_s * block + (rank - starts[key_s]),
                      n_dev * block)
    out = []
    for a in arrs:
        buf = torch.zeros((n_dev * block + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=dev)
        buf.index_copy_(0, pos, a[order])
        out.append(buf[:n_dev * block])
    return out, counts[:n_dev]


def all_to_all_rows(arrs: Sequence[Sequence[torch.Tensor]],
                    active: Sequence[torch.Tensor],
                    dest: Sequence[torch.Tensor], chips: Sequence[Chip],
                    block_cap: Optional[int] = None
                    ) -> Tuple[List[List[torch.Tensor]],
                               List[torch.Tensor]]:
    """Route each active row of source chip ``s`` to chip ``dest[s][i]``.
    ``arrs[s]`` are chip ``s``'s row arrays, all of ``active[s]``'s
    capacity. Returns, per destination chip ``d``, its received arrays as
    ``[n_src * block, ...]`` (block ``s`` from source ``s``) and the
    received active mask, on ``d``'s device. Padding rows are zeros.

    ``block_cap`` sizes each send block; the default (a whole slot's
    capacity) is safe when no counts were read first."""
    n_dev = len(chips)
    cap = int(active[0].shape[0])
    block = cap if block_cap is None else min(block_cap, cap)
    sends, counts = [], []
    for s in range(n_dev):
        blk, cnt = _send_blocks(arrs[s], active[s], dest[s], n_dev, block)
        sends.append(blk)
        counts.append(cnt)
    recv: List[List[torch.Tensor]] = []
    recv_act: List[torch.Tensor] = []
    for d, chip in enumerate(chips):
        parts: List[List[torch.Tensor]] = [[] for _ in arrs[0]]
        acts = []
        for s in range(n_dev):
            lo, hi = d * block, (d + 1) * block
            moved = copy_to_device([b[lo:hi] for b in sends[s]]
                                   + [counts[s][d:d + 1]],
                                   active[s].device, chip.device)
            for i, t in enumerate(moved[:-1]):
                parts[i].append(t)
            acts.append(torch.arange(block, device=chip.device)
                        < moved[-1])
        recv.append([torch.cat(p) for p in parts])
        recv_act.append(torch.cat(acts))
    return recv, recv_act


# ---------------------------------------------------------------------------
# Stacking: each chip's slot padded to the common bucket on its chip
# ---------------------------------------------------------------------------

def _pad_rows(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` with ``pad`` zero rows appended."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def _pad_column(c: AnyDeviceColumn, cap: int, char_cap: Optional[int]
                ) -> AnyDeviceColumn:
    if isinstance(c, DeviceStringColumn) and char_cap is not None \
            and c.char_cap < char_cap:
        c = DeviceStringColumn(c.dtype, torch.nn.functional.pad(
            c.chars, (0, char_cap - c.char_cap)), c.lengths, c.validity)
    pad = cap - c.capacity
    if not pad:
        return c
    return with_row_arrays([c], [_pad_rows(a, pad)
                                 for a in row_arrays(c)])[0]


def pad_batch(b: DeviceBatch, cap: int,
              char_caps: Sequence[Optional[int]]) -> DeviceBatch:
    """``b`` padded on its device to capacity ``cap``, its string columns
    to the given character widths."""
    cols = [_pad_column(c, cap, cc) for c, cc in zip(b.columns, char_caps)]
    active = _pad_rows(b.active, cap - b.capacity)
    return DeviceBatch(b.schema, cols, active, b._num_rows,
                       b._num_rows_dev, b.chip)


def stack_batches(slots: Sequence[DeviceBatch], mesh: TorchMesh):
    with TR.span("meshStack", slots=len(slots)):
        return _stack_batches(slots, mesh)


def _stack_batches(slots: Sequence[DeviceBatch], mesh: TorchMesh):
    """Each chip's slot padded to the common capacity bucket (and its
    string columns to the common character width) on its own chip: a
    slot already on its chip is padded in place, any other slot is moved
    there first (``batch_to_device``)."""
    schema = slots[0].schema
    cap = bucket_capacity(max(b.capacity for b in slots))
    char_caps: List[Optional[int]] = []
    for ci in range(len(schema.fields)):
        if isinstance(slots[0].columns[ci], DeviceStringColumn):
            char_caps.append(bucket_char_cap(
                max(b.columns[ci].char_cap for b in slots)))
        else:
            char_caps.append(None)
    padded = []
    for b, chip in zip(slots, mesh.chips):
        if batch_device(b) != chip.id or b.device != chip.device:
            b = batch_to_device(b, chip)
        padded.append(pad_batch(b, cap, char_caps))
    return padded, schema, cap


# ---------------------------------------------------------------------------
# The exchange
# ---------------------------------------------------------------------------

class _Routing:
    """One exchange shape's routing (cached per mesh, key expressions
    and partition count): every chip's partition ids, from one murmur3
    launch per chip, and their destination chips."""

    def __init__(self, n_dev: int, exprs: Tuple[E.Expression, ...],
                 n_parts: int):
        self.n_dev = n_dev
        self.exprs = list(exprs)
        self.n_parts = n_parts

    def __call__(self, padded: Sequence[DeviceBatch]):
        from spark_rapids_tpu_torch.exec.exchange import hash_partition_ids
        pids = [hash_partition_ids(self.exprs, b, self.n_parts)
                for b in padded]
        dest = [torch.remainder(p, self.n_dev) for p in pids]
        return pids, dest


def routing_fn(mesh: TorchMesh, exprs: Sequence[E.Expression],
               n_parts: int, metrics=None) -> _Routing:
    from spark_rapids_tpu_torch.ops import exprs as X
    key = (mesh_key(mesh), tuple(X.expr_key(e) for e in exprs), n_parts)
    fn, was_miss = _EXCHANGE_CACHE.get_or_build(
        key, lambda: _Routing(mesh_size(mesh), tuple(exprs), n_parts))
    if metrics is not None:
        mirror_to_metrics(metrics, was_miss)
    return fn


def dest_counts(padded: Sequence[DeviceBatch], dest, mesh: TorchMesh
                ) -> torch.Tensor:
    """The size exchange's ``[n, n]`` counts on the first chip:
    ``counts[s][d]``, the rows chip ``s`` sends to chip ``d``."""
    n_dev = mesh_size(mesh)
    first = padded[0].device
    per = []
    for b, d in zip(padded, dest):
        key = torch.where(b.active, d.to(torch.int64), n_dev)
        cnt = torch.bincount(key, minlength=n_dev + 1)[:n_dev]
        per.append(copy_to_device([cnt], b.device, first)[0])
    return torch.stack(per)


def mesh_exchange(slots: Sequence[DeviceBatch],
                  bound_exprs: Sequence[E.Expression], n_parts: int,
                  mesh: TorchMesh, metrics=None
                  ) -> List[List[DeviceBatch]]:
    """Run the mesh exchange: one input batch per chip ->
    ``out[pid] -> [DeviceBatch]`` like the in-process exchange, partition
    ``p`` on chip ``p % n``."""
    from spark_rapids_tpu_torch.columnar.device import on_chip
    from spark_rapids_tpu_torch.exec.exchange import split_by_pid
    n_dev = mesh_size(mesh)
    assert len(slots) == n_dev, (len(slots), n_dev)
    padded, schema, cap = stack_batches(slots, mesh)
    route = routing_fn(mesh, bound_exprs, n_parts, metrics)
    pids, dest = route(padded)
    with TR.span("meshSizeExchange"):
        # the one host read of the exchange, before any block moves
        counts = dest_counts(padded, dest, mesh).cpu().tolist()
    total = sum(sum(row) for row in counts)
    if metrics is not None:
        # rows staged for the exchange beyond the active ones (every
        # slot pads to the common bucket)
        metrics.create("meshPadWaste").add(n_dev * cap - total)
    block_cap = min(cap, bucket_capacity(
        max(1, max(max(row) for row in counts))))
    with TR.span("meshExchange", nDev=n_dev, blockCap=block_cap):
        flats, specs = [], None
        for b, p in zip(padded, pids):
            flat, specs = flatten_columns(b.columns)
            flats.append(flat + [p])
        recv, recv_act = all_to_all_rows(
            flats, [b.active for b in padded], dest, mesh.chips, block_cap)
    # land each owner chip's blocks through the shared sort-split (one
    # counts read per chip)
    out: List[List[DeviceBatch]] = [[] for _ in range(n_parts)]
    for d, chip in enumerate(mesh.chips):
        landed = DeviceBatch(schema, rebuild_columns(specs, recv[d][:-1]),
                             recv_act[d], None, chip=chip.id)
        for pid, part in enumerate(split_by_pid(landed, recv[d][-1],
                                                n_parts)):
            if part is not None:
                out[pid].append(on_chip(part, landed))
    return out

