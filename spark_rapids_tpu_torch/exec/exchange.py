"""TorchShuffleExchangeExec and TorchBroadcastExchangeExec: in-process
device exchanges (the counterparts of ``spark_rapids_tpu.exec.exchange``'s
TpuShuffleExchangeExec and TpuBroadcastExchangeExec).

Hash partition ids are Spark's pmod(murmur3(keys, 42), n), hashed by the
murmur3 kernel on the card, so rows land in exactly the partitions CPU
Spark would use. Range partitioning ranks every row globally (an exact,
not sampled, equal-depth split) as the JAX package does. ``split_by_pid``
sorts a batch by partition id and slices each partition out at its own
capacity bucket. The exchange materializes once into a list per
partition; the ICI/mesh, external and adaptive paths are not ported.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch.columnar.device import (
    DeviceBatch, bucket_capacity, concat_device, flatten_columns,
    rebuild_columns, sort_with_payload)
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.exec.base import (DevicePartitionThunk,
                                              TorchExec, device_channel)
from spark_rapids_tpu_torch.ops import exprs as X
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import physical as P


def hash_partition_ids(exprs: List[E.Expression], batch: DeviceBatch,
                       num_partitions: int) -> torch.Tensor:
    """pmod(murmur3(keys, 42), n) per row — Spark HashPartitioning."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    key_cols = [X.dev_eval(e, ctx) for e in exprs]
    return H.partition_ids(key_cols, batch.capacity, num_partitions)


def range_key_columns(bound: List[E.Expression], batch: DeviceBatch):
    """The evaluated order-key columns of one batch."""
    ctx = X.Ctx(batch.columns, batch.capacity, batch.device)
    return [X.dev_eval(e, ctx) for e in bound]


def global_range_pids(order: List[E.SortOrder], keycols_per_batch,
                      actives: List[torch.Tensor], n: int
                      ) -> List[torch.Tensor]:
    """Equal-depth bucketing over the global sort-rank space; returns
    the per-batch partition-id tensors (the CPU engine's range
    assignment, same stable order)."""
    from spark_rapids_tpu_torch.columnar.device import DeviceStringColumn
    from spark_rapids_tpu_torch.ops import sort as S
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
        subkeys = []
        for c, o in zip(kc, order):
            subkeys.extend(S.order_subkeys(c, o.ascending, o.nulls_first))
        keysets.append(subkeys)
    combined = [torch.cat([ks[i] for ks in keysets])
                for i in range(len(keysets[0]))]
    active = torch.cat(actives)
    _k, perm, _p = sort_with_payload([~active] + combined, [])
    ranks = torch.empty_like(perm)
    ranks[perm] = torch.arange(perm.shape[0], device=perm.device)
    total = torch.clamp(active.sum(), min=1)
    pids = torch.clamp((ranks * n) // total, max=n - 1).to(torch.int32)
    return list(torch.split(pids, [a.shape[0] for a in actives]))


def split_by_pid(batch: DeviceBatch, pids: torch.Tensor, n: int
                 ) -> List[Optional[DeviceBatch]]:
    """contiguousSplit: stable-sort rows by partition id (inactive rows
    sink), then slice each partition out at its own capacity bucket.
    One host sync (the counts) per input batch."""
    flat, spec = flatten_columns(batch.columns)
    key = torch.where(batch.active, pids, n).to(torch.int64)
    (sorted_key,), _order, sorted_flat = sort_with_payload([key], flat)
    counts = torch.bincount(sorted_key, minlength=n + 1)[:n].cpu().tolist()
    out: List[Optional[DeviceBatch]] = []
    off = 0
    for pid in range(n):
        cnt = int(counts[pid])
        if cnt == 0:
            out.append(None)
            continue
        cap = bucket_capacity(cnt)
        arrs = []
        for a in sorted_flat:
            part = a[off:off + cnt]
            if cap > cnt:
                part = torch.cat([part, torch.zeros(
                    (cap - cnt,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=a.device)])
            arrs.append(part)
        active = torch.arange(cap, device=batch.device) < cnt
        out.append(DeviceBatch(batch.schema, rebuild_columns(spec, arrs),
                               active, cnt))
        off += cnt
    return out


class TorchShuffleExchangeExec(TorchExec):
    def __init__(self, partitioning: P.Partitioning, child: TorchExec,
                 conf: TorchConf, device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self.partitioning = partitioning
        self._cache: Optional[List[List[DeviceBatch]]] = None

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def _materialize(self) -> List[List[DeviceBatch]]:
        if self._cache is not None:
            return self._cache
        p = self.partitioning
        n = p.num_partitions
        out: List[List[DeviceBatch]] = [[] for _ in range(n)]
        if isinstance(p, P.SinglePartitioning) or n == 1:
            for thunk in device_channel(self.child):
                out[0].extend(b for b in thunk() if b.row_count())
        elif isinstance(p, P.HashPartitioning):
            bound = P.bind_list(p.exprs, self.child.output)
            for thunk in device_channel(self.child):
                for b in thunk():
                    self.metrics.create("kernelDispatchCount.murmur3").add(1)
                    parts = split_by_pid(b, hash_partition_ids(bound, b, n),
                                         n)
                    for pid, part in enumerate(parts):
                        if part is not None:
                            out[pid].append(part)
        elif isinstance(p, P.RangePartitioning):
            self._materialize_range(p, n, out)
        else:
            raise NotImplementedError(
                f"{type(p).__name__} is not ported yet to "
                "spark_rapids_tpu_torch")
        self._cache = out
        return out

    def _materialize_range(self, p: P.RangePartitioning, n: int,
                           out: List[List[DeviceBatch]]) -> None:
        bound = P.bind_list([o.child for o in p.order], self.child.output)
        batches, keycols = [], []
        for thunk in device_channel(self.child):
            for b in thunk():
                if b.row_count() == 0:
                    continue
                keycols.append(range_key_columns(bound, b))
                batches.append(b)
        if not batches:
            return
        pids = global_range_pids(p.order, keycols,
                                 [b.active for b in batches], n)
        for b, pid_t in zip(batches, pids):
            for pid, part in enumerate(split_by_pid(b, pid_t, n)):
                if part is not None:
                    out[pid].append(part)

    def device_partitions(self) -> List[DevicePartitionThunk]:
        def make(pid: int) -> DevicePartitionThunk:
            def run() -> Iterator[DeviceBatch]:
                yield from self._materialize()[pid]
            return run
        return [make(i) for i in range(self.partitioning.num_partitions)]

    def simple_string(self):
        return f"TorchExchange {self.partitioning!r}"


class TorchBroadcastExchangeExec(TorchExec):
    """Device-resident broadcast: the build side concatenates on the card
    once (``concat_device`` compacts several batches to the bucket of
    their row count) and every consumer shares that one batch."""

    def __init__(self, child: TorchExec, conf: TorchConf,
                 device: torch.device):
        super().__init__(conf, device)
        self.children = [child]
        self._built: Optional[DeviceBatch] = None

    @property
    def child(self) -> TorchExec:
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def materialize_device(self) -> DeviceBatch:
        if self._built is None:
            batches = [b for t in device_channel(self.child)
                       for b in t() if b._num_rows != 0]
            self._built = (concat_device(batches) if batches else
                           DeviceBatch.empty(self.child.schema,
                                             self.device))
        return self._built

    def device_partitions(self) -> List[DevicePartitionThunk]:
        return [lambda: iter([self.materialize_device()])]

    def simple_string(self):
        return "TorchBroadcastExchange"
