"""The fused multi-chip aggregate step (the counterpart of
``spark_rapids_tpu.parallel.step``): scan-local partial aggregation,
the all-to-all routed by murmur3, and the final merge, the canonical
distributed SQL pipeline (GpuHashAggregateExec partial ->
GpuShuffleExchangeExec -> GpuHashAggregateExec final) in one call over
the mesh, with no host read between its three parts.

The JAX package jits it as one ``shard_map`` program; here each chip's
part runs as eager torch on that chip, and the blocks move between chips
through ``ici.all_to_all_rows``. ``dryrun_multichip`` holds it against a
host reduction, as the JAX package's ``dryrun_multichip`` does.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.device import DeviceColumn
from spark_rapids_tpu_torch.jit_cache import JitCache
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.parallel.ici import all_to_all_rows
from spark_rapids_tpu_torch.parallel.mesh import (TorchMesh, build_mesh,
                                                  mesh_key)
from spark_rapids_tpu_torch.sql import types as T

_STEP_CACHE = JitCache("meshStep")

_L = T.LongT


def _partial(keys: torch.Tensor, vals: torch.Tensor, active: torch.Tensor,
             n_dev: int):
    """One chip's partial aggregate and the destination chip of each of
    its groups (pmod(murmur3(key, 42), n), the murmur3 kernel on the
    card)."""
    cap = int(active.shape[0])
    kc = DeviceColumn(_L, keys, active)
    seg = G.build_segments([kc], active, payload=(keys, vals, active))
    keys_s, vals_s, act_s = seg.payload
    vc_s = DeviceColumn(_L, vals_s, act_s)
    psum, pcnt = G.seg_sums_batched(seg, [(vc_s, "sum", _L),
                                          (vc_s, "count", _L)])
    # results live at segment-END rows (scatter-free layout)
    pact = seg.out_active
    pkeys = torch.where(pact, keys_s, 0)
    dest = H.partition_ids([DeviceColumn(_L, pkeys, pact)], cap, n_dev)
    return [pkeys, psum.data, psum.validity, pcnt.data], pact, dest


def _final(rkeys, rsum, rsum_valid, rcnt, ract):
    """One chip's merge of the partial rows it received."""
    fseg = G.build_segments(
        [DeviceColumn(_L, rkeys, ract)], ract,
        payload=(rkeys, rsum, rsum_valid & ract, rcnt, ract))
    rkeys_s, rsum_s, rsumv_s, rcnt_s, ract_s = fseg.payload
    fsum, fcnt = G.seg_sums_batched(fseg, [
        (DeviceColumn(_L, rsum_s, rsumv_s), "sum", _L),
        (DeviceColumn(_L, rcnt_s, ract_s), "sum_nonnull", _L)])
    fact = fseg.out_active
    return torch.where(fact, rkeys_s, 0), fsum.data, fcnt.data, fact


def sum_count_step(mesh: TorchMesh) -> Callable:
    """``groupBy(key).agg(sum(val), count(val))`` over the mesh.

    The step takes per-chip lists ``keys`` int64[cap], ``vals``
    int64[cap] and ``active`` bool[cap] (entry ``i`` on chip ``i``'s
    device) and returns, per chip, ``(keys, sums, counts, active)`` for
    the key groups that chip owns (pmod(murmur3(key), n))."""
    n_dev = len(mesh.chips)
    chips = mesh.chips

    def build():
        def step(keys: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
                 active: Sequence[torch.Tensor]
                 ) -> List[Tuple[torch.Tensor, ...]]:
            parts = [_partial(k, v, a, n_dev)
                     for k, v, a in zip(keys, vals, active)]
            recv, recv_act = all_to_all_rows(
                [p[0] for p in parts], [p[1] for p in parts],
                [p[2] for p in parts], chips)
            return [_final(*recv[d], recv_act[d]) for d in range(n_dev)]
        return step

    fn, _ = _STEP_CACHE.get_or_build(
        (mesh_key(mesh), "sum_count", G.kernel_salt()), build)
    return fn


def dryrun_multichip(n_devices: int, cap: int = 64, seed: int = 7) -> dict:
    """Run ``sum_count_step`` over the first ``n_devices`` visible chips
    on seeded keys and values, and hold its result against a host
    reduction: every key owned by exactly one chip, every sum and count
    exact. Returns ``{key: (sum, count)}``; raises AssertionError on any
    difference."""
    mesh = build_mesh(n_devices)
    step = sum_count_step(mesh)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 13, (n_devices, cap)).astype(np.int64)
    vals = rng.integers(-5, 20, (n_devices, cap)).astype(np.int64)
    active = rng.random((n_devices, cap)) < 0.8
    out = step([torch.from_numpy(keys[d]).to(c.device)
                for d, c in enumerate(mesh.chips)],
               [torch.from_numpy(vals[d]).to(c.device)
                for d, c in enumerate(mesh.chips)],
               [torch.from_numpy(active[d]).to(c.device)
                for d, c in enumerate(mesh.chips)])
    expect: dict = {}
    for d in range(n_devices):
        for i in range(cap):
            if active[d, i]:
                s, c = expect.get(int(keys[d, i]), (0, 0))
                expect[int(keys[d, i])] = (s + int(vals[d, i]), c + 1)
    got: dict = {}
    for ka, sa, ca, aa in out:
        ka, sa, ca, aa = (t.cpu().numpy() for t in (ka, sa, ca, aa))
        for i in np.nonzero(aa)[0]:
            assert int(ka[i]) not in got, "key owned by two chips"
            got[int(ka[i])] = (int(sa[i]), int(ca[i]))
    assert got == expect, (got, expect)
    return got
