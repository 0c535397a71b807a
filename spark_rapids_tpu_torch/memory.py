"""Device spill store and the planned out-of-core budget oracle (the
counterpart of ``spark_rapids_tpu.memory``; the reference's
RapidsBufferCatalog, SpillableColumnarBatch and DeviceMemoryEventHandler).

Operators that hold batches across yields (the exchange's materialized
partitions, the aggregates' staged buffers, a sort's inputs, a join's
stream side) register them as ``SpillableBatch`` handles. When the
registered device bytes exceed the store's budget
(``spark.rapids.memory.tpu.poolSize``), the least recently used handles
are demoted device -> host (a ``HostBatch``) -> disk (``columnar/serde``
files under ``spark.rapids.memory.spillDirectory``, past
``spark.rapids.memory.host.spillStorageSize``), and re-promoted when
read. Registering reads only shapes (``DeviceBatch.sizeof``): nothing
synchronises on the normal path.

A spill is ``DeviceBatch.to_host``: its copies run on the current
stream, after everything already queued there, which includes the wait
on the upload ring's copy event for a batch made on the copy stream. The
store then drops its reference, so the caching allocator can reuse the
memory once no other reference holds it.

Lifecycle: handles release by ``close()``; a dropped handle releases
through a weakref finalizer; ``release_plan_handles`` closes every
handle of a finished plan; every store closes at interpreter exit and
removes its disk files.

A spill round trip compacts the batch (``to_host`` gathers the active
rows, ``from_host`` rebuilds them as a prefix at the bucket of their
count): the active rows keep their order, per-slot layouts do not.
Callers that pair a batch with per-slot tensors check ``ever_spilled``
and the capacity and remap (the range exchange, the out-of-core sort).

The store bounds what operators hold between programs; it does not see
the allocations inside a program or a captured stage graph's private
pool (the retry protocol's recovery releases those graphs).

Serving (``serve/``): every handle bills a tenant's ledger (live, peak
and spilled device bytes per tenant: ``stamp_plan_tenant`` tags the
executing plan's registries, ``tenant_scope`` is the fallback for a
registration without one), and a tenant over its fair share
(``serve.fairShareFactor`` x budget / live tenants) spills first. A
cache entry (``register(..., cache_entry=True)``: a subplan cache's
broadcast table) is reconstructible, so under pressure it is dropped
outright, before any live query's batch spills. Not ported: trace
spans and telemetry samples (ROADMAP A11b).
"""

from __future__ import annotations

import atexit
import contextlib
import glob
import logging
import os
import threading
import uuid
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import torch

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import (DEVICE_BUDGET_BYTES,
                                         DEVICE_MEMORY_LIMIT,
                                         HOST_SPILL_STORAGE_SIZE,
                                         MEMORY_DEBUG,
                                         OUT_OF_CORE_BUDGET_SHARE,
                                         OUT_OF_CORE_ENABLED,
                                         OUT_OF_CORE_MAX_PARTITIONS,
                                         OUT_OF_CORE_MAX_RECURSION,
                                         SHUFFLE_COMPRESSION_CODEC,
                                         SPILL_DIR, TorchConf)

_log = logging.getLogger("spark_rapids_tpu_torch.memory")

_DEFAULT_BUDGET = 8 << 30  # without a CUDA card

TIER_DEVICE = "device"
TIER_HOST = "host"
TIER_DISK = "disk"

UNATTRIBUTED = "(unattributed)"

# ---------------------------------------------------------------------------
# Tenant attribution: the server runs each query under a tenant, and every
# handle registered during that query bills the tenant's ledger. The
# attribution rides on the registering exec's metric registry
# (``stamp_plan_tenant`` tags every registry of the executing plan before
# the collect), because the registry travels with the exec into whatever
# thread registers (the upload ring's producer, a task thread); a
# thread-local scope is the fallback for registrations without one.
# ---------------------------------------------------------------------------

_TENANT_TLS = threading.local()


def current_tenant() -> Optional[str]:
    """The calling thread's fallback tenant (None = untenanted)."""
    return getattr(_TENANT_TLS, "name", None)


@contextlib.contextmanager
def tenant_scope(name: Optional[str]):
    """Thread-local fallback tenant for registrations that carry no
    metric registry (no-op for None)."""
    if name is None:
        yield
        return
    prev = getattr(_TENANT_TLS, "name", None)
    _TENANT_TLS.name = name
    try:
        yield
    finally:
        _TENANT_TLS.name = prev


def stamp_plan_tenant(physical, tenant: Optional[str]) -> None:
    """Tag every metric registry of ``physical`` (fused constituents
    included) with its tenant, so registrations from any thread bill the
    right ledger."""
    if tenant is None:
        return

    def walk(p) -> None:
        m = getattr(p, "metrics", None)
        if m is not None:
            m._tenant = tenant
        for op in getattr(p, "fused_ops", []) or []:
            fm = getattr(op, "metrics", None)
            if fm is not None:
                fm._tenant = tenant
        for c in getattr(p, "children", []):
            walk(c)

    walk(physical)


class _State:
    """Per-handle storage owned by the store (it outlives the handle, so
    the finalizer can release whatever tier the data is in)."""

    __slots__ = ("tier", "batch", "host", "disk_path", "device_bytes",
                 "host_bytes", "closed", "rows", "ever_spilled", "owner",
                 "metrics_ref", "device", "tenant", "cache_entry")

    def __init__(self, batch: DeviceBatch, owner: str, metrics,
                 cache_entry: bool = False):
        self.tier = TIER_DEVICE
        self.batch: Optional[DeviceBatch] = batch
        self.host: Optional[HostBatch] = None
        self.disk_path: Optional[str] = None
        self.device = batch.device
        self.device_bytes = batch.sizeof()
        self.host_bytes = 0
        self.closed = False
        # the count where the producer knows it; resolved on first use
        self.rows: Optional[int] = batch._num_rows
        self.ever_spilled = False
        self.owner = owner
        # held weakly: accounting never pins a released plan's metrics
        self.metrics_ref = (weakref.ref(metrics)
                            if metrics is not None else None)
        # the registry's stamp follows the work across threads; the
        # thread-local scope is the fallback
        self.tenant: Optional[str] = (
            getattr(metrics, "_tenant", None) if metrics is not None
            else None) or current_tenant()
        # a cache entry drops (never spills) under pressure, first
        self.cache_entry = cache_entry


class SpillableBatch:
    """Handle over a batch the store may demote (SpillableColumnarBatch)."""

    def __init__(self, store: "DeviceStore", state: _State, handle_id: int):
        self._store = store
        self._state = state
        self._id = handle_id
        weakref.finalize(self, store._release_id, handle_id)

    def get(self) -> DeviceBatch:
        """The device batch, re-promoted through the tiers if spilled."""
        return self._store._access(self._id)

    @property
    def rows(self) -> int:
        """Row count: cached when known, else read (one synchronise on
        the device tier, free from the host tier)."""
        st = self._state
        if st.rows is None:
            if st.tier == TIER_DEVICE:
                st.rows = st.batch.row_count()
            elif st.tier == TIER_HOST:
                st.rows = st.host.num_rows
            else:
                st.rows = self._store._access(self._id).row_count()
        return st.rows

    @property
    def capacity_hint(self) -> Optional[int]:
        """The device capacity without promoting a spilled batch; None
        when the data is off the device (callers treat that
        conservatively)."""
        st = self._state
        if st.tier == TIER_DEVICE and st.batch is not None:
            return st.batch.capacity
        return None

    @property
    def ever_spilled(self) -> bool:
        """True once the batch was demoted: its capacity and slot layout
        may differ from the registered batch's."""
        return self._state.ever_spilled

    @property
    def tier(self) -> str:
        return self._state.tier

    def sizeof(self) -> int:
        return self._state.device_bytes

    @property
    def closed(self) -> bool:
        return self._state.closed

    def close(self) -> None:
        self._store._release_id(self._id)

    def __repr__(self) -> str:
        return f"SpillableBatch(id={self._id}, tier={self._state.tier})"


class DeviceStore:
    """The catalog: tracks handles, keeps registered device bytes under
    the budget by LRU spill, and host bytes under the host budget by
    writing to disk."""

    def __init__(self, device_budget: int, host_budget: int,
                 spill_dir: str, debug: bool = False, codec: str = "none"):
        self.device_budget = device_budget
        self.host_budget = host_budget
        self.spill_dir = spill_dir
        self.debug = debug
        self.codec = codec
        self._lock = threading.RLock()
        self._states: "OrderedDict[int, _State]" = OrderedDict()
        self._next_id = 0
        self.device_bytes = 0
        self.host_bytes = 0
        self.spill_count = 0
        self.spilled_device_bytes = 0
        self.disk_spill_count = 0
        self.peak_device_bytes = 0
        # per registering operator: live and peak device bytes;
        # sum(owner_live.values()) == device_bytes at all times
        self.owner_live: Dict[str, int] = {}
        self.owner_peak: Dict[str, int] = {}
        # per serving tenant: live, peak and spilled device bytes;
        # sum(tenant_live) == the device bytes registered under a tenant
        self.tenant_live: Dict[str, int] = {}
        self.tenant_peak: Dict[str, int] = {}
        self.tenant_spill: Dict[str, int] = {}
        # a tenant over fair_share_factor x (budget / live tenants)
        # spills first (spark.rapids.sql.serve.fairShareFactor, set in
        # place by get_device_store)
        self.fair_share_factor = 1.5
        # cache entries dropped under pressure (released, not spilled)
        self.cache_drop_count = 0
        self.cache_dropped_bytes = 0
        # every disk file carries this store's prefix, so close() sweeps
        # stragglers without touching another store's files
        self._file_prefix = f"spill-{uuid.uuid4().hex[:8]}"
        self.disk_files_live = 0
        self._closed = False

    def _owner_delta(self, st: _State, delta: int) -> None:
        """Move ``delta`` device bytes on the owner's ledger and on the
        registering exec's ``peakDeviceMemory`` (under the lock)."""
        live = self.owner_live.get(st.owner, 0) + delta
        self.owner_live[st.owner] = live
        if delta > 0 and live > self.owner_peak.get(st.owner, 0):
            self.owner_peak[st.owner] = live
        if st.tenant is not None:
            tlive = self.tenant_live.get(st.tenant, 0) + delta
            self.tenant_live[st.tenant] = tlive
            if delta > 0 and tlive > self.tenant_peak.get(st.tenant, 0):
                self.tenant_peak[st.tenant] = tlive
        m = st.metrics_ref() if st.metrics_ref is not None else None
        if m is not None:
            inst = getattr(m, "_store_live_bytes", 0) + delta
            m._store_live_bytes = inst
            if delta > 0:
                m.create(M.PEAK_DEVICE_MEMORY).set_max(inst)

    def register(self, batch: DeviceBatch, owner: str = UNATTRIBUTED,
                 metrics=None, cache_entry: bool = False) -> SpillableBatch:
        """Track ``batch`` as spillable; ``owner`` and ``metrics`` name the
        registering operator (``TorchExec.register_spillable``).
        ``cache_entry`` marks reconstructible cache data, dropped first
        under pressure instead of spilled."""
        with self._lock:
            st = _State(batch, owner, metrics, cache_entry)
            hid = self._next_id
            self._next_id += 1
            self._states[hid] = st
            self.device_bytes += st.device_bytes
            self.peak_device_bytes = max(self.peak_device_bytes,
                                         self.device_bytes)
            self._owner_delta(st, st.device_bytes)
            if self.debug:
                _log.info("register %d bytes (pool %d/%d)",
                          st.device_bytes, self.device_bytes,
                          self.device_budget)
            self._enforce(exclude=hid)
            return SpillableBatch(self, st, hid)

    def _access(self, hid: int) -> DeviceBatch:
        with self._lock:
            st = self._states.get(hid)
            if st is None or st.closed:
                raise RuntimeError("SpillableBatch used after close")
            if st.tier == TIER_DISK:
                from spark_rapids_tpu_torch.columnar import serde
                with open(st.disk_path, "rb") as f:
                    st.host = serde.deserialize_batch(f.read())
                os.unlink(st.disk_path)
                self.disk_files_live -= 1
                st.disk_path = None
                st.tier = TIER_HOST
                st.host_bytes = _host_sizeof(st.host)
                self.host_bytes += st.host_bytes
            if st.tier == TIER_HOST:
                if self.debug:
                    _log.info("promote host->device: %d bytes",
                              st.host_bytes)
                st.batch = DeviceBatch.from_host(st.host, st.device)
                self.host_bytes -= st.host_bytes
                st.host, st.host_bytes = None, 0
                st.tier = TIER_DEVICE
                st.device_bytes = st.batch.sizeof()
                self.device_bytes += st.device_bytes
                self.peak_device_bytes = max(self.peak_device_bytes,
                                             self.device_bytes)
                self._owner_delta(st, st.device_bytes)
            self._states.move_to_end(hid)
            self._enforce(exclude=hid)
            return st.batch

    def _over_share_tenants(self) -> Dict[str, int]:
        """Tenants whose live device bytes exceed ``fair_share_factor``
        times the equal share of the budget, most over first (under the
        lock). A lone tenant is never over share."""
        live = {t: v for t, v in self.tenant_live.items() if v > 0}
        if len(live) < 2:
            return {}
        limit = self.fair_share_factor * (self.device_budget / len(live))
        over = {t: v for t, v in live.items() if v > limit}
        return dict(sorted(over.items(), key=lambda kv: -kv[1]))

    def _device_spill_order(self, exclude: int) -> list:
        """Handle ids in the order the pool demotes them: cache entries
        first, then over-share tenants' handles (most over first), then
        least recently used."""
        over = self._over_share_tenants()
        rank = {t: i for i, t in enumerate(over)}
        return sorted(
            (h for h in self._states if h != exclude),
            key=lambda h: (0 if self._states[h].cache_entry else 1,
                           rank.get(self._states[h].tenant, len(rank))))

    def _evict_one(self, hid: int, st: _State) -> None:
        """Free one device-tier handle: a cache entry drops, anything
        else spills to the host."""
        if st.cache_entry:
            self._drop_cache_entry(hid, st)
        else:
            self._spill_to_host(st)

    def _drop_cache_entry(self, hid: int, st: _State) -> None:
        """Release a cache entry outright: its data is reconstructible,
        so spilling it would spend copies on bytes nobody is owed. The
        owning cache sees the closed handle at its next lookup."""
        dropped = st.device_bytes
        self._release_id(hid)
        self.cache_drop_count += 1
        self.cache_dropped_bytes += dropped

    def _enforce(self, exclude: int) -> None:
        if self.device_bytes > self.device_budget:
            for hid in self._device_spill_order(exclude):
                if self.device_bytes <= self.device_budget:
                    break
                st = self._states[hid]
                if st.tier == TIER_DEVICE:
                    self._evict_one(hid, st)
        if self.host_bytes > self.host_budget:
            for hid in list(self._states):
                if self.host_bytes <= self.host_budget:
                    break
                st = self._states[hid]
                if st.tier == TIER_HOST:
                    self._spill_to_disk(st)

    def _spill_to_host(self, st: _State) -> None:
        if self.debug:
            _log.info("spill device->host: %d bytes (pool %d/%d)",
                      st.device_bytes, self.device_bytes,
                      self.device_budget)
        st.host = st.batch.to_host()
        st.rows = st.host.num_rows
        st.batch = None
        self.device_bytes -= st.device_bytes
        st.host_bytes = _host_sizeof(st.host)
        self.host_bytes += st.host_bytes
        st.tier = TIER_HOST
        st.ever_spilled = True
        self.spill_count += 1
        self.spilled_device_bytes += st.device_bytes
        if st.tenant is not None:
            self.tenant_spill[st.tenant] = (
                self.tenant_spill.get(st.tenant, 0) + st.device_bytes)
        self._owner_delta(st, -st.device_bytes)
        # billed to the owning operator, not the one that tripped the
        # budget
        m = st.metrics_ref() if st.metrics_ref is not None else None
        if m is not None:
            m.create(M.SPILL_BYTES).add(st.device_bytes)

    def _spill_to_disk(self, st: _State) -> None:
        if self.debug:
            _log.info("spill host->disk: %d bytes (host %d/%d)",
                      st.host_bytes, self.host_bytes, self.host_budget)
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(
            self.spill_dir,
            f"{self._file_prefix}-{uuid.uuid4().hex[:16]}.bin")
        from spark_rapids_tpu_torch.columnar import serde
        with open(path, "wb") as f:
            f.write(serde.serialize_batch(st.host, self.codec))
        self.host_bytes -= st.host_bytes
        st.host, st.host_bytes = None, 0
        st.disk_path = path
        st.tier = TIER_DISK
        self.disk_spill_count += 1
        self.disk_files_live += 1

    def _release_id(self, hid: int) -> None:
        with self._lock:
            st = self._states.pop(hid, None)
            if st is None or st.closed:
                return
            st.closed = True
            if st.tier == TIER_DEVICE:
                self.device_bytes -= st.device_bytes
                self._owner_delta(st, -st.device_bytes)
            elif st.tier == TIER_HOST:
                self.host_bytes -= st.host_bytes
            elif st.disk_path:
                try:
                    os.unlink(st.disk_path)
                    self.disk_files_live -= 1
                except OSError:
                    pass
                st.disk_path = None
            st.batch = None
            st.host = None

    def release_for_registries(self, reg_ids) -> int:
        """Close every live handle registered under one of the given
        metric registries (by ``id``); returns how many."""
        with self._lock:
            victims = []
            for hid, st in self._states.items():
                if st.metrics_ref is None:
                    continue
                m = st.metrics_ref()
                if m is not None and id(m) in reg_ids:
                    victims.append(hid)
            for hid in victims:
                self._release_id(hid)
        return len(victims)

    def spill_device_down(self, target_bytes: int = 0) -> int:
        """Demote device-tier handles, least recently used first, until
        at most ``target_bytes`` stay on the device (the retry protocol's
        recovery step). Returns the device bytes freed."""
        freed = 0
        with self._lock:
            for hid in self._device_spill_order(exclude=-1):
                if self.device_bytes <= target_bytes:
                    break
                st = self._states.get(hid)
                if st is not None and st.tier == TIER_DEVICE \
                        and not st.closed:
                    freed += st.device_bytes
                    self._evict_one(hid, st)
        return freed

    def close(self) -> None:
        """Release every handle and remove this store's disk files."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for hid in list(self._states):
                self._release_id(hid)
            for path in glob.glob(os.path.join(
                    self.spill_dir, f"{self._file_prefix}-*.bin")):
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self.disk_files_live = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"deviceBytes": self.device_bytes,
                    "peakDeviceBytes": self.peak_device_bytes,
                    "hostBytes": self.host_bytes,
                    "spillCount": self.spill_count,
                    "spilledDeviceBytes": self.spilled_device_bytes,
                    "diskSpillCount": self.disk_spill_count,
                    "diskFilesLive": self.disk_files_live,
                    "liveHandles": len(self._states),
                    "cacheDropCount": self.cache_drop_count,
                    "cacheDroppedBytes": self.cache_dropped_bytes}

    def owner_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-operator ledger: live and peak device bytes."""
        with self._lock:
            owners = set(self.owner_live) | set(self.owner_peak)
            return {o: {"liveBytes": self.owner_live.get(o, 0),
                        "peakBytes": self.owner_peak.get(o, 0)}
                    for o in sorted(owners)}

    def over_share_tenants(self) -> Dict[str, int]:
        """The fair-share offenders, most over first (the admission
        controller's throttle signal)."""
        with self._lock:
            return self._over_share_tenants()

    def tenant_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant ledger: live, peak and spilled device bytes."""
        with self._lock:
            tenants = (set(self.tenant_live) | set(self.tenant_peak)
                       | set(self.tenant_spill))
            return {t: {"liveBytes": self.tenant_live.get(t, 0),
                        "peakBytes": self.tenant_peak.get(t, 0),
                        "spillBytes": self.tenant_spill.get(t, 0)}
                    for t in sorted(tenants)}

    def live_handles(self, owner: Optional[str] = None) -> int:
        """Open handles, of one owner when given (the serve checks: no
        query's handle outlives it; cache entries are their own
        owner)."""
        with self._lock:
            return sum(1 for st in self._states.values()
                       if owner is None or st.owner == owner)


def _host_sizeof(b: HostBatch) -> int:
    total = 0
    for c in b.columns:
        if c.data.dtype == object:
            total += sum(len(str(v)) for v in c.data) + len(c.data)
        else:
            total += c.data.nbytes
        total += c.validity.nbytes
    return total


_CARD_BYTES: Dict[int, int] = {}


def _default_budget() -> int:
    """80% of the card's memory (read once per card); a fixed 8 GiB
    without a card."""
    if not torch.cuda.is_available():
        return _DEFAULT_BUDGET
    dev = torch.cuda.current_device()
    total = _CARD_BYTES.get(dev)
    if total is None:
        total = _CARD_BYTES[dev] = torch.cuda.mem_get_info(dev)[1]
    return int(total * 0.8)


_STORE: Optional[DeviceStore] = None
_STORE_KEY: Optional[tuple] = None
_STORE_LOCK = threading.Lock()
# every store the process built (a rebuilt store may still back live
# handles): all close at exit, so no disk file survives the interpreter
_ALL_STORES: list = []


def close_all_stores() -> None:
    for s in _ALL_STORES:
        s.close()


atexit.register(close_all_stores)


def get_device_store(conf: TorchConf) -> DeviceStore:
    """The process's store (one pool per executor, as GpuDeviceManager
    keeps one); rebuilt when the budgets, directory or codec change."""
    global _STORE, _STORE_KEY
    budget = int(conf.get(DEVICE_MEMORY_LIMIT)) or _default_budget()
    host_budget = int(conf.get(HOST_SPILL_STORAGE_SIZE))
    spill_dir = str(conf.get(SPILL_DIR))
    codec = str(conf.get(SHUFFLE_COMPRESSION_CODEC)).lower()
    from spark_rapids_tpu_torch.columnar import serde
    if codec not in serde._CODECS:
        raise ValueError(
            f"spark.rapids.shuffle.compression.codec={codec!r}: "
            f"supported codecs are {sorted(serde._CODECS)}")
    key = (budget, host_budget, spill_dir, codec)
    with _STORE_LOCK:
        if _STORE is None or _STORE_KEY != key:
            _STORE = DeviceStore(budget, host_budget, spill_dir,
                                 codec=codec)
            _STORE_KEY = key
            _ALL_STORES.append(_STORE)
        # policy, set in place: a flip never replaces the live store
        _STORE.debug = bool(conf.get(MEMORY_DEBUG))
        from spark_rapids_tpu_torch.conf import SERVE_FAIR_SHARE_FACTOR
        _STORE.fair_share_factor = float(conf.get(SERVE_FAIR_SHARE_FACTOR))
        return _STORE


def plan_registries(physical) -> set:
    """The ids of every metric registry of a physical plan, fused
    stages' constituents included."""
    regs = set()

    def walk(p) -> None:
        m = getattr(p, "metrics", None)
        if m is not None:
            regs.add(id(m))
        for op in getattr(p, "fused_ops", []) or []:
            fm = getattr(op, "metrics", None)
            if fm is not None:
                regs.add(id(fm))
        for c in getattr(p, "children", []):
            walk(c)
    walk(physical)
    return regs


def store_tenant_stats() -> Dict[str, Dict[str, int]]:
    """The process store's per-tenant ledger ({} without a store)."""
    return _STORE.tenant_stats() if _STORE is not None else {}


def release_plan_handles(physical) -> int:
    """Close every store handle the plan's operators registered, so none
    outlives its query; returns how many."""
    store = _STORE
    if store is None or physical is None:
        return 0
    return store.release_for_registries(plan_registries(physical))


# ---------------------------------------------------------------------------
# Planned out-of-core budget oracle. Operators ask it before they
# materialize a working set: a join build side or an aggregation estimated
# over its share partitions up front (a power-of-two partition count),
# instead of finding the overflow inside the OOM-retry protocol, which
# stays the backstop for estimates that are wrong.
# ---------------------------------------------------------------------------

class BudgetOracle:
    """One materialization decision's view of the out-of-core confs and
    the store's live bytes."""

    def __init__(self, conf: TorchConf):
        self.conf = conf
        self.enabled = bool(conf.get(OUT_OF_CORE_ENABLED))
        self.budget = int(conf.get(DEVICE_BUDGET_BYTES)) or _default_budget()
        self.share_fraction = float(conf.get(OUT_OF_CORE_BUDGET_SHARE))
        self.max_partitions = max(2,
                                  int(conf.get(OUT_OF_CORE_MAX_PARTITIONS)))
        self.max_recursion = max(0,
                                 int(conf.get(OUT_OF_CORE_MAX_RECURSION)))

    def headroom(self) -> int:
        """Budget bytes left over the store's live device bytes; a firing
        ``site:budget`` schedule halves the report."""
        live = _STORE.device_bytes if _STORE is not None else 0
        room = max(0, self.budget - live)
        from spark_rapids_tpu_torch import retry as R
        inj = R.get_fault_injector(self.conf)
        if inj is not None and inj.on_budget_query():
            room //= 2
        return room

    def operator_share(self) -> int:
        """Working-set bytes one operator may plan to hold at once."""
        return max(1, int(self.headroom() * self.share_fraction))

    def plan_partitions(self, estimate_bytes: int, metrics=None,
                        share: Optional[int] = None) -> int:
        """1 when the estimate fits the operator's share, else
        estimate / share rounded up to a power of two and clamped to
        ``outOfCore.maxPartitions``. Records ``budgetPressurePeak``, the
        largest estimate (``plannedWorkingSetBytes``, a port addition)
        and, when it partitions, ``plannedPartitions`` on ``metrics``."""
        if share is None:
            share = self.operator_share()
        n = 1
        if self.enabled and estimate_bytes > share:
            n = 2
            while n * share < estimate_bytes and n < self.max_partitions:
                n <<= 1
        if metrics is not None:
            metrics.create(M.BUDGET_PRESSURE_PEAK).set_max(
                int(estimate_bytes * 100 // max(1, share)))
            metrics.create(M.PLANNED_WORKING_SET).set_max(estimate_bytes)
            if n > 1:
                metrics.create(M.PLANNED_PARTITIONS).add(n)
        return n


def get_budget_oracle(conf: TorchConf) -> BudgetOracle:
    """A fresh oracle view for one materialization decision."""
    return BudgetOracle(conf)
