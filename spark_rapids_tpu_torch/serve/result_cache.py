"""Serve-tier result + subplan caching (the counterpart of
``spark_rapids_tpu.serve.result_cache``; docs/caching.md).

Dashboard traffic is thousands of tenants refreshing near-identical
queries over slowly-changing data. The plan cache (planCache.enabled)
skips the rewrite and batch fusion vectorizes concurrent same-shape
MISSES; this module completes the pair by serving the HITS from
memory:

- :class:`ResultCache`: the final Arrow IPC payload of a finished
  query, keyed by ``(plan-signature digest, literal bindings,
  input-file fingerprint set)``. The server consults it BEFORE
  admission — a hit costs zero device work, zero queue wait, zero
  admission slot — and serves the stored bytes verbatim, so a hit is
  bit-identical to the execution that populated it by construction.

- :class:`SubplanCache`: device-resident broadcast join build tables,
  keyed by the build subtree's structural signature, shared across
  queries and tenants (the reference reuses GpuBroadcastExchangeExec
  results within one plan; this lifts the reuse across query
  boundaries). Entries live in the :class:`~spark_rapids_tpu_torch.
  memory.DeviceStore` as ``cache_entry`` registrations: pool pressure DROPS
  them before any live query's batches spill.

Honesty model (the load-bearing part): every entry records the
``(path, size, mtime_ns)`` fingerprint of every input file its data
was derived from, plus the scan's input ``paths``. Validation re-LISTS
the paths (so files added to or removed from a scanned directory are
caught, not just mutations of known files) and compares the fresh
fingerprint set for exact equality; ANY difference — append, rewrite,
mtime-only touch, delete, new file — drops the entry and falls through
to normal execution. Fingerprints are captured BEFORE the execution
that populates an entry, so a file mutated mid-execution yields an
entry whose stored fingerprint no longer matches and is never served.

Result-cache probe soundness: the cache is probed by normalized SQL
text + literal vector (``adaptive.fusion_key``) because the plan
signature is unknowable without planning — and the point of a hit is
to skip planning. Within one server this probe cannot alias two
distinct plans: every tenant session derives from the server's single
base conf plus signature-excluded serve.* keys, so equal normalized
text implies an equal plan signature — and the signature recorded at
population is cross-checked on overwrite, while any
``register_view`` bump invalidates the whole cache (a re-registered
view may point the same SQL text at different data).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.io.readers import file_fingerprints, list_files

# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------


def source_fingerprints(paths) -> Optional[tuple]:
    """Fresh ``(path, size, mtime_ns)`` set for the CURRENT listing of
    ``paths`` — re-listing (not just re-statting known files) is what
    catches files added to or removed from a scanned directory. None
    when the listing fails: an unlistable source is uncacheable, never
    stale."""
    try:
        listed = list_files(list(paths))
    except OSError:
        return None
    return file_fingerprints([f for f, _ in listed])


def collect_scan_sources(physical) -> Optional[Tuple[str, ...]]:
    """The merged input paths of every file scan under ``physical``,
    or None when the plan reads anything that is NOT a fingerprintable
    file scan (local relations, generated data): such plans are
    uncacheable — there is no fingerprint to invalidate on."""
    paths: List[str] = []
    ok = True

    def walk(p) -> None:
        nonlocal ok
        if not ok:
            return
        node_paths = getattr(p, "paths", None)
        if getattr(p, "files", None) is not None and node_paths:
            paths.extend(node_paths)
        elif not getattr(p, "children", []):
            # non-file leaf: no fingerprint story, refuse to cache
            ok = False
            return
        for c in getattr(p, "children", []):
            walk(c)

    walk(physical)
    if not ok or not paths:
        return None
    return tuple(sorted(set(paths)))


def capture_fingerprints(physical):
    """``(paths, fingerprints)`` for every file-scan input of a
    physical plan, or None when the plan is uncacheable. Called BEFORE
    execution so a mid-execution mutation invalidates (the stored
    fingerprint predates the change) rather than going stale."""
    paths = collect_scan_sources(physical)
    if paths is None:
        return None
    fps = source_fingerprints(paths)
    if fps is None:
        return None
    return (paths, fps)


def fingerprints_current(paths, fingerprints) -> bool:
    """Whether the current listing of ``paths`` fingerprints exactly as
    recorded. Any append / same-size rewrite / mtime-only touch /
    delete / added file flips this to False."""
    return source_fingerprints(paths) == fingerprints


# pre-execution capture of the CURRENT query's (paths, fingerprints),
# installed by session.execute_plan on the executing thread. The join
# build-reuse hooks key their cache entries on this (a superset of the
# build subtree's own inputs — stricter invalidation, never staler),
# and the server reads it after _execute() to populate the result
# cache. Thread-local because the server plans and executes one request
# per connection thread.
_EXEC_TLS = threading.local()


def set_execution_fingerprints(captured) -> None:
    _EXEC_TLS.captured = captured


def current_execution_fingerprints():
    return getattr(_EXEC_TLS, "captured", None)


# ---------------------------------------------------------------------------
# Result cache
# ---------------------------------------------------------------------------


class _ResultEntry:
    __slots__ = ("signature", "paths", "fingerprints", "payload",
                 "rows", "generation")

    def __init__(self, signature: str, paths, fingerprints,
                 payload: bytes, rows: int, generation: int):
        self.signature = signature
        self.paths = paths
        self.fingerprints = fingerprints
        self.payload = payload
        self.rows = rows
        self.generation = generation


class ResultCache:
    """Bounded LRU over final Arrow IPC payloads (docs/caching.md).

    One instance per :class:`~spark_rapids_tpu_torch.serve.server.
    QueryServer`. Probe key: ``adaptive.fusion_key`` of the SQL text
    (normalized text + literal vector); entry validation: view
    generation + input-file fingerprint equality under re-listing."""

    def __init__(self, max_entries: int, max_bytes: int):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _ResultEntry]" = OrderedDict()
        self._bytes = 0
        self._generation = 0
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))

    def _probe_key(self, sql: str) -> tuple:
        from spark_rapids_tpu_torch import adaptive as A
        norm, lits = A.fusion_key(sql)
        return (norm, lits)

    def bump_generation(self) -> None:
        """Invalidate everything: a view (re-)registration may point an
        existing SQL text at different data under the same name, which
        fingerprints alone cannot see until the paths change."""
        with self._lock:
            self._generation += 1
            self.invalidations += len(self._entries)
            self._entries.clear()
            self._bytes = 0

    def lookup(self, sql: str) -> Optional[_ResultEntry]:
        """The valid entry for ``sql``, or None. Validation happens
        INSIDE the lookup — a stale entry is dropped here and reported
        as an invalidation + miss, so the caller's fall-through to
        normal execution needs no extra bookkeeping."""
        key = self._probe_key(sql)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            if entry.generation != self._generation:
                # bump_generation clears eagerly; this guards entries
                # captured around a concurrent re-registration
                self._forget(key, entry)
                self.invalidations += 1
                self.misses += 1
                return None
        # re-list + re-stat OUTSIDE the lock (filesystem IO)
        if not fingerprints_current(entry.paths, entry.fingerprints):
            with self._lock:
                cur = self._entries.get(key)
                if cur is entry:
                    self._forget(key, entry)
                    self.invalidations += 1
            self.misses += 1
            return None
        with self._lock:
            if self._entries.get(key) is entry:
                self._entries.move_to_end(key)
            self.hits += 1
            return entry

    def put(self, sql: str, signature: Optional[str], captured,
            payload: bytes, rows: int) -> bool:
        """Admit one finished query's payload. ``captured`` is the
        pre-execution ``(paths, fingerprints)`` from
        :func:`capture_fingerprints`; queries without one (no file
        scans, unstattable inputs) are refused — uncacheable beats
        unsound."""
        if not signature or captured is None or payload is None:
            return False
        paths, fps = captured
        if len(payload) > self.max_bytes:
            return False
        key = self._probe_key(sql)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= len(old.payload)
            entry = _ResultEntry(signature, paths, fps, payload, rows,
                                 self._generation)
            self._entries[key] = entry
            self._bytes += len(payload)
            while (len(self._entries) > self.max_entries
                   or self._bytes > self.max_bytes):
                _k, victim = self._entries.popitem(last=False)
                self._bytes -= len(victim.payload)
                self.evictions += 1
        return True

    def _forget(self, key: tuple, entry: _ResultEntry) -> None:
        # call under the lock
        self._entries.pop(key, None)
        self._bytes -= len(entry.payload)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
            }


# ---------------------------------------------------------------------------
# Subplan signature
# ---------------------------------------------------------------------------

# execution-side attrs that differ between clones of one template (or
# between plain re-plans of one shape) without changing what the
# subtree computes; everything else participates in the signature
_SIG_SKIP_ATTRS = ("children", "metrics", "conf", "fused_ops")


def subplan_signature(node, conf) -> str:
    """Structural digest of a PHYSICAL subtree + the planning-relevant
    session settings — the cross-query identity of a broadcast build
    side. Expression ids renumber in first-occurrence order (mirrors
    ``plan_cache.plan_signature``), unknown-typed attrs (locks,
    materialization state, scan-unit assignments) encode as a fixed
    placeholder: they are execution residue, and the data they could
    at most influence is covered by the fingerprint check at reuse
    time."""
    import hashlib

    from spark_rapids_tpu_torch.sql import expressions as E
    from spark_rapids_tpu_torch.sql import types as T

    ids: Dict[int, int] = {}

    def enc_val(v) -> str:
        if isinstance(v, (int, float, bool, bytes, str, type(None))):
            return repr(v)
        if isinstance(v, T.DataType):
            return repr(v)
        if isinstance(v, E.Expression):
            return enc_expr(v)
        if isinstance(v, (list, tuple)):
            return "[" + ",".join(enc_val(x) for x in v) + "]"
        if isinstance(v, dict):
            return "{" + ",".join(
                f"{k!r}:{enc_val(v[k])}"
                for k in sorted(v, key=str)) + "}"
        return "<?>"

    def enc_expr(e) -> str:
        frags = [type(e).__name__, "("]
        for k in sorted(vars(e)):
            if k == "children":
                continue
            v = vars(e)[k]
            if k == "expr_id":
                frags.append(f"@{ids.setdefault(v, len(ids))};")
            else:
                frags.append(f"{k}={enc_val(v)};")
        frags.append("|")
        frags.extend(enc_expr(c) for c in e.children)
        frags.append(")")
        return "".join(frags)

    def walk(p) -> str:
        frags = [type(p).__name__, "("]
        for k in sorted(vars(p)):
            if k in _SIG_SKIP_ATTRS:
                continue
            frags.append(f"{k}={enc_val(vars(p)[k])};")
        frags.append("|")
        frags.extend(walk(c) for c in getattr(p, "children", []))
        frags.append(")")
        return "".join(frags)

    # same exclusion families as plan_signature: serve/adaptive/cache
    # gates and fault schedules never change what a subtree computes
    settings = ";".join(
        f"{k}={v}" for k, v in sorted(
            (str(k), str(v)) for k, v in conf.settings.items())
        if not k.startswith((
            "spark.rapids.sql.serve.",
            "spark.rapids.sql.adaptive.",
            "spark.rapids.sql.resultCache.",
            "spark.rapids.sql.subplanCache.",
            # tpu-lint: disable=conf-key(prefix over the test.inject* key family, not a key literal)
            "spark.rapids.sql.test.inject")))
    body = (walk(node) + "||conf:" + settings
            + f"||device:{getattr(node, 'device', None)}")
    return hashlib.sha1(body.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Subplan (broadcast build) cache
# ---------------------------------------------------------------------------


class _SubplanEntry:
    __slots__ = ("paths", "fingerprints", "handle", "bytes", "rows")

    def __init__(self, paths, fingerprints, handle, nbytes: int):
        self.paths = paths
        self.fingerprints = fingerprints
        self.handle = handle
        self.bytes = nbytes


class SubplanCache:
    """Bounded LRU over device-resident broadcast build tables
    (docs/caching.md). Process-wide (one device pool, one cache):
    entries are shared across queries, sessions, and tenants. The
    batches register in the device store with ``cache_entry=True`` —
    the pool may DROP them at any moment under pressure, which a later
    lookup observes as a closed handle and forgets."""

    OWNER = "subplanCache"

    def __init__(self, max_entries: int, max_bytes: int):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _SubplanEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0
        self.max_entries = max(1, int(max_entries))
        self.max_bytes = max(1, int(max_bytes))

    def lookup(self, key: str):
        """The cached build batch for ``key`` (a DeviceBatch), or None.
        Validates the fingerprint set and the device-store handle; a
        dropped-by-pool handle counts as an eviction, a fingerprint
        mismatch as an invalidation — both miss."""
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            with self._lock:
                self.misses += 1
            return None
        if entry.handle.closed:
            with self._lock:
                if self._entries.get(key) is entry:
                    self._entries.pop(key, None)
                    self.evictions += 1
                self.misses += 1
            return None
        if not fingerprints_current(entry.paths, entry.fingerprints):
            with self._lock:
                if self._entries.get(key) is entry:
                    self._entries.pop(key, None)
                    self.invalidations += 1
                self.misses += 1
            entry.handle.close()
            return None
        try:
            # store-handle access, not a queue: get() unspills or
            # raises, it never blocks on a producer
            batch = entry.handle.get()  # tpu-lint: disable=cancel-checkpoint(a store handle's get unspills or raises; it never waits on a producer)
        except Exception:
            # raced a pool drop between the closed check and the access
            with self._lock:
                if self._entries.get(key) is entry:
                    self._entries.pop(key, None)
                    self.evictions += 1
                self.misses += 1
            return None
        with self._lock:
            if self._entries.get(key) is entry:
                self._entries.move_to_end(key)
            self.hits += 1
        return batch

    def put(self, key: str, captured, batch, store) -> bool:
        """Admit one freshly built broadcast table. ``captured`` is the
        build subtree's pre-build ``(paths, fingerprints)``; refused
        when None (unfingerprintable build side) or when the batch
        alone exceeds the byte bound."""
        if captured is None or batch is None:
            return False
        paths, fps = captured
        nbytes = batch.sizeof()
        if nbytes > self.max_bytes:
            return False
        handle = store.register(batch, owner=self.OWNER,
                                cache_entry=True)
        with self._lock:
            old = self._entries.pop(key, None)
            entry = _SubplanEntry(paths, fps, handle, nbytes)
            self._entries[key] = entry
            victims = []
            while (len(self._entries) > self.max_entries
                   or sum(e.bytes for e in self._entries.values())
                   > self.max_bytes):
                _k, v = self._entries.popitem(last=False)
                victims.append(v)
                self.evictions += 1
        if old is not None:
            old.handle.close()
        for v in victims:
            v.handle.close()
        return True

    def clear(self) -> None:
        with self._lock:
            victims = list(self._entries.values())
            self._entries.clear()
        for v in victims:
            v.handle.close()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            live = [e for e in self._entries.values()
                    if not e.handle.closed]
            return {
                "entries": len(live),
                "bytes": sum(e.bytes for e in live),
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
            }


# process singleton: one device pool, one build-table cache. Sized by
# the first conf that touches it (get_device_store does the same).
_SUBPLAN: Optional[SubplanCache] = None
_SUBPLAN_LOCK = threading.Lock()


def subplan_cache_enabled(conf) -> bool:
    from spark_rapids_tpu_torch.conf import SUBPLAN_CACHE_ENABLED
    return bool(conf.get(SUBPLAN_CACHE_ENABLED))


def get_subplan_cache(conf) -> SubplanCache:
    from spark_rapids_tpu_torch.conf import (SUBPLAN_CACHE_MAX_BYTES,
                                             SUBPLAN_CACHE_MAX_ENTRIES)
    global _SUBPLAN
    with _SUBPLAN_LOCK:
        if _SUBPLAN is None:
            _SUBPLAN = SubplanCache(
                int(conf.get(SUBPLAN_CACHE_MAX_ENTRIES)),
                int(conf.get(SUBPLAN_CACHE_MAX_BYTES)))
        return _SUBPLAN


def reset_subplan_cache() -> None:
    """Drop the process cache and its device-store registrations
    (tests and store teardown)."""
    global _SUBPLAN
    with _SUBPLAN_LOCK:
        cache, _SUBPLAN = _SUBPLAN, None
    if cache is not None:
        cache.clear()


def subplan_cache_stats() -> Optional[Dict[str, Any]]:
    """Stats of the live process cache, or None when no query has
    touched it yet (the server's stats verb and prometheus exporter)."""
    with _SUBPLAN_LOCK:
        cache = _SUBPLAN
    return cache.stats() if cache is not None else None
