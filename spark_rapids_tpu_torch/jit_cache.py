"""Bounded LRU caches for stage programs (the counterpart of
``spark_rapids_tpu.jit_cache``).

A fused stage's program is built once per key and reused for every batch
with that key: on a CUDA device it is a captured CUDA graph, which pins a
private memory pool; on the CPU it is the composed PyTorch function. A
long-running session that plans many distinct stage shapes would grow
the cache without limit, so eviction drops the oldest-used entry and
releases it (a value with a ``release`` method has it called: a graph
frees its pool). A re-planned stage simply builds again.

The port's operators other than fused stages run eagerly and keep no
program here: the JAX package's per-operator caches (``window``,
``sort``, ``agg`` and the rest) have no counterpart. The plan cache
(``plan_cache.PLAN_CACHE``, "planRewrite") is one of these caches: its
values are finished physical plans.

A thread waiting on another thread's build of the same key is a
lifecycle checkpoint (``cancellable_wait``): a cancelled query stops
waiting and raises, while the build goes on for its other waiters.

Hit and miss counters are kept per cache and surfaced two ways: execs
that own a cache mirror the counts into their metric registries
(``compileCacheHits`` / ``compileCacheMisses``), and ``cache_stats()``
returns the whole registry.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import trace as _trace

# Large enough that no single query thrashes, small enough that thousands
# of distinct plan shapes cannot pin unbounded programs.
DEFAULT_CAPACITY = 256

_CACHES: Dict[str, "JitCache"] = {}
# stats sources that are not a JitCache (the kernel autotuner's winner
# table) surfaced beside the caches: a provider returns a JitCache-shaped
# dict (size/capacity/hits/misses/evictions/contention at least: the
# Prometheus renderer reads those keys of every entry)
_EXTRA_STATS: Dict[str, Callable[[], Dict[str, int]]] = {}
_REG_LOCK = threading.Lock()


def register_stats_provider(name: str,
                            fn: Callable[[], Dict[str, int]]) -> None:
    """Expose an auxiliary stats source under ``cache_stats()[name]``."""
    with _REG_LOCK:
        _EXTRA_STATS[name] = fn


class JitCache:
    """Thread-safe LRU mapping structural keys -> built programs."""

    def __init__(self, name: str, capacity: int = DEFAULT_CAPACITY):
        self.name = name
        self.capacity = capacity
        self._data: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()
        # single-flight: keys whose build is in progress map to the Event
        # concurrent requesters wait on, so two queries sharing a shape
        # never build the same program twice
        self._building: Dict[Any, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.contention = 0  # threads that blocked on an in-progress build
        # optional eviction-protection predicate over keys (the plan
        # cache's pre-warm digests): protected entries are evicted last;
        # the capacity bound always wins
        self._protector: Optional[Callable[[Any], bool]] = None
        with _REG_LOCK:
            _CACHES[name] = self

    def set_protector(self,
                      pred: Optional[Callable[[Any], bool]]) -> None:
        """Install (or clear, with None) the eviction-protection
        predicate; it runs under the cache lock, so keep it cheap."""
        with self._lock:
            self._protector = pred

    def _put_locked(self, key, value) -> list:
        """Insert ``value``; returns the evicted values, which the
        caller releases outside the lock."""
        self._data[key] = value
        self._data.move_to_end(key)
        evicted = []
        while len(self._data) > self.capacity:
            victim = None
            if self._protector is not None:
                for k in self._data:  # oldest-used first
                    try:
                        if not self._protector(k):
                            victim = k
                            break
                    except Exception:
                        victim = k
                        break
            if victim is None:
                evicted.append(self._data.popitem(last=False)[1])
            else:
                evicted.append(self._data.pop(victim))
            self.evictions += 1
        return evicted

    def get_or_build(self, key, build: Callable[[], Any]
                     ) -> Tuple[Any, bool]:
        """Returns ``(value, was_miss)``. Single-flight: exactly one
        thread builds a missing key; concurrent requesters of the same
        key wait for it and then read the finished value. The build runs
        outside the lock. A build that raises caches nothing: its waiters
        re-race and one of them builds the key anew."""
        while True:
            with self._lock:
                val = self._data.get(key)
                if val is not None:
                    self._data.move_to_end(key)
                    self.hits += 1
                    return val, False
                ev = self._building.get(key)
                if ev is None:
                    self.misses += 1
                    my_ev = self._building[key] = threading.Event()
                    break
                self.contention += 1
            _trace.instant("compileCacheContention", cache=self.name)
            # a cancelled query stops waiting on another thread's build
            from spark_rapids_tpu_torch.lifecycle import cancellable_wait
            cancellable_wait(ev, site="jitWait")
        t0 = time.perf_counter_ns()
        try:
            val = build()
            with self._lock:
                evicted = self._put_locked(key, val)
            release_values(evicted)
            # the build on a miss: a stage program's warm-up and capture,
            # or a plan rewrite (cache= names which)
            qt = _trace._ACTIVE
            if qt is not None:
                qt.add("compile", t0, time.perf_counter_ns(),
                       cache=self.name)
            return val, True
        finally:
            with self._lock:
                self._building.pop(key, None)
            my_ev.set()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def keys(self) -> list:
        with self._lock:
            return list(self._data)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._data

    def pop_lru(self, n: int) -> list:
        """Remove up to ``n`` entries, least recently used first, and
        return their values; the caller releases them."""
        with self._lock:
            out = []
            while self._data and len(out) < n:
                out.append(self._data.popitem(last=False)[1])
            self.evictions += len(out)
            return out

    def clear(self) -> None:
        with self._lock:
            vals = list(self._data.values())
            self._data.clear()
        release_values(vals)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"size": len(self._data), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "contention": self.contention}


def release_values(values) -> None:
    for v in values:
        release = getattr(v, "release", None)
        if release is not None:
            release()


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Snapshot of every registered cache and stats provider."""
    with _REG_LOCK:
        caches = list(_CACHES.values())
        extras = list(_EXTRA_STATS.items())
    out = {c.name: c.stats() for c in caches}
    for name, fn in extras:
        try:
            out[name] = fn()
        except Exception:  # a broken provider leaves the others readable
            continue
    return out


def mirror_to_metrics(metrics, was_miss: bool) -> None:
    """Mirror one lookup's outcome into an exec's metric registry."""
    name = M.COMPILE_CACHE_MISSES if was_miss else M.COMPILE_CACHE_HITS
    metrics.create(name).add(1)
