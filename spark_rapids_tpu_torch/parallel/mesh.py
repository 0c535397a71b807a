"""The mesh of chips (the counterpart of ``spark_rapids_tpu.parallel.mesh``;
the reference's GpuDeviceManager and shuffle heartbeat topology).

A chip is an id and the ``torch.device`` its batches live on. The
visible chips are one per CUDA card (chip ``i`` is ``cuda:i``), or one
``cpu`` chip where there is no card. ``emulate_chips(n, device)`` makes
the visible chips ``n`` chips on that one device instead: the
counterpart of XLA's ``--xla_force_host_platform_device_count``, which
the JAX package's tests use for their 8-device mesh. Emulated chips
share one processor, so they check correctness, residency and balance,
never scaling. Only tests and ``chip_smoke.py`` turn it on; no conf key
does, and it is off by default.

A ``TorchMesh`` is a 1-D tuple of chips along ``SHUFFLE_AXIS``. A session
with ``spark.rapids.shuffle.mode=ici`` activates one at its start
(``set_active_mesh``); operators read ``healthy_mesh()`` and take the
single-chip path when no mesh of two or more healthy chips is active.
A chip demoted after a dispatch failure (``mark_chip_failed``) leaves
the healthy mesh, so scans, stages and exchanges re-plan on the
survivors; a new activation starts fully healthy.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

# The one mesh axis a SQL exchange needs: every chip is a shuffle peer.
SHUFFLE_AXIS = "shuffle"


@dataclass(frozen=True)
class Chip:
    """One mesh chip: its id and the device its tensors live on."""

    id: int
    device: torch.device


class TorchMesh:
    """A 1-D mesh: a tuple of chips along ``SHUFFLE_AXIS``."""

    axis_names = (SHUFFLE_AXIS,)

    def __init__(self, chips: Sequence[Chip]):
        self.chips: Tuple[Chip, ...] = tuple(chips)

    def chip(self, chip_id: int) -> Chip:
        for c in self.chips:
            if c.id == chip_id:
                return c
        raise KeyError(f"chip {chip_id} is not in the mesh")

    def __repr__(self) -> str:
        return f"TorchMesh({[(c.id, str(c.device)) for c in self.chips]})"


_lock = threading.Lock()
_active: Optional[TorchMesh] = None
# chips demoted after dispatch failures: the healthy mesh excludes them
_failed_chips: set = set()
_healthy_cache: Optional[tuple] = None  # (key, mesh)
# (n, device) while emulate_chips is on, else None
_emulated: Optional[Tuple[int, torch.device]] = None


def emulate_chips(n: Optional[int], device=None) -> None:
    """Make the visible chips ``n`` chips on ``device`` (``None`` turns
    emulation off). Process-wide; call it before a mesh is built."""
    global _emulated
    with _lock:
        _emulated = None if n is None else (int(n), torch.device(device))


def emulated_chips() -> Optional[Tuple[int, torch.device]]:
    """The emulation setting, for a caller that restores it."""
    return _emulated


def visible_chips(device=None) -> List[Chip]:
    """The emulated chips when emulation is on, else one chip per CUDA
    card, else one ``cpu`` chip (also for a caller that runs on the CPU,
    ``device="cpu"``)."""
    em = _emulated
    if em is not None:
        return [Chip(i, em[1]) for i in range(em[0])]
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and torch.cuda.is_available():
        return [Chip(i, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [Chip(0, torch.device("cpu"))]


def build_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence[Chip]] = None) -> TorchMesh:
    """A 1-D mesh over the first ``n_devices`` chips (all by default)."""
    chips = list(devices) if devices is not None else visible_chips()
    if n_devices is not None:
        if n_devices > len(chips):
            raise ValueError(
                f"requested {n_devices} devices, only {len(chips)} present")
        chips = chips[:n_devices]
    return TorchMesh(chips)


def set_active_mesh(mesh: Optional[TorchMesh]) -> None:
    global _active, _healthy_cache
    with _lock:
        _active = mesh
        # a (re)activated topology starts fully healthy
        _failed_chips.clear()
        _healthy_cache = None


def mark_chip_failed(chip_id: int) -> bool:
    """Demote one chip after a dispatch failure; False when it was
    already demoted. Degrade loops decide retry or raise against a
    ``failed_chips()`` snapshot taken before their attempt, and use this
    return value only to keep ``degradedChips`` exact."""
    global _healthy_cache
    with _lock:
        if chip_id in _failed_chips:
            return False
        _failed_chips.add(chip_id)
        _healthy_cache = None
        return True


def failed_chips() -> frozenset:
    with _lock:
        return frozenset(_failed_chips)


def degraded_chip_count() -> int:
    with _lock:
        return len(_failed_chips)


def healthy_mesh() -> Optional[TorchMesh]:
    """The active mesh without its failed chips: the active mesh itself
    while all are healthy, None when no mesh is active or at most one
    chip survives (the single-chip paths then run)."""
    global _healthy_cache
    with _lock:
        m = _active
        if m is None:
            return None
        if not _failed_chips:
            return m
        key = (mesh_key(m), frozenset(_failed_chips))
        if _healthy_cache is not None and _healthy_cache[0] == key:
            return _healthy_cache[1]
        chips = [c for c in m.chips if c.id not in _failed_chips]
        healthy = TorchMesh(chips) if len(chips) >= 2 else None
        _healthy_cache = (key, healthy)
        return healthy


def get_active_mesh() -> Optional[TorchMesh]:
    return _active


def mesh_size(mesh: Optional[TorchMesh] = None) -> int:
    m = mesh if mesh is not None else _active
    return 1 if m is None else len(m.chips)


@contextlib.contextmanager
def active_mesh(mesh: TorchMesh) -> Iterator[TorchMesh]:
    """Scoped activation (tests; a session activates its mesh once)."""
    prev = get_active_mesh()
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def mesh_key(mesh: TorchMesh) -> tuple:
    """Value-based cache key of a mesh: two meshes over the same chips
    share cached exchange plans."""
    return (tuple((c.id, str(c.device)) for c in mesh.chips),
            mesh.axis_names)


# ---------------------------------------------------------------------------
# Served-query serialization of the mesh exchange
#
# The JAX package serializes the mesh collective sections of served
# sessions behind one per-process mutex (two XLA collectives over one
# device set deadlock at rendezvous). The port's exchange is not a
# rendezvous collective, but it keeps the behaviour: served sessions
# (spark.rapids.sql.multichip.serializeServedQueries, default on) take
# the mutex around each mesh exchange, and a waiting query re-checks its
# cancel token every bounded slice (the meshMutex checkpoint).
# ---------------------------------------------------------------------------

_COLLECTIVE_MUTEX = threading.RLock()


@contextlib.contextmanager
def collective_section(conf) -> Iterator[None]:
    """Scoped mesh-exchange exclusion: a no-op for non-served sessions
    and when ``serializeServedQueries`` is off; reentrant on one
    thread."""
    from spark_rapids_tpu_torch.conf import (MULTICHIP_SERIALIZE_SERVED,
                                             SERVE_TENANT_ID)
    if conf is None or not str(conf.get(SERVE_TENANT_ID) or "") \
            or not bool(conf.get(MULTICHIP_SERIALIZE_SERVED)):
        yield
        return
    from spark_rapids_tpu_torch import lifecycle as LC
    while not _COLLECTIVE_MUTEX.acquire(timeout=0.05):
        # bounded slices: a cancel reaches a queued mesh query
        LC.checkpoint("meshMutex")
    try:
        yield
    finally:
        _COLLECTIVE_MUTEX.release()


def mesh_scan_devices(conf) -> List[Chip]:
    """The chips of the mesh-sharded scan: the healthy mesh's chips when
    ``spark.rapids.sql.multichip.scan.enabled`` is on and a mesh of two
    or more healthy chips is active, else ``[]``. The scan, the upload
    and the exchange all read this one gate, so they flip together."""
    m = healthy_mesh()  # demoted chips never receive scan streams
    if m is None or mesh_size(m) <= 1:
        return []
    from spark_rapids_tpu_torch.conf import MULTICHIP_SCAN_ENABLED
    if not bool(conf.get(MULTICHIP_SCAN_ENABLED)):
        return []
    return list(m.chips)


def record_chip_dispatch(metrics, batch) -> None:
    """Per-chip dispatch attribution: while a mesh is active, count a
    program dispatch against the chip its batch lives on
    (``dispatchCount.chip<N>``)."""
    if _active is None:
        return
    from spark_rapids_tpu_torch import metrics as M
    from spark_rapids_tpu_torch.columnar.device import batch_device
    chip = batch_device(batch)
    if chip is not None:
        metrics.create(f"{M.DISPATCH_COUNT}.chip{chip}").add(1)
