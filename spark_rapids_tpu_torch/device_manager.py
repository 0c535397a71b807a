"""Device bootstrap (the counterpart of ``spark_rapids_tpu.device_manager``,
itself the GpuDeviceManager twin).

The JAX package's ``initialize`` turns on the persistent XLA compilation
cache, so compiled programs survive a restart. The port's compiled
programs are its CUDA kernels: ``initialize`` builds every one of them
once per process (``kernels.build_all``, content-hashed libraries under
``build/kernels/`` that a restart finds up to date) and launches the
probe kernel on the card (``device_caps.probe``). A build or probe that
fails raises: a session never starts on a card without its kernels.

Idempotent and under a lock; ``TorchSparkSession`` calls it for a CUDA
device. The CPU needs nothing built: the plain versions run there.
"""

from __future__ import annotations

import threading
from typing import Optional, Set

import torch

_LOCK = threading.Lock()
# CUDA devices whose kernels were built and probed by this process
_INITIALIZED: Set[str] = set()


def initialize(conf=None, device=None) -> None:
    """Build the kernels and probe ``device`` (default: the current CUDA
    card) once per process; a no-op for a CPU device. ``conf`` is
    accepted for the JAX package's signature: nothing in the build reads
    a conf key."""
    from spark_rapids_tpu_torch.sql.session import resolve_device
    device = resolve_device(device)
    if device.type != "cuda":
        return
    key = str(device)
    with _LOCK:
        if key in _INITIALIZED:
            return
        from spark_rapids_tpu_torch import device_caps
        device_caps.probe(device)
        _INITIALIZED.add(key)


def device_memory_bytes(device=None) -> Optional[int]:
    """Total memory of a CUDA ``device`` (default: the current card), from
    ``torch.cuda.mem_get_info``; None for a CPU device."""
    from spark_rapids_tpu_torch.sql.session import resolve_device
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])

