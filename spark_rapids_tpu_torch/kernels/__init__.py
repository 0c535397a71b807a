"""Hand-written CUDA kernels for Hopper: build, load and launch support.

Every kernel source under ``spark_rapids_tpu_torch/csrc/`` is a plain C
interface over CUDA C++. At first use all of them compile together (one
``nvcc`` process per source, started at once) into shared libraries
under ``build/kernels/`` at the repo root, named by a hash of the source
so an edited source rebuilds, and load through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so
         csrc/<name>.cu

The compiler's report (``-Xptxas -v``: registers, spills and static
shared memory of each kernel) is kept beside each library as
``lib<name>-<hash>.ptxas``.

Each C entry launches on the stream it is handed (PyTorch's current
stream), never synchronises, and returns ``cudaGetLastError()``; the
Python wrapper raises on a non-zero code. Each wrapper keeps a plain
integer launch counter (``LAUNCHES``), bumped where it launches its
kernel and nowhere else. A launch made while a stage program is being
captured as a CUDA graph does not run then: ``recording_launches``
records it instead, and every replay of that graph adds the recorded
kernels (``count_replay``). The counters are exact under concurrent
queries (the query server's connection threads): every change to
``LAUNCHES`` is made under ``_COUNT_LOCK``. Nothing here falls back: on a CUDA tensor a
wrapper launches its kernel or raises; only a CPU tensor takes the plain
PyTorch version beside it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from spark_rapids_tpu_torch import trace as _trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("probe", "murmur3", "groupby_hash", "join_probe",
           "decode_fused")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {"murmur3": 0, "groupbyHash": 0,
                             "joinProbe": 0, "decodeFused": 0}

_LOCK = threading.Lock()
# guards LAUNCHES: several threads launch kernels and replay graphs at once
_COUNT_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Optional[float] = None
# per thread: the kernel names launched into a graph being captured
_CAPTURE = threading.local()


class KernelError(RuntimeError):
    """A kernel failed to build, to launch, or was handed a request it
    cannot serve. ``code`` is the CUDA error a launch returned (None
    where there was none): the retry protocol retries a launch only on
    ``CUDA_ERROR_MEMORY_ALLOCATION``."""

    def __init__(self, msg: str, code: Optional[int] = None):
        super().__init__(msg)
        self.code = code


# cudaErrorMemoryAllocation, the CUDA runtime's out-of-memory code
CUDA_ERROR_MEMORY_ALLOCATION = 2


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    """A consistent snapshot of ``LAUNCHES``."""
    with _COUNT_LOCK:
        return dict(LAUNCHES)


def count_launch(name: str) -> None:
    names = getattr(_CAPTURE, "names", None)
    if names is not None:
        names.append(name)
    else:
        with _COUNT_LOCK:
            LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches() -> Iterator[List[str]]:
    """Around a CUDA graph capture on this thread: the launches inside
    are recorded in the yielded list, not counted."""
    names: List[str] = []
    _CAPTURE.names = names
    try:
        yield names
    finally:
        _CAPTURE.names = None


def count_replay(names: List[str]) -> None:
    """One replay of a captured graph launched these kernels."""
    with _COUNT_LOCK:
        for n in names:
            LAUNCHES[n] += 1


def dispatch_start() -> Optional[int]:
    """The start of one direct launch's ``kernelDispatch`` span (its
    host enqueue, not the kernel's run on the card; on the CPU, the call
    of the plain version), or None: one None check when tracing is off.
    A launch recorded into a graph being captured runs at each replay
    instead, where the replay's span carries it, so it takes no span
    here."""
    if _trace._ACTIVE is None or getattr(_CAPTURE, "names",
                                         None) is not None:
        return None
    return time.perf_counter_ns()


def dispatch_end(t0: int, name: str, chip=None, **attrs) -> None:
    """Record the ``kernelDispatch`` span of kernel ``name`` that
    ``dispatch_start`` began (``kernel=<name>``); call it only with a
    start that is not None, so an untraced launch pays nothing more."""
    qt = _trace._ACTIVE
    if qt is not None:
        qt.add("kernelDispatch", t0, time.perf_counter_ns(), chip=chip,
               kernel=name, **attrs)


def count_dispatch(metrics, name: str) -> None:
    """One dispatch of kernel ``name`` by the operator owning
    ``metrics``: ``kernelDispatchCount.<name>`` (MODERATE), counted on
    the CPU too, where the plain version runs."""
    if metrics is not None:
        metrics.create(f"kernelDispatchCount.{name}").add(1)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all() -> float:
    """Compile every source that has no up-to-date library yet, all
    nvcc processes in parallel; returns the wall seconds spent."""
    global BUILD_SECONDS
    with _LOCK:
        if BUILD_SECONDS is not None:
            return BUILD_SECONDS
        t0 = time.perf_counter_ns()
        todo = [n for n in SOURCES if not _lib_path(n).exists()]
        nvcc = _nvcc() if todo else ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in todo:
            out = _lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc] + NVCC_FLAGS + ["-o", str(tmp),
                                            str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors = []
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
                out.with_suffix(".ptxas").write_bytes(log)
        if errors:
            raise KernelError("nvcc failed:\n" + "\n".join(errors))
        t1 = time.perf_counter_ns()
        BUILD_SECONDS = (t1 - t0) / 1e9
        qt = _trace._ACTIVE
        if todo and qt is not None:
            qt.add("compile", t0, t1, cache="nvcc", kernels=len(todo))
        return BUILD_SECONDS


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise KernelError(f"{what}: CUDA error {code}", code=code)


def on_device(device):
    """The context a kernel launch runs in: ``device`` made the calling
    thread's current CUDA device (a runtime-API launch goes to the
    current device, which need not be the tensors' on a mesh of cards);
    nothing on another device type."""
    import contextlib

    import torch
    if getattr(device, "type", None) != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(tensors, what: str) -> None:
    """Every tensor handed to a kernel lies on one CUDA device and is
    contiguous; anything else is a request the kernel cannot serve."""
    dev = None
    for t in tensors:
        if not t.is_cuda:
            raise KernelError(f"{what}: tensor on {t.device}, not CUDA")
        if not t.is_contiguous():
            raise KernelError(f"{what}: non-contiguous tensor")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise KernelError(f"{what}: tensors on {dev} and {t.device}")


def table_slots(conf, cap: int, slots_mult: int = 1) -> int:
    """Group-by table capacity: the conf bound (scaled by the autotuner's
    per-bucket ``slotsMult``), shrunk toward the batch (a 64-row batch
    cannot have 1024 groups), rounded up to a power of two (the kernel
    masks slot indices)."""
    from spark_rapids_tpu_torch.conf import KERNEL_GROUPBY_TABLE_SLOTS
    want = min(int(conf.get(KERNEL_GROUPBY_TABLE_SLOTS))
               * max(1, int(slots_mult)), max(2 * cap, 64))
    t = 64
    while t < want:
        t <<= 1
    return t
