"""Python worker-process pool + the worker-concurrency throttle.

The reference bounds concurrent python workers with its own semaphore
distinct from the GPU one (python/PythonWorkerSemaphore.scala,
spark.rapids.python.concurrentPythonWorkers in PythonConfEntries.scala
:32); here the pool IS the throttle: at most ``concurrentPythonWorkers``
processes exist, and a task borrowing a worker blocks until one frees.
Workers are plain subprocesses (no fork of the engine process, so the
CUDA context never duplicates into a child), started as ``python -m
spark_rapids_tpu_torch.python.worker`` with no card visible, and are
reused across batches and queries until shutdown (``TorchSparkSession
.stop()`` or interpreter exit). One pool a process.
"""

from __future__ import annotations

import atexit
import pickle
import queue
import threading
from typing import Any, List, Optional, Tuple


class PythonWorkerError(RuntimeError):
    """A UDF raised in the worker; carries the remote traceback."""


class _Worker:
    """One worker subprocess; frames ride its stdin/stdout (the
    reference uses a socket — same framed-stream shape). A plain
    subprocess (not multiprocessing) so no engine or torch state leaks
    into the child and no __main__ re-import happens."""

    def __init__(self):
        import os
        import subprocess
        import sys
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        env["CUDA_VISIBLE_DEVICES"] = ""  # the worker never touches a card
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_tpu_torch.python.worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    def request(self, mode: str, payload: Tuple, ipc: bytes) -> bytes:
        from spark_rapids_tpu_torch.python.worker import (_read_frame,
                                                          _write_frame)
        _write_frame(self.proc.stdin, pickle.dumps((mode, payload, ipc)))
        status, body = pickle.loads(_read_frame(self.proc.stdout))
        if status != "ok":
            raise PythonWorkerError(
                f"pandas UDF failed in python worker:\n{body}")
        return body

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except Exception:
            pass
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except Exception:
            self.proc.kill()


class PythonWorkerPool:
    """Lazy pool of at most ``size`` worker processes."""

    def __init__(self, size: int):
        self.size = max(1, int(size))
        self._idle: "queue.Queue[_Worker]" = queue.Queue()
        self._created = 0
        self._lock = threading.Lock()
        self._closed = False

    def run(self, mode: str, payload: Tuple, ipc: bytes) -> bytes:
        w = self._borrow()
        try:
            out = w.request(mode, payload, ipc)
        except PythonWorkerError:
            self._return(w)  # UDF error: worker loop is still healthy
            raise
        except Exception:
            # transport/process failure: replace the worker
            with self._lock:
                self._created -= 1
            w.close()
            raise
        self._return(w)
        return out

    def _return(self, w: "_Worker") -> None:
        """Idle-queue the worker, unless the pool was shut down while it
        was borrowed (resize/stop mid-query) — then it must die here or
        the subprocess leaks until interpreter exit."""
        with self._lock:
            closed = self._closed
            if closed:
                self._created = max(0, self._created - 1)
        if closed:
            w.close()
        else:
            self._idle.put(w)

    def _borrow(self) -> _Worker:
        while True:
            try:
                return self._idle.get_nowait()
            except queue.Empty:
                pass
            with self._lock:
                if self._closed:
                    raise RuntimeError("python worker pool is shut down")
                if self._created < self.size:
                    self._created += 1
                    try:
                        return _Worker()
                    except Exception:
                        self._created -= 1
                        raise
            try:
                # at capacity: wait for a free worker, but re-check
                # periodically (a crashed worker decrements _created and
                # never returns to the queue)
                return self._idle.get(timeout=5)
            except queue.Empty:
                continue

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            n = self._created
            self._created = 0
        for _ in range(n):
            try:
                w = self._idle.get_nowait()
            except queue.Empty:
                break
            w.close()


_POOL: Optional[PythonWorkerPool] = None
_POOL_LOCK = threading.Lock()


def get_worker_pool(conf) -> PythonWorkerPool:
    from spark_rapids_tpu_torch.conf import CONCURRENT_PYTHON_WORKERS
    # clamp BEFORE the staleness compare: an unclamped 0 would mismatch
    # the pool's clamped size forever and churn pools mid-query
    size = max(1, int(conf.get(CONCURRENT_PYTHON_WORKERS)))
    global _POOL
    with _POOL_LOCK:
        if _POOL is None or _POOL.size != size:
            if _POOL is not None:
                _POOL.shutdown()
            _POOL = PythonWorkerPool(size)
        return _POOL


def shutdown_worker_pool() -> None:
    global _POOL
    with _POOL_LOCK:
        if _POOL is not None:
            _POOL.shutdown()
            _POOL = None


atexit.register(shutdown_worker_pool)
