"""The port's device bootstrap (``spark_rapids_tpu_torch/device_manager.py``)
on the CPU: a CPU device needs nothing built, no device means the CUDA
card (and raises without one), the kernels' build and probe run once
under a lock and a failure raises instead of starting a session, and the
memory budget reads the card's size through ``device_memory_bytes``."""

from __future__ import annotations

import threading

import pytest
import torch

from spark_rapids_tpu_torch import device_caps
from spark_rapids_tpu_torch import device_manager as DM
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch import memory as MEM
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    saved = set(DM._INITIALIZED)
    DM._INITIALIZED.clear()
    yield
    DM._INITIALIZED.clear()
    DM._INITIALIZED.update(saved)


def test_cpu_needs_nothing_built(monkeypatch):
    calls = []
    monkeypatch.setattr(device_caps, "probe", lambda d: calls.append(d))
    DM.initialize(None, "cpu")
    TorchSparkSession(device="cpu").stop()
    assert calls == [] and not DM._INITIALIZED
    assert DM.device_memory_bytes("cpu") is None


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default resolves to it")
    with pytest.raises(RuntimeError):
        DM.initialize()
    with pytest.raises(RuntimeError):
        DM.device_memory_bytes()


def test_build_and_probe_once_under_a_lock(monkeypatch):
    """Eight sessions' worth of concurrent initialize calls for one card
    probe it once; a second card is probed on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    gate = threading.Event()

    def probe(device):
        gate.wait(5)
        calls.append(str(device))
        return 0.0
    monkeypatch.setattr(device_caps, "probe", probe)
    threads = [threading.Thread(target=DM.initialize,
                                args=(None, torch.device("cuda", 0)))
               for _ in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(10)
    DM.initialize(None, "cuda:1")
    DM.initialize(None, "cuda:0")
    assert calls == ["cuda:0", "cuda:1"]


def test_a_failed_build_raises_and_is_retried(monkeypatch):
    """A build that fails raises out of initialize (no session starts on
    a card without its kernels) and leaves the card uninitialised, so
    the next session tries again."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def probe(device):
        raise KR.KernelError("nvcc not found: the CUDA kernels cannot be "
                             "built")
    monkeypatch.setattr(device_caps, "probe", probe)
    for _ in range(2):
        with pytest.raises(KR.KernelError):
            DM.initialize(None, "cuda:0")
    assert not DM._INITIALIZED


def test_session_on_a_card_initializes_it(monkeypatch):
    """TorchSparkSession on a CUDA device calls initialize before it
    does anything else (here without a card: the session's own device
    check runs first and raises)."""
    seen = []
    monkeypatch.setattr(DM, "initialize",
                        lambda conf, device: seen.append(device))
    if torch.cuda.is_available():
        TorchSparkSession(device="cuda").stop()
        assert seen and seen[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchSparkSession(device="cuda")
        TorchSparkSession(device="cpu").stop()
        assert [d.type for d in seen] == ["cpu"]


def test_memory_budget_reads_the_card_through_device_manager(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 7)
    monkeypatch.setattr(DM, "device_memory_bytes",
                        lambda device: 1000 * (device.index + 1))
    MEM._CARD_BYTES.pop(7, None)
    try:
        assert MEM._default_budget() == int(8000 * 0.8)
    finally:
        MEM._CARD_BYTES.pop(7, None)
