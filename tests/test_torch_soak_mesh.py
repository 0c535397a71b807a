"""The soak's chip-failure round (``soak.py`` ``MESH_ROUND``) on the
port's ``QueryServer`` on the CPU, over 8 emulated ``cpu`` chips: mixed
q1/q3 tenants served over the mesh with chip 1 failing persistently.
Every surviving query's rows equal the serial CPU engine's, the failing
chip is demoted, the round drains and nothing leaks. The rotation of
rounds is the JAX package's."""

import pytest
import torch

from spark_rapids_tpu import soak as JSOAK

from spark_rapids_tpu_torch import soak as SOAK
from spark_rapids_tpu_torch.parallel import mesh as PM

from tests.torch_serve_support import reset_state

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    prev_mesh, prev_em = PM.get_active_mesh(), PM.emulated_chips()
    PM.set_active_mesh(None)
    reset_state()
    yield
    reset_state()
    PM.set_active_mesh(prev_mesh)
    PM.emulate_chips(*prev_em) if prev_em else PM.emulate_chips(None)


def test_round_rotation_is_the_jax_packages():
    assert SOAK.ROUND_SCHEDULES == JSOAK.SCHEDULES
    assert SOAK.ROUND_SCHEDULES[6] is SOAK.MESH_ROUND


def test_mesh_round_degrades_and_drains(tmp_path, monkeypatch):
    """The chip-failure round at concurrency 4: chip 1 is demoted (each
    activation of the mesh once at most), every survivor is exact, and
    the post-drain invariants hold."""
    PM.emulate_chips(8, torch.device("cpu"))
    demoted = []
    orig = PM.mark_chip_failed

    def spy(chip_id):
        fresh = orig(chip_id)
        demoted.append((chip_id, fresh))
        return fresh

    monkeypatch.setattr(PM, "mark_chip_failed", spy)
    report = SOAK.run_soak(rounds=1, concurrency=4, queries_per_tenant=2,
                           data_dir=str(tmp_path / "data"),
                           log=lambda msg: None, device="cpu",
                           start_round=6)
    assert report["ok"], report["errors"]
    rep = report["roundReports"][0]
    assert rep["schedule"] == SOAK.MESH_ROUND
    assert report["totals"]["ok"] > 0
    inv = rep["invariants"]
    assert inv["drained"] and inv["semaphoreInUse"] == 0
    assert inv["liveSessions"] == 0 and inv["liveQueryTokens"] == 0
    assert demoted and {c for c, _f in demoted} == {1}
    assert PM.get_active_mesh() is None


def test_mesh_round_without_chips_runs_the_oom_round(tmp_path):
    """With one visible chip the mesh round runs SCHEDULES[2] instead, as
    in the JAX package."""
    PM.emulate_chips(None)
    report = SOAK.run_soak(rounds=1, concurrency=2, queries_per_tenant=1,
                           data_dir=str(tmp_path / "data"),
                           log=lambda msg: None, device="cpu",
                           start_round=6)
    assert report["ok"], report["errors"]
    assert report["roundReports"][0]["schedule"] == SOAK.SCHEDULES[2]
