"""The chaos soak (``soak.py``) on the port's ``QueryServer`` on the CPU:
mixed q1/q3 tenants under the fault schedules and the lifecycle
injections (deadlines, cancels, disconnects). Every surviving query's
rows equal the serial CPU engine's, every round drains, and nothing
leaks: store bytes, semaphore permits, sessions and lifecycle tokens.
The soak's data is the JAX package's, byte for byte."""

import os

import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import soak as JSOAK

from spark_rapids_tpu_torch import soak as SOAK

from tests.torch_serve_support import reset_state

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


def test_soak_data_matches_jax_package(tmp_path):
    SOAK.make_soak_data(str(tmp_path / "port"), device="cpu")
    JSOAK.make_soak_data(str(tmp_path / "jax"))
    for name in ("lineitem", "fact", "dim"):
        tables = [pq.read_table(str(tmp_path / pkg / name)).to_pylist()
                  for pkg in ("port", "jax")]
        assert tables[0] == tables[1] and tables[0]


@pytest.mark.parametrize("rounds", [2])
def test_quick_soak_round_passes(tmp_path, rounds):
    """Two rounds at concurrency 4: the clean engine, then memory
    pressure (a tiny device budget with a lying budget oracle)."""
    report = SOAK.run_soak(rounds=rounds, concurrency=4,
                           queries_per_tenant=2,
                           data_dir=str(tmp_path / "data"),
                           log=lambda msg: None, device="cpu")
    assert report["ok"], report["errors"]
    assert report["totals"]["ok"] > 0
    for rep in report["roundReports"]:
        inv = rep["invariants"]
        assert inv["drained"] and inv["semaphoreInUse"] == 0
        assert inv["liveSessions"] == 0 and inv["liveQueryTokens"] == 0
    assert os.path.isdir(str(tmp_path / "data" / "lineitem"))


def test_soak_schedules_are_the_jax_packages_without_the_mesh_round():
    want = [s for s in JSOAK.SCHEDULES
            if "spark.rapids.sql.test.injectChipFailure" not in s]
    assert SOAK.SCHEDULES == want
    assert SOAK.Q1 == JSOAK.Q1 and SOAK.Q3 == JSOAK.Q3
