"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``card`` that need a CUDA card and skip without one (run them on the
card with ``python3 -m pytest benchmark/tests -m card``)."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def bench_with_held() -> dict:
    """``BENCHMARK.json`` with the cells of ``held_cells.json`` back in
    it, so the harness over them stays tested while they are held out."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "held_cells.json")) as f:
        held = json.load(f)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + held[key]
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + held["workloads_of"].get(
            m["name"], [])
    return bench
