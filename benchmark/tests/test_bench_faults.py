"""The correctness check catches a broken timed path: the rest of a run
driven on the CPU (past the look for a card) with the program broken
underneath, and with the control in the program's place."""

import time

import pytest

import control
import harness
from conftest import bench_with_held

BENCH = bench_with_held()

CELLS = ["tpch_q1.parquet.streams2", "tpcds_q3.parquet.streams4",
         "tpcds_q3.served.tenants4"]
SCALE = {"tpch_q1.parquet.streams2": 0.005,
         "tpcds_q3.parquet.streams4": 0.02,
         "tpcds_q3.served.tenants4": 0.02}


def run(cell):
    return harness.run_cell(cell, 77, 1.0, False, "cpu",
                            time.perf_counter(), scale=SCALE[cell],
                            bench=BENCH)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


def half_the_row_groups(monkeypatch):
    """Half of every batch left out: the scan plans every other row
    group."""
    from spark_rapids_tpu_torch.io import readers
    real = readers.plan_scan_units
    monkeypatch.setattr(readers, "plan_scan_units",
                        lambda fmt, files: real(fmt, files)[::2])


def altered_answer(monkeypatch):
    """An answer altered where the rows are produced: the last value of
    a result's first row."""
    from spark_rapids_tpu_torch.columnar.host import HostBatch
    real = HostBatch.rows

    def rows(self):
        out = [list(r) for r in real(self)]
        if out and isinstance(out[0][-1], int):
            out[0][-1] += 1
        elif out:
            out[0][-1] = out[0][-1] * 2 + 1
        return iter(tuple(r) for r in out)
    monkeypatch.setattr(HostBatch, "rows", rows)


@pytest.mark.parametrize("fault", [half_the_row_groups, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(cell)
    assert not r["correct"]
    assert r["checks"]["wrong_results"]["value"] > 0


@pytest.mark.parametrize("cell,scale", [("tpch_q1.parquet.streams2", 1.0),
                                        ("tpcds_q3.parquet.streams4", 0.05)])
def test_control_is_not_correct(cell, scale):
    """The reference with a guarantee broken, in the program's place, at
    the cell's size for q1 (its float64 sums are exact at small sizes)."""
    r = control.control_run(cell, 31, 1.0, scale=scale, bench=BENCH)
    assert not r["correct"]
    assert r["checks"]["wrong_results"]["value"] >= 1


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark()["workloads"]])
def test_cell_on_the_card(cell, card):
    import json
    import subprocess
    import sys
    from conftest import ROOT
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    assert {m["name"] for m in spec["end_to_end"]} == set(r["metrics"])
