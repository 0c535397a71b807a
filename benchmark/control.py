"""The control of a cell's correctness check: the plain reference put in
the program's place with one of the configuration's guarantees broken
(each reference's ``control_rows``: q1's decimals in float64, q3's
ORDER BY cut to its first key), driven through the rest of a run exactly
as the program is, at the cell's own data size and load.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 10

prints one JSON line a seed with the run's ``correct`` (false where the
check catches the control) and its ``checks``. It needs no card: the
control is NumPy. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]

import harness  # noqa: E402
import parquet_data  # noqa: E402


class ControlEntry:
    """Answers each query from the reference's control rows, computed
    from the run's own generated data."""

    def __init__(self, query: str, data: dict):
        self.ref = parquet_data.load_module("reference", query)
        self.state = self.ref.prepare(data)

    def client(self, i: int):
        def run(_text: str, binding: dict):
            return self.ref.control_rows(self.state, binding), {}
        return run

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.state = None


def control_run(cell: str, seed: int, seconds: float, scale: float = 1.0,
                bench: dict = None) -> dict:
    """One run of ``cell`` with the control in the program's place."""
    bench = bench or harness.load_benchmark()
    query = harness.cell_spec(bench, cell)["traffic"]["query"]

    def make_entry(_conf, _views, _device, _streams, _trace, data):
        return ControlEntry(query, data)
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter(), scale=scale, bench=bench,
                            make_entry=make_entry)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = control_run(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
