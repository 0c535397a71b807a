"""The benchmark of ``spark_rapids_tpu_torch`` on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and
prints, as the last line of standard output, one JSON object: whether
every query's rows were exact (``correct``), the queries sent and how
many failed, the cell's end-to-end metrics (``--trace 0``) or per-layer
metrics (``--trace 1``, with ``breakdown``), the card, and the numbers
compared against their limits (``checks``, also the last lines of
standard error). Exits non-zero with no result line where the card is
missing, the run fails, or a module of the JAX side was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program is imported from the checkout; transformers, if anything
# imports it, must not load flax (and with it JAX)
os.environ["USE_FLAX"] = "0"
# a few threads in each native pool (OpenMP, BLAS, torch, Arrow), set
# before any of them loads: the streams and the program's own threads
# share the host's cores, and a pool as wide as the host under each of
# them oversubscribes it and spreads the runs
HOST_THREADS = 2
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(HOST_THREADS)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    import pyarrow
    import torch
    torch.set_num_threads(HOST_THREADS)
    torch.set_num_interop_threads(HOST_THREADS)
    pyarrow.set_cpu_count(HOST_THREADS)
    pyarrow.set_io_thread_count(HOST_THREADS)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of the JAX side were loaded: {loaded}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
