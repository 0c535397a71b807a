"""What the benchmark's files may import, that a cell, a traffic mix and
a metric are found by name, and how run.py exits without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
from conftest import BENCH, ROOT, bench_with_held

# none of the benchmark may load the JAX side, and nothing it runs reads
# the scripts that measured the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "spark_rapids_tpu", "bench",
             "chip_smoke"}


def sources():
    for d, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_the_jax_side():
    found = {(os.path.relpath(p, BENCH), m) for p in sources()
             for m in top_level_imports(p) if m in FORBIDDEN}
    assert not found


def test_references_import_nothing_of_the_port():
    ref = os.path.join(BENCH, "reference")
    found = {(f, m) for f in os.listdir(ref) if f.endswith(".py")
             for m in top_level_imports(os.path.join(ref, f))
             if m == "spark_rapids_tpu_torch"}
    assert not found
    # whole top-level names: the port's name begins with the JAX one's
    assert "spark_rapids_tpu_torch" not in FORBIDDEN


@pytest.mark.parametrize("held", [False, True])
def test_benchmark_json_names_files_that_exist(held):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if held:
        # the held cells go back in whole
        bench = bench_with_held()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    # each cell reports the end-to-end metric its per-layer metrics move
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        e2e = {m["name"] for m in spec["end_to_end"]}
        assert {"setup_s"} < e2e and spec["per_layer"]
        assert {m["moves"] for m in spec["per_layer"]} <= e2e


def copy_benchmark(tmp_path, with_program=True):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    if with_program:
        os.symlink(os.path.join(ROOT, "spark_rapids_tpu_torch"),
                   root / "spark_rapids_tpu_torch")
    return root


DRIVE = """
import json, sys, time
sys.path[:0] = [sys.argv[1] + "/benchmark", sys.argv[1]]
import torch
torch.set_num_threads(2)
import harness
print(json.dumps(harness.run_cell(sys.argv[2], 5, 1.5, True, "cpu",
                                  time.perf_counter(), scale=0.005)))
"""


def test_new_traffic_and_metric_files_are_found_by_name(tmp_path):
    """A later cell and metric come as files and entries alone."""
    root = copy_benchmark(tmp_path)
    with open(root / "benchmark/traffic/q1.parquet.streams2.json") as f:
        mix = json.load(f)
    mix["streams"] = 1
    with open(root / "benchmark/traffic/q1.parquet.streams1.json", "w") as f:
        json.dump(mix, f)
    (root / "benchmark/metrics/window_queries.py").write_text(
        "def read(run):\n    return float(len(run.window))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tpch_q1.parquet.streams1",
                               "config": "tpch_sf1",
                               "traffic": "q1.parquet.streams1",
                               "chips": 1, "why": "one stream"})
    bench["per_layer"].append({"name": "window_queries", "unit": "queries",
                               "better": "higher",
                               "source": "host_clock", "layer": "Device",
                               "moves": "queries_per_s",
                               "workloads": ["tpch_q1.parquet.streams1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", DRIVE, str(root),
                          "tpch_q1.parquet.streams1"], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["window_queries"]["value"] >= 1
    assert "decode_fused_roofline" not in result["metrics"]


@pytest.mark.parametrize("with_program", [True, False])
def test_run_exits_without_a_result_and_without_a_card(tmp_path,
                                                       with_program):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = copy_benchmark(tmp_path, with_program)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tpch_q1.parquet.streams2", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(root))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
