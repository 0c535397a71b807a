"""The port's cross-process shuffle leg (``parallel/external_shuffle.py``)
and ``spark.rapids.shuffle.mode=external``, held against the JAX
package's (``tests/test_external_shuffle.py``).

A real second process that imports only the port writes the map outputs;
this process reads them back with the port and with the JAX package (the
SRTB files are byte-compatible both ways). A query under
``shuffle.mode=external`` must give the in-process rows and the JAX
package's external rows, with ``externalShuffleBytes`` counted.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spark_rapids_tpu.parallel import external_shuffle as JXS
from spark_rapids_tpu.sql import expressions as JE
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import physical as JP
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.parallel import external_shuffle as XS
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows, _sort_key
from tests.torch_dual import port_batch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _expected(n=5000):
    rng = np.random.default_rng(7)
    k = rng.integers(0, 1000, n)
    return sorted(zip(k.tolist(), [f"v{i % 37}" for i in range(n)]))


def test_two_process_shuffle_roundtrip(tmp_path):
    """A second process that imports only the port partitions rows by
    the port's murmur3 and writes SRTB files (zstd); this process reads
    every partition with the port and with the JAX package: the same
    batches, every row in its murmur3 partition, the union exact."""
    sdir = str(tmp_path / "shuffle")
    writer = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import torch
        from spark_rapids_tpu_torch.columnar.host import (HostBatch,
                                                          HostColumn)
        from spark_rapids_tpu_torch.columnar.device import DeviceColumn
        from spark_rapids_tpu_torch.ops import hashing as H
        from spark_rapids_tpu_torch.parallel import external_shuffle as XS
        from spark_rapids_tpu_torch.sql import types as T
        rng = np.random.default_rng(7)
        n = 5000
        schema = T.StructType([T.StructField("k", T.LongT),
                               T.StructField("s", T.StringT)])
        k = rng.integers(0, 1000, n)
        s = np.array([f"v{{i % 37}}" for i in range(n)], dtype=object)
        batch = HostBatch(schema, [HostColumn.all_valid(k, T.LongT),
                                   HostColumn.all_valid(s, T.StringT)], n)
        col = DeviceColumn(T.LongT, torch.from_numpy(k),
                           torch.ones(n, dtype=torch.bool))
        pids = H.partition_ids([col], n, 4).numpy()
        parts = [[batch.take(np.nonzero(pids == p)[0])] for p in range(4)]
        XS.write_map_output({sdir!r}, "A", parts, codec="zstd")
        print("WROTE", sum(p[0].num_rows for p in parts),
              "JAX" if any(m.startswith(("jax", "spark_rapids_tpu."))
                           or m == "spark_rapids_tpu"
                           for m in sys.modules) else "NOJAX")
    """)
    r = subprocess.run([sys.executable, "-c", writer],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WROTE 5000 NOJAX" in r.stdout, r.stdout

    assert XS.map_outputs_done(sdir) == JXS.map_outputs_done(sdir) == ["A"]
    part = JP.HashPartitioning([JE.AttributeReference("k", JT.LongT)], 4)
    bound = [JE.BoundReference(0, JT.LongT, True)]
    got = []
    for pid in range(4):
        mine = XS.read_partition(sdir, pid)
        theirs = JXS.read_partition(sdir, pid)
        assert [b.to_pydict() for b in mine] == \
            [b.to_pydict() for b in theirs]
        for hb in theirs:
            assert (part.partition_ids(hb, bound) == pid).all()
        for hb in mine:
            got.extend(zip(hb.columns[0].data.tolist(),
                           hb.columns[1].data.tolist()))
    assert sorted(got) == _expected()


def test_jax_package_files_read_by_the_port(tmp_path):
    """The other direction: SRTB files the JAX package writes read back
    through the port unchanged, every codec."""
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    schema = JT.StructType([JT.StructField("k", JT.LongT, True),
                            JT.StructField("s", JT.StringT, True)])
    hb = JHostBatch.from_pydict(
        {"k": [1, None, 3, 4], "s": ["a", "bb", None, ""]}, schema)
    for codec in ("none", "zlib", "zstd"):
        sdir = str(tmp_path / codec)
        JXS.write_map_output(sdir, "m", [[hb], [], [hb, hb]], codec)
        assert XS.map_outputs_done(sdir) == ["m"]
        assert XS.read_partition(sdir, 1) == []
        assert [b.to_pydict() for b in XS.read_partition(sdir, 2)] == \
            [hb.to_pydict()] * 2
        assert XS.read_partition(sdir, 0)[0].to_pydict() == hb.to_pydict()


@pytest.mark.parametrize("codec", ["zstd", "none"])
def test_external_shuffle_mode_dual_session(codec):
    """shuffle.mode=external routes every device exchange through the
    SRTB files: the in-process rows and the JAX package's external rows,
    with externalShuffleBytes counted."""
    data = {"k": [i % 23 for i in range(3000)], "v": list(range(3000))}

    def q(s, f):
        df = s.createDataFrame(data, "k int, v long", num_partitions=3)
        return df.groupBy("k").agg(f.sum("v").alias("sv"),
                                   f.count("v").alias("cv")).orderBy("k")

    conf = {"spark.rapids.shuffle.mode": "external",
            "spark.rapids.shuffle.compression.codec": codec}

    def port(c):
        s = TorchSparkSession(c, device="cpu")
        try:
            s.start_capture()
            rows = _rows(q(s, F)._execute().to_pydict())
            return rows, s.get_captured_plans()
        finally:
            s.stop()

    got, plans = port(conf)
    inproc, _ = port({})
    js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled": "true"}))
    try:
        want = _rows(q(js, JF)._execute().to_pydict())
    finally:
        js.stop()
    assert got == inproc == want
    metrics = {}
    for p in plans:
        for k, v in plan_metrics(p).items():
            metrics[k] = metrics.get(k, 0) + v
    assert metrics["externalShuffleBytes"] > 0
    assert metrics["externalShuffleWriteTime"] > 0
    assert metrics["externalShuffleReadTime"] > 0


def test_external_shuffle_q3_shape_join():
    """A join with both sides shuffled through the external leg gives the
    in-process rows (every exchange of the plan takes the leg)."""
    def q(s):
        left = s.createDataFrame(
            {"k": [i % 13 for i in range(400)], "v": list(range(400))},
            "k long, v long", num_partitions=4)
        right = s.createDataFrame(
            {"k2": [i % 13 for i in range(60)], "w": list(range(60))},
            "k2 long, w long", num_partitions=2)
        return (left.join(right, F.col("k") == F.col("k2"), "inner")
                .groupBy("k").agg(F.count("*").alias("c"),
                                  F.sum("w").alias("sw")).orderBy("k"))

    out = []
    for mode in ("external", "inprocess"):
        s = TorchSparkSession({
            "spark.rapids.shuffle.mode": mode,
            "spark.rapids.sql.autoBroadcastJoinThreshold": "-1"},
            device="cpu")
        try:
            out.append(sorted(_rows(q(s)._execute().to_pydict()),
                              key=_sort_key))
        finally:
            s.stop()
    assert out[0] == out[1] and len(out[0]) == 13


def test_port_hostbatch_roundtrip_matches_jax_bytes(tmp_path):
    """The port's writer produces the JAX writer's bytes for the same
    batch and codec."""
    from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
    schema = JT.StructType([JT.StructField("k", JT.LongT, True),
                            JT.StructField("s", JT.StringT, True)])
    hb = JHostBatch.from_pydict(
        {"k": [7, None, -3], "s": ["x", None, "yz"]}, schema)
    for codec in ("none", "zlib"):
        a, b = str(tmp_path / ("j" + codec)), str(tmp_path / ("p" + codec))
        JXS.write_map_output(a, "0", [[hb]], codec)
        XS.write_map_output(b, "0", [[port_batch(hb)]], codec)
        with open(os.path.join(a, "map0_part0.srtb"), "rb") as f1, \
                open(os.path.join(b, "map0_part0.srtb"), "rb") as f2:
            assert f1.read() == f2.read()
