"""The port's mesh (``spark_rapids_tpu_torch/parallel/``) on 8 emulated
``cpu`` chips, held against the JAX package's mesh on the 8 host devices
its conftest forces: the counterparts of ``tests/test_multichip.py``.

The same seeded inputs go through both packages. ``mesh_exchange`` must
give every partition the JAX mesh's rows in the JAX mesh's order, and a
query over the mesh the JAX mesh's rows, its in-process rows and the
JAX package's CPU engine's rows; the mesh counters (``numIciExchanges``,
``meshScanUnits.chip<N>``, ``dispatchCount.chip<N>``, ``meshPadWaste``)
must show the mesh ran. Every test restores the active mesh and the chip
emulation it found (the ``_mesh_state`` fixture), so the file is safe
under ``-n 6 --dist loadfile``.
"""

import os
import threading
import time
from decimal import Decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.metrics import sum_plan_metrics
from spark_rapids_tpu.parallel import active_mesh as jactive_mesh
from spark_rapids_tpu.parallel import build_mesh as jbuild_mesh
from spark_rapids_tpu.parallel import ici as JICI
from spark_rapids_tpu.sql import expressions as JE
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.columnar.device import (DeviceBatch,
                                                    batch_device)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.parallel import ici as ICI
from spark_rapids_tpu_torch.parallel import mesh as PM
from spark_rapids_tpu_torch.parallel.step import (dryrun_multichip,
                                                  sum_count_step)
from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from spark_rapids_tpu.sql import functions as JF
from tests.harness import _rows, _sort_key
from tests.test_multichip import _Unit, _write_scan_table
from tests.torch_dual import port_batch

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _mesh_state():
    """8 emulated cpu chips for the test; the active mesh and the
    emulation it found are restored after it."""
    prev_mesh, prev_em = PM.get_active_mesh(), PM.emulated_chips()
    PM.emulate_chips(8, CPU)
    PM.set_active_mesh(None)
    yield
    PM.set_active_mesh(prev_mesh)
    PM.emulate_chips(*prev_em) if prev_em else PM.emulate_chips(None)


@pytest.fixture
def mesh8():
    return PM.build_mesh(8)


@pytest.fixture(scope="module")
def jmesh8():
    return jbuild_mesh(8)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _slots(rng, jschema, n_dev, gen_row):
    """The same per-chip slots for both packages: ``(jax slots, port
    HostBatches, all rows)``."""
    jslots, hosts, all_rows = [], [], []
    for _ in range(n_dev):
        n = int(rng.integers(1, 60))
        rows = [gen_row(rng) for _ in range(n)]
        all_rows.extend(rows)
        cols = {f.name: [r[i] for r in rows]
                for i, f in enumerate(jschema.fields)}
        hb = JHostBatch.from_pydict(cols, jschema)
        jslots.append(JDeviceBatch.from_host(hb))
        hosts.append(port_batch(hb))
    return jslots, hosts, all_rows


def _port_slots(hosts, mesh):
    return [DeviceBatch.from_host(hb, c.device)
            for hb, c in zip(hosts, mesh.chips)]


def _partition_rows(out):
    """Per partition, its rows in order."""
    return [[row for b in bs for row in _rows(b.to_host().to_pydict())]
            for bs in out]


def _port_collect(q, conf=None, mesh=None):
    """``(rows, plans)`` of ``q`` on a port session on the CPU, under
    ``mesh`` when given."""
    s = TorchSparkSession(dict(conf or {}), device="cpu")
    try:
        s.start_capture()
        if mesh is not None:
            with PM.active_mesh(mesh):
                rows = _rows(q(s, F)._execute().to_pydict())
        else:
            rows = _rows(q(s, F)._execute().to_pydict())
        return rows, s.get_captured_plans()
    finally:
        s.stop()


def _jax_collect(q, conf=None, mesh=None, enabled=True):
    s = TpuSparkSession(dict(conf or {}, **{
        "spark.rapids.sql.enabled": "true" if enabled else "false"}))
    try:
        s.start_capture()
        if mesh is not None:
            with jactive_mesh(mesh):
                rows = _rows(q(s, JF)._execute().to_pydict())
        else:
            rows = _rows(q(s, JF)._execute().to_pydict())
        return rows, s.get_captured_plans()
    finally:
        s.stop()


def _sum_metric(plans, prefix):
    out = {}
    for p in plans:
        for k, v in plan_metrics(p).items():
            if k.startswith(prefix):
                out[k] = out.get(k, 0) + v
    return out


def _canon(rows):
    return sorted(rows, key=_sort_key)


def _assert_all_paths(q, conf=None, ordered=False, mesh=None, jmesh=None):
    """Port mesh == port in-process == JAX mesh == JAX CPU engine; returns
    the port mesh run's plans."""
    conf = dict(conf or {})
    mesh_conf = dict(conf) if mesh is not None else dict(
        conf, **{"spark.rapids.shuffle.mode": "ici"})
    got, plans = _port_collect(q, mesh_conf, mesh)
    inproc, _ = _port_collect(
        q, {k: v for k, v in conf.items()
            if k != "spark.rapids.shuffle.mode"})
    jmesh_rows, _ = _jax_collect(q, mesh_conf, jmesh)
    cpu, _ = _jax_collect(q, conf, enabled=False)
    norm = (lambda r: r) if ordered else _canon
    assert norm(got) == norm(inproc), "mesh path diverged from in-process"
    assert norm(got) == norm(jmesh_rows), "port mesh diverged from JAX mesh"
    assert norm(got) == norm(cpu), "port mesh diverged from CPU engine"
    return plans


# ---------------------------------------------------------------------------
# mesh_exchange and the fused step
# ---------------------------------------------------------------------------

def test_mesh_exchange_matches_cpu_partitioning(mesh8, jmesh8):
    """Every row lands in the partition CPU Spark's pmod(murmur3(key, 42),
    n) puts it in, partition p on chip p % n, each partition's rows in the
    JAX mesh's order."""
    jschema = JT.StructType([JT.StructField("k", JT.LongT),
                             JT.StructField("s", JT.StringT)])
    jslots, hosts, all_rows = _slots(
        np.random.default_rng(3), jschema, 8,
        lambda r: (int(r.integers(-1000, 1000)),
                   "v%d" % r.integers(0, 99)))
    n_parts = 16
    out = ICI.mesh_exchange(_port_slots(hosts, mesh8),
                            [E.BoundReference(0, T.LongT, True)], n_parts,
                            mesh8)
    jout = JICI.mesh_exchange(jslots, [JE.BoundReference(0, JT.LongT, True)],
                              n_parts, jmesh8)
    assert _partition_rows(out) == _partition_rows(jout)
    hb = JHostBatch.from_pydict(
        {"k": [r[0] for r in all_rows], "s": [r[1] for r in all_rows]},
        jschema)
    hv = JE.Murmur3Hash([JE.BoundReference(0, JT.LongT, True)]).eval(hb) \
        .data.astype(np.int64)
    pids = np.mod(hv, n_parts)
    for p, bs in enumerate(out):
        want = sorted(all_rows[i] for i in np.nonzero(pids == p)[0])
        assert sorted(_partition_rows([bs])[0]) == want, f"partition {p}"
        assert all(batch_device(b) == p % 8 for b in bs)


def test_mesh_exchange_null_keys(mesh8, jmesh8):
    """Null-keyed rows are routed, not dropped, to the JAX mesh's
    partitions."""
    jschema = JT.StructType([JT.StructField("k", JT.LongT, True)])
    rng = np.random.default_rng(11)
    jslots, hosts, total = [], [], 0
    for _ in range(8):
        vals = [None if rng.random() < 0.3 else int(rng.integers(0, 10))
                for _ in range(int(rng.integers(1, 40)))]
        total += len(vals)
        hb = JHostBatch.from_pydict({"k": vals}, jschema)
        jslots.append(JDeviceBatch.from_host(hb))
        hosts.append(port_batch(hb))
    out = ICI.mesh_exchange(_port_slots(hosts, mesh8),
                            [E.BoundReference(0, T.LongT, True)], 8, mesh8)
    jout = JICI.mesh_exchange(jslots, [JE.BoundReference(0, JT.LongT, True)],
                              8, jmesh8)
    assert sum(b.row_count() for bs in out for b in bs) == total
    assert _partition_rows(out) == _partition_rows(jout)


def test_sum_count_step(mesh8, jmesh8):
    """The fused partial -> all-to-all -> final step gives the exact
    global answer with each key on one chip, the JAX step's keys on the
    JAX step's chips."""
    assert len(dryrun_multichip(8)) == 13
    assert len(dryrun_multichip(2)) == 13
    import jax
    import jax.numpy as jnp
    from spark_rapids_tpu.parallel.mesh import shard_leading
    from spark_rapids_tpu.parallel.step import \
        sum_count_step as jsum_count_step
    rng = np.random.default_rng(7)
    cap = 64
    keys = rng.integers(0, 13, (8, cap)).astype(np.int64)
    vals = rng.integers(-5, 20, (8, cap)).astype(np.int64)
    active = rng.random((8, cap)) < 0.8
    sh = shard_leading(jmesh8, 2)
    jout = jsum_count_step(jmesh8)(
        *(jax.device_put(jnp.asarray(a), sh) for a in (keys, vals, active)))
    out = sum_count_step(mesh8)(
        [torch.from_numpy(k) for k in keys],
        [torch.from_numpy(v) for v in vals],
        [torch.from_numpy(a) for a in active])
    for d in range(8):
        jk, js, jc, ja = (np.asarray(a)[d] for a in jout)
        pk, ps, pc, pa = (t.numpy() for t in out[d])
        jrows = sorted(zip(jk[ja], js[ja], jc[ja]))
        prows = sorted(zip(pk[pa], ps[pa], pc[pa]))
        assert prows == jrows, f"chip {d}"


# ---------------------------------------------------------------------------
# queries over the mesh
# ---------------------------------------------------------------------------

def _agg_data():
    return {"k": [int(x) for x in
                  np.random.default_rng(5).integers(0, 25, 500)],
            "v": [int(x) for x in
                  np.random.default_rng(6).integers(-100, 100, 500)]}


def test_engine_aggregate_over_mesh(mesh8, jmesh8):
    data = _agg_data()

    def q(s, f):
        df = s.createDataFrame(data, "k long, v long", num_partitions=6)
        return df.groupBy("k").agg(
            f.sum("v").alias("s"), f.count("v").alias("c"),
            f.min("v").alias("mn"), f.max("v").alias("mx"))

    plans = _assert_all_paths(q, mesh=mesh8, jmesh=jmesh8)
    assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] >= 1


def test_engine_strings_over_mesh(mesh8, jmesh8):
    rng = np.random.default_rng(9)
    data = {"name": ["u%02d" % x for x in rng.integers(0, 30, 400)],
            "v": [int(x) for x in rng.integers(0, 1000, 400)]}

    def q(s, f):
        df = s.createDataFrame(data, "name string, v long",
                               num_partitions=5)
        return df.groupBy("name").agg(f.sum("v").alias("s"))

    plans = _assert_all_paths(q, mesh=mesh8, jmesh=jmesh8)
    assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] >= 1


def test_mesh_matches_inprocess_path(mesh8, jmesh8):
    """The mesh exchange and the in-process exchange give the same
    partition contents (transport equivalence)."""
    data = {"k": [int(x) for x in
                  np.random.default_rng(2).integers(0, 50, 300)],
            "v": list(range(300))}

    def q(s, f):
        df = s.createDataFrame(data, "k long, v long", num_partitions=4)
        return df.groupBy("k").agg(f.sum("v").alias("s"))

    _assert_all_paths(q, mesh=mesh8, jmesh=jmesh8)
    assert PM.get_active_mesh() is None
    got, plans = _port_collect(q)
    assert not _sum_metric(plans, "numIciExchanges")


def test_shuffle_mode_ici_conf_activates_mesh():
    """spark.rapids.shuffle.mode=ici activates the mesh at session start
    (no test-side active_mesh), the exchange takes the mesh path, and
    stop() tears the mesh down."""
    from tests.datagen import LongGen, SmallIntGen, gen_batch
    assert PM.get_active_mesh() is None
    spark = TorchSparkSession({"spark.rapids.shuffle.mode": "ici"},
                              device="cpu")
    try:
        assert PM.mesh_size(PM.get_active_mesh()) == 8
        spark.start_capture()
        df = spark.createDataFrame(
            port_batch(gen_batch([("k", SmallIntGen()), ("v", LongGen())],
                                 3000, 77)), num_partitions=4)
        got = _rows(df.groupBy("k").agg(F.sum("v").alias("s"),
                                         F.count("*").alias("c"))
                    ._execute().to_pydict())
        plans = spark.get_captured_plans()
        assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] > 0
    finally:
        spark.stop()
    assert PM.get_active_mesh() is None
    cpu = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        df = cpu.createDataFrame(
            gen_batch([("k", SmallIntGen()), ("v", LongGen())], 3000, 77),
            num_partitions=4)
        want = _rows(df.groupBy("k").agg(JF.sum("v").alias("s"),
                                         JF.count("*").alias("c"))
                     ._execute().to_pydict())
    finally:
        cpu.stop()
    assert _canon(got) == _canon(want)


def test_join_over_mesh():
    """A shuffled hash join whose two exchanges ride the mesh."""
    def q(s, f):
        return (s.createDataFrame(
            {"k": [i % 13 for i in range(400)], "v": list(range(400))},
            "k long, v long", num_partitions=4)
            .join(s.createDataFrame(
                {"k2": [i % 13 for i in range(60)], "w": list(range(60))},
                "k2 long, w long", num_partitions=2),
                f.col("k") == f.col("k2"), "inner")
            .groupBy("k").agg(f.count("*").alias("c"),
                              f.sum("w").alias("sw")).orderBy("k"))

    plans = _assert_all_paths(
        q, {"spark.rapids.sql.autoBroadcastJoinThreshold": "-1"},
        ordered=True)
    assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] >= 2


def test_sort_over_mesh():
    """A global orderBy under ici: the hash exchanges ride the mesh, the
    range exchange stays in-process; ordered rows match."""
    def q(s, f):
        return (s.createDataFrame(
            {"k": [i % 7 for i in range(500)],
             "v": [(i * 37) % 211 for i in range(500)]},
            "k long, v long", num_partitions=4)
            .groupBy("k").agg(f.sum("v").alias("s"))
            .orderBy(f.col("s").desc(), "k"))

    _assert_all_paths(q, ordered=True)


def test_q1_shape_over_mesh():
    """The q1 shape (filter -> decimal aggregate -> orderBy) over the
    8-chip mesh."""
    def q(s, f):
        rng = np.random.default_rng(12)
        n = 1200
        s.createDataFrame(
            {"l_returnflag": [["A", "N", "R"][i % 3] for i in range(n)],
             "l_linestatus": [["O", "F"][i % 2] for i in range(n)],
             "l_quantity": [Decimal(int(v)) for v in
                            rng.integers(1, 51, n)],
             "l_extendedprice": [Decimal(int(v)).scaleb(-2) for v in
                                 rng.integers(90100, 10494951, n)],
             "l_discount": [Decimal(int(v)).scaleb(-2) for v in
                            rng.integers(0, 11, n)],
             "l_shipdate": rng.integers(8000, 10500, n).tolist()},
            "l_returnflag string, l_linestatus string, "
            "l_quantity decimal(15,2), l_extendedprice decimal(15,2), "
            "l_discount decimal(15,2), l_shipdate int",
            num_partitions=4).createOrReplaceTempView("lineitem")
        return s.sql(
            "SELECT l_returnflag, l_linestatus, sum(l_quantity) sq, "
            "sum(l_extendedprice * (1 - l_discount)) sd, "
            "avg(l_discount) ad, count(*) c FROM lineitem "
            "WHERE l_shipdate <= 10000 "
            "GROUP BY l_returnflag, l_linestatus "
            "ORDER BY l_returnflag, l_linestatus")

    plans = _assert_all_paths(q, ordered=True)
    assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] >= 1


# ---------------------------------------------------------------------------
# the mesh-sharded scan
# ---------------------------------------------------------------------------

def test_shard_units_by_bytes_balances_skew():
    from spark_rapids_tpu.io.readers import \
        shard_units_by_bytes as jshard
    from spark_rapids_tpu_torch.io.readers import shard_units_by_bytes
    rng = np.random.default_rng(4)
    sizes = [int(s) for s in rng.integers(1, 1_000_000, 37)]
    units = [_Unit(s) for s in sizes]
    streams = shard_units_by_bytes(units, 8)
    assert sum(len(st) for st in streams) == 37
    loads = [sum(u.size_bytes for u in st) for st in streams]
    assert max(loads) - min(loads) <= max(sizes)
    assert [[units.index(u) for u in st] for st in streams] == \
        [[units.index(u) for u in st] for st in jshard(units, 8)]


def test_shard_units_by_bytes_fewer_units_than_streams():
    from spark_rapids_tpu_torch.io.readers import shard_units_by_bytes
    streams = shard_units_by_bytes([_Unit(10), _Unit(20)], 8)
    assert sum(len(st) for st in streams) == 2
    assert len(streams) == 8  # empty streams are kept
    assert sum(1 for st in streams if not st) == 6


def test_shard_units_by_bytes_zero_byte_units_spread():
    from spark_rapids_tpu_torch.io.readers import shard_units_by_bytes
    streams = shard_units_by_bytes([_Unit(0) for _ in range(8)], 4)
    assert [len(st) for st in streams] == [2, 2, 2, 2]


def _scan_table(tmp_path, name, n_files, rows_per_file=80):
    path = os.path.join(str(tmp_path), name)
    gen = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        _write_scan_table(gen, path, n_files, rows_per_file)
    finally:
        gen.stop()
    return path


def _scan_agg(path):
    def q(s, f):
        df = s.read.parquet(path)
        return (df.where(f.col("v") > -400).groupBy("k")
                .agg(f.sum("v").alias("sv"), f.count("*").alias("c"),
                     f.max("s").alias("mx"))
                .orderBy("k"))
    return q


def _jax_units(q):
    _rows_, jplans = _jax_collect(q, {"spark.rapids.shuffle.mode": "ici"})
    return sum_plan_metrics(jplans, "meshScanUnits.chip")


def test_mesh_scan_units_not_divisible_by_mesh(tmp_path):
    """11 scan units over 8 chips: uneven streams, the same rows, the
    JAX mesh scan's per-chip unit counts."""
    q = _scan_agg(_scan_table(tmp_path, "t11", 11))
    plans = _assert_all_paths(q, ordered=True)
    units = _sum_metric(plans, "meshScanUnits.chip")
    assert len(units) == 8 and sum(units.values()) == 11
    assert all(v >= 1 for v in units.values())
    assert units == _jax_units(q)


def test_mesh_scan_chip_with_zero_units(tmp_path):
    """2 scan units over 8 chips: six chips get none and still yield
    their (empty) partitions."""
    q = _scan_agg(_scan_table(tmp_path, "t2", 2))
    plans = _assert_all_paths(q, ordered=True)
    units = _sum_metric(plans, "meshScanUnits.chip")
    assert sum(units.values()) == 2
    assert sum(1 for v in units.values() if v == 0) == 6
    assert units == _jax_units(q)


def test_mesh_scan_empty_relation(tmp_path):
    """Pushdown prunes every row group: zero units on every chip, the
    same (empty) answer everywhere."""
    path = _scan_table(tmp_path, "tempty", 3)

    def q(s, f):
        return (s.read.parquet(path).where(f.col("v") > 10_000)
                .groupBy("k").agg(f.sum("v").alias("sv")).orderBy("k"))
    _assert_all_paths(q, ordered=True)


def test_mesh_scan_batches_resident_per_chip(tmp_path):
    """Every chip scans units and runs programs on its own resident
    batches (every dispatchCount.chip<N> above 0), each batch's chip and
    its tensors' device agree, and the exchange reports meshPadWaste."""
    q = _scan_agg(_scan_table(tmp_path, "t16", 16, rows_per_file=200))
    seen = []
    orig = ICI.stack_batches

    def spy(slots, mesh):
        for b in slots:
            chip = batch_device(b)
            if chip is not None:
                seen.append((chip, b.device, mesh.chip(chip).device))
        return orig(slots, mesh)

    ICI.stack_batches = spy
    try:
        rows, plans = _port_collect(q, {"spark.rapids.shuffle.mode": "ici"})
    finally:
        ICI.stack_batches = orig
    units = _sum_metric(plans, "meshScanUnits.chip")
    assert len(units) == 8 and all(v >= 1 for v in units.values())
    dispatch = _sum_metric(plans, "dispatchCount.chip")
    assert len(dispatch) == 8 and all(v >= 1 for v in dispatch.values()), \
        dispatch
    assert "meshPadWaste" in _sum_metric(plans, "meshPadWaste")
    assert sorted(c for c, _d, _m in seen) == list(range(8))
    assert all(d == m for _c, d, m in seen)
    jrows, _ = _jax_collect(q, {"spark.rapids.shuffle.mode": "ici"})
    assert rows == jrows


def test_multichip_scan_disabled_falls_back(tmp_path):
    """multichip.scan.enabled=false: the mesh exchange still runs but the
    scan stays one stream (no per-chip unit counters)."""
    q = _scan_agg(_scan_table(tmp_path, "tdis", 8))
    rows, plans = _port_collect(q, {
        "spark.rapids.shuffle.mode": "ici",
        "spark.rapids.sql.multichip.scan.enabled": "false"})
    assert not _sum_metric(plans, "meshScanUnits.chip")
    assert _sum_metric(plans, "numIciExchanges")["numIciExchanges"] >= 1
    cpu, _ = _jax_collect(q, enabled=False)
    assert rows == cpu


def test_collective_section_serializes_served_queries():
    """Served sessions' mesh exchange sections exclude each other;
    non-served sessions and the conf-off case skip the mutex; the section
    is reentrant on one thread."""
    def max_overlap(conf, workers=4):
        state = {"inside": 0, "peak": 0}
        lock = threading.Lock()
        start = threading.Barrier(workers)

        def worker():
            start.wait()
            with PM.collective_section(conf):
                with lock:
                    state["inside"] += 1
                    state["peak"] = max(state["peak"], state["inside"])
                time.sleep(0.03)
                with lock:
                    state["inside"] -= 1

        ts = [threading.Thread(target=worker) for _ in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        return state["peak"]

    served = TorchConf({"spark.rapids.sql.serve.tenantId": "t1"})
    assert max_overlap(served) == 1
    off = TorchConf({
        "spark.rapids.sql.serve.tenantId": "t1",
        "spark.rapids.sql.multichip.serializeServedQueries": "false"})
    assert max_overlap(off) > 1
    assert max_overlap(TorchConf({})) > 1
    with PM.collective_section(served):
        with PM.collective_section(served):
            pass


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_build_mesh_raises_past_the_visible_chips():
    """As the JAX package's build_mesh: asking for more chips than are
    visible raises; emulation off leaves one cpu chip for a CPU
    caller."""
    with pytest.raises(ValueError, match="requested 9 devices, only 8"):
        PM.build_mesh(9)
    PM.emulate_chips(None)
    assert [c.device.type for c in PM.visible_chips("cpu")] == ["cpu"]
    assert PM.mesh_size(PM.build_mesh(None, PM.visible_chips("cpu"))) == 1


def test_batch_to_device_keeps_rows_and_sets_chip(mesh8):
    """Moving a batch between chips keeps its rows and names the new chip;
    between emulated chips its tensors are not copied."""
    from spark_rapids_tpu_torch.columnar.device import batch_to_device
    hb = HostBatch.from_pydict({"k": [1, None, 3]},
                               T.StructType([T.StructField("k", T.LongT)]))
    b = DeviceBatch.from_host(hb, CPU)
    moved = batch_to_device(b, mesh8.chips[5])
    assert batch_device(moved) == 5 and batch_device(b) is None
    assert moved.active is b.active
    assert moved.to_host().to_pydict() == {"k": [1, None, 3]}
