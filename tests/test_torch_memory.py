"""The port's spill store and disk-tier format
(``spark_rapids_tpu_torch/memory.py``, ``columnar/serde.py``) held against
the JAX package's (``tests/test_memory_spill.py``'s cases) on the CPU.

Queries run through both packages on the same seeded numpy inputs under
the same tiny device pool: the rows must be equal (exact), and the port's
store must have spilled. The serialized bytes of a batch must be the JAX
package's, byte for byte, for every codec, and each tier (device, host,
disk) must give back exactly the rows it took.
"""

import glob
import math
from decimal import Decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import serde as jserde
from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import memory as MEM
from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

CPU = torch.device("cpu")
TINY_POOL = {"spark.rapids.memory.tpu.poolSize": str(64 << 10)}


def _long_batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return HostBatch.from_pydict(
        {"v": [int(x) for x in rng.integers(0, 1 << 40, n)]},
        T.StructType([T.StructField("v", T.LongT)]))


def _device(hb):
    return DeviceBatch.from_host(hb, CPU)


def _run_both(df_fn, conf, tmp_path, ordered=False):
    """(JAX rows, port rows, port plan metrics, port store) of
    ``df_fn(session, functions)`` under ``conf``; the port's spill files
    go under ``tmp_path``."""
    jax_s = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled":
                                          "true"}))
    try:
        want = [tuple(r) for r in df_fn(jax_s, JF).collect()]
    finally:
        jax_s.stop()
    conf = dict(conf, **{"spark.rapids.memory.spillDirectory":
                         str(tmp_path)})
    port = TorchSparkSession(conf, device="cpu")
    got = [tuple(r) for r in df_fn(port, PF).collect()]
    store = MEM.get_device_store(port.conf_obj)
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    return want, got, plan_metrics(port.last_plan), store, port.last_plan


def _gen(columns, n, seed):
    """Seeded columns: ``(name, kind)`` with kind small, int, long."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, kind in columns:
        if kind == "small":
            vals = rng.integers(0, 50, n)
        elif kind == "int":
            vals = rng.integers(-2**31, 2**31, n)
        else:
            vals = rng.integers(-2**62, 2**62, n)
        valid = rng.random(n) > 0.05
        out[name] = [int(v) if ok else None for v, ok in zip(vals, valid)]
    ddl = ", ".join(f"{n} {'int' if k in ('small', 'int') else 'bigint'}"
                    for n, k in columns)
    return out, ddl


# ---------------------------------------------------------------------------
# The store's tiers
# ---------------------------------------------------------------------------

def test_store_spills_lru_and_repromotes(tmp_path):
    hbs = [_long_batch(256, s) for s in (1, 2, 3)]
    bs = [_device(hb) for hb in hbs]
    budget = bs[0].sizeof() * 2 + 10
    store = MEM.DeviceStore(budget, 1 << 30, str(tmp_path))
    handles = [store.register(b, owner="op") for b in bs]
    assert store.spill_count >= 1
    # the per-owner ledger reconciles with the pool
    assert store.owner_stats()["op"] == {"liveBytes": store.device_bytes,
                                         "peakBytes": 3 * bs[0].sizeof()}
    assert handles[0].tier == MEM.TIER_HOST  # least recently used
    assert store.device_bytes <= budget
    out = handles[0].get()  # re-promotes, demotes another
    assert handles[0].tier == MEM.TIER_DEVICE
    assert out.to_host().to_pydict() == hbs[0].to_pydict()
    for h in handles:
        h.close()
    assert store.device_bytes == 0 and store.host_bytes == 0


def test_store_disk_tier(tmp_path):
    hbs = [_long_batch(512, s) for s in (4, 5)]
    b1, b2 = (_device(hb) for hb in hbs)
    store = MEM.DeviceStore(device_budget=b1.sizeof() + 10, host_budget=100,
                            spill_dir=str(tmp_path))
    h1 = store.register(b1)
    h2 = store.register(b2)
    assert store.disk_spill_count >= 1 and h1.tier == MEM.TIER_DISK
    assert h1.get().to_host().to_pydict() == hbs[0].to_pydict()
    h1.close()
    h2.close()
    store.close()
    assert not glob.glob(str(tmp_path / "spill-*.bin"))


def _typed_batch():
    schema = T.StructType([
        T.StructField("i", T.IntegerT), T.StructField("s", T.StringT),
        T.StructField("dec", T.DecimalType(12, 2)),
        T.StructField("big", T.DecimalType(30, 4)),
        T.StructField("d", T.DateT)])
    return HostBatch.from_pydict({
        "i": [1, None, 3, -7],
        "s": ["a", None, "日本語", "x" * 20],
        "dec": [Decimal("12.34"), None, Decimal("-0.05"), Decimal("1.00")],
        "big": [Decimal("123456789012345678901234.5678"), None,
                Decimal("-1.0000"), Decimal("0.0001")],
        "d": [None, 0, 18000, -5]}, schema)


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_every_tier_round_trips_exactly(tmp_path, tier):
    """Strings, 64-bit and two-limb decimals, dates and nulls come back
    from the host and the disk tiers exactly, with the active rows of a
    scattered mask in their order."""
    hb = _typed_batch()
    b = _device(hb)
    keep = torch.tensor([True, False, True, True] + [False] * (
        b.capacity - 4))
    b = DeviceBatch(b.schema, b.columns, b.active & keep, None)
    want = b.to_host().to_pydict()
    store = MEM.DeviceStore(1, 1 << 30 if tier == "host" else 1,
                            str(tmp_path), codec="zlib")
    h = store.register(b)
    other = store.register(_device(_long_batch(64, 9)))
    assert h.tier == (MEM.TIER_HOST if tier == "host" else MEM.TIER_DISK)
    assert h.ever_spilled and h.rows == 3
    back = h.get()
    assert back.to_host().to_pydict() == want
    assert back.capacity <= b.capacity
    h.close()
    other.close()
    store.close()


def test_sizeof_counts_what_the_jax_package_counts():
    """Same rows, same layout: the same bytes, reckoned from shapes."""
    cases = [
        ({"v": [1, 2, None]}, "v bigint"),
        ({"s": ["ab", None, "c" * 30]}, "s string"),
        ({"d": [Decimal("1.5"), None]}, "d decimal(15,2)"),
        ({"d": [Decimal("1.5"), None]}, "d decimal(30,2)"),
    ]
    from spark_rapids_tpu.sql.session import _parse_ddl_schema as jddl

    from spark_rapids_tpu_torch.sql.session import _parse_ddl_schema as pddl
    for data, ddl in cases:
        pb = _device(HostBatch.from_pydict(data, pddl(ddl)))
        jb = JDeviceBatch.from_host(JHostBatch.from_pydict(data, jddl(ddl)))
        assert pb.sizeof() == jb.sizeof(), ddl


# ---------------------------------------------------------------------------
# Serialized format: the JAX package's bytes
# ---------------------------------------------------------------------------

SERDE_DATA = {
    "i": [1, None, 3],
    "d": [1.5, float("nan"), None],
    "s": ["a", None, "日本語"],
    "dec": [Decimal("12.34"), None, Decimal("-0.05")],
    "big": [Decimal("123456789012345678901234.5678"), None,
            Decimal("-1.0000")],
    "arr": [[1, 2], None, []],
}


def _serde_schema(mod):
    return mod.StructType([
        mod.StructField("i", mod.IntegerT), mod.StructField("d", mod.DoubleT),
        mod.StructField("s", mod.StringT),
        mod.StructField("dec", mod.DecimalType(12, 2)),
        mod.StructField("big", mod.DecimalType(30, 4)),
        mod.StructField("arr", mod.ArrayType(mod.LongT))])


@pytest.mark.parametrize("codec", ["none", "zlib", "zstd"])
def test_serde_bytes_identical_to_jax_package(codec):
    batch = HostBatch.from_pydict(SERDE_DATA, _serde_schema(T))
    jbatch = JHostBatch.from_pydict(SERDE_DATA, _serde_schema(JT))
    data = serde.serialize_batch(batch, codec)
    assert data[:4] == b"SRTB"
    assert data == jserde.serialize_batch(jbatch, codec)

    def same(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return (math.isnan(a) and math.isnan(b)) or a == b
        return a == b

    want = batch.to_pydict()
    for back in (serde.deserialize_batch(data).to_pydict(),
                 serde.deserialize_batch(
                     jserde.serialize_batch(jbatch, codec)).to_pydict()):
        assert back.keys() == want.keys()
        for k in want:
            assert all(same(x, y) for x, y in zip(back[k], want[k])), k


def test_serde_rejects_foreign_bytes():
    with pytest.raises(ValueError, match="not a serialized batch"):
        serde.deserialize_batch(b"PK\x03\x04" + bytes(32))
    with pytest.raises(ValueError, match="codec"):
        serde.serialize_batch(_long_batch(4), "lz4")


def test_disk_spill_writes_the_serde_format(tmp_path):
    store = MEM.DeviceStore(device_budget=1, host_budget=1,
                            spill_dir=str(tmp_path), codec="zstd")
    schema = T.StructType([T.StructField("x", T.LongT)])
    hb = HostBatch.from_pydict({"x": list(range(100))}, schema)
    h1 = store.register(_device(hb))
    h2 = store.register(_device(hb))  # evicts h1 to disk
    files = glob.glob(str(tmp_path / "spill-*.bin"))
    assert files
    with open(files[0], "rb") as f:
        head = f.read()
    assert head[:4] == b"SRTB"
    assert serde.deserialize_batch(head).to_pydict() == hb.to_pydict()
    assert h1.get().to_host().to_pydict() == hb.to_pydict()
    h1.close()
    h2.close()


# ---------------------------------------------------------------------------
# Operators under a tiny pool: rows equal to the JAX package's
# ---------------------------------------------------------------------------

def test_exchange_completes_under_tiny_pool_with_spill(tmp_path):
    data, ddl = _gen([("k", "small"), ("v", "long")], 4000, 21)

    def fn(s, F):
        return (s.createDataFrame(data, ddl, num_partitions=4)
                .repartition(8, "k").groupBy("k")
                .agg(F.sum("v").alias("s"), F.count("*").alias("c")))
    want, got, _pm, store, _plan = _run_both(fn, TINY_POOL, tmp_path)
    assert got == want
    assert store.spill_count > 0 and store.peak_device_bytes > 0


def test_global_sort_under_tiny_pool(tmp_path):
    data, ddl = _gen([("a", "long"), ("b", "int")], 3000, 22)

    def fn(s, F):
        return s.createDataFrame(data, ddl, num_partitions=4) \
            .orderBy("a", "b")
    want, got, _pm, store, _plan = _run_both(fn, TINY_POOL, tmp_path,
                                             ordered=True)
    assert got == want
    assert store.spill_count > 0


def test_final_agg_bounded_merge(tmp_path):
    """Many partial batches and a small batchSizeRows: the final
    aggregate merges in several bounded rounds, its inputs and each
    round's results in the store."""
    data, ddl = _gen([("k", "int"), ("v", "long")], 5000, 23)
    conf = dict(TINY_POOL, **{"spark.rapids.sql.batchSizeRows": "256"})

    def fn(s, F):
        return (s.createDataFrame(data, ddl, num_partitions=6)
                .groupBy("k").agg(F.sum("v").alias("s"),
                                  F.min("v").alias("mn"),
                                  F.max("v").alias("mx"),
                                  F.count("v").alias("c")))
    want, got, pm, store, _plan = _run_both(fn, conf, tmp_path)
    assert got == want and len(got) > 4000
    assert store.spill_count > 0
    # the bounded merge's rounds each count one program
    assert pm.get(M.DISPATCH_COUNT, 0) > 6 + 1


def test_out_of_core_sort_emits_bounded_sorted_batches(tmp_path):
    """A sort partition far above batchSizeRows takes the rank-split
    path: several bounded batches, identical rows, key ties included."""
    data, ddl = _gen([("a", "small"), ("b", "long"), ("c", "int")], 6000,
                     41)
    conf = dict(TINY_POOL, **{"spark.rapids.sql.batchSizeRows": "512"})

    def fn(s, F):
        return s.createDataFrame(data, ddl, num_partitions=12) \
            .repartition(2, "c").sortWithinPartitions("a", "b")
    want, got, _pm, store, plan = _run_both(fn, conf, tmp_path,
                                            ordered=True)
    assert got == want
    assert store.spill_count > 0
    sort = next(p for p in _nodes(plan)
                if type(p).__name__ == "TorchSortExec")
    # 2 partitions of about 3000 rows, each of 12 exchange pieces, in
    # sub-ranges of at most 512 rows
    assert sort.metrics.value(M.NUM_OUTPUT_BATCHES) >= 12


def _nodes(plan):
    out = [plan]
    for c in plan.children:
        out.extend(_nodes(c))
    return out


def test_chunked_join_under_tiny_pool(tmp_path):
    left, lddl = _gen([("k", "small"), ("v", "long")], 6000, 42)
    right, rddl = _gen([("k", "small"), ("w", "int")], 700, 43)
    conf = dict(TINY_POOL, **{
        "spark.rapids.sql.batchSizeRows": "512",
        "spark.rapids.sql.autoBroadcastJoinThreshold": "-1"})

    def fn(s, F):
        lt = s.createDataFrame(left, lddl, num_partitions=3)
        rt = s.createDataFrame(right, rddl, num_partitions=3)
        return lt.join(rt, on="k", how="left")
    want, got, _pm, store, plan = _run_both(fn, conf, tmp_path)
    assert got == want
    assert store.spill_count > 0
    assert any(type(p).__name__ == "TorchShuffledHashJoinExec"
               for p in _nodes(plan))


def test_range_partition_ragged_string_keys(tmp_path):
    """Batches whose longest strings land in different char-cap buckets
    still rank globally."""
    def fn(s, F):
        return s.createDataFrame(
            {"v": ["xxx", "zz", "a", "y" * 20, "x" * 17, "b"],
             "i": list(range(6))}, "v string, i int",
            num_partitions=2).orderBy("v")
    want, got, _pm, _store, _plan = _run_both(fn, {}, tmp_path,
                                              ordered=True)
    assert got == want


def test_range_partition_after_filter_under_tiny_pool(tmp_path):
    """Scattered active masks and spill round trips: the remapped
    partition ids still put every row in its range."""
    data, ddl = _gen([("a", "long"), ("b", "int")], 4000, 31)
    conf = {"spark.rapids.memory.tpu.poolSize": str(32 << 10),
            "spark.sql.shuffle.partitions": "4",
            "spark.rapids.sql.shuffle.devicePartitions": "4"}

    def fn(s, F):
        return s.createDataFrame(data, ddl, num_partitions=5) \
            .filter(F.col("b") > 0).orderBy("a", "b")
    want, got, _pm, store, _plan = _run_both(fn, conf, tmp_path,
                                             ordered=True)
    assert got == want
    assert store.spill_count > 0
