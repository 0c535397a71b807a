"""The port's nested device columns (arrays, structs, explode, time
windows) against the JAX package's, on the CPU.

- The JAX package's own nested cases, all 10 of
  ``tests/test_device_generate.py`` and all 6 of ``tests/test_struct.py``,
  each run through the JAX package's device path and through
  ``TorchSparkSession(device="cpu")`` (``tests/torch_dual.py``): rows
  exact, and the same operators on the host as the JAX package's. A case
  the JAX package keeps (partly) on its CPU runs there on the port's
  host engine, with the JAX package's reason in the explain lines.
- Storage: the serde round trip of ``tests/test_memory_spill.py``'s
  ``test_serde_roundtrip_all_types`` through the port (a struct column
  added, bytes equal to the JAX package's); a device batch with an array
  and a struct column spilled by the port's store to host and to disk
  and read back equal; nested staging byte for byte the JAX package's
  ``_stage_column`` (nulls, empty arrays, strings, structs); array
  starts re-based by a concatenation.
- Hashing: the struct murmur3 fold of the plain version against the JAX
  package's ``hash_device_column``, and the partition ids the murmur3
  wrapper computes from a struct's fields against it.
- CPU placement: the shapes the JAX package places on its CPU
  (``split``, ``collect_list``, nested sort, join and window keys,
  nested-of-nested types, an explode over a copied array) run on the
  port's host engine at the same places, with the same rows.

Tolerances: none; every value is exact.
"""

import datetime
import tempfile
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar import serde as jserde
from spark_rapids_tpu.columnar import transfer as JTR
from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import types as JT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import memory as MEM
from spark_rapids_tpu_torch.columnar import serde
from spark_rapids_tpu_torch.columnar import transfer as TR
from spark_rapids_tpu_torch.columnar.device import (DeviceArrayColumn,
                                                    DeviceBatch,
                                                    DeviceStructColumn,
                                                    concat_device)
from spark_rapids_tpu_torch.columnar.host import HostBatch
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_generate as JG
from tests import test_struct as JS
from tests.torch_dual import dual_run, run_case

torch.set_num_threads(2)

CPU = torch.device("cpu")

GENERATE_CASES = [
    "test_device_explode", "test_device_explode_outer",
    "test_device_posexplode", "test_device_posexplode_outer",
    "test_device_explode_after_filter", "test_device_explode_strings",
    "test_device_size_element_at_contains",
    "test_device_create_array_and_explode",
    "test_device_generate_after_parquet_roundtrip",
    "test_heavy_ops_fall_back_on_arrays"]
STRUCT_CASES = [
    "test_struct_scan_project_exchange_collect",
    "test_struct_create_extract_with_decimal",
    "test_struct_in_filter_and_groupby_passthrough",
    "test_nested_struct_falls_back",
    "test_time_window_tumbling_device_groupby",
    "test_struct_groupby_key_device"]
# the cases the JAX package keeps (partly) on its CPU, with the reason
# the port's explain lines give
REFUSED = {
    "test_device_create_array_and_explode":
        "explode over computed arrays runs on CPU",
    "test_heavy_ops_fall_back_on_arrays": "array is not supported",
    "test_nested_struct_falls_back":
        "nested types in structs are not supported",
}


def _args(fn):
    code = fn.__code__
    if "tmp_path" in code.co_varnames[:code.co_argcount]:
        import pathlib
        return [pathlib.Path(tempfile.mkdtemp())]
    return []


@pytest.mark.parametrize("module,name", [(JG, n) for n in GENERATE_CASES]
                         + [(JS, n) for n in STRUCT_CASES],
                         ids=GENERATE_CASES + STRUCT_CASES)
def test_jax_nested_case(module, name):
    rec = run_case(module, name, *_args(getattr(module, name)))
    if name in REFUSED:
        assert rec.messages and REFUSED[name] in rec.messages[0], \
            rec.messages
    else:
        assert not rec.messages


# ---------------------------------------------------------------------------
# Storage: serde, the spill store, staging, concatenation
# ---------------------------------------------------------------------------

SERDE_DATA = {
    "i": [1, None, 3],
    "d": [1.5, float("nan"), None],
    "s": ["a", None, "日本語"],
    "dec": [Decimal("12.34"), None, Decimal("-0.05")],
    "big": [Decimal("123456789012345678901234.5678"), None,
            Decimal("-1.0000")],
    "arr": [[1, 2], None, []],
    "st": [(1, "x"), None, (None, "z")],
}


def _serde_schema(mod):
    return mod.StructType([
        mod.StructField("i", mod.IntegerT), mod.StructField("d", mod.DoubleT),
        mod.StructField("s", mod.StringT),
        mod.StructField("dec", mod.DecimalType(12, 2)),
        mod.StructField("big", mod.DecimalType(30, 4)),
        mod.StructField("arr", mod.ArrayType(mod.LongT)),
        mod.StructField("st", mod.StructType([
            mod.StructField("a", mod.IntegerT),
            mod.StructField("b", mod.StringT)]))])


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (np.isnan(a) and np.isnan(b)) or a == b
    return a == b


@pytest.mark.parametrize("codec", ["none", "zlib", "zstd"])
def test_serde_roundtrip_all_types(codec):
    """``test_memory_spill.py``'s round trip through the port's serde,
    with a struct column beside the array: every column class comes
    back, and the bytes are the JAX package's."""
    batch = HostBatch.from_pydict(SERDE_DATA, _serde_schema(T))
    jbatch = JHostBatch.from_pydict(SERDE_DATA, _serde_schema(JT))
    data = serde.serialize_batch(batch, codec)
    assert data == jserde.serialize_batch(jbatch, codec)
    want = batch.to_pydict()
    back = serde.deserialize_batch(data).to_pydict()
    assert back.keys() == want.keys()
    for k in want:
        assert all(_same(x, y) for x, y in zip(back[k], want[k])), k


def _nested_batch(n=50, seed=3):
    """An int key, an array<string> with null arrays, empty arrays and
    null elements, an array<bigint>, and a struct<int, string> with null
    structs and null fields."""
    rng = np.random.default_rng(seed)
    words = ["ab", "", "xyz", "日本", "q" * 20]
    arr_s, arr_l, st = [], [], []
    for i in range(n):
        r = rng.random()
        arr_s.append(None if r < 0.1 else [
            None if rng.random() < 0.15 else words[int(rng.integers(5))]
            for _ in range(int(rng.integers(0, 4)))])
        arr_l.append(None if rng.random() < 0.1 else [
            int(x) for x in rng.integers(-50, 50, int(rng.integers(0, 3)))])
        st.append(None if rng.random() < 0.2 else (
            None if rng.random() < 0.2 else int(rng.integers(100)),
            None if rng.random() < 0.2 else words[int(rng.integers(5))]))
    data = {"k": list(range(n)), "as": arr_s, "al": arr_l, "st": st}
    return data


def _nested_schema(mod):
    return mod.StructType([
        mod.StructField("k", mod.IntegerT),
        mod.StructField("as", mod.ArrayType(mod.StringT)),
        mod.StructField("al", mod.ArrayType(mod.LongT)),
        mod.StructField("st", mod.StructType([
            mod.StructField("a", mod.IntegerT),
            mod.StructField("b", mod.StringT)]))])


def test_nested_staging_byte_identical_to_jax_package():
    """Every staged array of a nested column (starts, lengths, the
    element pool at its own capacity bucket, validity; a struct's field
    arrays) is the JAX package's ``_stage_column`` byte for byte, from
    the tuples and from an Arrow round trip's compact form alike."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.io.arrow_convert import (
        arrow_to_host_batch, host_batch_to_arrow)
    data = _nested_batch()
    pb = HostBatch.from_pydict(data, _nested_schema(T))
    jb = JHostBatch.from_pydict(data, _nested_schema(JT))
    via_arrow = arrow_to_host_batch(
        pa.Table.from_batches(host_batch_to_arrow(pb).to_batches()),
        pb.schema)
    assert via_arrow.columns[1].elements is not None
    for cap in (64, 128):
        for pc, ac, jc, f in zip(pb.columns, via_arrow.columns, jb.columns,
                                 jb.schema.fields):
            want = JTR._stage_column(jc, f.data_type, cap)
            for got in (TR._stage_column(pc, pc.dtype, cap),
                        TR._stage_column(ac, ac.dtype, cap)):
                assert len(got) == len(want), f.name
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and g.shape == w.shape, f.name
                    assert g.tobytes() == w.tobytes(), f.name


def test_nested_upload_download_round_trip_and_sizeof():
    """Upload, a scattered active mask, download: the rows come back
    (arrays as lists, structs as tuples), and the batch's device bytes
    are what the JAX package counts for the same staging."""
    data = _nested_batch(80, 5)
    pb = HostBatch.from_pydict(data, _nested_schema(T))
    d = DeviceBatch.from_host(pb, CPU)
    assert isinstance(d.columns[1], DeviceArrayColumn)
    assert isinstance(d.columns[3], DeviceStructColumn)
    assert d.sizeof() == JDeviceBatch.from_host(JHostBatch.from_pydict(
        data, _nested_schema(JT))).sizeof()
    keep = torch.arange(d.capacity) % 3 != 1
    d = DeviceBatch(d.schema, d.columns, d.active & keep, None)
    got = d.to_host().to_pydict()
    idx = [i for i in range(80) if i % 3 != 1]
    want = pb.take(np.array(idx)).to_pydict()
    assert got == want


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_nested_batch_spills_and_returns(tmp_path, tier):
    """A device batch with array and struct columns, spilled by the
    port's store to the host or to disk, comes back with the same rows
    (the active rows of a scattered mask, in order)."""
    pb = HostBatch.from_pydict(_nested_batch(60, 7), _nested_schema(T))
    b = DeviceBatch.from_host(pb, CPU)
    keep = torch.arange(b.capacity) % 4 != 0
    b = DeviceBatch(b.schema, b.columns, b.active & keep, None)
    want = b.to_host().to_pydict()
    store = MEM.DeviceStore(1, 1 << 30 if tier == "host" else 1,
                            str(tmp_path), codec="zlib")
    h = store.register(b)
    other = store.register(DeviceBatch.from_host(HostBatch.from_pydict(
        {"v": list(range(64))}, T.StructType([T.StructField("v", T.LongT)])),
        CPU))
    assert h.tier == (MEM.TIER_HOST if tier == "host" else MEM.TIER_DISK)
    assert h.ever_spilled and h.rows == len(want["k"])
    back = h.get()
    assert isinstance(back.columns[1], DeviceArrayColumn)
    assert back.to_host().to_pydict() == want
    h.close()
    other.close()
    store.close()


def test_concat_rebases_array_starts():
    """Concatenating batches appends the element pools and shifts each
    batch's starts by the pools before it; structs concatenate field by
    field."""
    data = _nested_batch(70, 9)
    pb = HostBatch.from_pydict(data, _nested_schema(T))
    parts = [DeviceBatch.from_host(pb.slice(a, b), CPU)
             for a, b in ((0, 20), (20, 21), (21, 70))]
    parts[2] = DeviceBatch(parts[2].schema, parts[2].columns,
                           parts[2].active & (torch.arange(
                               parts[2].capacity) % 2 == 0), None)
    whole = concat_device(parts)
    want = HostBatch.concat([p.to_host() for p in parts]).to_pydict()
    assert whole.to_host().to_pydict() == want
    pool = whole.columns[1].child.capacity
    assert pool >= sum(p.columns[1].child.capacity for p in parts)


def test_decimal_array_elements_equal_cpu_engine():
    """Array elements of a decimal type keep their scale through upload
    and explode: the port's rows equal the JAX package's CPU engine's
    (its device path rescales them, ROADMAP C)."""
    data = {"k": [1, 2, 3], "a": [[Decimal("1.25"), None], [], None]}

    def q(s, F):
        return s.createDataFrame(data, "k int, a array<decimal(7,2)>") \
            .select("k", F.explode_outer("a").alias("x"))
    js = TpuSparkSession({"spark.rapids.sql.enabled": "false"})
    try:
        want = [tuple(r) for r in q(js, JF).collect()]
    finally:
        js.stop()
    got = [tuple(r) for r in q(TorchSparkSession(device="cpu"),
                               PF).collect()]
    assert got == want
    assert got[0] == (1, Decimal("1.25"))


def test_chars_from_varbytes_equal_encode_strings():
    """A string column's compact bytes stage to the char matrix and
    lengths that ``_encode_strings`` makes of its rows, also where null
    rows own bytes in the compact form (an Arrow null slot may) and
    where those bytes are longer than every valid row."""
    rows = ["ab", None, "", "xyz", None, "q" * 9, "日本"]
    owned = [b"ab", b"z" * 40, b"", b"xyz", b"w", b"q" * 9,
             "日本".encode()]
    validity = np.array([r is not None for r in rows])
    data = np.array(["" if r is None else r for r in rows], dtype=object)
    raw = np.array([len(b) for b in owned], dtype=np.int32)
    bts = np.frombuffer(b"".join(owned), dtype=np.uint8)
    for keep in (slice(None), slice(0, 5), slice(1, 2)):
        v, d = validity[keep], data[keep]
        vb = (bts[int(raw[:keep.start or 0].sum()):], raw[keep])
        got = TR._chars_from_varbytes(vb, v)
        want = TR._encode_strings(d, v, len(d), False)
        assert got[0].shape == want[0].shape
        assert got[0].tobytes() == want[0].tobytes()
        assert np.array_equal(got[1], want[1])


# explodes over an array that an explode below copied: ((array ordinal,
# position, outer) of the lower explode, then of the upper one, over the
# columns k, a, b and the lower explode's outputs)
CHAINED = {
    "explode_two_arrays": ((1, False, False), (2, False, False)),
    "explode_one_array_twice": ((1, False, False), (1, False, False)),
    "posexplode_outer_chain": ((1, False, True), (2, True, True)),
}


def _chained_reference(shape, a, b):
    """The rows of ``CHAINED[shape]``, row by row in Python: k, a, b, the
    lower element, then the upper position and element."""
    (oa, _p, outer_a), (ob, pos_b, outer_b) = CHAINED[shape]
    out = []
    for k, (ra, rb) in enumerate(zip(a, b)):
        lower = [(x,) for x in ra or []]
        if outer_a and not ra:
            lower = [(None,)]
        for x in lower:
            row = (k, ra, rb) + x
            arr = row[ob]
            upper = [((p,) if pos_b else ()) + (y,)
                     for p, y in enumerate(arr or [])]
            if outer_b and not arr:
                upper = [((None,) if pos_b else ()) + (None,)]
            out += [row + u for u in upper]
    return sorted(out, key=repr)


@pytest.mark.parametrize("shape", sorted(CHAINED))
def test_chained_explode_equals_python_reference(shape):
    """An explode copies its parent's other columns, arrays with their
    pools, to every output row, so an explode above it reads an array
    whose rows share its pool: its output (the sum over rows of len(a) *
    len(b)) outgrows that pool's capacity, and the generate sizes it from
    the count (``explodes_below``). The rows are exact against a Python
    reference. Through a session both packages put the project that
    carries the arrays between the explodes on the CPU, and the port runs
    it there (``test_cpu_placed_shapes_raise``)."""
    from spark_rapids_tpu_torch.conf import TorchConf
    from spark_rapids_tpu_torch.exec.generate import (TorchGenerateExec,
                                                      explode_batch,
                                                      explodes_below)
    rng = np.random.default_rng(13)
    n = 40
    a = [None if rng.random() < 0.1 else
         [int(v) for v in rng.integers(-9, 9, int(rng.integers(0, 7)))]
         for _ in range(n)]
    b = [None if rng.random() < 0.1 else
         [None if rng.random() < 0.1 else str(v)
          for v in rng.integers(0, 99, int(rng.integers(0, 7)))]
         for _ in range(n)]
    schema = T.StructType([T.StructField("k", T.IntegerT),
                           T.StructField("a", T.ArrayType(T.IntegerT)),
                           T.StructField("b", T.ArrayType(T.StringT))])
    d = DeviceBatch.from_host(HostBatch.from_pydict(
        {"k": list(range(n)), "a": a, "b": b}, schema), CPU)
    (oa, pa_, outer_a), (ob, pb_, outer_b) = CHAINED[shape]
    cols, active, total = explode_batch(d, oa, pa_, outer_a)
    s1 = T.StructType(list(schema.fields) + [T.StructField(
        "x", T.IntegerT)])
    d1 = DeviceBatch(s1, cols, active, None, total)
    cols2, active2, total2 = explode_batch(d1, ob, pb_, outer_b, True)
    s2 = T.StructType(list(s1.fields) + ([T.StructField("p", T.IntegerT)]
                                    if pb_ else []) +
                      [T.StructField("y", d1.columns[ob].dtype.element_type)])
    got = DeviceBatch(s2, cols2, active2, total2).to_host().to_pydict()
    rows = sorted(zip(*got.values()), key=repr)
    want = _chained_reference(shape, a, b)
    assert len(want) > d1.columns[ob].child.capacity
    assert rows == want
    conf = TorchConf({})
    leaf = TorchGenerateExec.__new__(TorchGenerateExec)
    leaf.children = []
    lower = TorchGenerateExec(None, [], leaf, conf, CPU)
    upper = TorchGenerateExec(None, [], lower, conf, CPU)
    assert explodes_below(upper.child) and not explodes_below(lower.child)


# ---------------------------------------------------------------------------
# Hashing: the struct murmur3 fold
# ---------------------------------------------------------------------------

def test_struct_murmur3_fold_matches_jax_package():
    """The plain version's struct fold (``hash_device_column``: fields
    left to right, a null struct keeps the seed) equals the JAX
    package's; the partition ids the murmur3 wrapper computes from the
    struct's fields (validity ANDed with the struct's) equal the fold's
    pmod; and both equal the host ``Murmur3Hash`` over the struct."""
    from spark_rapids_tpu_torch.sql import expressions as E
    data = _nested_batch(90, 11)
    pb = HostBatch.from_pydict(data, _nested_schema(T))
    jb = JDeviceBatch.from_host(JHostBatch.from_pydict(
        data, _nested_schema(JT)))
    d = DeviceBatch.from_host(pb, CPU)
    cap = d.capacity
    for cols, jcols in (([d.columns[3]], [jb.columns[3]]),
                        ([d.columns[0], d.columns[3]],
                         [jb.columns[0], jb.columns[3]])):
        got = H.murmur3_columns(cols, cap, 42)
        want = JH.murmur3_columns(jcols, cap, 42)
        assert np.array_equal(got.numpy(), np.asarray(want))
        pids = H.partition_ids(cols, cap, 7)
        assert np.array_equal(pids.numpy(),
                              np.asarray(jnp.mod(want.astype(jnp.int64),
                                                 7)))
    host = E.Murmur3Hash([E.BoundReference(3, pb.schema.fields[3].data_type,
                                            True)]
                         ).eval(pb)
    got = H.murmur3_columns([d.columns[3]], cap, 42).numpy()[:pb.num_rows]
    assert np.array_equal(host.data.astype(np.int32), got)


def test_time_window_follows_floor_mod_on_negative_times():
    """Times before the epoch and at window edges: the device window
    (``torch.remainder``, the divisor's sign) equals the host
    evaluator's and the JAX package's rows."""
    base = datetime.datetime(1969, 12, 31, 23, 59, 50)
    ts = [base + datetime.timedelta(seconds=s) for s in
          (-25, -10, -1, 0, 5, 9, 10, 11, 19, 20, 21)] + [None]
    rows = {"ts": ts, "v": list(range(len(ts)))}

    def q(s, F):
        return s.createDataFrame(rows, "ts timestamp, v long").select(
            F.window("ts", "10 seconds").alias("w"), "v").select(
            F.col("w").getField("start").alias("a"),
            F.col("w").getField("end").alias("b"), "v")
    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        want = sorted((tuple(r) for r in q(js, JF).collect()),
                      key=lambda r: r[2])
    finally:
        js.stop()
    got = sorted((tuple(r) for r in q(TorchSparkSession(device="cpu"),
                                      PF).collect()), key=lambda r: r[2])
    assert got == want
    assert got[0][0] == datetime.datetime(1969, 12, 31, 23, 59, 20)
    assert got[-1][:2] == (None, None)


# ---------------------------------------------------------------------------
# What the JAX package keeps on its CPU runs on the port's host engine
# ---------------------------------------------------------------------------

def _arrays(s):
    return s.createDataFrame(
        {"k": [1, 2, 3], "s": ["a,b", "c", ""], "a": [[1, 2], [], None],
         "n": [[[1]], [], None]},
        "k int, s string, a array<bigint>, n array<array<bigint>>")


def _structs(s, F):
    return s.createDataFrame({"k": [1, 2, 3], "v": [3, 1, 2]},
                             "k int, v int").select(
        F.struct(F.col("k")).alias("st"), "k", "v")


REFUSALS = {
    "split": lambda s, F: _arrays(s).select(F.split("s", ",").alias("p")),
    "collect_list": lambda s, F: _arrays(s).groupBy("k").agg(
        F.collect_list("k").alias("l")),
    "nested_of_nested": lambda s, F: _arrays(s).select(
        F.explode("n").alias("x")),
    "nested_sort_key": lambda s, F: _structs(s, F).orderBy("st"),
    "nested_join_key": lambda s, F: _structs(s, F).join(
        _structs(s, F).select(F.col("st").alias("st2"), "v"),
        F.col("st") == F.col("st2")),
    "chained_explode": lambda s, F: _arrays(s).select(
        "k", "a", F.explode("a").alias("x")).select(
        "k", "x", F.explode("a").alias("y")),
    "nested_window_key": lambda s, F: _structs(s, F).select(
        "k", F.row_number().over(F.Window.partitionBy("st").orderBy("v"))
        .alias("r")),
}


@pytest.mark.parametrize("shape", sorted(REFUSALS))
def test_cpu_placed_shapes_raise(shape):
    """The JAX package plans each shape with a CPU operator; the port
    keeps the same operators on its host engine, at the same places, and
    gives the same rows."""
    make = REFUSALS[shape]
    jax_rec, port_rec = dual_run(lambda s: make(s, JF),
                                 lambda s: make(s, PF))
    assert jax_rec.results[0][3], shape
    assert port_rec.messages, shape
