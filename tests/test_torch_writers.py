"""Writers through both packages: the port's DataFrameWriter against the
JAX package's, on the CPU.

For every format (Parquet, ORC, CSV, JSON), with and without
``partitionBy``, the two writers given the same seeded rows in the same
partitions lay out the same relative directories and files (names equal
but for their random suffix), with the same contents: CSV and JSON byte
for byte, Parquet and ORC as equal Arrow tables; and each package reads
what the other wrote to the same rows. The cases of ``tests/test_io.py``
too: save modes, the partitioned layout (``k=v`` directories,
``__HIVE_DEFAULT_PARTITION__`` for null, escaped values, partition
columns left out of the files), partition type inference (strict
numbers), and a partitioned scan on the device path. The JSON writer's
column-wise encoder is held against ``json.dumps`` row by row."""

import decimal
import json
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.orc as po
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch.io.readers import CpuFileScanExec
from spark_rapids_tpu_torch.io.writers import json_lines
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.test_torch_formats import (MIXED_SCHEMA, frame_rows, mixed_data,
                                      rows_equal, same_everywhere)

torch.set_num_threads(2)

FORMATS = ["parquet", "orc", "csv", "json"]
NAME = re.compile(r"part-(\d{5})-[0-9a-f]{12}\.(\w+)\Z")


def _sessions():
    """(name, session) of the JAX package with the engine off and of the
    port on the CPU: the two writers."""
    return [("jax", TpuSparkSession({"spark.rapids.sql.enabled": "false"})),
            ("port", TorchSparkSession({}, device="cpu"))]


def write_both(tmp_path, data: dict, schema: str, fmt: str, parts: int = 3,
               partition_by=(), **kw) -> dict:
    """The same rows written by each package: ``{package: root}``."""
    roots = {}
    for name, s in _sessions():
        root = str(tmp_path / name)
        w = s.createDataFrame(data, schema, num_partitions=parts).write
        if partition_by:
            w = w.partitionBy(*partition_by)
        getattr(w, fmt)(root, **kw)
        if name == "jax":
            s.stop()
        roots[name] = root
    return roots


def layout(root: str) -> dict:
    """``{(relative dir, task id, extension): path}`` of a written tree,
    and its ``_SUCCESS`` marker."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            rel = os.path.relpath(d, root)
            if n == "_SUCCESS":
                out[(rel, "_SUCCESS", "")] = os.path.join(d, n)
                continue
            m = NAME.match(n)
            assert m, n
            key = (rel, m.group(1), m.group(2))
            assert key not in out, key
            out[key] = os.path.join(d, n)
    return out


def same_files(roots: dict, fmt: str) -> dict:
    """The two trees hold the same files with the same contents."""
    jl, pl = layout(roots["jax"]), layout(roots["port"])
    assert sorted(jl) == sorted(pl)
    for key in jl:
        if key[1] == "_SUCCESS":
            continue
        jf, pf = jl[key], pl[key]
        if fmt in ("csv", "json"):
            with open(jf, "rb") as a, open(pf, "rb") as b:
                assert a.read() == b.read(), key
        else:
            read = pq.read_table if fmt == "parquet" else po.read_table
            jt, pt = read(jf), read(pf)
            assert jt.schema.equals(pt.schema), key
            # as Python values: NaN equal to NaN, -0.0 apart from 0.0
            rows_equal([tuple(r.values()) for r in jt.to_pylist()],
                       [tuple(r.values()) for r in pt.to_pylist()],
                       ordered=True)
    return jl


def _read(s, fmt: str, root: str, schema: str = MIXED_SCHEMA):
    if fmt in ("csv", "json"):
        return getattr(s.read, fmt)(root, schema=schema)
    return getattr(s.read, fmt)(root)


@pytest.mark.parametrize("fmt", FORMATS)
def test_files_equal_the_jax_writers(tmp_path, fmt):
    data = mixed_data(300)
    roots = write_both(tmp_path, data, MIXED_SCHEMA, fmt)
    files = same_files(roots, fmt)
    assert len(files) == 4  # three files and the marker
    want = frame_rows(data, MIXED_SCHEMA)
    for root in roots.values():
        rows_equal(want, same_everywhere(
            lambda s, F, root=root: _read(s, fmt, root)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_partitioned_files_equal_the_jax_writers(tmp_path, fmt):
    """Two partition columns, nulls among them: the same directories,
    files and row order in each file; each package reads both trees."""
    data = mixed_data(300)
    data["g"] = [None if i % 11 == 0 else f"g/{i % 3}" for i in range(300)]
    data["h"] = [None if i % 13 == 0 else i % 2 for i in range(300)]
    schema = MIXED_SCHEMA + ", g string, h int"
    roots = write_both(tmp_path, data, schema, fmt,
                       partition_by=("g", "h"))
    files = same_files(roots, fmt)
    dirs = {k[0] for k in files if k[1] != "_SUCCESS"}
    assert dirs == {os.path.join(f"g={g}", f"h={h}")
                    for g in ("__HIVE_DEFAULT_PARTITION__", "g%2F0", "g%2F1",
                              "g%2F2")
                    for h in ("__HIVE_DEFAULT_PARTITION__", "0", "1")}
    want = frame_rows(data, schema)
    for root in roots.values():
        # the JAX package's engine off reads it; its device path reads a
        # partitioned tree in test_partitioned_scan_on_the_device_path
        got = same_everywhere(
            lambda s, F, root=root: _read(s, fmt, root).select(
                *data.keys()), jax_device=False)
        rows_equal(want, got)


@pytest.mark.parametrize("fmt", FORMATS)
def test_write_modes(tmp_path, fmt):
    counts = {}
    for name, s in _sessions():
        df = s.createDataFrame({"a": [1, 2, 3]}, "a bigint")
        path = str(tmp_path / name)
        getattr(df.write, fmt)(path)
        with pytest.raises(FileExistsError):
            getattr(df.write, fmt)(path)
        getattr(df.write.mode("ignore"), fmt)(path)
        getattr(df.write.mode("append"), fmt)(path)
        got = [_read(s, fmt, path, "a bigint").count()]
        getattr(df.write.mode("overwrite"), fmt)(path)
        got.append(_read(s, fmt, path, "a bigint").count())
        counts[name] = got
        if name == "jax":
            s.stop()
    assert counts["port"] == counts["jax"] == [6, 3]


def test_partitioned_write_layout(tmp_path):
    roots = write_both(tmp_path, {"k": [1, 1, 2, None],
                                  "v": [10, 20, 30, 40]},
                       "k bigint, v bigint", "parquet",
                       partition_by=("k",))
    same_files(roots, "parquet")
    s = TorchSparkSession({}, device="cpu")
    path = roots["port"]
    assert {d for d in os.listdir(path) if not d.startswith("_")} == {
        "k=1", "k=2", "k=__HIVE_DEFAULT_PARTITION__"}
    # the files under a partition directory leave the column out
    sub = s.read.parquet(os.path.join(path, "k=1"))
    assert sub.columns == ["v"]
    assert sorted(r.v for r in sub.collect()) == [10, 20]
    back = {(r.k, r.v) for r in s.read.parquet(path).collect()}
    assert back == {(1, 10), (1, 20), (2, 30), (None, 40)}


@pytest.mark.parametrize("values,want_type", [
    (["a", "b"], "StringType"),
    (["a/b", "c=d", "plain"], "StringType"),
    (["1_0", "2_5"], "StringType"),
    (["7", "-3"], "IntegerType"),
    (["5000000000", "1"], "LongType"),
    (["1.5", "2"], "DoubleType"),
], ids=["strings", "escaped", "loosely_numeric", "ints", "longs",
        "doubles"])
def test_partition_type_inference_and_escaping(tmp_path, values,
                                               want_type):
    """A string partition column written by the port, read back: its
    type inferred from the directory names as the JAX package infers it,
    the values round-tripping through their escaping."""
    v = [float(i) for i in range(len(values))]
    roots = write_both(tmp_path, {"tag": values, "v": v},
                       "tag string, v double", "parquet",
                       partition_by=("tag",))
    same_files(roots, "parquet")
    types = {}
    for name, s in _sessions():
        back = s.read.parquet(roots["port"])
        types[name] = {f.name: type(f.data_type).__name__
                       for f in back.plan.schema.fields}["tag"]
        if name == "jax":
            s.stop()
    assert types["port"] == types["jax"] == want_type
    got = same_everywhere(lambda s, F: s.read.parquet(roots["port"]))
    if want_type == "StringType":
        assert {(r[1], r[0]) for r in got} == set(zip(values, v))


def test_partitioned_scan_on_the_device_path(tmp_path):
    """A group-by over a partitioned Parquet tree: decodeFused decodes the
    data columns, the directory column is added on the host."""
    roots = write_both(tmp_path, {"k": [1, 2, 1, 2, 1],
                                  "v": [1.0, 2.0, 3.0, 4.0, 5.0]},
                       "k int, v double", "parquet", parts=2,
                       partition_by=("k",))

    def build(s, F):
        return s.read.parquet(roots["port"]).groupBy("k").agg(
            F.count("v").alias("c"), F.max("v").alias("m"))
    got = same_everywhere(build)
    assert sorted(got) == [(1, 3, 5.0), (2, 2, 4.0)]
    s = TorchSparkSession({}, device="cpu")
    build(s, PF).collect()
    scan = next(n for n in _nodes(s.last_plan)
                if isinstance(n, CpuFileScanExec))
    assert scan.metrics.snapshot()["deviceDecodedBatches"] == 4
    assert plan_metrics(s.last_plan)["kernelDispatchCount.decodeFused"] == 4


def _nodes(plan):
    out = [plan]
    for c in getattr(plan, "children", []):
        out += _nodes(c)
    return out


def test_partitioned_write_of_a_device_plan(tmp_path):
    """A query's result (an aggregate on the device path) written with
    partitionBy: the same tree as the JAX package's device path writes
    (one device partition after the aggregate's exchange)."""
    data = mixed_data(300)
    roots = {}
    for name, s in (("jax", TpuSparkSession(
            {"spark.rapids.sql.enabled": "true"})),
            ("port", TorchSparkSession({}, device="cpu"))):
        df = s.createDataFrame(data, MIXED_SCHEMA, num_partitions=3)
        df.createOrReplaceTempView("t")
        q = s.sql("SELECT k, s, count(*) AS c, sum(d) AS sd FROM t "
                  "WHERE k IS NOT NULL GROUP BY k, s")
        roots[name] = str(tmp_path / name)
        q.write.partitionBy("k").json(roots[name])
        if name == "jax":
            s.stop()
    jl = layout(roots["jax"])
    pl = layout(roots["port"])
    assert sorted(jl) == sorted(pl)
    rows_equal(*[same_everywhere(lambda s, F, r=r: s.read.json(
        r, schema="s string, c bigint, sd decimal(25,2)"))
        for r in (roots["jax"], roots["port"])])


def test_nan_and_negative_zero_partition_keys(tmp_path):
    """A double partition column: -0.0 and 0.0 share a directory, named
    by the value seen first, as in the JAX package. The NaNs also share
    one file in the port, where the JAX package's per-row dict writes a
    file for each NaN row (ROADMAP C)."""
    s = TorchSparkSession({}, device="cpu")
    root = str(tmp_path / "port")
    s.createDataFrame({"x": [-0.0, 0.0, float("nan"), float("nan"), 1.5],
                       "v": [1, 2, 3, 4, 5]}, "x double, v bigint",
                      num_partitions=1).write.partitionBy("x").parquet(root)
    files = layout(root)
    dirs = sorted(k[0] for k in files if k[1] != "_SUCCESS")
    assert dirs == ["x=-0.0", "x=1.5", "x=nan"]
    assert pq.read_table(os.path.join(root, "x=-0.0")).column(
        "v").to_pylist() == [1, 2]


def test_json_lines_equal_json_dumps():
    """The column-wise JSON encoder against ``json.dumps(row,
    default=str)`` row by row: every type, nulls, unicode and control
    characters, NaN and infinities, whole and fractional seconds,
    dates and times before 1970, duplicate column names, no rows."""
    rng = np.random.default_rng(3)
    n = 600

    def nulls(a, p=0.2):
        m = rng.random(n) < p
        return [None if mm else x for x, mm in zip(a, m)]
    strs = ["a", "", "é☃", 'q"uo\\te', "ctl\x01\n\t", "\U0001F600", "x y"]
    us = rng.integers(-3 * 10 ** 15, 4 * 10 ** 15, n)
    us[::3] = us[::3] // 1_000_000 * 1_000_000
    floats = np.concatenate([rng.normal(0, 1e10, n - 6),
                             [np.nan, np.inf, -np.inf, -0.0, 1e16, 1e-7]])
    tbl = pa.table({
        "s": pa.array(nulls([strs[i] for i in
                             rng.integers(0, len(strs), n)]), pa.string()),
        "i8": pa.array(nulls(rng.integers(-128, 127, n).tolist()),
                       pa.int8()),
        "i64": pa.array(nulls(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                           dtype=np.int64).tolist()),
                        pa.int64()),
        "b": pa.array(nulls((rng.random(n) < 0.5).tolist()), pa.bool_()),
        "f": pa.array(nulls(floats.tolist()), pa.float64()),
        "f32": pa.array(nulls(rng.normal(0, 3, n).astype(np.float32)
                              .tolist()), pa.float32()),
        "d": pa.array(nulls([decimal.Decimal(int(x)).scaleb(-2) for x in
                             rng.integers(-10 ** 12, 10 ** 12, n)]),
                      pa.decimal128(15, 2)),
        "dt": pa.array(nulls(rng.integers(-700_000, 2_900_000, n).tolist()),
                       pa.int32()).cast(pa.date32()),
        "ts": pa.array(nulls(us.tolist()), pa.int64()).cast(
            pa.timestamp("us", tz="UTC")),
        "naive": pa.array(nulls(us.tolist()), pa.int64()).cast(
            pa.timestamp("us")),
        "bin": pa.array(nulls([b"x\x00y", b""] * (n // 2)), pa.binary()),
        "arr": pa.array(nulls([[1, None, 3], []] * (n // 2)),
                        pa.list_(pa.int64())),
        "st": pa.array(nulls([{"a": 1, "b": "x"}, {"a": None, "b": None}]
                             * (n // 2)),
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
    })

    def plain(t):
        return "".join(json.dumps(r, default=str) + "\n"
                       for r in t.to_pylist())
    assert json_lines(tbl) == plain(tbl)
    for c in tbl.column_names:
        assert json_lines(tbl.select([c])) == plain(tbl.select([c])), c
    assert json_lines(tbl.slice(0, 0)) == ""
    dup = pa.Table.from_arrays([tbl.column(0), tbl.column(1)],
                               names=["x", "x"])
    assert json_lines(dup) == plain(dup)


def test_unknown_format_raises(tmp_path):
    s = TorchSparkSession({}, device="cpu")
    df = s.createDataFrame({"a": [1]}, "a bigint")
    with pytest.raises(ValueError, match="unknown file format"):
        df.write.format("avro").save(str(tmp_path / "x"))


def test_group_rows_without_the_radix_key():
    """Partition codes too many to pack into one int64 key group as the
    packed key groups them."""
    from spark_rapids_tpu_torch.io.writers import _group_rows
    rng = np.random.default_rng(5)
    small = [rng.integers(-1, 3, 500) for _ in range(2)]
    wide = small + [rng.integers(-1, 2 ** 21, 500) for _ in range(3)]
    for codes in (small, wide):
        first, inverse = _group_rows(codes)
        keys = list(zip(*[c.tolist() for c in codes]))
        seen = {}
        for i, k in enumerate(keys):
            seen.setdefault(k, i)
        assert sorted(first.tolist()) == sorted(seen.values())
        assert [keys[first[g]] for g in inverse] == keys
