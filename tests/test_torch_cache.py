"""``DataFrame.cache`` in the port (``io/cache.py``) against the JAX
package's on the same data: the port on the CPU, the JAX package's device
path with kernels interpreted.

Checked: the rows of a cached in-memory relation and of a cached Parquet
read, one case a type family (integral, floating with NaN and -0.0,
decimals of both widths, dates and timestamps, strings with nulls,
arrays, and a struct built on the device), equal to the uncached query's
and to the JAX package's; materialisation once a relation however many
collects read it, and never while a collect fails; the captured plans
(the query's, then the materialisation's) equal to the JAX package's;
``last_plan`` the outer query's; no store handle of the nested plan left
after a collect or after one whose materialisation fails; the outer
query's device permit kept across the nested run and none held after the
collect; the JAX case ``tests/test_io.py`` ``test_cache_materializes_once``
rerun on the port."""

import datetime
import decimal
import os

import numpy as np
import pytest
import torch

import test_io
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.session import TpuSparkSession
from test_torch_runtime import fused_shape

from spark_rapids_tpu_torch import memory
from spark_rapids_tpu_torch.io import cache as C
from spark_rapids_tpu_torch.resource import get_semaphore
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.harness import _rows
from tests.torch_dual import _port_globals, assert_all_torch, compare

torch.set_num_threads(2)

D = decimal.Decimal
N = 60


def _cycle(vals, n=N):
    return [vals[i % len(vals)] for i in range(n)]


FAMILIES = {
    "integral": ({"b": _cycle([1, -128, 127, None, 0]),
                  "s": _cycle([300, None, -32768, 32767]),
                  "i": _cycle([7, None, -(1 << 31), (1 << 31) - 1, 0, 3]),
                  "l": _cycle([None, 1 << 62, -(1 << 63), 5, 0]),
                  "z": _cycle([True, None, False])},
                 "b tinyint, s smallint, i int, l bigint, z boolean"),
    "floating": ({"f": _cycle([1.5, None, float("nan"), -0.0, 0.0,
                               float("inf")]),
                  "d": _cycle([float("nan"), -0.0, None, 1e308, -1e-300,
                               float("-inf"), 2.5])},
                 "f float, d double"),
    "decimal": ({"p": _cycle([D("12345.67"), None, D("-0.01"),
                              D("99999.99")]),
                 "q": _cycle([D("12345678901234567890123456.7891"), None,
                              D("-0.0001"), D("0")])},
                "p decimal(7,2), q decimal(30,4)"),
    "datetime": ({"dt": _cycle([datetime.date(1998, 9, 2), None,
                                datetime.date(1940, 1, 1)]),
                  "ts": _cycle([datetime.datetime(2020, 2, 29, 12, 0, 1,
                                                  123456), None,
                                datetime.datetime(1969, 12, 31, 23, 59)])},
                 "dt date, ts timestamp"),
    "string": ({"k": _cycle([1, 2, None, 3]),
                "s": _cycle(["x", None, "", "héllo wörld", "zz" * 20])},
               "k int, s string"),
    "array": ({"k": _cycle([1, 2, 3, None]),
               "a": _cycle([[1, 2], None, [], [None, 5]]),
               "t": _cycle([["a", None], None, ["bc"], []])},
              "k int, a array<bigint>, t array<string>"),
}


def _jax(conf=None):
    return TpuSparkSession(dict(conf or {},
                                **{"spark.rapids.sql.enabled": "true"}))


def _port(conf=None):
    return TorchSparkSession(dict(conf or {}), device="cpu")


def _collect(df):
    return _rows(df._execute().to_pydict())


def _frame(s, family, source, path):
    data, ddl = FAMILIES[family]
    if source == "memory":
        return s.createDataFrame(data, ddl, num_partitions=3)
    return s.read.parquet(path)


@pytest.fixture(scope="module")
def parquet_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    out = {}
    for family, (data, ddl) in FAMILIES.items():
        out[family] = os.path.join(str(root), family)
        _port().createDataFrame(data, ddl, num_partitions=3) \
            .write.mode("overwrite").parquet(out[family])
    return out


@pytest.mark.parametrize("source", ["memory", "parquet"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cached_rows_equal_uncached_and_jax_package(family, source,
                                                    parquet_dirs):
    path = parquet_dirs[family]
    js, ps = _jax(), _port()
    try:
        want = _collect(_frame(js, family, source, path).cache())
    finally:
        js.stop()
    cached = _frame(ps, family, source, path).cache()
    got = _collect(cached)
    compare([("rows", want, False)], [("rows", got, False)])
    compare([("rows", _collect(_frame(ps, family, source, path)), False)],
            [("rows", got, False)])
    # a second collect reads the payloads: the same rows, one
    # materialisation
    compare([("rows", want, False)], [("rows", _collect(cached), False)])
    assert cached.plan.materializations == 1
    assert cached.plan.cached_bytes > 0
    assert_all_torch(ps.last_plan)


def test_struct_built_on_the_device_round_trips_through_the_cache():
    data, ddl = FAMILIES["string"]

    def q(s, F):
        return s.createDataFrame(data, ddl, num_partitions=3).select(
            "k", F.struct("k", "s").alias("st")).cache()
    js = _jax()
    try:
        want = _collect(q(js, JF))
    finally:
        js.stop()
    ps = _port()
    df = q(ps, F)
    got = _collect(df)
    compare([("rows", want, False)], [("rows", got, False)])
    assert df.plan.materializations == 1


def test_materializes_once_across_collects_and_subtrees():
    """Two subtrees of one query (a self-union) and two collects read
    one relation: one materialisation."""
    ps = _port()
    data, ddl = FAMILIES["integral"]
    cached = ps.createDataFrame(data, ddl, num_partitions=3).cache()
    rel = cached.plan
    rows = _collect(cached.union(cached))
    assert len(rows) == 2 * N
    assert rel.materializations == 1
    assert len(_collect(cached)) == N
    assert rel.materializations == 1
    assert rel.materialize() is rel.materialize()


def _cached_agg(s, F):
    df = s.createDataFrame({"k": [1, 2, 1, None, 2, 3] * 5,
                            "v": list(range(30))}, "k int, v bigint",
                           num_partitions=3)
    return df.cache(), df.filter(F.col("v") > 4).cache()


def test_captured_plans_match_jax_package():
    """The query's plan first, then the materialisation's: a bare host
    source for an in-memory child, the device plan for anything else."""
    shapes = {}
    for name, s, fns in (("jax", _jax(), JF), ("port", _port(), F)):
        plain, filtered = _cached_agg(s, fns)
        s.start_capture()
        for c in (plain, filtered):
            c.groupBy("k").agg(fns.sum("v").alias("s")).collect()
        plans = s.get_captured_plans()
        shapes[name] = [fused_shape(p) for p in plans]
        if name == "port":
            last = s.last_plan
        s.stop()
    assert shapes["port"] == shapes["jax"]
    assert len(shapes["port"]) == 4
    assert shapes["port"][1] == ["CpuLocalScanExec"]
    assert "TorchFilterExec" in shapes["port"][3]
    # last_plan is the outer query, not the nested materialisation
    assert "CpuCachedScanExec" in [n if isinstance(n, str) else n[0]
                                   for n in fused_shape(last)]


def _live_handles():
    store = memory._STORE
    return 0 if store is None else store.stats()["liveHandles"]


def _nested_exchange_frame(s):
    """A cached child whose device plan holds store handles (its
    aggregate's exchange) while it runs."""
    df = s.createDataFrame({"k": [i % 7 for i in range(200)],
                            "v": list(range(200))}, "k int, v bigint",
                           num_partitions=4)
    return df.groupBy("k").agg(F.sum("v").alias("s")).cache()


def test_no_store_handle_outlives_the_nested_plan():
    ps = _port()
    cached = _nested_exchange_frame(ps)
    rows = sorted(_collect(cached.filter(F.col("s") >= 0)))
    assert len(rows) == 7
    assert _live_handles() == 0
    assert get_semaphore(ps.conf_obj).in_use == 0


def test_failed_materialization_leaves_the_relation_lazy(monkeypatch):
    ps = _port()
    cached = _nested_exchange_frame(ps)
    rel = cached.plan
    encoded = []

    def failing(batch):
        encoded.append(batch.num_rows)
        raise RuntimeError("encode failed")
    monkeypatch.setattr(C, "_encode", failing)
    for _ in range(2):  # lazy again: the second collect retries
        with pytest.raises(RuntimeError, match="encode failed"):
            _collect(cached)
        assert rel._payloads is None and rel.materializations == 0
        assert _live_handles() == 0
        assert get_semaphore(ps.conf_obj).in_use == 0
    assert len(encoded) == 2
    monkeypatch.undo()
    assert len(_collect(cached)) == 7
    assert rel.materializations == 1


def test_outer_query_keeps_its_permit_across_materialization(monkeypatch):
    """A broadcast join uploads its small in-memory build side first
    (taking the thread's permit), then lists the cached stream side:
    the cache materialises inside the running query. The nested plan's
    columnar-to-row transition must not release the outer permit."""
    ps = _port()
    sem = get_semaphore(ps.conf_obj)
    seen = []
    plain = C.CachedRelation.materialize

    def spy(self):
        before = sem.held_by_caller()
        out = plain(self)
        seen.append((before, sem.held_by_caller(), sem.in_use))
        return out
    monkeypatch.setattr(C.CachedRelation, "materialize", spy)
    big = ps.createDataFrame({"k": [i % 5 for i in range(100)],
                              "v": list(range(100))}, "k int, v bigint",
                             num_partitions=2).filter(F.col("v") >= 0) \
        .cache()
    small = ps.createDataFrame({"k": [1, 2], "w": [10, 20]},
                               "k int, w bigint")
    rows = _collect(big.join(small, "k"))
    assert len(rows) == 40
    assert "TorchBroadcastHashJoin inner" in repr(ps.last_plan)
    assert seen and seen[0] == (True, True, 1), seen
    assert sem.in_use == 0 and not sem.held_by_caller()


def test_permit_kept_only_while_held(monkeypatch):
    """``hold_across`` keeps a held permit through a nested release and
    leaves a thread without one to the nested plan's own pair."""
    ps = _port()
    sem = get_semaphore(ps.conf_obj)
    sem.acquire_if_necessary()
    with sem.hold_across():
        sem.release_if_necessary()
        assert sem.held_by_caller() and sem.in_use == 1
    sem.release_if_necessary()
    assert sem.in_use == 0
    with sem.hold_across():
        sem.acquire_if_necessary()
        sem.release_if_necessary()
        assert not sem.held_by_caller()
    assert sem.in_use == 0


def test_jax_cache_case_runs_on_the_port(tmp_path):
    """``tests/test_io.py`` ``test_cache_materializes_once`` as written,
    then with its module rebound to the port (its sessions are the
    port's on the CPU)."""
    test_io.test_cache_materializes_once(str(tmp_path / "jax"))
    g = _port_globals(test_io)
    g["TpuSparkSession"] = lambda conf=None: TorchSparkSession(
        conf, device="cpu")
    g["test_cache_materializes_once"](str(tmp_path / "port"))


@pytest.mark.parametrize("arrow", [True, False])
def test_string_download_decodes_each_row_as_utf8(arrow, monkeypatch):
    """The download of a string column (the columnar-to-row transition
    and the cache's materialisation): pyarrow converts the rows, or the
    row loop where pyarrow refuses the bytes; either way each row is its
    bytes decoded as UTF-8 with replacement, and an invalid row is ''."""
    from spark_rapids_tpu_torch.columnar import device as DV
    from spark_rapids_tpu_torch.sql import types as T
    texts = [b"abc", "héllo".encode(), b"", b"x\x00", b"\x00\x00",
             b"bad\xff", b"zz", b"q"]
    cap = 8
    chars = torch.zeros((len(texts), cap), dtype=torch.uint8)
    for i, t in enumerate(texts):
        chars[i, :len(t)] = torch.tensor(list(t), dtype=torch.uint8)
    chars[6, 5] = 7  # bytes past a row's length are not part of it
    lengths = torch.tensor([len(t) for t in texts], dtype=torch.int32)
    valid = torch.tensor([True] * 7 + [False])
    if not arrow:
        monkeypatch.setattr(DV, "_strings_by_arrow", lambda c, n: None)
    col = DV.DeviceStringColumn(T.StringT, chars, lengths, valid)
    idx = np.array([7, 0, 1, 2, 3, 4, 6])
    got = DV._col_to_host(col, idx)
    assert list(got.data) == ["", "abc", "héllo", "", "x\x00",
                              "\x00\x00", "zz"]
    bad = DV._col_to_host(col, np.array([5, 0]))
    assert list(bad.data) == ["bad�", "abc"]


def _staged_bytes(batch):
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    from spark_rapids_tpu_torch.columnar.transfer import (prepare_upload,
                                                          wire_layout,
                                                          write_wires)
    staged = prepare_upload(batch, bucket_capacity(batch.num_rows))
    wires, offsets, total = wire_layout(staged)
    out = np.zeros(total, dtype=np.uint8)
    write_wires(wires, offsets, out)
    return staged[0], out.tobytes()


@pytest.mark.parametrize("family", sorted(FAMILIES) + ["packed"])
def test_cached_batch_stages_byte_for_byte_as_the_original(family):
    """A batch back from the cache's payload stages for the upload
    exactly as the batch that went in: the storage values (decimals'
    unscaled integers, dates' days, arrays' compact form) survive the
    Parquet round trip. ``packed``: 70,000 rows, the packed codec."""
    if family == "packed":
        data, ddl = FAMILIES["integral"]
        data = {k: _cycle(v, 70_000) for k, v in data.items()}
    else:
        data, ddl = FAMILIES[family]
    batch = _port().createDataFrame(data, ddl, num_partitions=1) \
        .plan.batches[0]
    back = C._decode(C._encode(batch), batch.schema)
    mode, want = _staged_bytes(batch)
    assert mode == ("packed" if family == "packed" else "direct")
    assert _staged_bytes(back) == (mode, want)
