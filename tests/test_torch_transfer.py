"""The port's upload codec against the JAX package's
(``columnar/transfer.py`` in both): the same seeded numpy columns staged
by each package's ``pack_batch`` must give the same words, extras and
layout byte for byte (at 70,000 rows, above ``PACKED_MIN_ROWS``, so the
packed path runs), and the port's decode must give the JAX package's
device arrays at full capacity, padding included. The string encoding
is held byte-equal to the JAX package's on every kind of string column,
and the direct staging of small batches equal to its ``_stage_direct``.
The staging ring's slots are reused on the CPU exactly as on the card."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import transfer as JX
from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.io import arrow_convert as JA
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch.columnar import transfer as PX
from spark_rapids_tpu_torch.columnar.device import bucket_capacity
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io import arrow_convert as PA
from spark_rapids_tpu_torch.sql import types as PT

torch.set_num_threads(2)

N = 70_000
assert N >= PX.PACKED_MIN_ROWS == JX.PACKED_MIN_ROWS


def _types(mod):
    return {"byte": mod.ByteType(), "short": mod.ShortType(),
            "int": mod.IntegerT, "long": mod.LongT,
            "bool": mod.BooleanT, "float": mod.FloatType(),
            "double": mod.DoubleT, "date": mod.DateT,
            "ts": mod.TimestampType(), "dec64": mod.DecimalType(15, 2),
            "dec128": mod.DecimalType(25, 2), "str": mod.StringT,
            "bin": mod.BinaryType()}


def _dec128(rng, n):
    hi = rng.integers(-(1 << 20), 1 << 20, n)
    lo = rng.integers(-(1 << 62), 1 << 62, n)
    return np.stack([hi, lo], axis=1)


def _case(name, n=N, seed=5):
    """[(column name, kind, storage array, validity or None)]."""
    rng = np.random.default_rng(seed)

    def valid(p=0.15):
        return rng.random(n) > p
    if name == "narrow_ints":
        return [("i8", "long", rng.integers(-128, 128, n), None),
                ("i16", "long", rng.integers(-30000, 30000, n), None),
                ("i32", "long", rng.integers(-2**31, 2**31, n), None),
                ("i64", "long", rng.integers(-2**62, 2**62, n), None),
                ("by", "byte", rng.integers(-100, 100, n).astype(np.int8),
                 None),
                ("sh", "short",
                 rng.integers(-300, 300, n).astype(np.int16), None),
                ("in", "int", rng.integers(0, 100, n).astype(np.int32),
                 None)]
    if name == "nulls_everywhere":
        return [("i", "int", rng.integers(-5000, 5000, n).astype(np.int32),
                 valid()),
                ("l", "long", rng.integers(-2**40, 2**40, n), valid(0.5)),
                ("b", "bool", rng.random(n) > 0.5, valid()),
                ("d", "double", rng.standard_normal(n), valid()),
                ("s", "str", np.array(["x", "yy", "", "zzz"], dtype=object)[
                    rng.integers(0, 4, n)], valid())]
    if name == "bool_float":
        return [("b", "bool", rng.random(n) > 0.3, None),
                ("f", "float", rng.standard_normal(n).astype(np.float32),
                 None),
                ("d", "double", rng.standard_normal(n), None)]
    if name == "decimals_dates":
        return [("m", "dec64", rng.integers(-10**12, 10**12, n), valid()),
                ("w", "dec128", _dec128(rng, n), valid()),
                ("w2", "dec128", _dec128(rng, n), None),
                ("dt", "date", rng.integers(0, 20000, n).astype(np.int32),
                 valid()),
                ("ts", "ts", rng.integers(0, 2**50, n), None)]
    if name == "strings":
        pool = np.array(["A", "N", "R", "hello", "", "é", "日本語",
                         "0123456789abcdefghij"], dtype=object)
        return [("ascii1", "str", np.array(["A", "N", "R"], dtype=object)[
                    rng.integers(0, 3, n)], None),
                ("mixed", "str", pool[rng.integers(0, len(pool), n)],
                 valid()),
                ("bin", "bin", np.array([b"\x00\x01", b"", b"abc"],
                                        dtype=object)[
                    rng.integers(0, 3, n)], valid())]
    raise KeyError(name)


CASES = ["narrow_ints", "nulls_everywhere", "bool_float", "decimals_dates",
         "strings"]


def _jax_batch(cols):
    types = _types(JT)
    n = len(cols[0][2])
    schema = JT.StructType([JT.StructField(c, types[k])
                            for c, k, _a, _v in cols])
    hcols = [JHostColumn(f.data_type, np.asarray(a),
                         np.ones(n, bool) if v is None else v).normalized()
             for f, (_c, _k, a, v) in zip(schema.fields, cols)]
    return JHostBatch(schema, hcols, n)


def _torch_batch(cols):
    types = _types(PT)
    return host_batch_from_numpy([(c, types[k]) for c, k, _a, _v in cols],
                                 [a for _c, _k, a, _v in cols],
                                 [v for _c, _k, _a, v in cols])


def _varbytes_batches(n=N, seed=9):
    """A string column read from Arrow by each package, so it carries
    ``varbytes`` (the ``vstr`` layout), with nulls owning bytes."""
    rng = np.random.default_rng(seed)
    pool = ["", "a", "bb", "hello world", "é", "tail\x00", "x" * 40]
    vals = [pool[i] for i in rng.integers(0, len(pool), n)]
    mask = rng.random(n) < 0.1
    tbl = pa.table({"s": pa.array(vals, mask=mask, type=pa.string()),
                    "k": pa.array(rng.integers(0, 9, n))})
    jb = JA.arrow_to_host_batch(tbl)
    pb = PA.arrow_to_host_batch(tbl)
    assert jb.columns[0].varbytes is not None
    assert pb.columns[0].varbytes is not None
    return jb, pb


def _batches(case):
    if case == "vstr":
        return _varbytes_batches()
    cols = _case(case)
    return _jax_batch(cols), _torch_batch(cols)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", CASES + ["vstr"])
def test_pack_batch_byte_identical(case):
    jb, pb = _batches(case)
    jwords, jextras, jlayout = JX.pack_batch(jb)
    pwords, pextras, playout = PX.pack_batch(pb)
    assert playout == jlayout
    _same(jwords, pwords, "words")
    assert len(pextras) == len(jextras)
    for i, (a, b) in enumerate(zip(jextras, pextras)):
        _same(a, b, f"extras[{i}]")
    if case == "vstr":
        assert playout[0][0] == "vstr"


@pytest.mark.parametrize("case", CASES + ["vstr"])
def test_packed_decode_equals_jax_device_arrays(case):
    """Every device array at capacity, padding included, and the rows
    read back."""
    jb, pb = _batches(case)
    cap = bucket_capacity(pb.num_rows) * 5 // 4  # padding on the device
    staged = PX.prepare_upload(pb, cap)
    assert staged[0] == "packed"
    got = PX.upload_batch(pb, cap, torch.device("cpu"))
    want = JDeviceBatch.from_host(jb, cap)
    _same(np.asarray(want.active), got.active.numpy(), "active")
    jarrs = [np.asarray(a) for c in want.columns for a in c.arrays()]
    parrs = [a.numpy() for c in got.columns for a in c.arrays()]
    assert len(jarrs) == len(parrs)
    for i, (a, b) in enumerate(zip(jarrs, parrs)):
        _same(a, b, f"array {i}")
    assert list(got.to_host().rows()) == list(want.to_host().rows())


def test_direct_staging_equals_jax():
    cols = _case("nulls_everywhere", n=5000) + _case("decimals_dates",
                                                       n=5000)
    jb, pb = _jax_batch(cols), _torch_batch(cols)
    cap = bucket_capacity(5000)
    _t, _s, jn, _spec, jarrays = JX.prepare_upload(jb, cap)
    staged = PX.prepare_upload(pb, cap)
    assert staged[0] == "direct" and staged[2] == jn
    parrays = [PX._materialize(w) for w in staged[4]]
    assert len(parrays) == len(jarrays)
    for i, (a, b) in enumerate(zip(jarrays, parrays)):
        _same(a, b, f"array {i}")


_STRINGS = {
    "ascii": (["A", "N", "R", "hello"], None),
    "one_width": (["AB", "CD", "EF", "GH"] * 5, None),
    "non_ascii": (["é", "a", "日本", ""], None),
    "nulls_with_bytes": (["abc", "dddddddddddd", "x", "yz"],
                         [True, False, True, False]),
    "empty_strings": (["", "", "a", ""], None),
    "all_empty": (["", "", ""], [True, False, True]),
    "none_at_nulls": (["abc", None, "de", None], [True, False, True, False]),
    "trailing_nul": (["ab\x00", "c", "d\x00\x00"], None),
    "inner_nul": (["a\x00b", "cd"], None),
    "numpy_str": ([np.str_("ab"), np.str_("c")], None),
    "long_rows": (["x" * 70, "y", "z" * 9], None),
}


@pytest.mark.parametrize("case", sorted(_STRINGS))
def test_encode_strings_byte_identical(case):
    vals, valid = _STRINGS[case]
    data = np.empty(len(vals), dtype=object)
    data[:] = vals
    validity = np.ones(len(vals), bool) if valid is None \
        else np.array(valid)
    jc, jl = JX._encode_strings(data, validity, len(vals), False)
    pc, pl = PX._encode_strings(data, validity, len(vals), False)
    _same(jc, pc, "chars")
    _same(jl, pl, "lengths")
    # plain ASCII columns take the join route
    joined = PX._ascii_join(data, validity, len(vals))
    if case in ("ascii", "one_width", "nulls_with_bytes", "empty_strings",
                "all_empty", "numpy_str", "long_rows"):
        assert joined is not None
        _same(joined[0], pc, "join chars")
    else:
        assert joined is None


def test_encode_binary_byte_identical():
    data = np.empty(4, dtype=object)
    data[:] = [b"\x00\xff", b"", b"abc", b"zz"]
    validity = np.array([True, True, False, True])
    for a, b in zip(JX._encode_strings(data, validity, 4, True),
                    PX._encode_strings(data, validity, 4, True)):
        _same(a, b, "binary")


def test_staging_ring_reuses_slots_without_changing_rows():
    """More batches than slots, each placed, its copy started and decoded
    only after later batches have refilled the slots: every decoded batch
    keeps its own rows."""
    ring = PX.StagingRing(torch.device("cpu"), 2)
    batches = [_torch_batch([("v", "long", np.arange(i * 100, i * 100 + 80),
                              None), ("s", "str", np.array(
                                  [f"r{i}"] * 80, dtype=object), None)])
               for i in range(5)]
    started = []
    for b in batches:
        started.append(ring.start(ring.place(PX.prepare_upload(
            b, bucket_capacity(b.num_rows)))))
    for b, s in zip(batches, started):
        assert list(PX.finish_started(s).to_host().rows()) == list(b.rows())
