"""The port's murmur3 (plain version, and the kernel wrapper on CPU
tensors) against the JAX package's ``ops/hashing.murmur3_columns`` and its
Pallas kernel ``kernels/murmur3.murmur3_columns_kernel`` run in interpret
mode, bit-exact, over every q1 key type plus ints, longs, floats with
-0.0, dates, timestamps, decimals, strings with empty values, embedded
NULs and high-bit tail bytes, and nulls."""

import jax
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
from spark_rapids_tpu.kernels import murmur3 as JKM
from spark_rapids_tpu.ops import hashing as JH
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.kernels import murmur3 as KM
from spark_rapids_tpu_torch.ops import hashing as H
from spark_rapids_tpu_torch.sql import types as PT

torch.set_num_threads(2)

_POOL = ["", "a", "ab", "abc", "abcd", "abcde", "\x00", "x\x00y",
         "\x7f\x00", "éä", "ÿþ", "0123456789abcdef", "tailé", "A", "N",
         "R", "O", "F"]


def _battery(n, seed):
    rng = np.random.default_rng(seed)
    strs = np.array([_POOL[i] for i in rng.integers(0, len(_POOL), n)],
                    dtype=object)
    cols = [
        ("b", "bool", rng.integers(0, 2, n).astype(bool)),
        ("i", "int", rng.integers(-2**31, 2**31, n,
                                  dtype=np.int64).astype(np.int32)),
        ("l", "long", rng.integers(-2**62, 2**62, n)),
        ("f", "float", np.where(rng.random(n) < 0.1, -0.0,
                                rng.standard_normal(n)).astype(np.float32)),
        ("d", "double", np.where(rng.random(n) < 0.1, -0.0,
                                 rng.standard_normal(n))),
        ("dt", "date", rng.integers(-11000, 47000, n).astype(np.int32)),
        ("ts", "ts", rng.integers(-10**15, 10**15, n)),
        ("dec", "dec", rng.integers(-10**10, 10**10, n)),
        ("s", "str", strs),
    ]
    valid = [rng.random(n) > 0.15 for _ in cols]
    return cols, valid


def _types(mod):
    return {"bool": mod.BooleanT, "byte": mod.ByteT, "short": mod.ShortT,
            "int": mod.IntegerT, "long": mod.LongT,
            "float": mod.FloatT, "double": mod.DoubleT, "date": mod.DateT,
            "ts": mod.TimestampT, "dec": mod.DecimalType(15, 2),
            "str": mod.StringT}


def _jax_hashes(cols, valid, n):
    types = _types(JT)
    schema = JT.StructType([JT.StructField(name, types[t])
                            for name, t, _v in cols])
    hcols = [JHostColumn(f.data_type, vals, ok).normalized()
             for f, (_n, _t, vals), ok in zip(schema.fields, cols, valid)]
    db = JDeviceBatch.from_host(JHostBatch(schema, hcols, n))
    cap = db.capacity
    plain = np.asarray(jax.jit(
        lambda: JH.murmur3_columns(db.columns, cap, 42))())[:n]
    kern = np.asarray(jax.jit(
        lambda: JKM.murmur3_columns_kernel(db.columns, cap, 42))())[:n]
    return plain, kern


def _port_batch(cols, valid):
    types = _types(PT)
    hb = host_batch_from_numpy([(name, types[t]) for name, t, _v in cols],
                               [v for _n, _t, v in cols], valid)
    return DeviceBatch.from_host(hb, torch.device("cpu"))


@pytest.mark.parametrize("n,seed", [(200, 9), (1000, 10), (64, 11)])
def test_murmur3_matches_jax_plain_and_kernel(n, seed):
    cols, valid = _battery(n, seed)
    jplain, jkern = _jax_hashes(cols, valid, n)
    assert np.array_equal(jplain, jkern)
    db = _port_batch(cols, valid)
    plain = H.murmur3_columns(db.columns, db.capacity, 42).numpy()[:n]
    KR.reset_launches()
    wrapped = KM.murmur3_columns(db.columns, db.capacity, 42).numpy()[:n]
    assert KR.LAUNCHES["murmur3"] == 0  # CPU tensors: plain version
    assert plain.dtype == np.int32
    assert np.array_equal(plain, jplain)
    assert np.array_equal(wrapped, jplain)


@pytest.mark.parametrize("name", ["b", "i", "l", "f", "d", "dt", "ts",
                                  "dec", "s"])
def test_murmur3_each_type_alone(name):
    cols, valid = _battery(300, 12)
    keep = [i for i, c in enumerate(cols) if c[0] == name]
    cols = [cols[i] for i in keep]
    valid = [valid[i] for i in keep]
    jplain, _jk = _jax_hashes(cols, valid, 300)
    db = _port_batch(cols, valid)
    got = KM.murmur3_columns(db.columns, db.capacity, 42).numpy()[:300]
    assert np.array_equal(got, jplain)


def test_q1_partition_ids_match_jax():
    """pmod(murmur3(l_returnflag, l_linestatus), 8): the q1 exchange."""
    n = 500
    rng = np.random.default_rng(3)
    cols = [("l_returnflag", "str",
             np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)]),
            ("l_linestatus", "str",
             np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)])]
    valid = [np.ones(n, bool), np.ones(n, bool)]
    jplain, _jk = _jax_hashes(cols, valid, n)
    want = np.mod(jplain.astype(np.int64), 8)
    db = _port_batch(cols, valid)
    got = H.partition_ids(db.columns, db.capacity, 8).numpy()[:n]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_parts", [1, 8, 200])
def test_partition_ids_match_jax_pmod(n_parts):
    """The port's partition ids (the wrapper's ``n_parts`` path on CPU
    tensors: the plain hash, then ``remainder``) against the JAX
    package's pmod(murmur3) over the whole battery, negative hashes
    included."""
    n = 700
    cols, valid = _battery(n, 40 + n_parts)
    jplain, _jk = _jax_hashes(cols, valid, n)
    assert (jplain < 0).any() and (jplain > 0).any()
    want = np.mod(jplain.astype(np.int64), n_parts)
    db = _port_batch(cols, valid)
    KR.reset_launches()
    got = H.partition_ids(db.columns, db.capacity, n_parts)
    wrapped = KM.murmur3_columns(db.columns, db.capacity, 42,
                                 n_parts=n_parts)
    assert KR.LAUNCHES["murmur3"] == 0
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[:n], want)
    assert np.array_equal(wrapped.numpy()[:n], want)


@pytest.mark.parametrize("kind", ["byte", "short"])
def test_murmur3_narrow_column_alone(kind):
    """A byte or short key alone, every value of its range's edges
    included and a sixth of the rows null: hashInt of the sign-extended
    value, as the JAX package hashes it."""
    n = 600
    rng = np.random.default_rng(50)
    dt = np.int8 if kind == "byte" else np.int16
    info = np.iinfo(dt)
    vals = rng.integers(info.min, info.max + 1, n).astype(dt)
    vals[:4] = [info.min, -1, 0, info.max]
    cols = [("x", kind, vals)]
    valid = [rng.random(n) > 0.16]
    jplain, jkern = _jax_hashes(cols, valid, n)
    assert np.array_equal(jplain, jkern)
    db = _port_batch(cols, valid)
    assert db.columns[0].data.dtype == (torch.int8 if kind == "byte"
                                        else torch.int16)
    got = KM.murmur3_columns(db.columns, db.capacity, 42).numpy()[:n]
    assert np.array_equal(got, jplain)


def test_murmur3_strings_of_every_length():
    """Strings of every length from 0 to the column's char cap (24), with
    high-bit bytes in every position, so each tail length (0-3) follows
    each number of whole words."""
    rng = np.random.default_rng(51)
    alphabet = [chr(c) for c in range(1, 128)] + ["\x80", "\xff"]
    strs = []
    for length in range(0, 25):
        for _ in range(3):
            chars = [alphabet[i] for i in rng.integers(0, len(alphabet),
                                                       length)]
            # latin-1 code points above 127 take two UTF-8 bytes: keep
            # the byte length exact by using ASCII for them
            strs.append("".join(c if ord(c) < 128 else "\x7f"
                                for c in chars))
    strs.append("\x7f" * 24)
    hi = "".join(chr(0x80 + i % 60) for i in range(12))  # 24 UTF-8 bytes
    strs += [hi[:k] for k in range(13)]
    n = len(strs)
    cols = [("s", "str", np.array(strs, dtype=object))]
    valid = [np.ones(n, bool)]
    jplain, jkern = _jax_hashes(cols, valid, n)
    assert np.array_equal(jplain, jkern)
    db = _port_batch(cols, valid)
    col = db.columns[0]
    assert col.char_cap == 24
    lengths = col.lengths.numpy()[:n]
    assert set(range(25)) <= set(lengths.tolist())
    got = KM.murmur3_columns(db.columns, db.capacity, 42).numpy()[:n]
    assert np.array_equal(got, jplain)
