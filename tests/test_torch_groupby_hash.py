"""The port's groupbyHash (plain version behind the kernel wrapper, on CPU
tensors) against the JAX package's Pallas kernel run in interpret mode:
the table pass compared as a set of (first row, add/min/max lanes) per
group, the overflow flag, the key words and their hash bit-exact, and
``plan_lanes`` encode/decode through ``hash_groupby``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
import spark_rapids_tpu.ops.exprs  # noqa: F401  (device-column pytrees)
from spark_rapids_tpu.kernels import groupby_hash as JKG
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.sql import expressions as JE
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.kernels import groupby_hash as KG
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.sql import expressions as PE
from spark_rapids_tpu_torch.sql import types as PT

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _table_inputs(cap, n_keys, seed, K=2, n_add=3, n_min=1, n_max=2):
    rng = np.random.default_rng(seed)
    base = rng.integers(-2**62, 2**62, (n_keys, K))
    g = rng.integers(0, n_keys, cap)
    kw = base[g]
    h = rng.integers(-2**62, 2**62, n_keys)[g]
    valid = rng.random(cap) > 0.1
    add = rng.integers(-2**40, 2**40, (cap, n_add))
    mn = rng.integers(-2**40, 2**40, (cap, n_min))
    mx = rng.integers(-2**40, 2**40, (cap, n_max))
    return kw, h, valid, add, mn, mx


def _as_set(row, used, add, mn, mx):
    return {(int(row[s]), tuple(add[s]), tuple(mn[s]), tuple(mx[s]))
            for s in range(len(used)) if used[s]}


def _jax_table(kw, h, valid, add, mn, mx, slots):
    fn = JKG._build_kernel(kw.shape[0], kw.shape[1], add.shape[1],
                           mn.shape[1], mx.shape[1], slots, True)
    row, used, a, n_, x, ovf = jax.jit(fn)(
        jnp.asarray(kw), jnp.asarray(h), jnp.asarray(valid),
        jnp.asarray(add), jnp.asarray(mn), jnp.asarray(mx))
    return (np.asarray(row), np.asarray(used), np.asarray(a),
            np.asarray(n_), np.asarray(x), bool(np.asarray(ovf)[0]))


def _port_table(kw, h, valid, add, mn, mx, slots):
    """The port's table pass on the same rows; its lanes are lane-major,
    ``(n_lanes, cap)``, the transpose of the JAX kernel's."""
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (kw, h, valid, add.T, mn.T, mx.T)]
    KR.reset_launches()
    owner, a, n_, x, ovf = KG.groupby_table(*t, slots)
    assert KR.LAUNCHES["groupbyHash"] == 0  # CPU tensors: plain version
    owner = owner.numpy()
    return (owner, owner >= 0, a.numpy(), n_.numpy(), x.numpy(),
            bool(ovf.numpy()[0]))


@pytest.mark.parametrize("cap,n_keys,slots,seed", [
    (512, 6, 64, 1), (1024, 40, 128, 2), (256, 1, 64, 3),
    (2048, 300, 1024, 4)])
def test_table_pass_matches_jax_kernel(cap, n_keys, slots, seed):
    ins = _table_inputs(cap, n_keys, seed)
    jr, ju, ja, jn, jx, jovf = _jax_table(*ins, slots)
    pr, pu, pa, pn, px, povf = _port_table(*ins, slots)
    assert not jovf and not povf
    assert int(pu.sum()) == int(ju.sum())
    assert _as_set(pr, pu, pa, pn, px) == _as_set(jr, ju, ja, jn, jx)


def test_overflow_flag_when_groups_exceed_slots():
    ins = _table_inputs(512, 200, 5)
    *_j, jovf = _jax_table(*ins, 64)
    *_p, povf = _port_table(*ins, 64)
    assert jovf and povf


def _key_batch(n, seed):
    """q1-shaped string keys plus an int key and a decimal with nulls."""
    rng = np.random.default_rng(seed)
    rf = np.array(["A", "N", "R", "", "long-key-value"],
                  dtype=object)[rng.integers(0, 5, n)]
    ls = np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)]
    k = rng.integers(-5, 5, n).astype(np.int32)
    q = rng.integers(-10**12, 10**12, n)
    v = rng.integers(-10**6, 10**6, n)
    valid = [rng.random(n) > 0.1, None, rng.random(n) > 0.2,
             rng.random(n) > 0.1, rng.random(n) > 0.1]
    return [("rf", "str", rf), ("ls", "str", ls), ("k", "int", k),
            ("q", "dec", q), ("v", "long", v)], valid


def _types(mod):
    return {"str": mod.StringT, "int": mod.IntegerT,
            "dec": mod.DecimalType(15, 2), "long": mod.LongT}


def _both_batches(cols, valid, n):
    jt, pt = _types(JT), _types(PT)
    schema = JT.StructType([JT.StructField(name, jt[t])
                            for name, t, _v in cols])
    hcols = [JHostColumn(f.data_type, vals,
                         np.ones(n, bool) if ok is None else ok).normalized()
             for f, (_n, _t, vals), ok in zip(schema.fields, cols, valid)]
    jb = JDeviceBatch.from_host(JHostBatch(schema, hcols, n))
    pb = DeviceBatch.from_host(host_batch_from_numpy(
        [(name, pt[t]) for name, t, _v in cols],
        [v for _n, _t, v in cols], valid), CPU)
    return jb, pb


def test_key_words_and_hash_bit_exact():
    n = 700
    cols, valid = _key_batch(n, 6)
    jb, pb = _both_batches(cols, valid, n)
    jwords, pwords = [], []
    for c in jb.columns[:3]:
        jwords.extend(JG.grouping_subkeys(c, True))
    for c in pb.columns[:3]:
        pwords.extend(G.grouping_subkeys(c))
    jkw = np.asarray(JKG.pack_words_i64(jwords))
    pkw = KG.pack_words_i64(pwords).numpy()
    assert np.array_equal(jkw, pkw)
    jh = np.asarray(JG.hash_subkey_words(jwords).view(jnp.int64))
    ph = G.hash_subkey_words(pwords).numpy()
    assert np.array_equal(jh, ph)


def _entries(cols, mod_e, mod_t):
    """(col, prim, out_type) for sum(q) into decimal(25,2), count(v),
    sum_nonnull(v), min(v), max(k)."""
    q, v, k = cols[3], cols[4], cols[2]
    return [(q, mod_e.PRIM_SUM, mod_t.DecimalType(25, 2)),
            (v, mod_e.PRIM_COUNT, mod_t.LongT),
            (v, mod_e.PRIM_SUM_NONNULL, mod_t.LongT),
            (v, mod_e.PRIM_MIN, mod_t.LongT),
            (k, mod_e.PRIM_MAX, mod_t.IntegerT)]


def _decoded_rows(key_out, buffers, used, hi_lo):
    """One tuple per used slot: key columns (validity + value words) and
    every buffer (validity + value)."""
    rows = set()
    used = np.asarray(used)
    for s in np.nonzero(used)[0]:
        row = []
        for c in list(key_out) + list(buffers):
            vals = hi_lo(c)
            row.append(tuple(np.asarray(a)[s].tobytes() for a in vals))
        rows.add(tuple(row))
    return rows


def _arrays(c):
    if hasattr(c, "chars"):
        return (c.validity, c.lengths, c.chars)
    if hasattr(c, "hi"):
        return (c.validity, c.hi, c.lo)
    return (c.validity, c.data)


def test_hash_groupby_decode_matches_jax():
    n = 900
    cols, valid = _key_batch(n, 8)
    jb, pb = _both_batches(cols, valid, n)
    slots = 256
    jk, jbuf, jused, _cnt, jovf = jax.jit(
        lambda cs, act: JKG.hash_groupby(
            cs[:3], _entries(cs, JE, JT), act, slots))(jb.columns,
                                                       jb.active)
    pk, pbuf, pused, povf = KG.hash_groupby(
        pb.columns[:3], _entries(pb.columns, PE, PT), pb.active, slots)
    assert not bool(np.asarray(jovf)) and not bool(povf.numpy()[0])

    def jarr(c):
        return tuple(np.asarray(a) for a in _arrays(c))

    def parr(c):
        return tuple(a.numpy() for a in _arrays(c))
    want = _decoded_rows(jk, jbuf, jused, jarr)
    got = _decoded_rows(pk, pbuf, pused, parr)
    assert len(want) > 10
    assert got == want


def test_plan_lanes_encoding_bit_exact():
    n = 300
    cols, valid = _key_batch(n, 9)
    jb, pb = _both_batches(cols, valid, n)
    ja, jn, jx, _jd = JKG.plan_lanes(_entries(jb.columns, JE, JT),
                                     jb.active)
    pa, pn, px, _pd = KG.plan_lanes(_entries(pb.columns, PE, PT),
                                    pb.active)
    for js, ps in ((ja, pa), (jn, pn), (jx, px)):
        assert len(js) == len(ps)
        for a, b in zip(js, ps):
            assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("slots", [64, 128, 1024, 1 << 16])
def test_local_table_sizing_fits_shared_memory(slots):
    """Each kernel block's shared-memory group table: a power of two of
    entries (or 0), at most ``slots``, that fits in the 227 KB a block can
    use, for 1 to 64 lanes; more lanes never get more entries."""
    prev = None
    for n_lanes in range(1, 65):
        L = KG.local_table_entries(n_lanes, slots)
        assert L == 0 or (L & (L - 1)) == 0
        assert L <= slots
        cache = 4 * slots if slots <= KG.OWNER_CACHE_SLOTS else 0
        assert L * (8 * n_lanes + 8) + cache <= min(KG.LOCAL_TABLE_BYTES,
                                                    232_448)
        assert prev is None or L <= prev
        prev = L
    # q1's partial aggregate (21 add lanes, 1024 slots) gets one entry a
    # slot; the widest case keeps a table
    assert KG.local_table_entries(21, 1024) == 1024
    assert KG.local_table_entries(64, slots) > 0
    assert KG.local_table_entries(30_000, slots) == 0


def test_lane_matrix_is_lane_major():
    lanes = [torch.arange(5) * (j + 1) for j in range(3)]
    m = KG._lane_matrix(lanes, 5, CPU)
    assert m.shape == (3, 5) and m.is_contiguous()
    assert torch.equal(m[1], lanes[1])
    assert KG._lane_matrix([], 5, CPU).shape == (0, 5)
