"""The port's joinProbe (its plain version behind the kernel wrapper, on
CPU tensors) against the JAX package's Pallas ``build_probe`` run in
interpret mode: ``matched`` and ``first_row`` equal per row, for raw key
words and for evaluated key columns (a long plus a padded string key,
and a string key alone), with duplicate build keys, invalid rows on both
sides (up to every row of one side), stream keys that match nothing and
a build side at the 8,192-row cap (16,384 slots). The JAX kernel takes
its own hashes; the port's kernel hashes the key words itself, so its
wrapper takes none. Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.device import DeviceBatch as JDeviceBatch
from spark_rapids_tpu.columnar.host import HostBatch as JHostBatch
from spark_rapids_tpu.columnar.host import HostColumn as JHostColumn
import spark_rapids_tpu.ops.exprs  # noqa: F401  (device-column pytrees)
import spark_rapids_tpu.ops.groupby  # noqa: F401
import spark_rapids_tpu.ops.lanes  # noqa: F401
from spark_rapids_tpu.kernels import groupby_hash as JKG
from spark_rapids_tpu.kernels import join_probe as JKJ
from spark_rapids_tpu.ops import groupby as JG
from spark_rapids_tpu.ops import join as JJ
from spark_rapids_tpu.sql import types as JT

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar.device import DeviceBatch
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.kernels import groupby_hash as KG
from spark_rapids_tpu_torch.kernels import join_probe as KJ
from spark_rapids_tpu_torch.ops import groupby as G
from spark_rapids_tpu_torch.ops import join as J
from spark_rapids_tpu_torch.sql import types as PT

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _jax_probe(kw_r, valid_r, kw_l, valid_l):
    """JAX words (uint64) -> the JAX kernel's (matched, first_row)."""
    @jax.jit
    def run(kr, vr, kl, vl):
        wr = [kr[:, i] for i in range(kr.shape[1])]
        wl = [kl[:, i] for i in range(kl.shape[1])]
        return JKJ.build_probe(
            JKG.pack_words_i64(wr), JG.hash_subkey_words(wr).view(jnp.int64),
            vr, JKG.pack_words_i64(wl),
            JG.hash_subkey_words(wl).view(jnp.int64), vl)
    m, ri = run(jnp.asarray(kw_r.view(np.uint64)), jnp.asarray(valid_r),
                jnp.asarray(kw_l.view(np.uint64)), jnp.asarray(valid_l))
    return np.asarray(m), np.asarray(ri)


def _port_probe(kw_r, valid_r, kw_l, valid_l):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (kw_r, valid_r, kw_l, valid_l)]
    wr = [t[0][:, i] for i in range(t[0].shape[1])]
    wl = [t[2][:, i] for i in range(t[2].shape[1])]
    KR.reset_launches()
    m, ri = KJ.build_probe(KG.pack_words_i64(wr), t[1],
                           KG.pack_words_i64(wl), t[3])
    assert KR.LAUNCHES["joinProbe"] == 0  # CPU tensors: plain version
    assert m.dtype == torch.bool and ri.dtype == torch.int32
    return m.numpy(), ri.numpy()


def _raw_case(cap_r, cap_l, K, n_keys, seed, dup=True, miss_all=False):
    rng = np.random.default_rng(seed)
    base = rng.integers(-2**62, 2**62, (n_keys, K))
    if dup:
        kw_r = base[rng.integers(0, n_keys, cap_r)]
    else:
        kw_r = base[rng.permutation(max(n_keys, cap_r))[:cap_r] % n_keys]
    valid_r = rng.random(cap_r) > 0.2
    if miss_all:
        kw_l = rng.integers(-2**62, 2**62, (cap_l, K)) | 1
        kw_r = kw_r & ~1  # disjoint from every left key
    else:
        pick = rng.integers(0, 2 * n_keys, cap_l)
        kw_l = np.where((pick < n_keys)[:, None],
                        base[np.minimum(pick, n_keys - 1)],
                        rng.integers(-2**62, 2**62, (cap_l, K)))
    valid_l = rng.random(cap_l) > 0.2
    return kw_r, valid_r, kw_l, valid_l


@pytest.mark.parametrize("cap_r,cap_l,K,n_keys,seed,dup", [
    (1, 64, 1, 1, 1, False),
    (64, 256, 1, 40, 2, True),
    (64, 320, 2, 20, 3, True),
    (5000, 2048, 1, 6000, 4, False),
    (5000, 1024, 2, 900, 5, True),
])
def test_build_probe_matches_jax_kernel(cap_r, cap_l, K, n_keys, seed, dup):
    ins = _raw_case(cap_r, cap_l, K, n_keys, seed, dup)
    jm, jri = _jax_probe(*ins)
    pm, pri = _port_probe(*ins)
    assert jm.any() and not jm.all()
    assert np.array_equal(pm, jm)
    assert np.array_equal(pri, jri)
    # invalid left rows never match; first_row is 0 where unmatched
    assert not pm[~ins[3]].any()
    assert (pri[~pm] == 0).all()


def test_build_probe_left_side_matching_nothing():
    ins = _raw_case(64, 256, 2, 30, 6, miss_all=True)
    jm, jri = _jax_probe(*ins)
    pm, pri = _port_probe(*ins)
    assert not jm.any() and not pm.any()
    assert np.array_equal(pri, jri) and (pri == 0).all()


def test_build_probe_smallest_row_of_duplicate_keys():
    """Every build key appears three times (rows r, r+n, r+2n), the first
    copy invalid for some keys: first_row is the smallest VALID row."""
    n = 50
    keys = np.arange(n, dtype=np.int64) * 7919
    kw_r = np.concatenate([keys, keys, keys])[:, None]
    valid_r = np.ones(3 * n, bool)
    valid_r[:n:2] = False
    kw_l = np.concatenate([keys, keys + 1])[:, None]
    valid_l = np.ones(2 * n, bool)
    jm, jri = _jax_probe(kw_r, valid_r, kw_l, valid_l)
    pm, pri = _port_probe(kw_r, valid_r, kw_l, valid_l)
    want = np.where(np.arange(n) % 2 == 0, np.arange(n) + n, np.arange(n))
    assert np.array_equal(pri[:n], want) and pm[:n].all()
    assert np.array_equal(pm, jm) and np.array_equal(pri, jri)


def _edge_case(name):
    """Raw inputs for the named edge case."""
    if name == "cap_8192_k1":  # a build side at the cap: 16,384 slots
        return _raw_case(8192, 1024, 1, 7000, 21, dup=False)
    if name == "cap_8192_k2_duplicates":
        return _raw_case(8192, 1024, 2, 600, 22, dup=True)
    if name == "every_build_row_invalid":
        kw_r, valid_r, kw_l, valid_l = _raw_case(300, 512, 2, 40, 23)
        return kw_r, np.zeros_like(valid_r), kw_l, valid_l
    if name == "every_stream_row_invalid":
        kw_r, valid_r, kw_l, valid_l = _raw_case(300, 512, 1, 40, 24)
        return kw_r, valid_r, kw_l, np.zeros_like(valid_l)
    # eight copies of every key at random rows, a third of them invalid:
    # first_row is the smallest valid copy
    rng = np.random.default_rng(25)
    keys = rng.integers(-2**62, 2**62, (500, 1))
    kw_r = keys[rng.permutation(np.repeat(np.arange(500), 8))]
    valid_r = rng.random(4000) > 0.33
    kw_l = np.concatenate([keys, keys + 1])
    return kw_r, valid_r, kw_l, np.ones(1000, bool)


@pytest.mark.parametrize("name", [
    "cap_8192_k1", "cap_8192_k2_duplicates", "every_build_row_invalid",
    "every_stream_row_invalid", "duplicates_smallest_valid_row"])
def test_build_probe_edge_cases_match_jax_kernel(name):
    kw_r, valid_r, kw_l, valid_l = ins = _edge_case(name)
    jm, jri = _jax_probe(*ins)
    pm, pri = _port_probe(*ins)
    assert np.array_equal(pm, jm)
    assert np.array_equal(pri, jri)
    if name.startswith("cap_8192"):
        assert KJ.probe_table_slots(kw_r.shape[0]) == 16384
        assert jm.any() and not jm.all()
    if name.startswith("every"):
        assert not pm.any() and (pri == 0).all()
    if name == "duplicates_smallest_valid_row":
        for i in np.nonzero(pm)[0]:
            rows = np.nonzero((kw_r[:, 0] == kw_l[i, 0]) & valid_r)[0]
            assert pri[i] == rows.min()
        assert pm[:500].sum() > 490 and not pm[500:].any()


def _key_batches(n, seed, strings):
    """Right and left sides with a long key and a string key; the left
    side's strings are longer, so its char capacity is wider."""
    rng = np.random.default_rng(seed)
    out = []
    for side, width in (("r", 3), ("l", 21)):
        k = rng.integers(0, 12, n)
        s = np.array([strings[i % len(strings)][:width]
                      for i in rng.integers(0, len(strings), n)],
                     dtype=object)
        kv = rng.random(n) > 0.1
        sv = rng.random(n) > 0.1
        out.append(([k, s], [kv, sv]))
    return out


def _both(arrays, valid):
    n = len(arrays[0])
    jschema = JT.StructType([JT.StructField("k", JT.LongT),
                             JT.StructField("s", JT.StringT)])
    jb = JDeviceBatch.from_host(JHostBatch(jschema, [
        JHostColumn(f.data_type, np.asarray(a), v).normalized()
        for f, a, v in zip(jschema.fields, arrays, valid)], n))
    pb = DeviceBatch.from_host(host_batch_from_numpy(
        [("k", PT.LongT), ("s", PT.StringT)], arrays, valid), CPU)
    return jb, pb


@pytest.mark.parametrize("null_safe", [(False, False), (True, False)])
def test_key_columns_long_and_padded_string(null_safe):
    """Evaluated key columns through each package's own key layout:
    string char caps aligned, null-safe validity words, the same key
    words and hashes bit for bit, then the same probe result."""
    strings = ["", "a", "ab", "abcdefgh", "abcdefghijklmnopqrstu", "x\x00y"]
    (ra, rv), (la, lv) = _key_batches(300, 7, strings)
    jr, pr = _both(ra, rv)
    jl, pl = _both(la, lv)
    assert jr.columns[1].char_cap != jl.columns[1].char_cap
    ns = list(null_safe)

    def valid_of(b, ns_):
        v = b.active
        for c, nsf in zip(b.columns, ns_):
            if not nsf:
                v = v & c.validity
        return v

    jkl, jkr = JJ._align_string_caps(jl.columns, jr.columns)
    jwl, jwr = JJ._key_words(jkl, ns), JJ._key_words(jkr, ns)
    pkl, pkr = J._align_string_caps(pl.columns, pr.columns)
    pwl, pwr = J._key_words(pkl, ns), J._key_words(pkr, ns)
    for jw, pw in ((jwl, pwl), (jwr, pwr)):
        assert np.array_equal(np.asarray(JKG.pack_words_i64(jw)),
                              KG.pack_words_i64(pw).numpy())
        assert np.array_equal(
            np.asarray(JG.hash_subkey_words(jw).view(jnp.int64)),
            G.hash_subkey_words(pw).numpy())

    jm, jri = jax.jit(lambda wr, vr, wl, vl: JKJ.build_probe(
        JKG.pack_words_i64(wr), JG.hash_subkey_words(wr).view(jnp.int64),
        vr, JKG.pack_words_i64(wl),
        JG.hash_subkey_words(wl).view(jnp.int64), vl))(
            jwr, valid_of(jr, ns), jwl, valid_of(jl, ns))
    pm, pri = KJ.build_probe(KG.pack_words_i64(pwr), valid_of(pr, ns),
                             KG.pack_words_i64(pwl), valid_of(pl, ns))
    assert np.asarray(jm).any()
    assert np.array_equal(pm.numpy(), np.asarray(jm))
    assert np.array_equal(pri.numpy(), np.asarray(jri))


def test_key_column_padded_string_alone():
    """A string key alone: the build side's char cap (8) padded to the
    stream side's (24) before the words are made; the same words, then
    the same probe result as the JAX kernel."""
    strings = ["", "a", "ab", "abcdefgh", "abcdefghijklmnopqrstu", "x\x00y",
               "abcdefg\xff"]
    rng = np.random.default_rng(31)
    sides = []
    for n, width in ((200, 8), (700, 24)):
        s = np.array([strings[i][:width]
                      for i in rng.integers(0, len(strings), n)],
                     dtype=object)
        v = rng.random(n) > 0.1
        jschema = JT.StructType([JT.StructField("s", JT.StringT)])
        jb = JDeviceBatch.from_host(JHostBatch(jschema, [
            JHostColumn(JT.StringT, s, v).normalized()], n))
        pb = DeviceBatch.from_host(host_batch_from_numpy(
            [("s", PT.StringT)], [s], [v]), CPU)
        sides.append((jb, pb))
    (jr, pr), (jl, pl) = sides
    assert pr.columns[0].char_cap != pl.columns[0].char_cap
    jkl, jkr = JJ._align_string_caps(jl.columns, jr.columns)
    pkl, pkr = J._align_string_caps(pl.columns, pr.columns)
    jwl, jwr = JJ._key_words(jkl, [False]), JJ._key_words(jkr, [False])
    pwl, pwr = J._key_words(pkl, [False]), J._key_words(pkr, [False])
    assert len(pwl) == len(jwl) >= 2
    for jw, pw in ((jwl, pwl), (jwr, pwr)):
        assert np.array_equal(np.asarray(JKG.pack_words_i64(jw)),
                              KG.pack_words_i64(pw).numpy())
    vr = pr.active & pr.columns[0].validity
    vl = pl.active & pl.columns[0].validity
    jm, jri = _jax_probe(KG.pack_words_i64(pwr).numpy(), vr.numpy(),
                         KG.pack_words_i64(pwl).numpy(), vl.numpy())
    pm, pri = KJ.build_probe(KG.pack_words_i64(pwr), vr,
                             KG.pack_words_i64(pwl), vl)
    assert jm.any() and not jm.all()
    assert np.array_equal(pm.numpy(), jm)
    assert np.array_equal(pri.numpy(), jri)


@pytest.mark.parametrize("n_r,routed", [(300, 1), (9000, 0)])
@pytest.mark.parametrize("join_type", ["leftsemi", "leftanti"])
def test_device_join_takes_probe_route_within_cap(n_r, routed, join_type):
    """``device_join`` takes the joinProbe route exactly when the build
    capacity is within the JAX package's default cap, with no setting
    needed, and its mask equals the sort-based plan's."""
    from spark_rapids_tpu.conf import KERNEL_JOIN_MAX_BUILD_ROWS as JCAP
    from spark_rapids_tpu_torch.sql import expressions as PE
    assert J._MAX_BUILD_ROWS == JCAP.default
    strings = ["", "a", "ab", "abcdefgh"]
    (ra, rv), _ = _key_batches(n_r, 3, strings)
    (_, _), (la, lv) = _key_batches(500, 4, strings)
    _jr, pr = _both(ra, rv)
    _jl, pl = _both(la, lv)
    assert (pr.capacity <= J._MAX_BUILD_ROWS) == bool(routed)
    keys = [PE.BoundReference(0, PT.LongT, True),
            PE.BoundReference(1, PT.StringT, True)]
    counts = {}
    out = J.device_join(pl, pr, keys, keys, join_type, pl.schema,
                        counts=counts)
    assert counts.get("joinProbe", 0) == routed
    want = J._mask_sorted(pl, pr, keys, keys, join_type, (False, False))
    assert out.active.any()
    assert torch.equal(out.active, want)


def test_probe_table_slots_equal():
    for cap in list(range(0, 300)) + [1023, 1024, 1025, 4096, 5000, 6144,
                                      8192, 8193, 81920]:
        assert KJ.probe_table_slots(cap) == JKJ.probe_table_slots(cap)
    assert KJ.probe_table_slots(6144) == 16384
