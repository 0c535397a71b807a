"""Each plain function of the port's ``ops/rle.py`` against
``spark_rapids_tpu.ops.rle`` on the same seeded numpy inputs, exactly:
bit widths 0/1/32/33/64, offsets at and past the end of the buffer
(both packages clamp), negative FLBA values and decimal128 limbs, and
int64 sums that wrap."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import rle as J

from spark_rapids_tpu_torch.ops import rle as P

torch.set_num_threads(2)


def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _both(fn_name, *args):
    """Run ``fn_name`` in both packages on numpy ``args`` (ints stay
    Python ints); return the two results as numpy arrays."""
    j = getattr(J, fn_name)(*[_jnp(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    p = getattr(P, fn_name)(*[torch.from_numpy(a)
                              if isinstance(a, np.ndarray) else a
                              for a in args])
    if isinstance(j, tuple):
        return ([np.asarray(x) for x in j], [x.numpy() for x in p])
    return np.asarray(j), p.numpy()


def _same(j, p):
    if isinstance(j, list):
        for a, b in zip(j, p):
            _same(a, b)
        return
    assert j.dtype == p.dtype and j.shape == p.shape, (j.dtype, p.dtype)
    assert np.array_equal(j, p), (j[:8], p[:8])


def _bytes(rng, n=257):
    """An int32 byte array (values 0..255) as ``bytes_of_words`` makes
    it, from ``n`` random bytes padded to whole words."""
    raw = rng.integers(0, 256, (n + 3) // 4 * 4).astype(np.uint8)
    return np.array(J.bytes_of_words(_jnp(raw.view(np.int32))))


def test_bytes_of_words():
    rng = np.random.default_rng(1)
    words = rng.integers(-2**31, 2**31, 300).astype(np.int32)
    _same(*_both("bytes_of_words", words))


@pytest.mark.parametrize("width", [0, 1, 7, 31, 32])
def test_read_packed(width):
    rng = np.random.default_rng(2 + width)
    b = _bytes(rng)
    nbits = b.shape[0] * 8
    # offsets across the buffer, including windows that run off its end
    off = np.concatenate([rng.integers(0, nbits, 200),
                          np.arange(nbits - 40, nbits + 9)]).astype(np.int64)
    w = np.full(off.shape[0], width, dtype=np.int64)
    _same(*_both("read_packed", b, off, w))


def test_read_packed_per_lane_widths():
    rng = np.random.default_rng(3)
    b = _bytes(rng)
    off = rng.integers(0, b.shape[0] * 8, 300).astype(np.int64)
    w = rng.integers(0, 33, 300).astype(np.int64)
    _same(*_both("read_packed", b, off, w))


@pytest.mark.parametrize("width", [0, 1, 32, 33, 47, 63, 64])
def test_read_packed64(width):
    rng = np.random.default_rng(4 + width)
    b = _bytes(rng, 600)
    nbits = b.shape[0] * 8
    off = np.concatenate([rng.integers(0, nbits, 200),
                          np.arange(nbits - 70, nbits + 3)]).astype(np.int64)
    w = np.full(off.shape[0], width, dtype=np.int64)
    _same(*_both("read_packed64", b, off, w))


def _run_table(rng, n_runs, pad_to, max_width, n_bits):
    """A random run table as the host planner pads it: ascending
    out_start with a 1<<62 sentinel tail, packed flags, RLE values,
    payload bit offsets and widths."""
    starts = np.sort(rng.choice(np.arange(1, 4000), n_runs - 1,
                                replace=False))
    os_ = np.full(pad_to, 1 << 62, dtype=np.int64)
    os_[:n_runs] = np.concatenate([[0], starts])
    pk = np.zeros(pad_to, dtype=bool)
    pk[:n_runs] = rng.random(n_runs) < 0.6
    va = np.zeros(pad_to, dtype=np.int64)
    va[:n_runs] = rng.integers(-2**62, 2**62, n_runs)
    bs = np.zeros(pad_to, dtype=np.int64)
    bs[:n_runs] = rng.integers(0, n_bits, n_runs)
    wd = np.ones(pad_to, dtype=np.int64)
    wd[:n_runs] = rng.integers(0, max_width + 1, n_runs)
    return [os_, pk, va, bs, wd]


@pytest.mark.parametrize("fn,max_width", [("hybrid_lookup", 32),
                                          ("delta_lookup", 64)])
def test_run_lookups(fn, max_width):
    rng = np.random.default_rng(5)
    b = _bytes(rng, 4096)
    runs = _run_table(rng, 40, 64, max_width, b.shape[0] * 8)
    pos = np.concatenate([np.arange(0, 4100),
                          [-3, 1 << 40]]).astype(np.int64)
    _same(*_both(fn, b, pos, *runs))


@pytest.mark.parametrize("nbytes", [4, 8])
def test_read_bss(nbytes):
    rng = np.random.default_rng(6)
    b = _bytes(rng, 900)
    m = 300
    base = rng.integers(0, 200, m).astype(np.int64)
    stride = rng.integers(0, 120, m).astype(np.int64)
    local = rng.integers(0, 120, m).astype(np.int64)
    _same(*_both("read_bss", b, base, stride, local, nbytes))


def test_gather_chars():
    rng = np.random.default_rng(7)
    b = _bytes(rng, 300)
    m = 200
    starts = np.concatenate([rng.integers(0, 300, m - 4),
                             [-5, 295, 299, 310]]).astype(np.int64)
    lengths = rng.integers(-2, 30, m).astype(np.int32)
    _same(*_both("gather_chars", b, starts, lengths, 24))


def test_seg_excl_cumsum_wraps():
    rng = np.random.default_rng(8)
    contrib = rng.integers(-2**62, 2**62, 500).astype(np.int64)
    lanes = np.arange(500)
    seg = np.maximum(lanes - rng.integers(0, 40, 500), 0).astype(np.int64)
    _same(*_both("seg_excl_cumsum", contrib, seg))


@pytest.mark.parametrize("nbytes", [1, 2, 3, 4, 7, 8])
def test_read_le(nbytes):
    rng = np.random.default_rng(9 + nbytes)
    b = _bytes(rng)
    off = np.concatenate([rng.integers(0, 250, 100),
                          np.arange(250, 262)]).astype(np.int64)
    _same(*_both("read_le", b, off, nbytes))


@pytest.mark.parametrize("nbytes", [1, 3, 7, 8])
def test_read_be_signed_negative(nbytes):
    rng = np.random.default_rng(20 + nbytes)
    b = _bytes(rng)
    off = np.concatenate([rng.integers(0, 250, 100),
                          np.arange(250, 262)]).astype(np.int64)
    j, p = _both("read_be_signed", b, off, nbytes)
    _same(j, p)
    assert (p < 0).any()  # high bytes >= 0x80 read as negative values
    want = [int.from_bytes(bytes(b[o:o + nbytes].astype(np.uint8)), "big",
                           signed=True) for o in off[:100]]
    assert p[:100].tolist() == want


@pytest.mark.parametrize("nbytes", [9, 12, 16])
def test_read_be_limbs_negative(nbytes):
    rng = np.random.default_rng(30 + nbytes)
    b = _bytes(rng)
    off = rng.integers(0, 240, 100).astype(np.int64)
    j, p = _both("read_be_limbs", b, off, nbytes)
    _same(j, p)
    hi, lo = p
    assert (hi < 0).any() and (lo < 0).any()
    for k, o in enumerate(off):
        full = int.from_bytes(bytes(b[o:o + nbytes].astype(np.uint8)),
                              "big", signed=True)
        assert int(hi[k]) == full >> 64
        assert int(lo[k]) & ((1 << 64) - 1) == full & ((1 << 64) - 1)


def test_dense_ranks():
    rng = np.random.default_rng(10)
    v = rng.random(1000) < 0.4
    v[:3] = False  # leading nulls rank -1, as in the JAX package
    _same(*_both("dense_ranks", v))
