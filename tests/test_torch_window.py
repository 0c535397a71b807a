"""The port's window functions against the JAX package's: the JAX
package's own 20 cases of ``tests/test_device_window.py`` (ranking,
running and whole-partition aggregates, bounded ROWS and value-bounded
RANGE frames with NaN and nulls, lag/lead over strings and decimal128,
a window over a filter, a global window, key batching over a tiny batch
goal and store pool), each run through the JAX package's device path
and through ``TorchSparkSession(device="cpu")`` (``tests/torch_dual.py``).

Tolerances: rows are exact (NaN equal to NaN, -0.0 distinct from 0.0),
integer, rank and offset results included; a case the JAX package marks
approximate (the whole-partition aggregates, avg among them) holds
floats within rel_tol=1e-12, since the port's segmented float scan adds
in another order than XLA's. A case the JAX package keeps on the CPU
(a float window sum with ``variableFloatAgg`` off) runs on the port's
host engine, placed as in the JAX package, with the JAX package's reason
in the explain lines; its rows are also held against a numpy reference
within rel_tol=1e-12, once as the session runs it and once with one
device permit and the upload ring two units deep (the host window drained
on the ring's producer thread between two transitions), each under a
time limit of its own: the JAX package's own CPU window has hung there.

Also here: the window's running and bounded min/max tie rules, each held
against the JAX window's own (``_seg_running_extreme`` keeps the later
of two tied rows, ``_sparse_table_extreme`` the earlier), bit for bit.
"""

import math
import signal
import struct

import numpy as np
import pytest

from spark_rapids_tpu_torch.sql import functions as PF
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests import test_device_window as JW
from tests.datagen import DoubleGen, IntegerGen, SmallIntGen
from tests.torch_dual import port_batch, run_case

LIMIT_S = 120

CASES = [
    ("test_ranking_functions", 4), ("test_running_aggregates", 4),
    ("test_whole_partition_aggregates", 5),
    ("test_bounded_rows_frame_sum_count", 0), ("test_rows_running_frame", 0),
    ("test_lag_lead", 0), ("test_lag_string_values", 0),
    ("test_first_last_over_partition", 0), ("test_window_no_partition", 0),
    ("test_window_string_partition_keys", 0),
    ("test_float_window_sum_falls_back", 0), ("test_bounded_min_on_device", 0),
    ("test_window_then_filter_pipeline", 0),
    ("test_lag_string_with_default", 0), ("test_bounded_rows_min_max", 0),
    ("test_value_bounded_range_frames", 0),
    ("test_value_bounded_range_desc_and_nulls", 0),
    ("test_window_key_batching_over_budget", 0),
    ("test_value_bounded_range_nan_order_values", 0),
    ("test_lag_lead_decimal128_on_device", 0),
]


def _params():
    """The JAX cases, each parametrised case by its index into the JAX
    test's own parameter list."""
    out = []
    for name, n in CASES:
        if n == 0:
            out.append(pytest.param(name, None, id=name))
        for i in range(n):
            out.append(pytest.param(name, i, id=f"{name}[{i}]"))
    return out


def _jax_param(name: str, i: int):
    fn = getattr(JW, name)
    mark = next(m for m in fn.pytestmark if m.name == "parametrize")
    return mark.args[1][i]


@pytest.mark.parametrize("name,i", _params())
def test_window_case(name, i):
    if i is None:
        rec = run_case(JW, name)
    else:
        rec = run_case(JW, name, _jax_param(name, i))
    if name == "test_float_window_sum_falls_back":
        assert rec.messages and "variableFloatAgg" in rec.messages[0]
        assert rec.reports[0].fallbacks[0][0] == "CpuWindowExec"
        for conf in ({}, {"spark.rapids.sql.concurrentGpuTasks": "1",
                          "spark.rapids.sql.format.parquet.deviceDecode"
                          ".maxInFlight": "2"}):
            _float_window_sum_against_numpy(conf)


def _float_window_sum_against_numpy(conf):
    """``test_float_window_sum_falls_back``'s query on the port (a
    running double sum over ``k`` ordered by ``o``, the window on the
    host) against numpy, under a time limit."""
    from tests.datagen import gen_batch
    jb = gen_batch([("k", SmallIntGen()), ("o", IntegerGen()),
                    ("v", DoubleGen())], JW.N, 13)
    cols = {f.name: (c.data, c.validity)
            for f, c in zip(jb.schema.fields, jb.columns)}

    def expire(_sig, _frame):
        raise TimeoutError(f"the host window ran over {LIMIT_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT_S)
    try:
        s = TorchSparkSession(conf, device="cpu")
        w = PF.Window.partitionBy("k").orderBy("o")
        got = [tuple(r) for r in s.createDataFrame(
            port_batch(jb), num_partitions=2).select(
            "k", PF.sum("v").over(w).alias("s")).collect()]
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert [n for n, _ in s.last_rewrite_report.fallbacks] == \
        ["CpuWindowExec"]
    (k, kv), (o, ov), (v, vv) = cols["k"], cols["o"], cols["v"]
    want = []
    for key in {(int(x) if ok else None) for x, ok in zip(k, kv)}:
        rows = [i for i in range(len(k))
                if (int(k[i]) if kv[i] else None) == key]
        # nulls first, then ascending; peers share the running sum
        rows.sort(key=lambda i: (ov[i], int(o[i])) if ov[i] else (False,))
        order = [(int(o[i]) if ov[i] else None) for i in rows]
        for j, i in enumerate(rows):
            peers = [r for r, x in zip(rows, order) if x == order[j]]
            last = max(rows.index(r) for r in peers)
            vals = [float(v[r]) for r in rows[:last + 1] if vv[r]]
            want.append((key, math.fsum(vals) if vals else None))
    assert len(got) == len(want)
    by_key = {}
    for key, val in got:
        by_key.setdefault(key, []).append(val)
    def order(x):
        nan = x is not None and math.isnan(x)
        return (x is None, nan, 0.0 if x is None or nan else x)
    for key in by_key:
        g = sorted(by_key[key], key=order)
        w_ = sorted([val for kk, val in want if kk == key], key=order)
        assert len(g) == len(w_)
        for a, b in zip(g, w_):
            assert (a is None and b is None) or (
                a is not None and b is not None and (
                    (math.isnan(a) and math.isnan(b))
                    or math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-9))), \
                (key, a, b)


ZERO_TIES = [0.0, -0.0, 2.0, -0.0, 0.0, -1.0, -1.0, 0.0, -0.0, 3.0]


@pytest.mark.parametrize("frame", ["running_rows", "running_range",
                                   "whole", "bounded"])
@pytest.mark.parametrize("fn", ["min", "max"])
def test_min_max_ties_follow_the_jax_window(frame, fn):
    """Running and bounded min/max over -0.0/0.0 ties (and NaNs of two
    payloads, which also tie), bit for bit against the JAX window: the
    running scan keeps the later tied row, the bounded sparse table the
    earlier one."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as PF
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    nan_a = np.array([0x7FF8000000000001], np.uint64).view(np.float64)[0]
    nan_b = np.array([0x7FF8000000000ABC], np.uint64).view(np.float64)[0]
    vals = ZERO_TIES + [nan_a, 1.0, nan_b, nan_a]
    n = len(vals)
    data = {"k": [1] * n, "o": list(range(n)), "v": vals}

    def q(s, F):
        w = F.Window.partitionBy("k").orderBy("o")
        w = {"running_rows": w.rowsBetween(F.Window.unboundedPreceding, 0),
             "running_range": w,
             "whole": F.Window.partitionBy("k"),
             "bounded": w.rowsBetween(-2, 1)}[frame]
        f = getattr(F, fn)
        return s.createDataFrame(data, "k int, o int, v double",
                                 num_partitions=1).select(
            "o", f("v").over(w).alias("m"))

    js = TpuSparkSession({"spark.rapids.sql.enabled": "true"})
    try:
        want = sorted(tuple(r) for r in q(js, JF).collect())
    finally:
        js.stop()
    got = sorted(tuple(r) for r in q(TorchSparkSession({}, device="cpu"),
                                     PF).collect())
    assert [(o, struct.pack("<d", m)) for o, m in want] == \
        [(o, struct.pack("<d", m)) for o, m in got]


def test_bounded_rows_float_sum_within_the_prefix_tolerance():
    """A bounded ROWS frame over doubles is a difference of two prefix
    sums, so its error scales with the prefix, not with the result: each
    value is held within 1e-12 of the largest absolute prefix sum of its
    partition against the JAX package's (the stated tolerance);
    the counts are exact."""
    from spark_rapids_tpu.sql import functions as JF
    from spark_rapids_tpu.sql.session import TpuSparkSession
    from spark_rapids_tpu_torch.sql import functions as PF
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    rng = np.random.default_rng(5)
    n = 600
    k = rng.integers(0, 4, n)
    v = np.where(rng.random(n) < 0.5, rng.normal(0, 1e6, n),
                 rng.normal(0, 1e-3, n))
    data = {"k": k.tolist(), "o": list(range(n)), "v": v.tolist()}
    conf = {"spark.rapids.sql.variableFloatAgg.enabled": "true"}

    def q(s, F):
        w = F.Window.partitionBy("k").orderBy("o").rowsBetween(-3, 2)
        return s.createDataFrame(data, "k int, o int, v double",
                                 num_partitions=2).select(
            "k", "o", F.sum("v").over(w).alias("s"),
            F.count("v").over(w).alias("c"))

    js = TpuSparkSession(dict(conf, **{"spark.rapids.sql.enabled": "true"}))
    try:
        want = sorted(tuple(r) for r in q(js, JF).collect())
    finally:
        js.stop()
    got = sorted(tuple(r) for r in q(TorchSparkSession(conf, device="cpu"),
                                     PF).collect())
    bound = {}
    for g in range(4):
        part = v[k == g]
        bound[g] = float(np.max(np.abs(np.cumsum(part))))
    assert [(a, b, d) for a, b, _s, d in got] == \
        [(a, b, d) for a, b, _s, d in want]
    for (kk, _o, s_got, _c), (_k, _o2, s_want, _c2) in zip(got, want):
        assert abs(s_got - s_want) <= 1e-12 * bound[kk], (s_got, s_want)
