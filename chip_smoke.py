#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: build its kernels, hold each
kernel against its plain PyTorch version, run TPC-H q1 at SF1 through
``TorchSparkSession`` and check the rows against an exact reference,
then time the query and each kernel.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; kernels build into ``build/kernels/``
at the repo root. Exits non-zero, printing no result, when CUDA is
absent or any phase fails. Output, one line per phase:

  1. the card (nvidia-smi name, power limit), torch and CUDA versions,
     whether ``pyarrow`` imports;
  2. the nvcc build seconds and the probe launch;
  3. kernel parity on the card: murmur3 at 1M rows over a type battery
     and at q1's exchange shapes (exact), groupbyHash at q1's partial
     shapes (the same groups and lanes) and an overflow case;
  4. q1 at SF1 (6,001,215 rows, 8 partitions) against an exact
     reference computed here with numpy and Python ints, with the
     executed plan all ``Torch*``, both kernels launched and no
     overflow re-run;
  5. q1 wall (one warm run, median of three) and rows/s; per-kernel
     device time, launches per q1, bound and plain-version time;
  then a ``{"kernels": [...]}`` line and, last, the contract line
  ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import decimal
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SF1_ROWS = 6_001_215
N_PARTITIONS = 8
SEED = 20260730
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

Q1 = """
SELECT
    l_returnflag,
    l_linestatus,
    sum(l_quantity) AS sum_qty,
    sum(l_extendedprice) AS sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    avg(l_quantity) AS avg_qty,
    avg(l_extendedprice) AS avg_price,
    avg(l_discount) AS avg_disc,
    count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def lineitem_arrays(n: int = SF1_ROWS, seed: int = SEED):
    """The seeded SF1 lineitem of bench.py's generator: decimal(15,2)
    money columns as unscaled int64, dates as days since the epoch."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n) * 100
    extendedprice = rng.integers(90100, 10494951, n)
    discount = rng.integers(0, 11, n)
    tax = rng.integers(0, 9, n)
    returnflag = np.array(["A", "N", "R"], dtype=object)[
        rng.integers(0, 3, n)]
    linestatus = np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n)]
    lo = (np.datetime64("1992-01-02") - np.datetime64("1970-01-01")).astype(
        int)
    hi = (np.datetime64("1998-12-01") - np.datetime64("1970-01-01")).astype(
        int)
    shipdate = rng.integers(lo, hi + 1, n).astype(np.int32)
    return [quantity, extendedprice, discount, tax, returnflag, linestatus,
            shipdate]


def _half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return -q if num < 0 else q


def q1_reference(arrays):
    """Exact q1 rows: unscaled sums as Python ints, the products at scale
    4 and 6, avg as HALF_UP at scale 6 (Spark's avg(decimal(15,2)) is
    decimal(19,6)). Returns [(rf, ls, (value, scale)...)] sorted."""
    qty, price, disc, tax, rf, ls, ship = arrays
    cutoff = (np.datetime64("1998-09-02")
              - np.datetime64("1970-01-01")).astype(int)
    keep = ship <= cutoff
    disc_price = price * (100 - disc)                # scale 4
    charge = disc_price * (100 + tax)                # scale 6
    rows = []
    for f in ("A", "N", "R"):
        for s in ("F", "O"):
            m = keep & (rf == f) & (ls == s)
            cnt = int(m.sum())
            if cnt == 0:
                continue
            sq = int(qty[m].sum(dtype=np.int64))
            sp = int(price[m].sum(dtype=np.int64))
            sd = int(disc_price[m].sum(dtype=np.int64))
            sc = int(charge[m].sum(dtype=np.int64))
            sdisc = int(disc[m].sum(dtype=np.int64))
            rows.append((f, s, (sq, 2), (sp, 2), (sd, 4), (sc, 6),
                         (_half_up_div(sq * 10**4, cnt), 6),
                         (_half_up_div(sp * 10**4, cnt), 6),
                         (_half_up_div(sdisc * 10**4, cnt), 6), cnt))
    return rows


def check_q1_rows(got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"q1: {len(got)} rows, want {len(want)}")
    for g, w in zip(got, want):
        g = tuple(g)
        if g[:2] != w[:2] or g[9] != w[9]:
            raise AssertionError(f"q1 row {g} != {w}")
        for v, (unscaled, scale) in zip(g[2:9], w[2:9]):
            exp = decimal.Decimal(unscaled).scaleb(-scale)
            if not isinstance(v, decimal.Decimal) or v != exp \
                    or v.as_tuple().exponent != -scale:
                raise AssertionError(f"q1 row {g}: {v!r} != {exp}")


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: a spin kernel holds the
    stream while the host enqueues all calls, so the events time the
    launches back to back rather than the host's enqueue rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / reps


def find_exec(plan, pred):
    if pred(plan):
        return plan
    for c in plan.children:
        hit = find_exec(c, pred)
        if hit is not None:
            return hit
    return None


def plan_names(plan):
    out = [type(plan).__name__]
    for c in plan.children:
        out += plan_names(c)
    return out


def table_rows(owner, add, mn, mx):
    """{first row: (add lanes, min lanes, max lanes)} of the used slots."""
    owner = owner.cpu().numpy()
    add, mn, mx = add.cpu().numpy(), mn.cpu().numpy(), mx.cpu().numpy()
    return {int(owner[s]): (add[s], mn[s], mx[s])
            for s in np.nonzero(owner >= 0)[0]}


def compare_tables(got, want) -> int:
    """Max |difference| over every lane of matching groups; raises when
    the group sets differ."""
    if set(got) != set(want):
        raise AssertionError(f"groupbyHash: groups {sorted(got)[:8]} != "
                             f"{sorted(want)[:8]}")
    err = 0
    for k, lanes in got.items():
        for a, b in zip(lanes, want[k]):
            d = np.abs(a.astype(object) - b.astype(object))
            err = max(err, int(d.max()) if d.size else 0)
    return err


def murmur3_battery(n: int, seed: int):
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as T
    rng = np.random.default_rng(seed)
    pool = np.array(["", "a", "abcd", "abcde", "\x00", "x\x00y", "éä",
                     "ÿþ", "0123456789abcdef", "tailé", "A", "N", "R"],
                    dtype=object)
    fields = [("b", T.BooleanT), ("i", T.IntegerT), ("l", T.LongT),
              ("f", T.FloatT), ("d", T.DoubleT), ("dt", T.DateT),
              ("dec", T.DecimalType(15, 2)), ("s", T.StringT)]
    arrays = [rng.integers(0, 2, n).astype(bool),
              rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(
                  np.int32),
              rng.integers(-2**62, 2**62, n),
              np.where(rng.random(n) < 0.1, -0.0,
                       rng.standard_normal(n)).astype(np.float32),
              np.where(rng.random(n) < 0.1, -0.0, rng.standard_normal(n)),
              rng.integers(-11000, 47000, n).astype(np.int32),
              rng.integers(-10**10, 10**10, n),
              pool[rng.integers(0, len(pool), n)]]
    valid = [rng.random(n) > 0.15 for _ in arrays]
    return host_batch_from_numpy(fields, arrays, valid)


def breakdown(spark, df, arrays, fields, device, card) -> None:
    """``--breakdown``: where one warm q1 spends its wall. Times the
    host->device upload of the 8 partitions alone, then runs q1 under
    torch.profiler: device-busy time (sum of kernel time), idle share,
    and the top device kernels and host ops, the full table written to
    chiprun_out/q1_profile.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    whole = host_batch_from_numpy(fields, arrays)
    per = (whole.num_rows + N_PARTITIONS - 1) // N_PARTITIONS
    parts = [whole.slice(i * per, (i + 1) * per)
             for i in range(N_PARTITIONS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in parts:
        DeviceBatch.from_host(p, device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0

    df.collect()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    on_device = [e for e in events
                 if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in on_device)
    top_dev = sorted(on_device, key=dev_us, reverse=True)[:10]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:10]
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "q1_profile.txt"), "w") as f:
        f.write(card + "\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=40))
    phase("q1_breakdown", card=card, upload_8_partitions_s=upload_s,
          profiled_wall_s=wall, device_busy_s=busy_us / 1e6,
          device_idle_share=1.0 - busy_us / 1e6 / wall,
          top_device_us={e.key[:60]: dev_us(e) for e in top_dev},
          top_host_self_us={e.key[:60]: e.self_cpu_time_total
                            for e in top_cpu})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch import device_caps
    from spark_rapids_tpu_torch import kernels as KR
    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.exec.agg import TorchHashAggregateExec
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.kernels import groupby_hash as KG
    from spark_rapids_tpu_torch.kernels import murmur3 as KM
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.sql import types as T
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession

    # -- 1. the card ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi: " + smi.stderr.strip()
    print(card, flush=True)
    try:
        import pyarrow  # noqa: F401
        pyarrow_ok = True
    except ImportError:
        pyarrow_ok = False
    device = torch.device("cuda", 0)
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          pyarrow_importable=pyarrow_ok,
          pyarrow_spec=importlib.util.find_spec("pyarrow") is not None)

    # -- 2. build + probe ------------------------------------------------
    build_s = device_caps.probe(device)
    phase("build", nvcc_seconds=round(build_s, 3), probe="ok",
          libraries=sorted(os.listdir(KR.BUILD_DIR)))

    # -- 3. kernel parity on the card ------------------------------------
    battery = DeviceBatch.from_host(murmur3_battery(1 << 20, 5), device)
    got = KM.murmur3_columns(battery.columns, battery.capacity)
    want = H.murmur3_columns(battery.columns, battery.capacity)
    torch.cuda.synchronize()
    m3_err = int((got.long() - want.long()).abs().max())
    if m3_err != 0:
        raise AssertionError("murmur3 kernel != plain at 1M rows")

    spark = TorchSparkSession({"spark.sql.shuffle.partitions":
                               str(N_PARTITIONS)})
    fields = [("l_quantity", T.DecimalType(15, 2)),
              ("l_extendedprice", T.DecimalType(15, 2)),
              ("l_discount", T.DecimalType(15, 2)),
              ("l_tax", T.DecimalType(15, 2)),
              ("l_returnflag", T.StringT), ("l_linestatus", T.StringT),
              ("l_shipdate", T.DateT)]
    t0 = time.perf_counter()
    arrays = lineitem_arrays()
    spark.createDataFrame(host_batch_from_numpy(fields, arrays),
                          num_partitions=N_PARTITIONS) \
        .createOrReplaceTempView("lineitem")
    gen_s = time.perf_counter() - t0
    df = spark.sql(Q1)

    # the main path's own kernel inputs, from partition 0 of a q1 plan
    probe_plan = spark.plan_physical(df.plan)
    agg = find_exec(probe_plan, lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    batch = next(iter(agg.child.device_partitions()[0]()))
    key_cols, vals, prims = agg._eval_inputs(batch)
    entries = [(v, p, dt) for v, (p, dt) in zip(vals, prims)]
    slots = KR.table_slots(spark.conf_obj, batch.capacity)
    kw, h, add, mn, mx, _decode = KG.table_inputs(key_cols, entries,
                                                  batch.active)
    gb_in = (kw, h, batch.active, add, mn, mx)
    k_out = KG.groupby_table(*gb_in, slots)
    p_out = KG.groupby_table_plain(*gb_in, slots)
    torch.cuda.synchronize()
    if int(k_out[4].item()) or int(p_out[4].item()):
        raise AssertionError("groupbyHash overflowed at q1 shapes")
    gb_err = compare_tables(table_rows(*k_out[:4]), table_rows(*p_out[:4]))
    n_groups = int((k_out[0] >= 0).sum())
    # overflow case: 5000 distinct keys into a 1024-slot table
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.integers(0, 5000, 1 << 16)).to(device)
    okw = torch.stack([g, g * 7], dim=1).contiguous()
    oh = g * 2654435761
    ovalid = torch.ones_like(g, dtype=torch.bool)
    olanes = torch.ones((g.shape[0], 1), dtype=torch.int64, device=device)
    o_k = KG.groupby_table(okw, oh, ovalid, olanes, olanes, olanes, 1024)
    o_p = KG.groupby_table_plain(okw, oh, ovalid, olanes, olanes, olanes,
                                 1024)
    torch.cuda.synchronize()
    if not (int(o_k[4].item()) and int(o_p[4].item())):
        raise AssertionError("groupbyHash overflow flag not raised")

    # murmur3 at q1's exchange shapes: the partial aggregate's output
    part_out = next(iter(agg.device_partitions()[0]()))
    xkeys = part_out.columns[:2]
    mk = KM.murmur3_columns(xkeys, part_out.capacity)
    mp = H.murmur3_columns(xkeys, part_out.capacity)
    torch.cuda.synchronize()
    m3_err = max(m3_err, int((mk.long() - mp.long()).abs().max()))
    if m3_err != 0:
        raise AssertionError("murmur3 kernel != plain at q1 shapes")
    phase("kernel_parity", murmur3_rows_1m=battery.capacity,
          murmur3_max_abs_err=m3_err, groupby_cap=batch.capacity,
          groupby_key_words=int(kw.shape[1]), groupby_slots=slots,
          groupby_lanes=[int(add.shape[1]), int(mn.shape[1]),
                         int(mx.shape[1])], groupby_groups=n_groups,
          groupby_max_abs_err=gb_err, overflow_case="flagged by both")

    # -- 4. q1 at SF1 through the session ----------------------------------
    want_rows = q1_reference(arrays)
    KR.reset_launches()
    t0 = time.perf_counter()
    rows = df.collect()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    check_q1_rows(rows, want_rows)
    names = plan_names(spark.last_plan)
    r2c = names.index("TorchRowToColumnarExec")
    if names[0] != "TorchColumnarToRowExec" or not all(
            n.startswith("Torch") for n in names[:r2c + 1]):
        raise AssertionError(f"q1 plan is not all Torch*: {names}")
    partial = find_exec(spark.last_plan, lambda p: isinstance(
        p, TorchHashAggregateExec) and p.mode == "partial")
    if launches["groupbyHash"] <= 0 or launches["murmur3"] <= 0:
        raise AssertionError(f"q1 did not launch both kernels: {launches}")
    if partial.overflow_reruns != 0:
        raise AssertionError(f"{partial.overflow_reruns} overflow re-runs")
    phase("q1_sf1", rows_in=SF1_ROWS, partitions=N_PARTITIONS,
          rows_out=len(rows), reference="exact", plan=names,
          launches=launches, overflow_reruns=partial.overflow_reruns,
          first_run_s=round(first_s, 4), generate_s=round(gen_s, 3))

    # -- 5. times -------------------------------------------------------------
    df.collect()  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    phase("q1_wall", card=card, warm_runs=1, timed_runs=walls,
          median_s=wall, rows_per_s=SF1_ROWS / wall)

    gb_ms = cuda_ms(lambda: KG.groupby_table(*gb_in, slots), 20)
    gb_plain_ms = wall_ms(lambda: KG.groupby_table_plain(*gb_in, slots), 3)
    gb_bytes = (sum(t.numel() * t.element_size() for t in gb_in)
                + slots * 4 + 4
                + slots * 8 * (add.shape[1] + mn.shape[1] + mx.shape[1]))
    m3_ms = cuda_ms(lambda: KM.murmur3_columns(xkeys, part_out.capacity),
                    200)
    m3_plain_ms = wall_ms(lambda: H.murmur3_columns(
        xkeys, part_out.capacity), 20)
    m3_bytes = part_out.capacity * 4 + sum(
        c.chars.numel() + c.lengths.numel() * 4 + c.validity.numel()
        for c in xkeys)
    m3_1m_ms = cuda_ms(lambda: KM.murmur3_columns(
        battery.columns, battery.capacity), 20)
    m3_1m_plain_ms = wall_ms(lambda: H.murmur3_columns(
        battery.columns, battery.capacity), 3)
    m3_1m_bytes = battery.capacity * 4 + sum(
        t.numel() * t.element_size() for c in battery.columns
        for t in c.arrays())
    phase("kernel_times", card=card,
          groupbyHash={"rows": batch.capacity, "ms": gb_ms,
                       "plain_ms": gb_plain_ms, "bytes": gb_bytes},
          murmur3_q1={"rows": part_out.capacity, "ms": m3_ms,
                      "plain_ms": m3_plain_ms, "bytes": m3_bytes},
          murmur3_1m={"rows": battery.capacity, "ms": m3_1m_ms,
                      "plain_ms": m3_1m_plain_ms, "bytes": m3_1m_bytes,
                      "bound_ms": m3_1m_bytes / HBM_BYTES_PER_S * 1e3})

    if "--breakdown" in sys.argv[1:]:
        breakdown(spark, df, arrays, fields, device, card)

    kernels = [
        {"name": "groupbyHash", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/groupby_hash.cu",
         "replaces": "spark_rapids_tpu/kernels/groupby_hash.py:311",
         "launches": launches["groupbyHash"], "max_abs_err": gb_err,
         "ms": gb_ms, "plain_ms": gb_plain_ms,
         "bound_ms": gb_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
        {"name": "murmur3", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
         "replaces": "spark_rapids_tpu/kernels/murmur3.py:62",
         "launches": launches["murmur3"], "max_abs_err": m3_err,
         "ms": m3_ms, "plain_ms": m3_plain_ms,
         "bound_ms": m3_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
