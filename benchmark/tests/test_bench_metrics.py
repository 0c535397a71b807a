"""The metric arithmetic: rates and percentiles over every query of the
window, the idle share and its labels from a synthetic device trace, and
the roofline's bytes from a written Parquet footer."""

import os
import statistics

import pytest

import device_trace
import harness
import parquet_data
import summary
from conftest import BENCH


def load(name):
    return harness.metric_reader(name)


def fake_run(latencies, seconds=10.0, late=()):
    """A run whose window holds queries of ``latencies`` end to end, one
    stream, plus ``late`` queries (start, latency) past the close."""
    spec = {"config": {}, "traffic": {}}
    run = harness.Run(spec, seconds)
    run.t_window, run.t_close = 100.0, 100.0 + seconds
    t = run.t_window
    for lat in latencies:
        q = harness.Query(0, "window", {})
        q.t0, q.t1 = t, t + lat
        run.queries.append(q)
        t += lat
    for t0, lat in late:
        q = harness.Query(1, "window", {})
        q.t0, q.t1 = run.t_window + t0, run.t_window + t0 + lat
        run.queries.append(q)
    warm = harness.Query(0, "warmup", {})
    warm.t0, warm.t1 = 0.0, 50.0
    run.queries.append(warm)
    return run


def test_rate_counts_every_query_and_the_share_of_one_in_flight():
    run = fake_run([1.0] * 9, late=[(8.0, 4.0)])
    # nine whole queries, and half of the one running at the close
    assert load("queries_per_s").read(run) == pytest.approx(9.5 / 10.0)


def test_failed_query_counts_in_latency_not_in_rate():
    run = fake_run([1.0, 2.0, 3.0])
    run.queries[1].error = "boom"
    assert load("queries_per_s").read(run) == pytest.approx(0.2)
    assert load("latency_p50_s").read(run) == pytest.approx(2.0)


def test_percentiles_over_all_queries_match_statistics():
    lat = [0.1 * i for i in range(1, 201)]
    run = fake_run(lat, seconds=1e4)
    qs = statistics.quantiles(lat, n=10, method="inclusive")
    assert load("latency_p90_s").read(run) == pytest.approx(qs[8])
    # a name with a suffix and no file of its own takes its base's reader
    assert load("latency_p90_s.some.cell").read(run) == pytest.approx(qs[8])
    assert load("latency_p50_s").read(run) == \
        pytest.approx(statistics.median(lat))
    # a query ending after the close is not in the window's latencies
    run = fake_run([1.0] * 5, seconds=5.0, late=[(4.0, 100.0)])
    assert load("latency_p50_s").read(run) == pytest.approx(1.0)


def test_roofline_work_is_that_of_the_queries_inside_the_trace():
    run = fake_run([1.0] * 10)
    assert len(summary.traced(run)) == 10
    # a trace over 3.5 s .. 7.5 s of the window holds queries 4 to 7 whole
    run.t_trace, run.t_trace_end = run.t_window + 3.5, run.t_window + 7.5
    assert [q.t0 - run.t_window for q in summary.traced(run)] == \
        [4.0, 5.0, 6.0]
    run.queries[5].error = "boom"
    assert len(summary.traced(run)) == 2


def synthetic_trace():
    # markers at host 1,000 and 1,001,000 ns; device clock 500 ns ahead
    events = [(1_500, 1_000, "at::cuda::spin_kernel(long)"),
              (101_500, 200_000,
               "void (anonymous namespace)::decode_tiles<1>(int)"),
              (201_500, 100_000, "Memcpy HtoD (Pinned -> Device)"),
              (601_500, 100_000,
               "void (anonymous namespace)::groupby_kernel(long)"),
              (701_510, 20, "void at::native::fill()"),
              (1_001_500, 1_000, "at::cuda::spin_kernel(long)")]
    return device_trace.DeviceTrace(events, [1_000, 1_001_000])


def test_idle_share_is_the_union_of_device_intervals():
    dt = synthetic_trace()
    assert dt.offset == 500
    assert dt.window_s == pytest.approx(1_001_000 / 1e9)
    # decode and copy overlap: busy 100,000..301,500 plus 100,000 + 20
    assert dt.busy_s == pytest.approx((200_000 + 100_000 + 20) / 1e9)
    run = fake_run([1.0])
    run.device_trace = dt
    assert load("device_idle_pct").read(run) == pytest.approx(
        100 * (1 - 300_020 / 1_001_000))


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    dt = synthetic_trace()
    spans = [("query", 0, 2_000_000, 7, None, None, None),
             ("deviceDecodeTime", 300_000, 650_000, 7, None, None, None),
             ("semaphoreWait", 0, 1_000_000, 8, None, None, None)]
    idle = dt.idle_by_host_span(spans)
    # the gap 301,500..601,500 (host 301,000..601,000): decode on one
    # thread, the permit wait on the other, half each
    assert idle["deviceDecodeTime"] == pytest.approx(300_000 / 2 / 1e9)
    assert idle["semaphoreWait"] > idle["deviceDecodeTime"]
    assert idle["(gaps under 50 us)"] == pytest.approx(10 / 1e9)
    total = sum(idle.values())
    assert total == pytest.approx(dt.window_s - dt.busy_s)


def test_roofline_bytes_come_from_the_footers(tmp_path, monkeypatch):
    import json
    import pyarrow.parquet as pq
    with open(os.path.join(BENCH, "configs", "tpch_sf1.json")) as f:
        cfg = json.load(f)
    data = parquet_data.generate(cfg, 1, scale=0.002)
    views = parquet_data.write_tables(cfg, data, str(tmp_path))
    cols = ["l_tax", "l_returnflag"]
    got = parquet_data.scan_bytes(views["lineitem"], cols)
    want = 0
    for f in os.listdir(views["lineitem"]):
        md = pq.ParquetFile(os.path.join(views["lineitem"], f)).metadata
        names = [md.schema.column(j).name for j in range(md.num_columns)]
        for j, n in enumerate(names):
            if n in cols:
                want += md.row_group(0).column(j).total_compressed_size
    assert got == {"compressed": want, "rows": len(data["lineitem"]["l_tax"])}
    # row groups over the reader's cap are host-decoded: not counted
    assert parquet_data.scan_bytes(views["lineitem"], cols, 1 << 20) == got
    assert parquet_data.scan_bytes(views["lineitem"], cols, 1) == \
        {"compressed": 0, "rows": 0}
    assert parquet_data.spark_width("decimal(15,2)") == 8
    assert parquet_data.spark_width("decimal(7,2)") == 4
    assert parquet_data.spark_width("string", ["ab", "abcd"]) == 3

    run = fake_run([1.0, 1.0])
    run.config, run.data, run.views = cfg, data, views
    run.reference = parquet_data.load_module("reference", "tpch_q1")
    run.device_trace = synthetic_trace()
    monkeypatch.setattr(summary, "hbm_bytes_per_s", lambda kind: 1e12)
    import torch
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    per_query = 0
    for table, columns in run.reference.SCANS.items():
        b = parquet_data.scan_bytes(views[table], columns)
        per_query += b["compressed"] + b["rows"] * sum(
            parquet_data.spark_width(t) if t != "string" else 1.0
            for c, t in cfg["tables"][table]["columns"] if c in columns)
    share = load("decode_fused_roofline").read(run)
    assert share == pytest.approx(100 * (2 * per_query / 1e12) / 200e-6)
