"""The port's kernel autotuner (``spark_rapids_tpu_torch/kernels/
autotune.py``) on the CPU, where the plain versions run: a twin of every
case of ``tests/test_autotune.py`` (read-only when disabled, sweep once
then warm hits, restart, torn lines, last entry wins, an unwritable dir,
a broken candidate, a winner applied, the budget, the stats provider, an
engine sweep bit-identical), the two oracles over every candidate of
their grids, and q1 with the autotuner on against the JAX package's rows
and table keys. Rows are exact; times are not compared."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from spark_rapids_tpu.kernels import autotune as JAT
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import jit_cache as JC
from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.conf import TorchConf
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.kernels import autotune as AT
from spark_rapids_tpu_torch.metrics import plan_metrics
from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_autotuner():
    AT.reset_for_tests()
    JAT.reset_for_tests()
    yield
    AT.reset_for_tests()
    JAT.reset_for_tests()


def _conf(dir_, enabled=True, budget_ms=60000):
    return TorchConf({
        "spark.rapids.sql.kernel.autotune.enabled":
            str(bool(enabled)).lower(),
        "spark.rapids.sql.kernel.autotune.dir": str(dir_),
        "spark.rapids.sql.kernel.autotune.budgetMs": str(budget_ms),
    })


def _table_path(dir_):
    return os.path.join(str(dir_), "kernel-autotune.jsonl")


def _fake(fn):
    """A stand-in for ``_run_candidate(probe, params)`` that skips the
    oracles (the JAX tests' monkeypatch shape: kernel, cap, params)."""
    def run(probe, params):
        return fn(probe.kernel, probe.cap, params)
    return run


class _NoProbe:
    def __init__(self, kernel, cap):
        self.kernel, self.cap, self.device = kernel, cap, CPU


@pytest.fixture
def stub_probes(monkeypatch):
    """Oracle set-up replaced by a stub (no corpus, no batch) so a test
    with a fake candidate runner stays instant."""
    monkeypatch.setattr(AT, "_PROBE_TYPES", {
        k: (lambda conf, cap, dev, k=k: _NoProbe(k, cap))
        for k in AT._PROBE_TYPES})


# ---------------------------------------------------------------------------
# sweep-once + persistence
# ---------------------------------------------------------------------------

def test_read_only_when_disabled(tmp_path):
    p, tuned = AT.params_for(_conf(tmp_path, enabled=False),
                             "decodeFused", 2048, device=CPU)
    assert (p, tuned) == ({}, False)
    assert AT.stats()["sweeps"] == 0
    assert not os.path.exists(_table_path(tmp_path))


def test_sweep_once_then_warm_hits(tmp_path):
    conf = _conf(tmp_path)
    p1, t1 = AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert AT.stats()["sweeps"] == 1
    p2, t2 = AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert (p2, t2) == (p1, t1)
    s = AT.stats()
    assert s["sweeps"] == 1 and s["hits"] == 1
    with open(_table_path(tmp_path)) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    assert len(lines) == 1
    e = lines[0]
    assert e["kernel"] == "decodeFused" and e["bucket"] == 2048
    assert e["device"] == AT.device_kind(CPU) == "cpu"
    # every candidate of the grid was validated and timed
    log = AT.sweep_log()[-1]
    assert [c["params"] for c in log["candidates"]] == \
        AT._GRIDS["decodeFused"]
    assert all(c["ok"] and c["ms"] >= 0 for c in log["candidates"])


def test_restart_roundtrip_zero_resweeps(tmp_path, stub_probes,
                                         monkeypatch):
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 1.0 if p else 5.0)))
    conf = _conf(tmp_path)
    p1, t1 = AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert AT.stats()["sweeps"] == 1
    AT.reset_for_tests()  # process restart: memory gone, file kept
    p2, t2 = AT.params_for(conf, "decodeFused", 2048, device=CPU)
    s = AT.stats()
    assert s["sweeps"] == 0, "warm start must never re-sweep"
    assert s["loaded"] >= 1 and s["hits"] == 1
    assert (p2, t2) == (p1, t1)


def test_torn_lines_skipped_and_counted(tmp_path):
    good = {"kernel": "decodeFused", "bucket": 2048,
            "device": AT.device_kind(CPU),
            "params": {"rowsPerThread": 4}, "applied": True}
    with open(_table_path(tmp_path), "w") as f:
        f.write('{"kernel": "decodeFused", "bucket": 2048\n')  # torn
        f.write("not json at all\n")
        f.write(json.dumps(good) + "\n")
    # disabled = read-only: the recorded winner still applies
    p, tuned = AT.params_for(_conf(tmp_path, enabled=False),
                             "decodeFused", 2048, device=CPU)
    assert (p, tuned) == ({"rowsPerThread": 4}, True)
    s = AT.stats()
    assert s["torn"] == 2 and s["sweeps"] == 0 and s["loaded"] == 1


def test_last_entry_per_key_wins(tmp_path):
    base = {"kernel": "decodeFused", "bucket": 2048,
            "device": AT.device_kind(CPU), "applied": True}
    with open(_table_path(tmp_path), "w") as f:
        f.write(json.dumps({**base,
                            "params": {"rowsPerThread": 1}}) + "\n")
        f.write(json.dumps({**base,
                            "params": {"rowsPerThread": 4}}) + "\n")
    p, tuned = AT.params_for(_conf(tmp_path, enabled=False),
                             "decodeFused", 2048, device=CPU)
    assert (p, tuned) == ({"rowsPerThread": 4}, True)


def test_jax_entry_never_applies_to_another_device(tmp_path):
    """An entry the JAX package wrote (its device is a TPU's kind or
    "cpu"-less) does not key a card's or the host's lookup: the device
    is part of the key."""
    with open(_table_path(tmp_path), "w") as f:
        f.write(json.dumps({"kernel": "groupbyHash", "bucket": 2048,
                            "device": "TPU v5 lite",
                            "params": {"slotsMult": 2},
                            "applied": True}) + "\n")
    assert AT.params_for(_conf(tmp_path, enabled=False), "groupbyHash",
                         2048, device=CPU) == ({}, False)
    assert AT.stats()["loaded"] == 1 and AT.stats()["hits"] == 0


def test_unwritable_dir_degrades_to_memory(tmp_path, stub_probes,
                                           monkeypatch):
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 10.0)))
    blocker = os.path.join(str(tmp_path), "blocker")
    with open(blocker, "w") as f:
        f.write("x")
    conf = _conf(os.path.join(blocker, "sub"))  # makedirs must fail
    AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert AT.stats()["sweeps"] == 1
    # the in-memory entry still serves warm lookups this process life...
    AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert AT.stats()["hits"] == 1
    # ...but a restart finds nothing persisted and sweeps again
    AT.reset_for_tests()
    AT.params_for(conf, "decodeFused", 2048, device=CPU)
    assert AT.stats()["sweeps"] == 1 and AT.stats()["loaded"] == 0


def test_memory_only_table_for_empty_dir(stub_probes, monkeypatch):
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 1.0 if p == {"slotsMult": 2} else 9.0)))
    conf = _conf("")
    assert AT.params_for(conf, "groupbyHash", 512, device=CPU) == \
        ({"slotsMult": 2}, True)
    assert AT.params_for(conf, "groupbyHash", 512, device=CPU) == \
        ({"slotsMult": 2}, True)
    assert AT.stats()["sweeps"] == 1 and AT.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# candidate validation
# ---------------------------------------------------------------------------

def test_broken_candidate_rejected_never_wins(tmp_path, stub_probes,
                                              monkeypatch):
    def fake(kernel, cap, params):
        if params.get("rowsPerThread") == 1:
            return False, 0.0  # fastest but WRONG: must never win
        return (True, 10.0) if not params else (True, 20.0)
    monkeypatch.setattr(AT, "_run_candidate", _fake(fake))
    p, tuned = AT.params_for(_conf(tmp_path), "decodeFused", 4096,
                             device=CPU)
    assert (p, tuned) == ({}, False)  # default won; sweep remembered
    s = AT.stats()
    assert s["rejected"] == 1 and s["sweeps"] == 1
    with open(_table_path(tmp_path)) as f:
        (entry,) = [json.loads(x) for x in f if x.strip()]
    assert entry["params"] == {} and entry["applied"] is False
    # re-lookup is a warm hit, not a re-sweep of the losing sweep
    AT.params_for(_conf(tmp_path), "decodeFused", 4096, device=CPU)
    assert AT.stats()["hits"] == 1 and AT.stats()["sweeps"] == 1


def test_refused_and_wrong_candidates_rejected_by_real_oracle(
        tmp_path, monkeypatch):
    """The real groupbyHash oracle: a candidate the launch refuses (a
    KernelError) and one whose table is off by one are both rejected,
    counted and never recorded; the default launch is never rejected
    silently."""
    real = AT._GroupbyProbe.launch

    def launch(self, params):
        if params.get("refuse"):
            raise KR.KernelError("refused")
        out = real(self, {k: v for k, v in params.items()
                          if k != "corrupt"})
        if params.get("corrupt"):
            add = out[1].clone()
            add[int(torch.nonzero(out[0] >= 0)[0, 0]), 0] += 1
            out = (out[0], add) + tuple(out[2:])
        return out
    monkeypatch.setattr(AT._GroupbyProbe, "launch", launch)
    monkeypatch.setitem(AT._GRIDS, "groupbyHash",
                        [{}, {"refuse": 1}, {"corrupt": 1}])
    p, _t = AT.params_for(_conf(tmp_path), "groupbyHash", 1024,
                          device=CPU)
    assert p == {}
    assert AT.stats()["rejected"] == 2
    oks = {json.dumps(c["params"]): c["ok"]
           for c in AT.sweep_log()[-1]["candidates"]}
    assert oks == {"{}": True, '{"refuse": 1}': False,
                   '{"corrupt": 1}': False}
    # a default launch that fails raises: it is never swallowed
    monkeypatch.setattr(AT._GroupbyProbe, "launch",
                        lambda self, params: launch(self, {"refuse": 1}))
    AT.reset_for_tests()
    with pytest.raises(KR.KernelError):
        AT.params_for(_conf(tmp_path / "b"), "groupbyHash", 1024,
                      device=CPU)


def test_winning_candidate_applied(tmp_path, stub_probes, monkeypatch):
    def fake(kernel, cap, params):
        return True, (1.0 if params.get("rowsPerThread") == 4 else 50.0)
    monkeypatch.setattr(AT, "_run_candidate", _fake(fake))
    p, tuned = AT.params_for(_conf(tmp_path), "decodeFused", 4096,
                             device=CPU)
    assert (p, tuned) == ({"rowsPerThread": 4}, True)
    AT.reset_for_tests()  # the winner survives restart
    p2, t2 = AT.params_for(_conf(tmp_path, enabled=False),
                           "decodeFused", 4096, device=CPU)
    assert (p2, t2) == ({"rowsPerThread": 4}, True)


def test_budget_bounds_sweep_but_default_always_runs(tmp_path, stub_probes,
                                                     monkeypatch):
    ran = []

    def fake(kernel, cap, params):
        ran.append(dict(params))
        import time
        time.sleep(0.01)  # make the budget clock move
        return True, 10.0
    monkeypatch.setattr(AT, "_run_candidate", _fake(fake))
    p, tuned = AT.params_for(_conf(tmp_path, budget_ms=0),
                             "decodeFused", 2048, device=CPU)
    assert ran == [{}]  # budget 0: only the mandatory default baseline
    assert (p, tuned) == ({}, False)
    assert AT.stats()["sweeps"] == 1  # partial sweep still recorded


def test_grids_mirror_the_jax_grids():
    """groupbyHash keeps the JAX grid's six entries in its order;
    decodeFused's knob is rowsPerThread where the JAX one is charChunk;
    the default comes first in both."""
    assert AT._GRIDS["groupbyHash"] == JAT._GRIDS["groupbyHash"]
    assert AT._GRIDS["decodeFused"] == [{}, {"rowsPerThread": 1},
                                        {"rowsPerThread": 4}]
    assert len(AT._GRIDS["decodeFused"]) == len(JAT._GRIDS["decodeFused"])
    assert all(g[0] == {} for g in AT._GRIDS.values())


@pytest.mark.parametrize("cand", AT._GRIDS["decodeFused"])
def test_decode_fused_probe_oracle(cand):
    """The real decodeFused oracle on the CPU: every candidate is byte
    for byte the default launch over the synthetic row group."""
    probe = AT._DecodeProbe(2048, CPU)
    assert probe.check(probe.launch({}))
    assert AT._run_candidate(probe, cand)[0], cand


def test_decode_corpus_covers_every_page_class():
    """The synthetic row group reaches every page class the device
    decode has: PLAIN, dictionary, DELTA_BINARY_PACKED,
    DELTA_LENGTH_BYTE_ARRAY and BYTE_STREAM_SPLIT pages, with definition
    levels, for every column kind (no host-decoded column)."""
    from spark_rapids_tpu_torch.io.device_decode import (
        PGE_BSS, PGE_DELTA, PGE_DICT, PGE_DL_STR, PGE_PLAIN, PGE_PLAIN_STR)
    probe = AT._DecodeProbe(4096, CPU)
    assert all(e[0] == "dev" for e in probe.layout)
    kinds = {e[1] for e in probe.layout}
    assert {"int", "f32", "f64", "str", "dec128", "bool"} <= kinds, kinds
    classes = set()
    from spark_rapids_tpu_torch.columnar.transfer import walk_layout
    for _ent, t in walk_layout(probe.layout, probe.extras):
        classes |= set(t["pg_enc"].tolist())
    assert {PGE_DICT, PGE_PLAIN, PGE_DELTA, PGE_BSS, PGE_PLAIN_STR,
            PGE_DL_STR} <= classes, classes


@pytest.mark.parametrize("params", AT._GRIDS["groupbyHash"])
def test_groupby_candidates_bit_exact(params):
    """Every groupbyHash candidate passes the numpy oracle (the JAX
    ``autotune_probe`` cases: blockRows, laneGroups, slotsMult)."""
    probe = AT._GroupbyProbe(TorchConf({}), 2048, CPU)
    assert probe.check(probe.launch(params)), params


def test_runs_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """No device means the CUDA card: without one, a lookup raises
    instead of tuning the host."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            AT.params_for(_conf(tmp_path), "groupbyHash", 64)


# ---------------------------------------------------------------------------
# stats plumbing
# ---------------------------------------------------------------------------

def test_stats_provider_in_cache_stats(tmp_path, stub_probes, monkeypatch):
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 10.0)))
    AT.params_for(_conf(tmp_path), "decodeFused", 2048, device=CPU)
    cs = JC.cache_stats()
    assert "kernelAutotune" in cs
    e = cs["kernelAutotune"]
    # the Prometheus renderer reads these keys unconditionally
    for k in ("size", "capacity", "hits", "misses", "evictions",
              "contention"):
        assert k in e, k
    assert e["misses"] == 1 and e["size"] == 1


def test_broken_stats_provider_is_isolated():
    JC.register_stats_provider("_boomProvider", lambda: 1 // 0)
    try:
        cs = JC.cache_stats()
        assert "kernelAutotune" in cs
        assert "_boomProvider" not in cs
    finally:
        JC._EXTRA_STATS.pop("_boomProvider", None)


def test_prometheus_exports_the_autotuner(tmp_path, stub_probes,
                                          monkeypatch):
    from spark_rapids_tpu_torch.telemetry.prometheus import \
        render_prometheus
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 10.0)))
    AT.params_for(_conf(tmp_path), "groupbyHash", 2048, device=CPU)
    text = render_prometheus()
    assert 'srt_jit_cache_misses_total{cache="kernelAutotune"} 1' in text


# ---------------------------------------------------------------------------
# end to end: the engine sweeps once and stays bit-identical
# ---------------------------------------------------------------------------

def _groupy_batch(n=4000, ngroups=7, seed=9):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, ngroups, n)
    vals = rng.integers(-1000, 1000, n)
    vv = rng.random(n) >= 0.1
    return host_batch_from_numpy([("k", T.LongT), ("v", T.LongT)],
                                 [keys, vals], [None, vv])


def _run_port(conf, sql):
    s = TorchSparkSession(dict(conf), device="cpu")
    try:
        s.createDataFrame(_groupy_batch(), num_partitions=2) \
            .createOrReplaceTempView("t")
        rows = [tuple(r) for r in s.sql(sql).collect()]
        return rows, plan_metrics(s.last_plan)
    finally:
        s.stop()


SQL = ("SELECT k, sum(v), count(v), min(v), max(v) FROM t "
       "GROUP BY k ORDER BY k")


def test_engine_sweep_bit_identical_and_warm_restart(tmp_path):
    cpu, _ = _run_port({"spark.rapids.sql.enabled": "false"}, SQL)
    conf = {"spark.rapids.sql.kernel.autotune.enabled": "true",
            "spark.rapids.sql.kernel.autotune.dir": str(tmp_path),
            "spark.rapids.sql.kernel.autotune.budgetMs": "0"}
    tuned_out, mets = _run_port(conf, SQL)
    assert cpu == tuned_out
    assert mets.get("kernelDispatchCount.groupbyHash", 0) >= 1
    assert AT.stats()["sweeps"] >= 1
    assert os.path.exists(_table_path(tmp_path))
    AT.reset_for_tests()  # restart: the table warm-starts the engine
    warm_out, _ = _run_port(conf, SQL)
    assert cpu == warm_out
    assert AT.stats()["sweeps"] == 0 and AT.stats()["hits"] >= 1


def test_tuned_knobs_key_the_stage_program(tmp_path, stub_probes,
                                           monkeypatch):
    """A winner with slotsMult reaches the aggregate's table size and the
    stage key: the run with the winner keys a program of its own, and
    its rows equal the defaults'."""
    from spark_rapids_tpu_torch.exec import fused as F
    monkeypatch.setattr(AT, "_run_candidate", _fake(
        lambda k, c, p: (True, 1.0 if p == {"slotsMult": 2} else 9.0)))
    # a filter below the aggregate makes one fused stage program
    sql = SQL.replace("FROM t", "FROM t WHERE v > -900")
    plain, _ = _run_port({}, sql)
    before = set(F.STAGE_CACHE.keys())
    conf = {"spark.rapids.sql.kernel.autotune.enabled": "true",
            "spark.rapids.sql.kernel.autotune.dir": str(tmp_path)}
    tuned_rows, _ = _run_port(conf, sql)
    assert tuned_rows == plain
    new = [k for k in F.STAGE_CACHE.keys() if k not in before]
    assert any("('slotsMult', 2)" in str(k) for k in new), new


def test_q1_with_autotune_equals_the_jax_package(tmp_path):
    """TPC-H q1's shape at a few thousand rows with the autotuner on in
    both packages: equal rows, and both tables' lines carry the same
    keys (the JAX package's: kernel, bucket, device, params, applied,
    defaultMs, bestMs, ts)."""
    from test_torch_q1 import (_LINEITEM, _jax_batch, _lineitem_arrays,
                               _q1_sql, _torch_batch)
    arrays = _lineitem_arrays()
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    base = {"spark.rapids.sql.kernel.autotune.enabled": "true",
            "spark.rapids.sql.kernel.autotune.budgetMs": "60000",
            "spark.sql.shuffle.partitions": "4"}
    j = TpuSparkSession(dict(base, **{
        "spark.rapids.sql.enabled": "true",
        "spark.rapids.sql.kernel.autotune.dir": str(jdir)}))
    try:
        j.createDataFrame(_jax_batch(_LINEITEM, arrays), num_partitions=3) \
            .createOrReplaceTempView("t")
        want = [tuple(r) for r in j.sql(_q1_sql()).collect()]
    finally:
        j.stop()
    s = TorchSparkSession(dict(base, **{
        "spark.rapids.sql.kernel.autotune.dir": str(pdir)}), device="cpu")
    try:
        s.createDataFrame(_torch_batch(_LINEITEM, arrays), num_partitions=3) \
            .createOrReplaceTempView("t")
        got = [tuple(r) for r in s.sql(_q1_sql()).collect()]
    finally:
        s.stop()
    assert len(want) == 6 and got == want
    with open(_table_path(pdir)) as f:
        plines = [json.loads(x) for x in f if x.strip()]
    with open(_table_path(jdir)) as f:
        jlines = [json.loads(x) for x in f if x.strip()]
    keys = ["applied", "bestMs", "bucket", "defaultMs", "device", "kernel",
            "params", "ts"]
    assert plines and jlines
    assert all(sorted(e) == keys for e in plines + jlines)
    assert {e["kernel"] for e in plines} == {"groupbyHash"}
    assert all(e["device"] == "cpu" for e in plines)
