"""The tuning controller (``telemetry/tuning.py``) held against the JAX
package's: each scenario writes the same synthetic query history (the
same records, timestamps included) into a directory per package, ticks
each package's controller over it with its own admission controller,
and compares the actions, the admission knobs and ``format_tuning``'s
table byte for byte. The JAX package's ``kernelFallback`` action has no
counterpart in the port (it has no kernel enable confs): its own test
checks that the port's controller leaves such a verdict alone."""

import os
import time

import pytest

from spark_rapids_tpu import retry as JR
from spark_rapids_tpu.conf import TpuConf
from spark_rapids_tpu.serve.scheduler import \
    AdmissionController as JAdmission
from spark_rapids_tpu.telemetry import history as JH
from spark_rapids_tpu.telemetry import tuning as JT

from spark_rapids_tpu_torch import retry as R
from spark_rapids_tpu_torch.conf import _REGISTRY, TorchConf
from spark_rapids_tpu_torch.serve.scheduler import AdmissionController
from spark_rapids_tpu_torch.telemetry import history as H
from spark_rapids_tpu_torch.telemetry import tuning as T

PKGS = {"jax": (JT, JH, TpuConf, JAdmission, JR),
        "port": (T, H, TorchConf, AdmissionController, R)}
# fields that carry the wall clock of the tick that wrote them
_CLOCK = ("appliedTs", "acceptedTs", "revertedTs", "ts")


@pytest.fixture(autouse=True)
def _fresh():
    for _t, h, _c, _a, r in PKGS.values():
        h.reset_history()
        r.reset_fault_injection()
    yield
    for _t, h, _c, _a, r in PKGS.values():
        h.reset_history()
        r.reset_fault_injection()


def _conf(hdir, **extra):
    base = {"spark.rapids.sql.telemetry.history.dir": str(hdir),
            "spark.rapids.sql.serve.tuning.enabled": "true",
            "spark.rapids.sql.serve.tuning.intervalS": "3600",
            "spark.rapids.sql.serve.tuning.guardWindowQueries": "2"}
    base.update({k: str(v) for k, v in extra.items()})
    return base


def _rec(ts, sig="a" * 40, status="finished", wall=0.1, **kw):
    r = {"version": 1, "ts": ts, "signature": sig, "status": status,
         "wallSeconds": wall, "queueWaitSeconds": 0.0, "outputRows": 10}
    r.update(kw)
    return r


def _store(h, hdir, records):
    store = h.HistoryStore(str(hdir), 1 << 30, 14)
    for r in records:
        store.append(dict(r))
    return store


def _storm(sig, t0, **target_kw):
    """A signature's baseline plus one regressed newest record."""
    return ([_rec(t0 - 60 + i, sig=sig, wall=0.05) for i in range(4)]
            + [_rec(t0, sig=sig, wall=0.5, **target_kw)])


def _clean(actions):
    out = []
    for a in actions:
        a = {k: v for k, v in a.items() if k not in _CLOCK}
        ev = dict(a.get("evidence") or {})
        for k in ("accepted", "observed"):
            if isinstance(ev.get(k), dict):
                ev[k] = {kk: vv for kk, vv in ev[k].items()
                         if kk not in _CLOCK}
        a["evidence"] = ev
        out.append(a)
    return out


class _Slo:
    def evaluate(self):
        return {"acme": {"burnRatio": 0.8, "windowQueries": 5,
                         "objectiveP99Ms": 10, "observedP99Ms": 50.0,
                         "violations": 4}}


def _scenario(name, pkg, tmp_path, t0):
    tmod, h, conf_cls, adm_cls, _r = PKGS[pkg]
    hdir = tmp_path / pkg / "hist"
    os.makedirs(str(hdir))
    writes: dict = {}
    adm = adm_cls(conf_cls({}))
    extra = {}
    if name == "harmful":
        extra["spark.rapids.sql.test.injectOOM"] = "site:tuning:2"
    kw = dict(admission=adm)
    if name == "sloBurn":
        kw["slo"] = _Slo()
    if name == "seedOutOfCore":
        kw.update(set_conf=writes.__setitem__, get_conf=writes.get)
    tun = tmod.TuningController(conf_cls(_conf(hdir, **extra)), **kw)
    sig = {"retrySpill": "c", "seedOutOfCore": "d", "sloBurn": "e",
           "harmful": "f", "accept": "1"}[name] * 40
    if name in ("retrySpill", "seedOutOfCore"):
        _store(h, hdir, _storm(sig, t0, retryCount=6))
        tun.tick()
        tun.tick()
    elif name == "sloBurn":
        tun.tick()
    elif name == "harmful":
        tun.observe("SELECT 1", sig, "acme")
        tun.tick()
        tun.tick()
        # the guard window: records after the action (ordinary walls
        # against its epsilon baseline read as a regression)
        _store(h, hdir, [_rec(time.time() + 0.001, sig=sig,
                              wall=0.05)] * 2)
        tun.tick()
    elif name == "accept":
        act = tun._new_action(
            "limitConcurrency", sig, tmod.KNOB_SIGNATURE_CONCURRENCY,
            None, 2, {"baseline": {"p50": 0.05, "p99": 0.05}})
        with tun._lock:
            tun._apply(act)
        _store(h, hdir, [_rec(time.time() + 0.001, sig=sig,
                              wall=0.05)] * 2)
        tun.tick()
    return {"actions": _clean(tun.actions()),
            "limit": adm.signature_limit(sig),
            "weight": adm.tenant_weight("acme"),
            "writes": writes,
            "table": tmod.format_tuning(tun._state),
            "stats": {k: v for k, v in tun.stats().items()
                      if k != "lastScanTs"},
            "audit": [r.get("action") for r in h.read_records(str(hdir))
                      if r.get("status") in h.TUNING_STATUSES]}


@pytest.mark.parametrize("name", ["retrySpill", "seedOutOfCore", "sloBurn",
                                  "harmful", "accept"])
def test_controller_actions_match_jax_package(tmp_path, name):
    t0 = time.time()
    got = {pkg: _scenario(name, pkg, tmp_path, t0) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"]["actions"]


def test_kernel_fallback_verdict_takes_no_action_in_the_port(tmp_path):
    """The JAX package flips the culprit kernel's enable conf; the port
    has none, so the verdict (read from a JAX-written history) leaves the
    port's controller idle and writes no conf."""
    t0 = time.time()
    sig = "e" * 40
    recs = _storm(sig, t0, kernelFallbacks=6,
                  kernelFallbacksByName={"joinProbe": 6})
    writes = {}
    for pkg in ("jax", "port"):
        tmod, h, conf_cls, adm_cls, _r = PKGS[pkg]
        hdir = tmp_path / pkg
        _store(h, hdir, recs)
        w: dict = {}
        tun = tmod.TuningController(
            conf_cls(_conf(hdir)), admission=adm_cls(conf_cls({})),
            set_conf=w.__setitem__, get_conf=w.get)
        tun.tick()
        writes[pkg] = (w, [a["action"] for a in tun.actions()])
    assert writes["jax"] == ({"spark.rapids.sql.kernel.joinProbe.enabled":
                              "false"}, ["kernelFallback"])
    assert writes["port"] == ({}, [])
    assert "kernelFallback" not in T.ACTION_CATALOG
    # no kernel has an enable key (the autotuner's own key is not one)
    assert not any(f"spark.rapids.sql.kernel.{name}.enabled" in _REGISTRY
                   for name in ("murmur3", "groupbyHash", "joinProbe",
                                "decodeFused"))
    assert [k for k in _REGISTRY if k.startswith("spark.rapids.sql.kernel.")
            and k.endswith(".enabled")] == [
        "spark.rapids.sql.kernel.autotune.enabled"]


def test_catalog_is_the_jax_catalog_less_kernel_fallback():
    want = {k: v for k, v in JT.ACTION_CATALOG.items()
            if k != "kernelFallback"}
    assert T.ACTION_CATALOG == want
    for entry in T.ACTION_CATALOG.values():
        knob = entry["knob"]
        assert knob in T.INTERNAL_KNOBS or knob in _REGISTRY


def test_state_and_table_round_trip(tmp_path):
    state = {"version": 1, "epoch": 3, "actions": [
        {"epoch": 3, "action": "limitConcurrency", "scope": "a" * 40,
         "knob": "signatureConcurrency", "oldValue": None, "newValue": 2,
         "state": "applied", "pinned": True,
         "evidence": {"injected": True}}], "prewarm": {}}
    for pkg in PKGS:
        tmod = PKGS[pkg][0]
        tmod.save_state(str(tmp_path / pkg), state)
        assert tmod.load_state(str(tmp_path / pkg))["actions"] == \
            state["actions"]
    assert T.format_tuning(state) == JT.format_tuning(state)
    assert T.format_tuning({}) == JT.format_tuning({})


def test_site_tuning_counts_ticks():
    conf = TorchConf({"spark.rapids.sql.test.injectOOM": "site:tuning:2"})
    inj = R.get_fault_injector(conf)
    assert [inj.on_tuning_tick() for _ in range(4)] == \
        [False, True, False, True]
    assert inj.stats()["tuningFaultsInjected"] == 2
    # the site's schedule never fires an allocation fault
    inj.on_alloc("upload")
