"""The port's result and subplan caches (``spark_rapids_tpu_torch/serve/
result_cache.py``, the build cache in ``exec/join.py`` and the store's
cache-entry tier) against the JAX package's.

Checked through both servers: a hit serves identical bytes with no
execution, the invalidation matrix (a file appended, rewritten in place,
touched, deleted, or a new file) re-executes and answers as the JAX
package does over the changed files, a view's re-registration drops
every entry. Through sessions: subplan reuse within and across sessions
with the JAX package's rows, a changed build-side file rebuilding the
table. Units: cache entries drop before any live batch spills, a
pressure drop is seen as an eviction, the LRU bounds, the fusion key
equal to the JAX package's, and the fingerprint capture over
``CpuFileScanExec``."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest
import torch

from spark_rapids_tpu import adaptive as JA
from spark_rapids_tpu.sql.session import TpuSparkSession
from spark_rapids_tpu_torch import adaptive as A
from spark_rapids_tpu_torch import memory as MEM
from spark_rapids_tpu_torch.serve import result_cache as RC
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

from tests.torch_serve_support import (Q1S, Q3S, TIMEOUT, VIEWS, clients,
                                       reset_state, rows, serving,
                                       write_tables)

torch.set_num_threads(2)

RESULT_ON = {"spark.rapids.sql.resultCache.enabled": "true"}
SUBPLAN_ON = {"spark.rapids.sql.subplanCache.enabled": "true",
              "spark.rapids.sql.batchSizeRows": "512"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return write_tables(str(tmp_path_factory.mktemp("result_cache_tables")))


@pytest.fixture(autouse=True)
def _fresh():
    reset_state()
    yield
    reset_state()


def _copy(root, dst) -> str:
    for v in VIEWS:
        shutil.copytree(os.path.join(root, v), os.path.join(dst, v))
    return str(dst)


def _count_executions(srv) -> list:
    """Every sql the server's sessions execute (a hook on its sessions)."""
    seen: list = []
    orig = srv._session

    def hook(tenant):
        s = orig(tenant)
        if not getattr(s, "_count_hook", False):
            inner = s.execute_plan

            def counted(plan):
                seen.append(tenant)
                return inner(plan)
            s.execute_plan = counted
            s._count_hook = True
        return s
    srv._session = hook
    return seen


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_hit_serves_identical_bytes_without_executing(root, pkg):
    with serving(pkg, root, **RESULT_ON) as srv:
        runs = _count_executions(srv)
        with clients()[pkg](srv.port, tenant="dash", timeout=TIMEOUT) as c:
            b1, h1 = c.sql(Q1S)
            b2, h2 = c.sql(Q1S)
        assert not h1.get("resultCacheHit") and h2["resultCacheHit"]
        assert h2["planCacheHit"] and h2["queueWaitMs"] == 0.0
        assert rows(b1) == rows(b2)
        assert runs == ["dash"]
        st = srv.stats()["cache"]["result"]
        assert (st["hits"], st["misses"], st["entries"]) == (1, 1, 1)


def _part(d):
    return os.path.join(d, sorted(p for p in os.listdir(d)
                                  if p.endswith(".parquet"))[0])


def _mutate(li: str, mutation: str) -> None:
    part = _part(li)
    if mutation == "append":
        shutil.copy(part, os.path.join(li, "part-zz-extra.parquet"))
    elif mutation == "rewrite":
        with open(part, "rb") as f:
            blob = f.read()
        st = os.stat(part)
        with open(part, "wb") as f:
            f.write(blob)
        os.utime(part, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000))
    elif mutation == "touch":
        st = os.stat(part)
        os.utime(part, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    elif mutation == "delete":
        os.remove(part)
    else:  # a new file with other rows
        import pyarrow as pa
        import pyarrow.parquet as pq
        pq.write_table(pa.table({
            "flag": np.array(["A", "N"]), "status": np.int32([1, 2]),
            "qty": np.int64([3, 4]), "price": np.int32([5, 6])}),
            os.path.join(li, "part-zz-new.parquet"))


def _invalidation(pkg, root, tmp, mutation):
    d = _copy(root, tmp)
    with serving(pkg, d, **RESULT_ON) as srv:
        with clients()[pkg](srv.port, tenant="dash", timeout=TIMEOUT) as c:
            before = rows(c.sql(Q1S)[0])
            assert c.sql(Q1S)[1]["resultCacheHit"]
            _mutate(os.path.join(d, "lineitem"), mutation)
            # the cached plan's scan lists its files at planning: drop the
            # templates, as the JAX package's own test does, so the
            # re-execution reads the changed directory
            reset_state()
            after, head = c.sql(Q1S)
            again = c.sql(Q1S)[1]
        st = srv.stats()["cache"]["result"]
    return (before, rows(after), bool(head.get("resultCacheHit")),
            bool(again.get("resultCacheHit")), st["invalidations"] >= 1)


@pytest.mark.parametrize("mutation", ["append", "rewrite", "touch",
                                      "delete", "new_file"])
def test_invalidation_matrix_matches_jax(root, tmp_path, mutation):
    jax = _invalidation("jax", root, tmp_path / "jax", mutation)
    port = _invalidation("port", root, tmp_path / "port", mutation)
    assert port == jax
    before, after, hit, again_hit, invalidated = port
    assert not hit and again_hit and invalidated
    if mutation in ("touch", "rewrite"):
        assert after == before
    else:
        assert after != before


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_register_view_drops_every_entry(root, pkg):
    with serving(pkg, root, **RESULT_ON) as srv:
        with clients()[pkg](srv.port, tenant="v", timeout=TIMEOUT) as c:
            c.sql(Q1S)
            c.sql(Q3S)
            srv.register_view("lineitem", os.path.join(root, "lineitem"))
            assert not c.sql(Q1S)[1].get("resultCacheHit")
            assert c.sql(Q1S)[1]["resultCacheHit"]
        st = srv.stats()["cache"]["result"]
        assert st["invalidations"] == 2 and st["entries"] == 1


def _views(spark, root):
    for v in VIEWS:
        spark.read.parquet(os.path.join(root, v)).createOrReplaceTempView(v)
    return spark


def _build_cache_hits(plan) -> int:
    from spark_rapids_tpu_torch.metrics import plan_metrics
    return plan_metrics(plan).get("subplanCacheHits", 0)


def test_subplan_reuse_matches_jax(root):
    want = [tuple(r) for r in _views(TpuSparkSession(dict(SUBPLAN_ON)),
                                     root).sql(Q3S).collect()]
    s = _views(TorchSparkSession(dict(SUBPLAN_ON), device="cpu"), root)
    assert [tuple(r) for r in s.sql(Q3S).collect()] == want
    st0 = RC.subplan_cache_stats()
    assert st0["entries"] == 1 and _build_cache_hits(s.last_plan) == 0
    assert [tuple(r) for r in s.sql(Q3S).collect()] == want
    assert _build_cache_hits(s.last_plan) == 1
    # another session (another tenant) shares the device-resident table
    s2 = _views(TorchSparkSession(dict(SUBPLAN_ON, **{
        "spark.rapids.sql.serve.tenantId": "other"}), device="cpu"), root)
    assert [tuple(r) for r in s2.sql(Q3S).collect()] == want
    assert RC.subplan_cache_stats()["hits"] == st0["hits"] + 2
    # the entry lives in the store's cache tier, owned by the cache
    assert MEM._STORE.live_handles(RC.SubplanCache.OWNER) == 1
    assert MEM._STORE.live_handles() == 1


def test_subplan_changed_build_file_rebuilds(root, tmp_path):
    # the plan cache serves one template, so the second run probes the
    # same subplan key: the fingerprint re-check is all that stands
    # between it and a stale table (the JAX package's own case)
    d = _copy(root, tmp_path)
    conf = dict(SUBPLAN_ON, **{"spark.rapids.sql.planCache.enabled": "true"})
    s = _views(TorchSparkSession(conf, device="cpu"), d)
    first = [tuple(r) for r in s.sql(Q3S).collect()]
    dim = _part(os.path.join(d, "dim"))
    st = os.stat(dim)
    os.utime(dim, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert [tuple(r) for r in s.sql(Q3S).collect()] == first
    assert _build_cache_hits(s.last_plan) == 0
    assert RC.subplan_cache_stats()["invalidations"] == 1
    assert [tuple(r) for r in s.sql(Q3S).collect()] == first
    assert _build_cache_hits(s.last_plan) == 1


def _batch(n=256, seed=0):
    from spark_rapids_tpu_torch.columnar.device import DeviceBatch
    from spark_rapids_tpu_torch.columnar.host import HostBatch, HostColumn
    from spark_rapids_tpu_torch.sql import types as T
    rng = np.random.default_rng(seed)
    col = HostColumn(T.LongT, rng.integers(0, 1 << 40, n),
                     np.ones(n, dtype=bool))
    return DeviceBatch.from_host(
        HostBatch(T.StructType([T.StructField("v", T.LongT)]), [col], n),
        torch.device("cpu"))


def test_cache_entries_drop_before_live_spill(tmp_path):
    b_live, b_cache, b_new = _batch(256, 1), _batch(256, 2), _batch(256, 3)
    store = MEM.DeviceStore(b_live.sizeof() * 2 + 10, 1 << 30,
                            str(tmp_path))
    h_live = store.register(b_live, owner="query")
    h_cache = store.register(b_cache, owner="subplanCache",
                             cache_entry=True)
    store.register(b_new, owner="query")  # over the budget
    assert store.cache_drop_count == 1 and store.spill_count == 0
    assert h_cache.closed and h_live.tier == MEM.TIER_DEVICE
    st = store.stats()
    assert st["cacheDropCount"] == 1 and st["cacheDroppedBytes"] > 0


def test_over_share_tenant_spills_first(tmp_path):
    a1, a2, b1, new = (_batch(256, i) for i in range(4))
    size = a1.sizeof()
    store = MEM.DeviceStore(size * 3 + 10, 1 << 30, str(tmp_path))
    store.fair_share_factor = 1.0
    with MEM.tenant_scope("b"):
        hb = store.register(b1, owner="query")
    with MEM.tenant_scope("a"):
        ha1 = store.register(a1, owner="query")
        ha2 = store.register(a2, owner="query")
        assert store.over_share_tenants() == {"a": 2 * size}
        hn = store.register(new, owner="query")  # over the budget
    # b's handle is the least recently used, but a is over its share
    assert hb.tier == MEM.TIER_DEVICE and ha1.tier == MEM.TIER_HOST
    t = store.tenant_stats()
    assert t["a"]["spillBytes"] == size and t["b"]["spillBytes"] == 0
    assert t["a"]["peakBytes"] == 3 * size
    for h in (ha1, ha2, hn, hb):
        h.close()
    assert store.tenant_stats()["a"]["liveBytes"] == 0


def test_pressure_drop_is_an_eviction(tmp_path):
    store = MEM.DeviceStore(1 << 30, 1 << 30, str(tmp_path))
    cache = RC.SubplanCache(max_entries=8, max_bytes=1 << 30)
    src = tmp_path / "src.bin"
    src.write_bytes(b"x" * 64)
    paths = (str(src),)
    assert cache.put("k1", (paths, RC.source_fingerprints(paths)),
                     _batch(128, 7), store)
    assert cache.lookup("k1") is not None
    store.spill_device_down(0)
    assert store.cache_drop_count == 1
    assert cache.lookup("k1") is None
    assert cache.stats()["evictions"] == 1 and cache.stats()["entries"] == 0


def test_result_cache_lru_bounds(tmp_path):
    rc = RC.ResultCache(max_entries=2, max_bytes=100)
    src = tmp_path / "src.bin"
    src.write_bytes(b"x")
    cap = ((str(src),), RC.source_fingerprints([str(src)]))
    for i in range(3):
        assert rc.put(f"SELECT {i} + x FROM t", "sig", cap, b"p" * 10, 1)
    assert rc.stats()["entries"] == 2 and rc.evictions == 1
    assert not rc.put("SELECT big", "sig", cap, b"p" * 101, 1)
    assert not rc.put("SELECT nosig", None, cap, b"p", 1)
    assert not rc.put("SELECT nofp", "sig", None, b"p", 1)
    # one probe key per literal-normalized text and its literal vector
    assert rc.lookup("SELECT 2 +  x FROM t") is not None
    assert rc.lookup("SELECT 5 + x FROM t") is None


@pytest.mark.parametrize("sql", [
    "SELECT * FROM t WHERE a = 5 AND b = 'x''y' AND c < 1.5",
    "SELECT x1, sum(v2) FROM t2 WHERE y=10 GROUP BY x1",
    "select  a\n from t where d = date '1998-09-02' limit 100",
    Q1S, Q3S])
def test_fusion_key_matches_jax(sql):
    assert A.fusion_key(sql) == JA.fusion_key(sql)


def test_fingerprint_capture_over_scans(root):
    s = _views(TorchSparkSession({}, device="cpu"), root)
    plan = s.plan_physical(s.sql(Q3S).plan)
    paths, fps = RC.capture_fingerprints(plan)
    assert set(paths) == {os.path.join(root, v) for v in ("fact", "dim")}
    assert len(fps) == 5 and RC.fingerprints_current(paths, fps)
    local = s.createDataFrame({"a": [1, 2]}, "a long")
    assert RC.capture_fingerprints(s.plan_physical(local.plan)) is None
    scans = [p for p in _walk(plan) if hasattr(p, "fingerprints")]
    assert sorted(f for sc in scans for f in sc.fingerprints) == \
        sorted(fps)


def _walk(p):
    yield p
    for c in getattr(p, "children", []):
        yield from _walk(c)
