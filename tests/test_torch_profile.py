"""Query profiles (``profile.py``) held against the JAX package's: TPC-H
q1 and TPC-DS q3's pushed form from Parquet through both packages with
``spark.rapids.sql.profile.enabled``. The profile trees must name the
same operators (``Tpu`` read as ``Torch``) with the same row counts,
``format_profile`` must render a profile file identically in both
packages, the kernel summary must equal the plan's kernel dispatch
counters, and every metric the port records must be described."""

import os

import pyarrow.parquet as pq
import pytest
import torch

from chip_smoke import (Q1, Q3_PUSHED, lineitem_arrays, lineitem_fields,
                        q3_tables)
from spark_rapids_tpu import profile as JPROF
from spark_rapids_tpu.sql.session import TpuSparkSession

from spark_rapids_tpu_torch import metrics as M
from spark_rapids_tpu_torch import profile as PROF
from spark_rapids_tpu_torch.interop import host_batch_from_numpy
from spark_rapids_tpu_torch.io.arrow_convert import host_batch_to_arrow
from spark_rapids_tpu_torch.sql import types as PT
from spark_rapids_tpu_torch.sql.session import TorchSparkSession

torch.set_num_threads(2)

QUERIES = {"q1": Q1, "q3": Q3_PUSHED}


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("prof"))
    out = {"lineitem": os.path.join(base, "lineitem")}
    os.makedirs(out["lineitem"])
    tbl = host_batch_to_arrow(host_batch_from_numpy(
        lineitem_fields(), lineitem_arrays(4000)))
    for i in range(2):
        pq.write_table(tbl.slice(i * 2000, 2000),
                       os.path.join(out["lineitem"], f"part-{i}.parquet"),
                       row_group_size=1000)
    tables = q3_tables(6000)
    types = {"long": PT.LongT, "int": PT.IntegerT, "str": PT.StringT,
             "dec72": PT.DecimalType(7, 2)}
    s = TorchSparkSession(device="cpu")
    for name in ("item", "date_dim", "store_sales"):
        cols = tables[name]
        batch = host_batch_from_numpy([(c, types[k]) for c, k, _a in cols],
                                      [a for _c, _k, a in cols])
        out[name] = os.path.join(base, name)
        s.createDataFrame(batch, num_partitions=4).write \
            .mode("overwrite").parquet(out[name])
    return out


@pytest.fixture(scope="module")
def profiles(views, tmp_path_factory):
    out = {}
    for q, sql in QUERIES.items():
        for pkg in ("jax", "port"):
            d = str(tmp_path_factory.mktemp(f"{pkg}-{q}"))
            conf = {"spark.rapids.sql.profile.enabled": "true",
                    "spark.rapids.sql.profile.dir": d}
            if pkg == "jax":
                s = TpuSparkSession(dict(conf, **{
                    "spark.rapids.sql.enabled": "true"}))
            else:
                s = TorchSparkSession(conf, device="cpu")
            try:
                for name, path in views.items():
                    s.read.parquet(path).createOrReplaceTempView(name)
                rows = s.sql(sql).collect()
                plan = getattr(s, "last_plan", None)
            finally:
                s.stop()
            mod = JPROF if pkg == "jax" else PROF
            (prof,) = list(mod.read_profiles(d))
            out[pkg, q] = {"prof": prof, "rows": len(rows), "plan": plan}
    return out


def _tree(entry) -> list:
    """(op, numOutputRows) of each node and fused constituent, in
    order."""
    out = [(entry["op"].replace("Tpu", "Torch"),
            (entry.get("metrics") or {}).get("numOutputRows"))]
    for fe in entry.get("fused", []):
        out.append((fe["op"].replace("Tpu", "Torch"),
                    (fe.get("metrics") or {}).get("numOutputRows")))
    for c in entry.get("children", []):
        out += _tree(c)
    return out


@pytest.mark.parametrize("q", list(QUERIES))
def test_profile_trees_match_jax_package(profiles, q):
    jp, pp = profiles["jax", q]["prof"], profiles["port", q]["prof"]
    jt, pt = _tree(jp["plan"]), _tree(pp["plan"])
    assert [op for op, _n in pt] == [op for op, _n in jt]
    # the JAX package leaves most device operators' numOutputRows at 0
    # (it reads a row count only where it needs one); where it counted,
    # the counts agree
    counted = [(i, n) for i, (_op, n) in enumerate(jt) if n]
    assert counted and all(pt[i][1] == n for i, n in counted)
    assert pp["outputRows"] == jp["outputRows"] == profiles["port", q][
        "rows"]
    assert pp["version"] == jp["version"]
    assert set(pp) == set(jp)


@pytest.mark.parametrize("q", list(QUERIES))
@pytest.mark.parametrize("src", ["jax", "port"])
def test_format_profile_renders_identically(profiles, q, src):
    prof = profiles[src, q]["prof"]
    assert PROF.format_profile(prof) == JPROF.format_profile(prof)
    assert PROF.format_profile(prof, top=2) == \
        JPROF.format_profile(prof, top=2)


@pytest.mark.parametrize("q", list(QUERIES))
def test_kernel_summary_equals_the_dispatch_counters(profiles, q):
    pp = profiles["port", q]
    counts = {k.split(".", 1)[1]: v
              for k, v in M.plan_metrics(pp["plan"]).items()
              if k.startswith("kernelDispatchCount.") and v}
    assert pp["prof"]["kernels"] == {"dispatches": counts, "fallbacks": {}}
    assert pp["prof"]["kernels"]["dispatches"] == \
        profiles["jax", q]["prof"]["kernels"]["dispatches"]


@pytest.mark.parametrize("q", list(QUERIES))
def test_every_recorded_metric_is_described(profiles, q):
    for name in M.plan_metrics(profiles["port", q]["plan"]):
        assert M.describe_metric(name) is not None, name


def test_metric_catalog_is_the_jax_catalog_plus_the_ports_own():
    from spark_rapids_tpu import metrics as JM
    extra = set(M.METRIC_DESCRIPTIONS) - set(JM.METRIC_DESCRIPTIONS)
    assert extra == {M.PINNED_STREAM_COPIES, M.PLANNED_WORKING_SET}
    assert set(JM.METRIC_DESCRIPTIONS) <= set(M.METRIC_DESCRIPTIONS)
    assert set(M.METRIC_PREFIX_DESCRIPTIONS) == \
        set(JM.METRIC_PREFIX_DESCRIPTIONS)


def test_write_profile_is_off_by_default_and_never_raises(tmp_path):
    from spark_rapids_tpu_torch.conf import TorchConf
    assert PROF.write_profile(TorchConf({}), None, None, 0.0, 0) is None
    bad = TorchConf({"spark.rapids.sql.profile.enabled": "true",
                     "spark.rapids.sql.profile.dir":
                         str(tmp_path / "f" / "x")})
    (tmp_path / "f").write_text("a file, not a directory")
    assert PROF.write_profile(bad, None, None, 0.0, 0) is None
