"""Rules of the port: it imports nothing of JAX or of the JAX package,
its session runs on the card unless asked for the CPU, and a kernel
wrapper handed a CUDA request it cannot serve raises instead of falling
back to its plain version."""

import ast
import os
from pathlib import Path

import pytest
import torch

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar.device import (DeviceColumn,
                                                    DeviceDecimal128Column)
from spark_rapids_tpu_torch.kernels import groupby_hash as KG
from spark_rapids_tpu_torch.kernels import join_probe as KJ
from spark_rapids_tpu_torch.kernels import murmur3 as KM
from spark_rapids_tpu_torch.sql import session as S
from spark_rapids_tpu_torch.sql import types as T

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    files = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "spark_rapids_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 20


@pytest.mark.parametrize("rel", [str(p.relative_to(ROOT))
                                 for p in _port_files()])
def test_no_jax_or_jax_package_import(rel):
    bad = [m for m in _imports(ROOT / rel) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_python_worker_imports_no_torch():
    """The pandas-UDF worker process runs ``python/worker.py`` (through
    the package's import-free ``__init__`` files): it loads no torch,
    whatever the engine has loaded."""
    files = [ROOT / "spark_rapids_tpu_torch" / "python" / "worker.py",
             ROOT / "spark_rapids_tpu_torch" / "python" / "__init__.py",
             ROOT / "spark_rapids_tpu_torch" / "__init__.py"]
    for path in files:
        mods = list(_imports(path))
        assert not [m for m in mods if m.split(".")[0] == "torch"
                    or _forbidden(m)], f"{path.name} imports {mods}"
        tree = ast.parse(path.read_text())
        assert not [n for n in ast.walk(tree) if isinstance(
            n, ast.ImportFrom) and n.level > 0], path


def test_scan_covers_the_serving_modules():
    rels = {str(p.relative_to(ROOT)) for p in _port_files()}
    for mod in ("serve/__init__.py", "serve/server.py", "serve/client.py",
                "serve/protocol.py", "serve/scheduler.py",
                "serve/result_cache.py", "lifecycle.py", "plan_cache.py"):
        assert f"spark_rapids_tpu_torch/{mod}" in rels, mod


def test_forbidden_matches_module_names_exactly():
    assert _forbidden("spark_rapids_tpu.sql.types")
    assert _forbidden("spark_rapids_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("spark_rapids_tpu_torch.sql.types")
    assert not _forbidden("jaxtyping_like")


def test_session_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.TorchSparkSession()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.TorchSparkSession(device="cuda")
    assert S.TorchSparkSession(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert S.resolve_device(None) == torch.device("cuda", 0)


class _CudaTyped:
    """A CPU tensor that reports itself as lying on a CUDA device."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)

    def is_contiguous(self):
        return True


def _cuda_long_col(n=64):
    return DeviceColumn(T.LongT, _CudaTyped(torch.zeros(n, dtype=torch.int64)),
                        _CudaTyped(torch.ones(n, dtype=torch.bool)))


def test_murmur3_raises_on_unservable_cuda_requests():
    KR.reset_launches()
    z = torch.zeros(64, dtype=torch.int64)
    dec = DeviceDecimal128Column(T.DecimalType(30, 2), _CudaTyped(z),
                                 _CudaTyped(z), _CudaTyped(z.bool()))
    with pytest.raises(KR.KernelError, match="cannot hash"):
        KM.murmur3_columns([dec], 64)
    with pytest.raises(KR.KernelError, match="at most"):
        KM.murmur3_columns([_cuda_long_col()] * 17, 64)
    mixed = DeviceColumn(T.LongT, z, _CudaTyped(z.bool()))
    with pytest.raises(KR.KernelError, match="not CUDA"):
        KM.murmur3_columns([mixed], 64)
    with pytest.raises(KR.KernelError, match="capacity"):
        KM.murmur3_columns([_cuda_long_col(64)], 128)
    with pytest.raises(KR.KernelError, match="n_parts"):
        KM.murmur3_columns([_cuda_long_col()], 64, n_parts=-1)
    wide = DeviceColumn(T.IntegerT, _CudaTyped(z), _CudaTyped(z.bool()))
    with pytest.raises(KR.KernelError, match="stored as"):
        KM.murmur3_columns([wide], 64)
    assert KR.LAUNCHES["murmur3"] == 0


def test_groupby_raises_on_unservable_cuda_requests():
    KR.reset_launches()
    n = 64
    kw = _CudaTyped(torch.zeros((n, 2), dtype=torch.int64))
    h = _CudaTyped(torch.zeros(n, dtype=torch.int64))
    valid = _CudaTyped(torch.ones(n, dtype=torch.bool))
    lanes = _CudaTyped(torch.zeros((1, n), dtype=torch.int64))
    with pytest.raises(KR.KernelError, match="not CUDA"):
        KG.groupby_table(kw, torch.zeros(n, dtype=torch.int64), valid,
                         lanes, lanes, lanes, 64)
    with pytest.raises(KR.KernelError, match="power"):
        KG.groupby_table(kw, h, valid, lanes, lanes, lanes, 100)
    bad = _CudaTyped(torch.zeros((n, 1), dtype=torch.int32))
    with pytest.raises(KR.KernelError, match="lanes"):
        KG.groupby_table(kw, h, valid, bad, lanes, lanes, 64)
    assert KR.LAUNCHES["groupbyHash"] == 0


def test_join_probe_raises_on_unservable_cuda_requests():
    KR.reset_launches()
    n = 64
    kw2 = _CudaTyped(torch.zeros((n, 2), dtype=torch.int64))
    kw1 = _CudaTyped(torch.zeros((n, 1), dtype=torch.int64))
    v = _CudaTyped(torch.ones(n, dtype=torch.bool))
    with pytest.raises(KR.KernelError, match="not CUDA"):
        KJ.build_probe(kw2, torch.ones(n, dtype=torch.bool), kw2, v)
    with pytest.raises(KR.KernelError, match="key words"):
        KJ.build_probe(kw2, v, kw1, v)
    kw32 = _CudaTyped(torch.zeros((n, 2), dtype=torch.int32))
    with pytest.raises(KR.KernelError, match="int64"):
        KJ.build_probe(kw32, v, kw2, v)
    big = 20_000  # 65,536 slots: more than one block's shared memory
    with pytest.raises(KR.KernelError, match="one block holds"):
        KJ.build_probe(_CudaTyped(torch.zeros((big, 2), dtype=torch.int64)),
                       _CudaTyped(torch.ones(big, dtype=torch.bool)), kw2, v)
    assert KR.LAUNCHES["joinProbe"] == 0


def test_missing_compiler_raises_instead_of_falling_back(monkeypatch):
    """A CUDA request whose kernel cannot be built raises; the plain
    version is never substituted."""
    monkeypatch.setattr(KR.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(str(ROOT), "no-such-dir"))
    monkeypatch.setattr(KR, "_LIBS", {})
    monkeypatch.setattr(KR, "BUILD_SECONDS", None)
    monkeypatch.setattr(KR, "_lib_path",
                        lambda name: ROOT / "no-such-dir" / f"{name}.so")
    with pytest.raises(KR.KernelError, match="nvcc"):
        KM.murmur3_columns([_cuda_long_col()], 64)
    n = 64
    t = _CudaTyped(torch.zeros((n, 1), dtype=torch.int64))
    lanes = _CudaTyped(torch.zeros((1, n), dtype=torch.int64))
    with pytest.raises(KR.KernelError, match="nvcc"):
        KG.groupby_table(t, _CudaTyped(torch.zeros(n, dtype=torch.int64)),
                         _CudaTyped(torch.ones(n, dtype=torch.bool)),
                         lanes, lanes, lanes, 64)


def test_table_slots_power_of_two():
    from spark_rapids_tpu_torch.conf import TorchConf
    conf = TorchConf()
    assert KR.table_slots(conf, 786432) == 1024
    assert KR.table_slots(conf, 64) == 128
    assert KR.table_slots(conf, 8) == 64
    small = TorchConf({"spark.rapids.sql.kernel.groupbyHash.tableSlots":
                       "100"})
    assert KR.table_slots(small, 786432) == 128


def _recorded_kinds():
    """(span kinds, instant kinds) recorded as string literals anywhere
    in the port: ``span("k")``, ``dispatch_end`` (a ``kernelDispatch``),
    ``qt.add("k", ...)``, ``instant("k")`` and ``qt.mark("k")``."""
    spans, instants = set(), set()
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            first = node.args[0] if node.args else None
            lit = first.value if isinstance(first, ast.Constant) \
                and isinstance(first.value, str) else None
            if name == "dispatch_end":
                spans.add("kernelDispatch")
            elif lit is None:
                continue
            elif name == "span" or (name == "add" and len(node.args) >= 3):
                spans.add(lit)
            elif name in ("instant", "mark"):
                instants.add(lit)
    return spans, instants


def test_every_recorded_span_and_instant_kind_is_catalogued():
    """The counterpart of the JAX package's ``span-kind`` lint rule: a
    literal kind recorded in the port is in ``SPAN_CATALOG`` or
    ``INSTANT_CATALOG``."""
    from spark_rapids_tpu_torch import trace as TR
    spans, instants = _recorded_kinds()
    assert {"kernelDispatch", "compile", "retryBlock", "semaphoreWait",
            "serveQueueWait"} <= spans
    assert {"retryOOM", "queryCancelled", "telemetryTrigger"} <= instants
    assert spans - set(TR.SPAN_CATALOG) == set()
    assert instants - set(TR.INSTANT_CATALOG) == set()
