"""Device capability probes and the build-and-launch check of the CUDA
kernel tier (the counterparts of ``spark_rapids_tpu.device_caps``).

Numeric probes: tiny torch programs run once per device on that device
and compared with numpy (IEEE binary64, the CPU engine's arithmetic).
The expression tagger asks them before it lets float arithmetic,
division or transcendentals run on the device
(``ops.exprs.platform_gate``); on an inexact device such an expression
raises at plan rewrite unless ``spark.rapids.sql.incompatibleOps.enabled``
is set. The JAX package needs them because TPUs emulate float64; on the
CPU and on an H100 every probe is expected to answer exact.

Kernel tier: the JAX package lowers one trivial Pallas kernel to choose
between native, interpret and off. The port has no mode to choose:
``probe`` builds every kernel from ``csrc/`` and launches the trivial
one (``csrc/probe.cu``, out = 2 * in), and raises on any failure.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spark_rapids_tpu_torch import kernels as KR


def _key(device) -> str:
    return str(torch.device(device))


@functools.lru_cache(maxsize=None)
def _f64_arith_exact(dev: str) -> bool:
    a = np.array([110.0, 0.1, 1e300, 7.0, 1.0, -0.3], dtype=np.float64)
    b = np.array([3.0, 0.3, 7.0, 11.0, 3.0, 0.7], dtype=np.float64)
    x = torch.from_numpy(a).to(dev)
    y = torch.from_numpy(b).to(dev)
    add, mul, div = (x + y).cpu().numpy(), (x * y).cpu().numpy(), \
        (x / y).cpu().numpy()
    total = float(torch.sum(x).cpu())
    with np.errstate(all="ignore"):
        return (np.array_equal(add, a + b) and np.array_equal(mul, a * b)
                and np.array_equal(div, a / b)
                and total == float(np.sum(a)))


@functools.lru_cache(maxsize=None)
def _float_div_exact(dev: str) -> bool:
    a32 = np.array([1.5, 0.1, 7.0, 110.0], dtype=np.float32)
    b32 = np.array([3.0, 0.3, 11.0, 3.0], dtype=np.float32)
    x = torch.from_numpy(a32).to(dev)
    y = torch.from_numpy(b32).to(dev)
    return (np.array_equal((x / y).cpu().numpy(), a32 / b32)
            and np.array_equal(torch.sqrt(x).cpu().numpy(), np.sqrt(a32))
            and _f64_arith_exact(dev))


@functools.lru_cache(maxsize=None)
def _f64_bitcast_exact(dev: str) -> bool:
    bits = np.array([0x3FF0000000000000, -0x10000000000000000 +
                     0xC000000000000000, 0x7FF0000000000000, 0],
                    dtype=np.int64)
    out = torch.from_numpy(bits).to(dev).view(torch.float64).cpu().numpy()
    return np.array_equal(out, bits.view(np.float64), equal_nan=True)


def f64_arith_exact(device) -> bool:
    """True when float64 +, *, / and a sum on ``device`` are
    bit-identical to IEEE (numpy)."""
    return _f64_arith_exact(_key(device))


def float_div_exact(device) -> bool:
    """True when float32 division and sqrt on ``device`` are correctly
    rounded (and float64 arithmetic is exact)."""
    return _float_div_exact(_key(device))


def f64_bitcast_exact(device) -> bool:
    """True when int64 <-> float64 bit reinterpretation on ``device`` is
    exact."""
    return _f64_bitcast_exact(_key(device))


def float_arith_reason(kind: str = "arithmetic") -> str:
    return (f"device float {kind} is not bit-identical to CPU on this "
            "backend (TPU f64 is emulated); set "
            "spark.rapids.sql.incompatibleOps.enabled=true to allow")


def capabilities(device) -> dict:
    """Every probe's answer on ``device``."""
    return {"f64_arith_exact": f64_arith_exact(device),
            "float_div_exact": float_div_exact(device),
            "f64_bitcast_exact": f64_bitcast_exact(device)}


def probe(device: torch.device) -> float:
    """Build all kernels, launch the probe on ``device`` and check it;
    returns the build seconds (0 when the libraries were up to date)."""
    if device.type != "cuda":
        raise KR.KernelError(f"probe needs a CUDA device, got {device}")
    seconds = KR.build_all()
    x = torch.arange(8, dtype=torch.int32, device=device)
    out = launch_probe(x)
    torch.cuda.synchronize(device)
    if not torch.equal(out.cpu(), (x * 2).cpu()):
        raise KR.KernelError(f"probe kernel returned {out.tolist()}")
    return seconds


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/probe.cu`` on a contiguous int32 CUDA
    tensor: returns ``2 * x`` (not synchronised)."""
    KR.require_cuda([x], "probe")
    if x.dtype != torch.int32:
        raise KR.KernelError("probe: int32 input")
    out = torch.empty_like(x)
    fn = KR.library("probe").probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the launch goes to the calling thread's current device: make
    # it the tensors' (a card other than 0 on a mesh)
    with KR.on_device(x.device):
        KR.check(fn(x.data_ptr(), out.data_ptr(), x.numel(),
                    KR.stream_handle(x.device)), "probe launch")
    return out


# A float64 column decodes on the device by reinterpreting its 64-bit
# pattern (``Tensor.view(torch.float64)`` in the plain version, a
# ``long long`` -> ``double`` bit copy in the kernel). Both are exact on
# the CPU and on CUDA, so no Parquet DOUBLE column falls back for want of
# an exact bitcast (the JAX package probes its backend for this).
F64_BITCAST_EXACT = True
