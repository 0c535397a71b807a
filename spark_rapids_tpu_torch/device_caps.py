"""Build-and-launch check of the CUDA kernel tier (the counterpart of
``spark_rapids_tpu.device_caps.pallas_mode``).

The JAX package lowers one trivial Pallas kernel to choose between
native, interpret and off. The port has no mode to choose: ``probe``
builds every kernel from ``csrc/`` and launches the trivial one
(``csrc/probe.cu``, out = 2 * in), and raises on any failure.
"""

from __future__ import annotations

import ctypes

import torch

from spark_rapids_tpu_torch import kernels as KR


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
    KR.check(fn(x.data_ptr(), out.data_ptr(), x.numel(),
                KR.stream_handle(x.device)), "probe launch")
    return out


# A float64 column decodes on the device by reinterpreting its 64-bit
# pattern (``Tensor.view(torch.float64)`` in the plain version, a
# ``long long`` -> ``double`` bit copy in the kernel). Both are exact on
# the CPU and on CUDA, so no Parquet DOUBLE column falls back for want of
# an exact bitcast (the JAX package probes its backend for this).
F64_BITCAST_EXACT = True
