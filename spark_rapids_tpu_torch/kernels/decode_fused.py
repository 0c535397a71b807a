"""Parquet page decode of a row group (CUDA, ``csrc/decode_fused.cu``).

Replaces ``spark_rapids_tpu/kernels/decode_fused.py`` ``build_fused_decode``:
every device-decoded column of an EncodedBatch (``io/device_decode.py``)
comes out of one decode: RLE/bit-packed runs, dictionary gathers, PLAIN
and FLBA reads, DELTA_BINARY_PACKED and BYTE_STREAM_SPLIT
reconstruction, string offsets and bytes, and definition levels into
validity. Host-decoded columns pass through untouched.

``decode_fused`` on CPU tensors runs the plain PyTorch version
(``columnar/transfer.py`` ``_encoded_decode_body`` over ``ops/rle.py``);
on CUDA tensors it launches the kernel (1 CUDA launch per batch when no
column needs a prefix sum, else 3) or raises. Each decoded batch counts
one ``decodeFused`` launch, the JAX package's unit of one dispatch per
batch. Bound on the H100: bytes (page words and tables in, every output
out, at 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import kernels as KR

# column descriptor fields, in csrc/decode_fused.cu's Field order
FIELDS = ("kind", "out_bytes", "sext32", "elem_bytes", "char_cap", "npg",
          "dense_start", "plain_byte", "pg_enc", "pg_first",
          "ndl", "dl_os", "dl_pk", "dl_va", "dl_bs", "dl_wd",
          "nvr", "vr_os", "vr_pk", "vr_va", "vr_bs", "vr_wd",
          "ndr", "dr_os", "dr_pk", "dr_va", "dr_bs", "dr_wd",
          "slen", "dict0", "dict1", "dict_rows",
          "has_plain", "has_delta", "has_bss", "rank_slot", "dense_slot",
          "out0", "out1", "out2")
KINDS = ("bool", "int", "f32", "f64", "dec64", "dec128", "str")
SCAN_BLOCK = 1024

_RUN_DTYPES = (torch.int64, torch.bool, torch.int64, torch.int64,
               torch.int64)
_DICT_DTYPES = {"str": (torch.uint8, torch.int32),
                "dec128": (torch.int64, torch.int64)}


def _out_dtype(kind: str, np_dt: str) -> torch.dtype:
    if kind == "bool":
        return torch.bool
    if kind == "f32":
        return torch.float32
    if kind == "f64":
        return torch.float64
    return getattr(torch, np_dt)


def decode_fused(layout: Tuple, cap: int, n: int, words: torch.Tensor,
                 extras: Sequence[torch.Tensor], rows_per_thread: int = 0,
                 tuned: bool = False):
    """Packed page words + plan tables -> ``(active, outs)`` at capacity
    ``cap`` for ``n`` rows, outs in the layout's column order.
    ``rows_per_thread`` (1, 2 or 4; 0 = chosen by the batch's size) is
    the autotuner's launch knob: it changes the launch, never a byte, and
    the plain version has no launch to change. ``tuned`` marks the
    dispatch span of a launch that runs a recorded winner."""
    from spark_rapids_tpu_torch.columnar.transfer import (
        _encoded_decode_body, walk_layout)
    if not words.is_cuda:
        # the plain version's call takes the kernel's span on the CPU
        t0 = KR.dispatch_start()
        out = _encoded_decode_body(layout, cap, words, n, extras)
        if t0 is not None:
            KR.dispatch_end(t0, "decodeFused", bucket=cap, tuned=tuned)
        return out
    return _launch(list(walk_layout(layout, extras)), cap, n, words,
                   int(rows_per_thread), tuned)


def _check(t: torch.Tensor, dtype: torch.dtype, shape, what: str) -> int:
    if t.dtype != dtype:
        raise KR.KernelError(f"decodeFused: {what} is {t.dtype}, "
                             f"not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KR.KernelError(f"decodeFused: {what} has shape "
                             f"{tuple(t.shape)}, not {tuple(shape)}")
    return t.data_ptr()


def _launch(entries, cap: int, n: int, words: torch.Tensor,
            rows_per_thread: int, tuned: bool):
    device = words.device
    tensors = [words] + [x for _e, t in entries for x in _tensors_of(t)]
    KR.require_cuda(tensors, "decodeFused")
    if words.dtype != torch.int32 or words.dim() != 1:
        raise KR.KernelError("decodeFused: words must be 1-D int32")
    if not 0 <= n <= cap:
        raise KR.KernelError(f"decodeFused: {n} rows at capacity {cap}")
    outs: List[torch.Tensor] = []
    descs: List[List[int]] = []
    n_slots = 0
    for ent, t in entries:
        if ent[0] == "host":
            outs.extend(t["parts"])
            continue
        (_tag, kind, np_dt, elem_bytes, char_cap, npg, ndl, nvr, ndr,
         dict_shapes, has_plain, has_delta, has_bss, has_slen) = ent
        f = dict.fromkeys(FIELDS, 0)
        f.update(kind=KINDS.index(kind), elem_bytes=elem_bytes,
                 char_cap=char_cap, npg=npg, ndl=ndl, nvr=nvr, ndr=ndr,
                 has_plain=int(has_plain), has_delta=int(has_delta),
                 has_bss=int(has_bss), rank_slot=-1, dense_slot=-1)
        f["dense_start"] = _check(t["dense_start"], torch.int64,
                                  (npg + 1,), "dense_start")
        f["plain_byte"] = _check(t["plain_byte"], torch.int64, (npg,),
                                 "plain_byte")
        f["pg_enc"] = _check(t["pg_enc"], torch.int32, (npg,), "pg_enc")
        if has_delta:
            f["pg_first"] = _check(t["pg_first"], torch.int64, (npg,),
                                   "pg_first")
        for name, count in (("dl", ndl), ("vr", nvr), ("dr", ndr)):
            for sub, arr, dt in zip(("os", "pk", "va", "bs", "wd"),
                                    t[name] or (), _RUN_DTYPES):
                f[f"{name}_{sub}"] = _check(arr, dt, (count,),
                                            f"{name}.{sub}")
        if kind == "bool" and not nvr:
            raise KR.KernelError("decodeFused: boolean column without "
                                 "value runs")
        if has_slen:
            f["slen"] = _check(t["slen"], torch.int32, (cap,), "slen")
        if dict_shapes:
            rows = dict_shapes[0][0][0]
            d0, d1 = _DICT_DTYPES.get(kind, (torch.int64, None))
            shape0 = (rows, char_cap) if kind == "str" else (rows,)
            f["dict0"] = _check(t["dicts"][0], d0, shape0, "dict")
            if d1 is not None:
                f["dict1"] = _check(t["dicts"][1], d1, (rows,), "dict")
            f["dict_rows"] = rows
        if ndl:
            f["rank_slot"] = n_slots
            n_slots += 1
        if (kind == "str" and has_slen) or has_delta:
            f["dense_slot"] = n_slots
            n_slots += 1
        if kind == "str":
            if char_cap % 8:
                raise KR.KernelError(f"decodeFused: char_cap {char_cap} "
                                     "is not a multiple of 8")
            col = [torch.empty((cap, char_cap), dtype=torch.uint8,
                               device=device),
                   torch.empty(cap, dtype=torch.int32, device=device)]
        elif kind == "dec128":
            col = [torch.empty(cap, dtype=torch.int64, device=device),
                   torch.empty(cap, dtype=torch.int64, device=device)]
        else:
            dt = _out_dtype(kind, np_dt)
            col = [torch.empty(cap, dtype=dt, device=device)]
            f["out_bytes"] = col[0].element_size()
            f["sext32"] = int(kind == "int" and np_dt == "int64"
                              and elem_bytes == 4)
        col.append(torch.empty(cap, dtype=torch.bool, device=device))
        for k, out in zip(("out0", "out1", "out2"), col):
            f[k] = out.data_ptr()
        outs.extend(col)
        descs.append([f[k] for k in FIELDS])
    if not descs:
        raise KR.KernelError("decodeFused: no device-decoded column")
    # pinned, so the descriptor copy stays asynchronous on the stream
    desc = torch.tensor(descs, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)
    nblk = (cap + SCAN_BLOCK - 1) // SCAN_BLOCK
    part = torch.empty((n_slots, cap), dtype=torch.int64, device=device)
    bsum = torch.empty((n_slots, nblk), dtype=torch.int64, device=device)
    active = torch.empty(cap, dtype=torch.bool, device=device)
    fn = KR.library("decode_fused").decode_fused_launch
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, cl, vp, ci, cl, cl, ci, vp, vp, vp, ci, vp]
    fn.restype = ci
    t0 = KR.dispatch_start()
    KR.count_launch("decodeFused")
    # the launch goes to the calling thread's current device: make
    # it the tensors' (a card other than 0 on a mesh)
    with KR.on_device(device):
        KR.check(fn(words.data_ptr(), words.numel() * 4, desc.data_ptr(),
                    len(descs), n, cap, n_slots,
                    part.data_ptr() if n_slots else None,
                    bsum.data_ptr() if n_slots else None, active.data_ptr(),
                    rows_per_thread, KR.stream_handle(device)),
                 "decodeFused launch")
    if t0 is not None:
        KR.dispatch_end(t0, "decodeFused", chip=device.index, bucket=cap,
                        tuned=tuned)
    return active, tuple(outs)


def _tensors_of(t: dict) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for v in t.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, list):
            out.extend(v)
    return out
