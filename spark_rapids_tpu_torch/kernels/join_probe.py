"""Join build + probe through a hash table (CUDA, ``csrc/join_probe.cu``).

Replaces ``spark_rapids_tpu/kernels/join_probe.py`` ``build_probe``. When
the build side is small (broadcast dimension tables, the star-schema /
FK shape) one build pass inserts the right side's keys, keeping the
smallest row per key, and one probe pass resolves every left row. That
covers the two join forms whose results need no pair expansion:

- semi/anti masks: ``matched`` per left row is the whole answer;
- the FK fast path (build keys certified unique by
  ``ops.join.build_key_max_multiplicity``): ``(matched, first_row)`` is
  the gather map, with no count pass and no sizing sync.

The table has at least ``probe_table_slots(cap_r)`` slots (load factor
<= 0.5), so every probe walk ends at an empty slot: overflow cannot
happen. The kernel is one launch: each block builds its own copy of the
table in shared memory (the build validity and key words where they fit,
and int32 owners, up to 4 slots a build row and at most ``MAX_SLOTS``),
hashing the key words itself, then probes its share of the stream rows.
Bound on the H100: bytes (both key-word matrices and validity read once,
5 bytes written per left row).

On CPU tensors ``build_probe`` runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from spark_rapids_tpu_torch import kernels as KR


MAX_SLOTS = 32768  # 128 KB of int32 owners in one block's shared memory


def probe_table_slots(cap_r: int) -> int:
    """Power-of-two table capacity >= max(64, 2 * build capacity)."""
    t = 64
    while t < 2 * cap_r:
        t <<= 1
    return t


def build_probe_plain(kw_r: torch.Tensor, valid_r: torch.Tensor,
                      kw_l: torch.Tensor, valid_l: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one ``unique`` over the valid build keys and
    every stream key gives each key an id; the smallest build row per id
    is its first row."""
    rows_r = torch.nonzero(valid_r).flatten()
    n_r = int(rows_r.shape[0])
    cap_l = kw_l.shape[0]
    both = torch.cat([kw_r[rows_r], kw_l])
    _u, ids = torch.unique(both, dim=0, return_inverse=True)
    none = kw_r.shape[0]  # past every build row: "no build row"
    first = torch.full((int(_u.shape[0]),), none, dtype=torch.int64,
                       device=kw_l.device)
    first = first.scatter_reduce(0, ids[:n_r], rows_r, reduce="amin")
    first_l = first[ids[n_r:n_r + cap_l]]
    matched = valid_l & (first_l < none)
    first_row = torch.where(matched, first_l, 0).to(torch.int32)
    return matched, first_row


def build_probe(kw_r: torch.Tensor, valid_r: torch.Tensor,
                kw_l: torch.Tensor, valid_l: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(matched, first_row)`` per LEFT row: ``matched`` only for valid
    left rows whose key words equal those of a valid right row;
    ``first_row`` is the smallest such right row (0 where unmatched).
    ``kw_*`` are ``(cap, K)`` int64 word matrices in one layout on both
    sides (string char caps padded alike); the kernel hashes them."""
    if not kw_l.is_cuda:
        # the plain version's call takes the kernel's span on the CPU
        t0 = KR.dispatch_start()
        out = build_probe_plain(kw_r, valid_r, kw_l, valid_l)
        if t0 is not None:
            KR.dispatch_end(t0, "joinProbe")
        return out
    KR.require_cuda([kw_r, valid_r, kw_l, valid_l], "joinProbe")
    n_r, K = kw_r.shape
    n_l = kw_l.shape[0]
    if kw_l.shape[1] != K:
        raise KR.KernelError(f"joinProbe: {K} build key words, "
                             f"{kw_l.shape[1]} stream key words")
    for t, what in ((kw_r, "kw_r"), (kw_l, "kw_l")):
        if t.dtype != torch.int64:
            raise KR.KernelError(f"joinProbe: {what} must be int64")
    if valid_r.dtype != torch.bool or valid_l.dtype != torch.bool:
        raise KR.KernelError("joinProbe: validity must be bool")
    if valid_r.shape[0] != n_r or valid_l.shape[0] != n_l:
        raise KR.KernelError("joinProbe: row counts differ")
    if K == 0 or n_l >= (1 << 30):
        raise KR.KernelError("joinProbe: no key words, or too many rows")
    slots = probe_table_slots(n_r)
    if slots > MAX_SLOTS:
        raise KR.KernelError(f"joinProbe: {n_r} build rows need {slots} "
                             f"slots, over the {MAX_SLOTS} one block holds")
    fn = KR.library("join_probe").join_probe_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, vp, vp, ci, ci, ci, vp, vp, vp]
    fn.restype = ci
    device = kw_l.device
    matched = torch.empty(n_l, dtype=torch.bool, device=device)
    first_row = torch.empty(n_l, dtype=torch.int32, device=device)
    t0 = KR.dispatch_start()
    KR.count_launch("joinProbe")
    # the launch goes to the calling thread's current device: make
    # it the tensors' (a card other than 0 on a mesh)
    with KR.on_device(device):
        KR.check(fn(kw_r.data_ptr(), valid_r.data_ptr(), n_r,
                    kw_l.data_ptr(), valid_l.data_ptr(), n_l, K, slots,
                    matched.data_ptr(), first_row.data_ptr(),
                    KR.stream_handle(device)),
                 "joinProbe launch")
    if t0 is not None:
        KR.dispatch_end(t0, "joinProbe", chip=device.index)
    return matched, first_row
