"""Host -> device upload (the counterpart of
``spark_rapids_tpu.columnar.transfer``).

``prepare_upload`` stages a batch on the host in one of three modes, each
byte for byte the JAX package's staging:

- ``packed``, a HostBatch of at least ``PACKED_MIN_ROWS`` rows
  (``pack_batch``): integer columns narrowed to the smallest type that
  holds their range, each a buffer of its own; booleans and validity
  masks bit-packed into one int32 word buffer (an all-valid mask is not
  shipped); strings as a char matrix in the words with narrowed lengths,
  or, where the column carries Arrow ``varbytes``, the compact bytes
  padded to a bucket; float64 as it is; decimal128 limbs narrowed. Only
  the real rows ship. ``decode_packed`` widens, unpacks, rebuilds the
  char matrix of ``varbytes`` columns and pads to capacity on the device
  (PyTorch ops: the JAX package's XLA decode program, not a Pallas
  kernel);
- ``direct``, a smaller batch or one with nested columns
  (``_stage_direct``): every device array at full capacity, an array
  column's element pool at the bucket of its element count;
- ``encoded``, a Parquet row group (``prepare_encoded_upload``): the
  still-encoded page words and plan tables, decoded on the device by the
  ``decodeFused`` kernel.

Every mode's arrays are laid out in one host buffer, each at a 64-byte
aligned offset (``wire_layout``, ``write_wires``), copied to the device
in one copy and viewed there in their own dtypes and shapes
(``decode_staged``). The row-to-columnar transition's upload ring writes
that buffer straight into a pinned slot of a ``StagingRing`` and copies
it on the ring's copy stream; ``upload_batch`` uses pageable memory and
the current stream.

Why the packed codec on PCIe, where a copy's fixed cost is small: the
upload is host-bound, not copy-bound. ``chip_smoke.py``'s
``upload_split`` over q1's 8 partitions of 750,152 rows (NVIDIA H100
80GB HBM3 at 700 W) staged 168 MB; the copies took 0.029 s from pageable
and 0.0053 s from pinned memory, and the decode on the card 0.013 s,
against 0.54 s of string encoding. The JAX package's string route
(``_ascii_codepoints``, ``astype(np.str_)``) took 2.09 s on the same
columns, so ASCII columns go through one NUL-separated join
(``_ascii_join``), which gives the same bytes; the code-point route and
a row-by-row encoding stay for the columns the join cannot take.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Iterator, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.sql import types as T

# below this row count a batch stages directly at capacity
PACKED_MIN_ROWS = 1 << 16
# byte alignment of every buffer inside the one staging buffer: a device
# view in any dtype, and a kernel's 16-byte loads, need aligned offsets
_ALIGN = 64


def _narrow_kind(mn: int, mx: int) -> str:
    if -128 <= mn and mx <= 127:
        return "i8"
    if -32768 <= mn and mx <= 32767:
        return "i16"
    if -(1 << 31) <= mn and mx <= (1 << 31) - 1:
        return "i32"
    return "i64"


_KIND_WIDTH = {"i8": 1, "i16": 2, "i32": 4, "i64": 8}
_KIND_NP = {"i8": np.int8, "i16": np.int16, "i32": np.int32,
            "i64": np.int64}


class _Packer:
    """Accumulates 4-byte-aligned byte regions into one staging buffer."""

    def __init__(self):
        self.parts: List[np.ndarray] = []
        self.off = 0

    def add(self, arr: np.ndarray) -> int:
        b = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
        start = self.off
        self.parts.append(b)
        self.off += b.nbytes
        pad = (-self.off) % 4
        if pad:
            self.parts.append(np.zeros(pad, np.uint8))
            self.off += pad
        return start

    def words(self) -> np.ndarray:
        if not self.parts:
            return np.zeros(1, dtype=np.int32)
        return np.concatenate(self.parts).view(np.int32)


# -- string encoding ---------------------------------------------------------

def _ascii_join(data: np.ndarray, validity: np.ndarray, n: int
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """An all-``str`` ASCII column without NUL characters, encoded
    through one NUL-separated ``join``: the separators give each row's
    length, and the bytes land in the char matrix as one strided copy
    (rows of one width) or under the mask of each row's length. Returns
    None for any other column. Gives exactly ``_ascii_codepoints``'
    bytes (char_cap from every row's length, nulls zeroed after)."""
    from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
    try:
        s = "\x00".join(data)
    except TypeError:
        return None
    if not s.isascii():
        return None
    b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    sep = np.flatnonzero(b == 0)
    # a NUL inside a string: the code-point route drops trailing NULs
    # (numpy's U dtype), so such columns go there to keep its bytes
    if len(sep) != n - 1:
        return None
    starts = np.concatenate(([0], sep + 1))
    lengths = (np.append(sep, len(b)) - starts).astype(np.int32)
    char_cap = bucket_char_cap(int(lengths.max(initial=1)))
    chars = np.zeros((n, char_cap), np.uint8)
    width = int(lengths[0])
    if (lengths == width).all():
        if width:
            chars[:, :width] = np.lib.stride_tricks.as_strided(
                b, (n, width), (width + 1, 1))
    else:
        chars[np.arange(char_cap) < lengths[:, None]] = b[b != 0]
    lengths = np.where(validity, lengths, 0)
    chars[~validity] = 0
    return chars, lengths


def _ascii_codepoints(data: np.ndarray, validity: np.ndarray, n: int
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The JAX package's vectorised route: code points through a U-dtype
    view, for a column whose ``astype(np.str_)`` is pure ASCII; None for
    any other column."""
    from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
    try:
        u = data.astype(np.str_)
    except (TypeError, ValueError):
        return None
    if u.dtype.itemsize == 0:
        return np.zeros((n, 8), np.uint8), np.zeros(n, np.int32)
    k = u.dtype.itemsize // 4
    u32 = np.ascontiguousarray(u).view(np.uint32).reshape(n, k)
    if not (u32 < 128).all():
        return None
    # pure ASCII: UTF-32 code points are the bytes
    lengths = np.char.str_len(u).astype(np.int32)
    char_cap = bucket_char_cap(int(lengths.max(initial=1)))
    chars = np.zeros((n, char_cap), np.uint8)
    w = min(k, char_cap)
    chars[:, :w] = u32[:, :w].astype(np.uint8)
    lengths = np.where(validity, lengths, 0)
    chars[~validity] = 0
    return chars, lengths


def _chars_from_varbytes(varbytes, validity: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """A column's compact UTF-8 bytes and raw lengths (``varbytes``) ->
    the padded char matrix and lengths that ``_encode_strings`` makes of
    the same strings: the width from the valid rows' longest, null rows
    zeroed. One masked scatter, no per-string work."""
    from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
    bts, raw = varbytes
    raw = raw.astype(np.int64)
    lengths = np.where(validity, raw, 0).astype(np.int32)
    char_cap = bucket_char_cap(int(lengths.max(initial=1)))
    if (raw[~validity] > 0).any():  # a null slot that owns bytes
        bts = bts[:int(raw.sum())][np.repeat(validity, raw)]
    chars = np.zeros((len(raw), char_cap), np.uint8)
    # row-major order of the mask is the order of the bytes
    chars[np.arange(char_cap) < lengths[:, None]] = \
        bts[:int(lengths.sum())]
    return chars, lengths


def _encode_strings(data: np.ndarray, validity: np.ndarray, n: int,
                    is_binary: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str/bytes -> (uint8[n, char_cap], int32 lengths),
    the JAX package's ``_encode_strings`` byte for byte. ASCII string
    columns take ``_ascii_join``, then ``_ascii_codepoints``; anything
    else is encoded row by row."""
    from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
    if n == 0:
        return np.zeros((0, 8), np.uint8), np.zeros(0, np.int32)
    if not is_binary:
        out = _ascii_join(data, validity, n)
        if out is None:
            out = _ascii_codepoints(data, validity, n)
        if out is not None:
            return out
    encoded: List[bytes] = []
    max_len = 1
    for i in range(n):
        if validity[i]:
            v = data[i]
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        else:
            b = b""
        encoded.append(b)
        max_len = max(max_len, len(b))
    char_cap = bucket_char_cap(max_len)
    chars = np.zeros((n, char_cap), np.uint8)
    lengths = np.zeros(n, np.int32)
    for i, b in enumerate(encoded):
        chars[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        lengths[i] = len(b)
    return chars, lengths


# -- buffers on the wire -----------------------------------------------------

class Wire(NamedTuple):
    """One buffer of a staged batch: its dtype and shape on the wire, and
    how to write it into a typed view of its bytes."""

    dtype: np.dtype
    shape: Tuple[int, ...]
    write: Callable[[np.ndarray], None]

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize


def _wire(a: np.ndarray) -> Wire:
    a = np.asarray(a)
    return Wire(a.dtype, a.shape, lambda out: np.copyto(out, a))


def _wire_cast(a: np.ndarray, dtype) -> Wire:
    """``a.astype(dtype)`` written straight into its place: one copy."""
    return Wire(np.dtype(dtype), a.shape,
                lambda out: np.copyto(out, a, casting="unsafe"))


def _wire_words(pk: _Packer) -> Wire:
    """The packer's regions written one after another: ``pk.words()``
    without the concatenation."""
    def write(out: np.ndarray) -> None:
        b = out.view(np.uint8)
        if not pk.parts:
            b[:] = 0
            return
        off = 0
        for p in pk.parts:
            b[off:off + p.nbytes] = p
            off += p.nbytes
    return Wire(np.dtype(np.int32), (max(1, pk.off // 4),), write)


def wire_layout(staged) -> Tuple[List[Wire], List[int], int]:
    """A staged token's buffers, their byte offsets in the one staging
    buffer, and its size."""
    if staged[0] == "encoded":
        words, extras = staged[4], staged[5]
        wires = [_wire(words)] + [_wire(np.ascontiguousarray(e))
                                  for e in extras]
    else:
        wires = staged[4]
    offsets, off = [], 0
    for w in wires:
        offsets.append(off)
        off += -(-w.nbytes // _ALIGN) * _ALIGN
    return wires, offsets, max(off, _ALIGN)


def write_wires(wires: Sequence[Wire], offsets: Sequence[int],
                out: np.ndarray) -> List[np.ndarray]:
    """Write every buffer into ``out`` (uint8) at its offset; returns the
    typed views."""
    views = []
    for w, off in zip(wires, offsets):
        v = out[off:off + w.nbytes].view(w.dtype).reshape(w.shape)
        w.write(v)
        views.append(v)
    return views


def _materialize(w: Wire) -> np.ndarray:
    out = np.empty(w.shape, w.dtype)
    w.write(out)
    return out


# -- packed staging ------------------------------------------------------------

def _pack(batch) -> Tuple[_Packer, List[Wire], Tuple]:
    """The packed staging of a HostBatch: the word packer, the extra
    buffers and the layout descriptor (the JAX package's ``pack_batch``,
    with each extra written where it lands instead of cast first)."""
    from spark_rapids_tpu_torch.columnar.device import (column_arity,
                                                        is_string_like)
    n = batch.num_rows
    pk = _Packer()
    extras: List[Wire] = []
    layout: List[Tuple] = []
    for f, c in zip(batch.schema.fields, batch.columns):
        dt = f.data_type
        column_arity(dt)  # raises for types the port does not carry
        validity = np.ascontiguousarray(c.validity[:n])
        if validity.all():
            vdesc: Tuple = ("av",)
        else:
            vdesc = ("vb", pk.add(np.packbits(validity, bitorder="little")))
        if is_string_like(dt):
            vb = c.varbytes
            if vb is not None and len(vb[1]) == n and len(vb[0]) > 0:
                # compact Arrow bytes, padded to a bucket so that the
                # layout repeats across batches; the device rebuilds
                # the char matrix
                from spark_rapids_tpu_torch.columnar.device import (
                    bucket_capacity, bucket_char_cap)
                bts, raw_lengths = vb
                masked_max = int(raw_lengths[validity].max()) \
                    if validity.any() else 1
                char_cap = bucket_char_cap(max(1, masked_max))
                nb = bucket_capacity(len(bts))
                if nb > len(bts):
                    bts = np.concatenate(
                        [bts, np.zeros(nb - len(bts), np.uint8)])
                c_off = pk.add(bts)
                raw_max = int(raw_lengths.max(initial=0))
                lk = ("i8" if raw_max <= 127 else
                      "i16" if raw_max <= 32767 else "i32")
                l_idx = len(extras)
                extras.append(_wire_cast(raw_lengths, _KIND_NP[lk]))
                layout.append(("vstr", char_cap, c_off, nb, lk, l_idx,
                               vdesc))
                continue
            chars, lengths = _encode_strings(
                c.data, validity, n, isinstance(dt, T.BinaryType))
            char_cap = chars.shape[1] if n else 8
            c_off = pk.add(chars)
            lk = ("i8" if char_cap <= 127 else
                  "i16" if char_cap <= 32767 else "i32")
            l_idx = len(extras)
            extras.append(_wire_cast(lengths, _KIND_NP[lk]))
            layout.append(("str", char_cap, c_off, lk, l_idx, vdesc))
            continue
        if T.is_limb_decimal(dt):
            limbs = c.data[:n]
            if not validity.all():
                limbs = limbs.copy()
                limbs[~validity] = 0
            ent: List[Any] = ["dec128"]
            for li in range(2):  # hi then lo, each narrowed like an int
                ld = limbs[:, li]
                mn, mx = (int(ld.min()), int(ld.max())) if n else (0, 0)
                ent.append(len(extras))
                extras.append(_wire_cast(ld, _KIND_NP[_narrow_kind(mn,
                                                                   mx)]))
            ent.append(vdesc)
            layout.append(tuple(ent))
            continue
        np_dt = T.numpy_dtype(dt)
        data = np.ascontiguousarray(c.data[:n])
        if not validity.all():
            # normalised zeros at null slots (narrowing and determinism)
            data = data.copy()
            data[~validity] = (False if np_dt == np.dtype(bool) else
                               np_dt.type(0))
        if np_dt == np.dtype(bool):
            layout.append(("bool", pk.add(np.packbits(
                data.astype(bool), bitorder="little")), vdesc))
        elif np_dt == np.dtype(np.float64):
            layout.append(("f64", len(extras), vdesc))
            extras.append(_wire(np.asarray(data, np.float64)))
        elif np_dt == np.dtype(np.float32):
            layout.append(("f32", pk.add(np.asarray(data, np.float32)),
                           vdesc))
        else:
            mn, mx = (int(data.min()), int(data.max())) if n else (0, 0)
            kind = _narrow_kind(mn, mx)
            # never widen on the wire (int8 storage stays int8)
            kind = kind if _KIND_WIDTH[kind] <= np_dt.itemsize else \
                {1: "i8", 2: "i16", 4: "i32", 8: "i64"}[np_dt.itemsize]
            layout.append(("int", str(np_dt), len(extras), vdesc))
            extras.append(_wire_cast(data, _KIND_NP[kind]))
    return pk, extras, tuple(layout)


def pack_batch(batch) -> Tuple[np.ndarray, List[np.ndarray], Tuple]:
    """Stage a HostBatch: ``(int32 staging words, extra buffers, layout
    descriptor)``, the JAX package's ``pack_batch`` byte for byte."""
    pk, extras, layout = _pack(batch)
    return pk.words(), [_materialize(w) for w in extras], layout


def decode_packed(layout: Tuple, n: int, cap: int, words: torch.Tensor,
                  extras: Sequence[torch.Tensor]):
    """Packed staging -> ``(active, outs)``, each column's arrays at
    capacity ``cap`` on the tensors' device, in ``flatten_columns`` order
    (the JAX package's ``_build_decode`` program as PyTorch ops)."""
    dev = words.device
    bytes_all = words.view(torch.uint8)  # little-endian, as on the host
    lanes = torch.arange(8, dtype=torch.int32, device=dev)

    def bits(off: int, count: int) -> torch.Tensor:
        b = bytes_all[off:off + (count + 7) // 8].to(torch.int32)
        return ((b[:, None] >> lanes) & 1).reshape(-1)[:count].bool()

    def pad(x: torch.Tensor) -> torch.Tensor:
        if cap == n:
            return x
        out = x.new_zeros((cap,) + tuple(x.shape[1:]))
        out[:n] = x
        return out

    active = torch.arange(cap, device=dev) < n
    outs: List[torch.Tensor] = []
    for ent in layout:
        vdesc = ent[-1]
        validity = active if vdesc[0] == "av" else pad(bits(vdesc[1], n))
        kind = ent[0]
        if kind == "vstr":
            # compact bytes -> (cap, char_cap): starts are the cumsum of
            # the raw lengths, each row gathers its window, nulls and
            # tails mask to 0
            _, char_cap, c_off, nbytes, _lk, l_idx, _v = ent
            raw_len = extras[l_idx].to(torch.int64)
            starts = torch.cumsum(raw_len, 0) - raw_len
            src = bytes_all[c_off:c_off + max(1, nbytes)]
            cols = torch.arange(char_cap, device=dev)
            idx = (starts[:, None] + cols).clamp(0, max(0, nbytes - 1))
            out_len = torch.where(validity[:n], raw_len, 0)
            chars = torch.where(cols < out_len[:, None], src[idx], 0) \
                .to(torch.uint8)
            outs += [pad(chars), pad(out_len.to(torch.int32)), validity]
        elif kind == "str":
            _, char_cap, c_off, _lk, l_idx, _v = ent
            chars = bytes_all[c_off:c_off + n * char_cap].reshape(
                n, char_cap)
            outs += [pad(chars), pad(extras[l_idx].to(torch.int32)),
                     validity]
        elif kind == "dec128":
            _, i_hi, i_lo, _v = ent
            outs += [pad(extras[i_hi].to(torch.int64)),
                     pad(extras[i_lo].to(torch.int64)), validity]
        elif kind == "bool":
            outs += [pad(bits(ent[1], n)), validity]
        elif kind == "f64":
            outs += [pad(extras[ent[1]]), validity]
        elif kind == "f32":
            w = ent[1] // 4
            outs += [pad(words[w:w + n].view(torch.float32)), validity]
        else:  # "int": its own narrowed buffer, widened elementwise
            _, np_dt, idx, _v = ent
            outs += [pad(extras[idx].to(getattr(torch, np_dt))), validity]
    return active, tuple(outs)


def _stage_direct(batch, cap: int):
    """Full-capacity staging of a small batch: every device array, then
    the active mask."""
    n = batch.num_rows
    arrays: List[np.ndarray] = []
    spec: List[Tuple[T.DataType, int]] = []
    for f, c in zip(batch.schema.fields, batch.columns):
        parts = _stage_column(c, f.data_type, cap)
        spec.append((f.data_type, len(parts)))
        arrays.extend(parts)
    active = np.zeros(cap, dtype=bool)
    active[:n] = True
    arrays.append(active)
    return ("direct", batch.schema, n, cap, [_wire(a) for a in arrays],
            tuple(spec))


def prepare_upload(batch, cap: int, conf=None, device=None):
    """Host half of an upload: the staged token of a HostBatch
    (``packed`` or ``direct``) or of an EncodedBatch (``encoded``). With
    a ``conf``, an encoded token carries a ninth item, the autotuner's
    ``(params, tuned)`` for decodeFused at this capacity on ``device``,
    resolved here, on the staging thread, so the decode itself never
    reads a conf (a first lookup at a new bucket may sweep the kernel on
    ``device``)."""
    from spark_rapids_tpu_torch.io.device_decode import EncodedBatch
    if isinstance(batch, EncodedBatch):
        staged = prepare_encoded_upload(batch, cap)
        if conf is None:
            return staged
        from spark_rapids_tpu_torch.kernels import autotune as AT
        return staged + (AT.params_for(conf, "decodeFused", cap,
                                       device=device),)
    n = batch.num_rows
    # nested columns stage directly, as in the JAX package: the packed
    # codec has no layout for them
    if n < PACKED_MIN_ROWS or any(
            isinstance(f.data_type, (T.ArrayType, T.StructType))
            for f in batch.schema.fields):
        return _stage_direct(batch, cap)
    pk, extras, layout = _pack(batch)
    return ("packed", batch.schema, n, cap, [_wire_words(pk)] + extras,
            layout)


def decode_staged(staged, dev: torch.Tensor, offsets: Sequence[int]):
    """A staged token's buffer, now on the device as ``dev`` (uint8) ->
    DeviceBatch: the packed decode, the ``decodeFused`` kernel, or the
    direct arrays as they are."""
    from spark_rapids_tpu_torch.columnar import device as D
    wires = wire_layout(staged)[0]
    views = [dev[off:off + w.nbytes].view(D._NP_TO_TORCH[w.dtype])
             .reshape(w.shape) for w, off in zip(wires, offsets)]
    mode, schema, n, cap = staged[:4]
    if mode == "direct":
        return D.DeviceBatch(schema, D.rebuild_columns(staged[5],
                                                       views[:-1]),
                             views[-1], n)
    if mode == "encoded":
        from spark_rapids_tpu_torch.kernels import decode_fused as DF
        layout, spec = staged[6], staged[7]
        params, tuned = staged[8] if len(staged) > 8 else ({}, False)
        active, outs = DF.decode_fused(
            layout, cap, n, views[0], views[1:],
            rows_per_thread=int(params.get("rowsPerThread", 0)),
            tuned=tuned)
        return D.DeviceBatch(schema, D.rebuild_columns(list(spec), outs),
                             active, n)
    active, outs = decode_packed(staged[5], n, cap, views[0], views[1:])
    spec = [(f.data_type, D.column_arity(f.data_type))
            for f in schema.fields]
    return D.DeviceBatch(schema, D.rebuild_columns(spec, outs), active, n)


def finish_upload(staged, device: torch.device):
    """Synchronous device half of an upload: the staged buffers written
    into one pageable buffer, one copy on the current stream, then the
    decode."""
    from spark_rapids_tpu_torch import trace as _trace
    with _trace.span("finishUpload", mode=staged[0],
                     chip=device.index):
        wires, offsets, total = wire_layout(staged)
        host = torch.empty(total, dtype=torch.uint8)
        write_wires(wires, offsets, host.numpy())
        return decode_staged(staged, host.to(device), offsets)


def upload_batch(batch, cap: int, device: torch.device):
    """HostBatch -> DeviceBatch at capacity ``cap`` on ``device``."""
    if cap < batch.num_rows:
        raise ValueError(f"capacity {cap} < {batch.num_rows} rows")
    return finish_upload(prepare_upload(batch, cap), device)


# -- the upload ring's staging slots and copy stream -------------------------

class _Slot:
    def __init__(self):
        self.buf: Optional[torch.Tensor] = None  # uint8 host buffer
        self.event = None  # the copy that last read it


class Placed(NamedTuple):
    """A staged batch written into a ring slot, ready to copy."""

    staged: tuple
    slot: _Slot
    offsets: List[int]
    nbytes: int


class Started(NamedTuple):
    """A staged batch whose copy to the device has been issued."""

    staged: tuple
    dev: torch.Tensor
    event: Any  # torch.cuda.Event on the copy stream; None on the CPU
    offsets: List[int]


class StagingRing:
    """Host staging slots and a copy stream for one partition's uploads.

    On a CUDA device each slot is a pinned buffer, sized by the
    ``bucket_capacity`` of the bytes it must hold; each copy runs on the
    ring's own stream and ends in an event. A slot is refilled only after
    that event has completed: refilling it while the DMA still reads it
    would change the rows on the card. ``place`` runs on the producer
    thread, ``start`` on the task thread. On the CPU the same ring runs
    with pageable slots, and the copy is a ``clone``.
    """

    def __init__(self, device: torch.device, n_slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._free = deque(_Slot() for _ in range(n_slots))
        self._cv = threading.Condition()

    def place(self, staged) -> Placed:
        """Write a staged batch's buffers into a free slot, waiting for
        the slot's previous copy first."""
        from spark_rapids_tpu_torch.columnar.device import bucket_capacity
        wires, offsets, total = wire_layout(staged)
        with self._cv:
            while not self._free:
                self._cv.wait()
            slot = next((s for s in self._free
                         if s.buf is not None and s.buf.numel() >= total),
                        self._free[0])
            self._free.remove(slot)
        if slot.event is not None:
            slot.event.synchronize()
            slot.event = None
        if slot.buf is None or slot.buf.numel() < total:
            slot.buf = torch.empty(bucket_capacity(total),
                                   dtype=torch.uint8, pin_memory=self.cuda)
        write_wires(wires, offsets, slot.buf[:total].numpy())
        return Placed(staged, slot, offsets, total)

    def release(self, placed: Placed) -> None:
        """Hand back a placed unit's slot without copying it (an upload
        that gave up on the device and degrades from its source)."""
        with self._cv:
            self._free.append(placed.slot)
            self._cv.notify()

    def start(self, placed: Placed) -> Started:
        """Issue the slot's copy to the device and hand the slot back,
        tagged with the copy's event. If the device buffer cannot be
        allocated, the error propagates and the slot stays the caller's
        (to retry, or to ``release``)."""
        host = placed.slot.buf[:placed.nbytes]
        event = None
        if self.cuda:
            with torch.cuda.stream(self.stream):
                dev = torch.empty(placed.nbytes, dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.stream)
        else:
            dev = host.clone()
        with self._cv:
            placed.slot.event = event
            self._free.append(placed.slot)
            self._cv.notify()
        return Started(placed.staged, dev, event, placed.offsets)


def finish_started(started: Started):
    """Decode a started upload on the current stream, after its copy: the
    stream waits for the copy's event, and the device buffer, made on the
    copy stream, is recorded as used by this stream so that the caching
    allocator does not hand it out again before the decode has read
    it."""
    if started.event is not None:
        cur = torch.cuda.current_stream(started.dev.device)
        cur.wait_event(started.event)
        started.dev.record_stream(cur)
    return decode_staged(started.staged, started.dev, started.offsets)



def _col_from_storage_values(vals, dt: T.DataType):
    """Storage-form python values (None = null) -> HostColumn, without
    the from_pylist value conversion (dates/decimals already sit in
    storage ints inside struct tuples)."""
    from spark_rapids_tpu_torch.columnar.host import HostColumn
    n = len(vals)
    validity = np.array([v is not None for v in vals], dtype=bool)
    if T.is_limb_decimal(dt):
        from spark_rapids_tpu_torch.ops import int128 as I
        hi, lo = I.from_pyints([0 if v is None else int(v) for v in vals])
        return HostColumn(dt, np.stack([hi, lo], axis=1), validity)
    np_dt = T.numpy_dtype(dt)
    if np_dt == np.dtype(object):
        data = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            data[i] = v if v is not None else ""
        return HostColumn(dt, data, validity)
    fill = False if np_dt == np.dtype(bool) else np_dt.type(0)
    data = np.array([fill if v is None else v for v in vals],
                    dtype=np_dt)
    return HostColumn(dt, data, validity)


def _stage_column(c, dt: T.DataType, cap: int) -> List[np.ndarray]:
    """Full-width staging arrays of one host column, in its device
    column's ``arrays()`` order: the JAX package's ``_stage_column``
    byte for byte. An array column stages from its compact form
    (``host.array_elements``: lengths and the element column, in numpy)
    where the JAX package loops over rows: starts are the running sum
    of the lengths (0 at a null row), and the element pool stages at the
    bucket of the element count."""
    from spark_rapids_tpu_torch.columnar import device as D
    from spark_rapids_tpu_torch.columnar import host as H
    D.column_arity(dt)  # raises for map columns
    n = len(c)
    validity = np.zeros(cap, dtype=bool)
    validity[:n] = c.validity
    if isinstance(dt, T.ArrayType):
        lens, child = H.array_elements(c)
        lens = lens.astype(np.int64)
        total = int(lens.sum())
        starts = np.zeros(cap, dtype=np.int32)
        starts[:n] = np.where(c.validity, np.cumsum(lens) - lens, 0)
        lengths = np.zeros(cap, dtype=np.int32)
        lengths[:n] = lens
        return [starts, lengths] + _stage_column(
            child, dt.element_type, D.bucket_capacity(max(1, total))) + \
            [validity]
    if isinstance(dt, T.StructType):
        parts: List[np.ndarray] = []
        for fi, f in enumerate(dt.fields):
            # field values are storage-form already (struct tuples hold
            # storage ints)
            parts.extend(_stage_column(
                _col_from_storage_values(
                    H.struct_field_values(c, fi)[:n], f.data_type),
                f.data_type, cap))
        return parts + [validity]
    if D.is_string_like(dt):
        if c.varbytes is not None and n and len(c.varbytes[1]) == n:
            ch, ln = _chars_from_varbytes(c.varbytes, c.validity)
        else:
            ch, ln = _encode_strings(c.data, c.validity, n,
                                     isinstance(dt, T.BinaryType))
        char_cap = ch.shape[1] if n else 8
        chars = np.zeros((cap, char_cap), dtype=np.uint8)
        chars[:n] = ch
        lengths = np.zeros(cap, dtype=np.int32)
        lengths[:n] = ln
        return [chars, lengths, validity]
    if T.is_limb_decimal(dt):
        limbs = np.zeros((cap, 2), dtype=np.int64)
        limbs[:n] = c.normalized().data
        return [np.ascontiguousarray(limbs[:, 0]),
                np.ascontiguousarray(limbs[:, 1]), validity]
    data = np.zeros(cap, dtype=T.numpy_dtype(dt))
    data[:n] = c.normalized().data
    return [data, validity]


# -- Parquet pages decoded on the device (EncodedBatch path) ----------------

def _pad_pow2(n: int, floor: int = 8) -> int:
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def prepare_encoded_upload(enc, cap: int):
    """EncodedBatch -> staged token ``("encoded", schema, n, cap, words,
    extras, layout, spec)``: plan tables padded to power-of-two lengths,
    the page words to a capacity bucket, host-decoded columns staged at
    full width. ``words``, ``extras`` and ``layout`` equal the JAX
    package's ``prepare_encoded_upload`` byte for byte."""
    from spark_rapids_tpu_torch.columnar.device import bucket_capacity
    n = enc.num_rows
    extras: List[np.ndarray] = []
    layout: List[Tuple] = []
    spec: List[Tuple[T.DataType, int]] = []
    for fi, f in enumerate(enc.schema.fields):
        dt = f.data_type
        plan = enc.plans.get(fi)
        if plan is None:
            parts = _stage_column(enc.host_cols[fi], dt, cap)
            layout.append(("host", len(parts)))
            spec.append((dt, len(parts)))
            extras.extend(parts)
            continue
        n_pages = len(plan.pg_enc)
        npg = _pad_pow2(n_pages)
        dense_start = np.full(npg + 1, 1 << 62, dtype=np.int64)
        dense_start[:n_pages + 1] = plan.pg_dense_start
        plain_byte = np.zeros(npg, dtype=np.int64)
        plain_byte[:n_pages] = plan.pg_plain_byte
        pg_enc = np.zeros(npg, dtype=np.int32)
        pg_enc[:n_pages] = plan.pg_enc
        extras.extend([dense_start, plain_byte, pg_enc])
        if plan.has_delta:
            pg_first = np.zeros(npg, dtype=np.int64)
            pg_first[:n_pages] = plan.pg_first
            extras.append(pg_first)
        ndl = _pad_pow2(len(plan.dl)) if plan.dl is not None else 0
        if plan.dl is not None:
            extras.extend(plan.dl.arrays(ndl))
        nvr = _pad_pow2(len(plan.vr)) if plan.vr is not None else 0
        if plan.vr is not None:
            extras.extend(plan.vr.arrays(nvr))
        ndr = _pad_pow2(len(plan.dr)) if plan.dr is not None else 0
        if plan.dr is not None:
            extras.extend(plan.dr.arrays(ndr))
        has_slen = plan.str_lens is not None
        if has_slen:
            slen = np.zeros(cap, dtype=np.int32)
            slen[:plan.str_lens.shape[0]] = plan.str_lens
            extras.append(slen)
        dict_shapes: List[Tuple] = []
        for da in plan.dict_arrays:
            pad = _pad_pow2(da.shape[0], floor=1)
            if pad > da.shape[0]:
                padded = np.zeros((pad,) + da.shape[1:], dtype=da.dtype)
                padded[:da.shape[0]] = da
                da = padded
            dict_shapes.append((da.shape, str(da.dtype)))
            extras.append(da)
        layout.append(("dev", plan.kind, plan.np_dtype, plan.elem_bytes,
                       plan.char_cap, npg, ndl, nvr, ndr,
                       tuple(dict_shapes), plan.has_plain,
                       plan.has_delta, plan.has_bss, has_slen))
        arity = 3 if plan.kind in ("str", "dec128") else 2
        spec.append((dt, arity))
    # a capacity bucket, as the JAX package pads it (there the bucket
    # keys a compiled program; here it keeps the staging identical)
    words = enc.words
    nw = bucket_capacity(len(words))
    if nw > len(words):
        words = np.concatenate([words,
                                np.zeros(nw - len(words), np.int32)])
    return ("encoded", enc.schema, n, cap, words, extras, tuple(layout),
            tuple(spec))


def walk_layout(layout: Tuple, extras: Sequence[Any]
                ) -> Iterator[Tuple[Tuple, dict]]:
    """The extras of each layout entry, in layout order: ``(ent,
    {"parts": [...]})`` for a host column, ``(ent, tables)`` for a
    device-decoded one, ``tables`` holding ``dense_start``,
    ``plain_byte``, ``pg_enc``, ``pg_first``, the ``dl``/``vr``/``dr``
    run tables (5 arrays each), ``slen`` (None where absent) and the
    ``dicts`` list."""
    cur = 0
    for ent in layout:
        if ent[0] == "host":
            yield ent, {"parts": list(extras[cur:cur + ent[1]])}
            cur += ent[1]
            continue
        (_tag, _kind, _np_dt, _eb, _cc, _npg, ndl, nvr, ndr, dict_shapes,
         _has_plain, has_delta, _has_bss, has_slen) = ent
        t = {"dense_start": extras[cur], "plain_byte": extras[cur + 1],
             "pg_enc": extras[cur + 2], "pg_first": None, "slen": None}
        cur += 3
        if has_delta:
            t["pg_first"] = extras[cur]
            cur += 1
        for name, count in (("dl", ndl), ("vr", nvr), ("dr", ndr)):
            t[name] = None
            if count:
                t[name] = list(extras[cur:cur + 5])
                cur += 5
        if has_slen:
            t["slen"] = extras[cur]
            cur += 1
        t["dicts"] = list(extras[cur:cur + len(dict_shapes)])
        cur += len(dict_shapes)
        yield ent, t


def _encoded_decode_body(layout: Tuple, cap: int, words: torch.Tensor,
                         n: int, extras: Sequence[torch.Tensor]):
    """Plain PyTorch version of the ``decodeFused`` kernel: packed page
    words + plan tables -> ``(active, outs)``, per column ``(data,
    validity)`` or ``(chars, lengths, validity)`` / ``(hi, lo,
    validity)`` at capacity ``cap``; host-decoded columns pass through.
    The JAX package's ``_encoded_decode_body`` step for step, with every
    gather index clamped as ``jnp`` clamps it."""
    from spark_rapids_tpu_torch.io.device_decode import (PGE_BSS, PGE_DELTA,
                                                         PGE_DICT,
                                                         PGE_DL_STR,
                                                         PGE_PLAIN_STR)
    from spark_rapids_tpu_torch.ops import rle as R
    dev = words.device
    bytes_all = R.bytes_of_words(words)
    pos = torch.arange(cap, dtype=torch.int64, device=dev)
    active = pos < n
    zero64 = torch.zeros(cap, dtype=torch.int64, device=dev)
    outs: List[torch.Tensor] = []

    def page_of(dense_start, x, npg):
        return (torch.searchsorted(dense_start, x, right=True) - 1) \
            .clamp(0, npg - 1)

    for ent, t in walk_layout(layout, extras):
        if ent[0] == "host":
            outs.extend(t["parts"])
            continue
        (_tag, kind, np_dt, elem_bytes, char_cap, npg, _ndl, _nvr, _ndr,
         dict_shapes, has_plain, has_delta, has_bss, has_slen) = ent
        dense_start, plain_byte = t["dense_start"], t["plain_byte"]
        pg_enc, vr, dicts = t["pg_enc"], t["vr"], t["dicts"]
        if t["dl"] is not None:
            validity = (R.hybrid_lookup(bytes_all, pos, *t["dl"]) == 1) \
                & active
        else:
            validity = active
        j = R.dense_ranks(validity).clamp(0, cap - 1).to(torch.int64)
        if kind == "bool":
            v = R.hybrid_lookup(bytes_all, j, *vr)
            outs.extend([validity & (v != 0), validity])
            continue
        pg = page_of(dense_start, j, npg)
        local = j - dense_start[pg]
        enc_pg = pg_enc[pg]
        is_dict_pg = enc_pg == PGE_DICT
        didx = None
        if vr is not None and dict_shapes:
            didx = R.hybrid_lookup(bytes_all, j, *vr) \
                .clamp(0, dict_shapes[0][0][0] - 1)
        if kind == "str":
            if has_slen:
                # offsets from lengths in DENSE coordinates (pos): a
                # per-page segmented prefix sum over the byte
                # footprints (PLAIN values add their 4-byte length
                # prefix), then one gather builds the char matrix
                pgd = page_of(dense_start, pos, npg)
                encd = pg_enc[pgd]
                sl_d = t["slen"].to(torch.int64)
                lp_d = torch.where(encd == PGE_PLAIN_STR, 4, 0) \
                    .to(torch.int64)
                is_str_d = (encd == PGE_PLAIN_STR) | (encd == PGE_DL_STR)
                contrib = torch.where(is_str_d, sl_d + lp_d, 0)
                based = dense_start[pgd].clamp(0, cap - 1)
                start_d = plain_byte[pgd] + R.seg_excl_cumsum(
                    contrib, based) + lp_d
                plens = sl_d[j].to(torch.int32)
                pchars = R.gather_chars(bytes_all, start_d[j], plens,
                                        char_cap)
            else:
                pchars = torch.zeros((cap, char_cap), dtype=torch.uint8,
                                     device=dev)
                plens = torch.zeros(cap, dtype=torch.int32, device=dev)
            if didx is not None:
                chars = torch.where(is_dict_pg[:, None], dicts[0][didx],
                                    pchars)
                lengths = torch.where(is_dict_pg,
                                      dicts[1][didx].to(torch.int32), plens)
            else:
                chars, lengths = pchars, plens
            chars = torch.where(validity[:, None], chars, 0) \
                .to(torch.uint8)
            lengths = torch.where(validity, lengths, 0)
            outs.extend([chars, lengths, validity])
            continue
        if kind == "dec128":
            if has_plain:
                p_hi, p_lo = R.read_be_limbs(
                    bytes_all, plain_byte[pg] + local * elem_bytes,
                    elem_bytes)
            else:
                p_hi = p_lo = zero64
            if didx is not None:
                hi = torch.where(is_dict_pg, dicts[0][didx], p_hi)
                lo = torch.where(is_dict_pg, dicts[1][didx], p_lo)
            else:
                hi, lo = p_hi, p_lo
            outs.extend([torch.where(validity, hi, 0),
                         torch.where(validity, lo, 0), validity])
            continue
        # fixed-width scalar kinds: select in the int64 bit domain
        v = zero64
        if has_plain:
            off = plain_byte[pg] + local * elem_bytes
            v = R.read_be_signed(bytes_all, off, elem_bytes) \
                if kind == "dec64" else R.read_le(bytes_all, off, elem_bytes)
        if has_bss:
            stride = (dense_start[pg + 1] - dense_start[pg]).clamp(0, cap)
            b_v = R.read_bss(bytes_all, plain_byte[pg], stride, local,
                             elem_bytes)
            v = torch.where(enc_pg == PGE_BSS, b_v, v)
        if has_delta:
            # DELTA_BINARY_PACKED in DENSE coordinates: per-value deltas
            # from the miniblock run table, a per-page segmented prefix
            # sum off the page's first value, gathered per row
            pgd = page_of(dense_start, pos, npg)
            encd = pg_enc[pgd]
            d_raw = R.delta_lookup(bytes_all, pos, *t["dr"])
            d_contrib = torch.where(
                (encd == PGE_DELTA) & (pos > dense_start[pgd]), d_raw, 0)
            c = torch.cumsum(d_contrib, dim=0)
            based = dense_start[pgd].clamp(0, cap - 1)
            val_d = t["pg_first"][pgd] + (c - c[based])
            v = torch.where(enc_pg == PGE_DELTA, val_d[j], v)
        if didx is not None:
            v = torch.where(is_dict_pg, dicts[0][didx], v)
        if kind == "f32":
            data = torch.where(validity, v.to(torch.int32)
                               .view(torch.float32), 0.0)
        elif kind == "f64":
            data = torch.where(validity, v.view(torch.float64), 0.0)
        else:  # int / dec64: reinterpret the low bits into the storage
            if np_dt == "int64" and elem_bytes == 4 and kind != "dec64":
                data = v.to(torch.int32).to(torch.int64)
            else:
                data = v.to(getattr(torch, np_dt))
            data = torch.where(validity, data, 0)
        outs.extend([data, validity])
    return active, tuple(outs)


