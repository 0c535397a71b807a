"""Host -> device upload (the counterpart of
``spark_rapids_tpu.columnar.transfer``).

Two paths:

- A HostBatch: the JAX package stages narrowed and bit-packed buffers
  into one transfer and decodes them with one program, because each
  transfer on its backend pays a large fixed cost. Over PCIe to the card
  the per-buffer cost is small, so each column ships as its own tensor at
  the batch capacity. The string encoding stays vectorised in numpy:
  millions of object strings through a Python loop would dominate the
  upload.
- An EncodedBatch (a Parquet row group staged by
  ``io/device_decode.py``): the still-encoded page bytes ship as one int32
  word buffer beside small plan tables (``prepare_encoded_upload``, the
  same staging as the JAX package's, byte for byte), and the
  ``decodeFused`` kernel expands them into device columns
  (``finish_encoded_upload``). ``_encoded_decode_body`` is the plain
  PyTorch version of that kernel, used for CPU tensors.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.sql import types as T


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


def _encode_strings(data: np.ndarray, validity: np.ndarray, n: int,
                    is_binary: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Object array of str/bytes -> (uint8[n, char_cap], int32 lengths).
    ASCII string columns take a vectorized numpy path (codepoints via a
    U-dtype view); anything else falls back to per-row encoding."""
    from spark_rapids_tpu_torch.columnar.device import bucket_char_cap
    if n == 0:
        return np.zeros((0, 8), np.uint8), np.zeros(0, np.int32)
    if not is_binary:
        try:
            u = data.astype(np.str_)
        except (TypeError, ValueError):
            u = None
        if u is not None and u.dtype.itemsize == 0:
            return np.zeros((n, 8), np.uint8), np.zeros(n, np.int32)
        if u is not None:
            k = u.dtype.itemsize // 4
            u32 = np.ascontiguousarray(u).view(np.uint32).reshape(n, k)
            if (u32 < 128).all():
                # pure-ASCII fast path: UTF-32 codepoints ARE the bytes
                lengths = np.char.str_len(u).astype(np.int32)
                char_cap = bucket_char_cap(int(lengths.max(initial=1)))
                chars = np.zeros((n, char_cap), np.uint8)
                w = min(k, char_cap)
                chars[:, :w] = u32[:, :w].astype(np.uint8)
                lengths = np.where(validity, lengths, 0)
                chars[~validity] = 0
                return chars, lengths
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


def _padded(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def pack_batch(batch, cap: int) -> List[np.ndarray]:
    """Stage a HostBatch as the flat list of capacity-padded numpy arrays
    of its device columns (``flatten_columns`` order), with normalized
    zeros at null slots."""
    from spark_rapids_tpu_torch.columnar.device import (column_arity,
                                                        is_string_like)
    n = batch.num_rows
    flat: List[np.ndarray] = []
    for f, c in zip(batch.schema.fields, batch.columns):
        dt = f.data_type
        column_arity(dt)  # raises for types the port does not carry
        validity = np.ascontiguousarray(c.validity[:n], dtype=bool)
        if is_string_like(dt):
            chars, lengths = _encode_strings(
                c.data[:n], validity, n, isinstance(dt, T.BinaryType))
            flat += [_padded(chars, cap), _padded(lengths, cap)]
        elif T.is_limb_decimal(dt):
            limbs = np.where(validity[:, None], c.data[:n], 0)
            flat += [_padded(np.ascontiguousarray(limbs[:, 0]), cap),
                     _padded(np.ascontiguousarray(limbs[:, 1]), cap)]
        else:
            np_dt = T.numpy_dtype(dt)
            data = np.asarray(c.data[:n], dtype=np_dt)
            data = np.where(validity, data, np_dt.type(0))
            flat.append(_padded(data, cap))
        flat.append(_padded(validity, cap))
    return flat


def upload_batch(batch, cap: int, device: torch.device):
    """HostBatch -> DeviceBatch at capacity ``cap`` on ``device``."""
    from spark_rapids_tpu_torch.columnar import device as D
    n = batch.num_rows
    assert cap >= n, (cap, n)
    flat = [torch.from_numpy(a).to(device) for a in pack_batch(batch, cap)]
    spec = [(f.data_type, D.column_arity(f.data_type))
            for f in batch.schema.fields]
    active = torch.arange(cap, device=device) < n
    return D.DeviceBatch(batch.schema, D.rebuild_columns(spec, flat),
                         active, n)


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
    """Full-width staging arrays of one flat host column, in its device
    column's ``arrays()`` order (the JAX package's ``_stage_column`` for
    the column types the port carries)."""
    from spark_rapids_tpu_torch.columnar import device as D
    D.column_arity(dt)  # raises for nested types
    n = len(c)
    validity = np.zeros(cap, dtype=bool)
    validity[:n] = c.validity
    if D.is_string_like(dt):
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


def finish_encoded_upload(staged, device: torch.device):
    """Staged EncodedBatch -> DeviceBatch on ``device``: the page words
    and every table go up as their own tensors, then one ``decodeFused``
    decode (the kernel on CUDA, its plain version on the CPU)."""
    from spark_rapids_tpu_torch.columnar import device as D
    from spark_rapids_tpu_torch.kernels import decode_fused as DF
    _tag, schema, n, cap, words, extras, layout, spec = staged
    dev_words = torch.from_numpy(words).to(device)
    dev_extras = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                  for a in extras]
    active, outs = DF.decode_fused(layout, cap, n, dev_words, dev_extras)
    return D.DeviceBatch(schema, D.rebuild_columns(list(spec), outs),
                         active, n)
