"""Host -> device upload (the plain path of
``spark_rapids_tpu.columnar.transfer``).

The JAX package stages narrowed and bit-packed buffers into one transfer
and decodes them with one program, because each transfer on its backend
pays a large fixed cost. Over PCIe to the card the per-buffer cost is
small, so each column ships as its own tensor at the batch capacity. The
string encoding stays vectorised in numpy: millions of object strings
through a Python loop would dominate the upload.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.sql import types as T


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
