"""Parquet page-decode arithmetic, plain PyTorch (the port's copy of
``spark_rapids_tpu.ops.rle``).

These are the plain versions of what the ``decodeFused`` kernel computes
per row (``csrc/decode_fused.cu``): the CPU tests decode with them, and
``chip_smoke.py`` holds the kernel against them on the card.

- ``hybrid_lookup``: positional decode of the RLE/bit-packed hybrid
  stream (dictionary indices, definition levels). The run headers were
  parsed on the host; each output position binary-searches its run, then
  either takes the run's RLE value or bit-gathers from the packed bytes.
- ``read_le`` / ``read_be_signed`` / ``read_be_limbs``: PLAIN fixed-width
  and FIXED_LEN_BYTE_ARRAY (decimal) reinterpretation at byte offsets.
- ``delta_lookup`` / ``read_bss`` / ``gather_chars`` / ``seg_excl_cumsum``
  / ``dense_ranks``: the DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, string
  and definition-level pieces.

Every function takes the byte array as an int32 tensor (one byte per
element, as ``bytes_of_words`` makes it from the packed int32 staging
words) and int64 offsets, and returns int64 values, wrapping on overflow
as the JAX package's int64 does. Every gather clamps its index into
range, as ``jnp`` indexing does: torch would raise instead. Callers mask
invalid lanes afterwards.
"""

from __future__ import annotations

import torch

# A bit-packed value of width <= 32 plus a 0..7 bit phase spans at most
# 5 bytes.
_PACKED_WINDOW = 5


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[clip(idx, 0, len - 1)]`` (jnp's clamped gather)."""
    return src[idx.clamp(0, src.shape[0] - 1)]


def bytes_of_words(words: torch.Tensor) -> torch.Tensor:
    """int32 staging words -> int32 byte array (little-endian order)."""
    shifts = torch.arange(4, dtype=torch.int32, device=words.device) * 8
    return ((words[:, None] >> shifts) & 0xFF).reshape(-1)


def _gather_window(bytes_all: torch.Tensor, byte_off: torch.Tensor,
                   width: int) -> torch.Tensor:
    """(m, width) int64 window of bytes starting at byte_off (clamped)."""
    k = torch.arange(width, dtype=torch.int64, device=byte_off.device)
    return _take(bytes_all, byte_off[:, None] + k).to(torch.int64)


def read_packed(bytes_all: torch.Tensor, bit_off: torch.Tensor,
                width: torch.Tensor) -> torch.Tensor:
    """``width``-bit little-endian values at arbitrary bit offsets (the
    Parquet bit-packed layout); width may vary per lane, width <= 32."""
    byte0 = bit_off >> 3
    shift = bit_off & 7
    win = _gather_window(bytes_all, byte0, _PACKED_WINDOW)
    k = torch.arange(_PACKED_WINDOW, dtype=torch.int64,
                     device=bit_off.device) * 8
    word = (win << k).sum(dim=1)
    mask = (torch.ones_like(word) << width.to(torch.int64)) - 1
    return (word >> shift) & mask


def hybrid_lookup(bytes_all: torch.Tensor, pos: torch.Tensor,
                  out_start: torch.Tensor, packed: torch.Tensor,
                  value: torch.Tensor, bit_start: torch.Tensor,
                  width: torch.Tensor) -> torch.Tensor:
    """Decode the RLE/bit-packed hybrid stream at positions ``pos``. The
    run table (out_start ascending, padded with a huge sentinel; packed
    flag; RLE value; absolute payload bit offset; per-run bit width)
    comes from the host-side header parse."""
    rid = torch.searchsorted(out_start, pos, right=True) - 1
    rid = rid.clamp(0, out_start.shape[0] - 1)
    local = pos - out_start[rid]
    w = width[rid]
    v_packed = read_packed(bytes_all, bit_start[rid] + local * w, w)
    return torch.where(packed[rid], v_packed, value[rid])


def read_packed64(bytes_all: torch.Tensor, bit_off: torch.Tensor,
                  width: torch.Tensor) -> torch.Tensor:
    """``read_packed`` for widths up to 64 (DELTA_BINARY_PACKED
    miniblocks), assembled from two <= 32-bit reads; width 0 reads 0."""
    w = width.to(torch.int64)
    lo = read_packed(bytes_all, bit_off, w.clamp(max=32))
    hi = read_packed(bytes_all, bit_off + 32, (w - 32).clamp(min=0))
    return lo | (hi << 32)


def delta_lookup(bytes_all: torch.Tensor, pos: torch.Tensor,
                 out_start: torch.Tensor, packed: torch.Tensor,
                 value: torch.Tensor, bit_start: torch.Tensor,
                 width: torch.Tensor) -> torch.Tensor:
    """Per-lane DELTA_BINARY_PACKED delta from a run table of one entry
    per miniblock (value = the block's min_delta): lane ``pos`` returns
    min_delta + unpacked[pos - out_start]."""
    del packed
    rid = torch.searchsorted(out_start, pos, right=True) - 1
    rid = rid.clamp(0, out_start.shape[0] - 1)
    local = pos - out_start[rid]
    w = width[rid]
    raw = read_packed64(bytes_all, bit_start[rid] + local * w, w)
    return value[rid] + raw


def read_bss(bytes_all: torch.Tensor, base: torch.Tensor,
             stride: torch.Tensor, local: torch.Tensor,
             nbytes: int) -> torch.Tensor:
    """BYTE_STREAM_SPLIT: byte j of value ``local`` lives at
    base + j*stride + local; assembled little-endian, zero-extended."""
    k = torch.arange(nbytes, dtype=torch.int64, device=base.device)
    idx = base[:, None] + k[None, :] * stride[:, None] + local[:, None]
    win = _take(bytes_all, idx).to(torch.int64)
    return (win << (k * 8)).sum(dim=1)


def gather_chars(bytes_all: torch.Tensor, starts: torch.Tensor,
                 lengths: torch.Tensor, char_cap: int) -> torch.Tensor:
    """Variable bytes -> (n, char_cap) uint8 matrix: row i takes
    lengths[i] bytes at starts[i], zero-padded."""
    cols = torch.arange(char_cap, dtype=torch.int64, device=starts.device)
    mask = cols.to(torch.int32) < lengths[:, None]
    g = _take(bytes_all, starts[:, None] + cols)
    return torch.where(mask, g, 0).to(torch.uint8)


def seg_excl_cumsum(contrib: torch.Tensor, seg_first_lane: torch.Tensor
                    ) -> torch.Tensor:
    """Exclusive prefix sum restarting at each segment: lane i gets
    sum(contrib[seg_first_lane[i]:i])."""
    c = torch.cumsum(contrib, dim=0)
    excl = c - contrib
    return excl - excl[seg_first_lane]


def read_le(bytes_all: torch.Tensor, byte_off: torch.Tensor,
            nbytes: int) -> torch.Tensor:
    """PLAIN fixed width: little-endian nbytes -> int64 (zero-extended
    below 8 bytes; the caller's narrowing cast re-signs)."""
    win = _gather_window(bytes_all, byte_off, nbytes)
    k = torch.arange(nbytes, dtype=torch.int64, device=byte_off.device) * 8
    return (win << k).sum(dim=1)


def _sign_extend(v: torch.Tensor, nbytes: int) -> torch.Tensor:
    if nbytes >= 8:
        return v
    bits = 8 * nbytes
    return v - ((v >> (bits - 1)) << bits)


def read_be_signed(bytes_all: torch.Tensor, byte_off: torch.Tensor,
                   nbytes: int) -> torch.Tensor:
    """FIXED_LEN_BYTE_ARRAY decimal: big-endian two's complement of
    nbytes (<= 8) -> signed int64."""
    win = _gather_window(bytes_all, byte_off, nbytes)
    k = (nbytes - 1 - torch.arange(nbytes, dtype=torch.int64,
                                   device=byte_off.device)) * 8
    return _sign_extend((win << k).sum(dim=1), nbytes)


def read_be_limbs(bytes_all: torch.Tensor, byte_off: torch.Tensor,
                  nbytes: int):
    """FIXED_LEN_BYTE_ARRAY decimal128: big-endian two's complement of
    nbytes (9..16) -> (hi, lo) int64 limbs (hi = value >> 64, lo = the
    low 64 bits)."""
    hi_bytes = nbytes - 8
    hi = read_be_signed(bytes_all, byte_off, hi_bytes)
    win = _gather_window(bytes_all, byte_off + hi_bytes, 8)
    k = (7 - torch.arange(8, dtype=torch.int64,
                          device=byte_off.device)) * 8
    lo = (win << k).sum(dim=1)
    return hi, lo


def dense_ranks(validity: torch.Tensor) -> torch.Tensor:
    """Row -> index of its value in the null-stripped (dense) value
    stream: Parquet data pages store only non-null values."""
    return torch.cumsum(validity.to(torch.int32), dim=0,
                        dtype=torch.int32) - 1
