"""Device string <-> long/bool/date casts on torch tensors (the counterpart
of ``spark_rapids_tpu.ops.cast``).

Everything is fixed-shape arithmetic over the padded byte matrix: digit
extraction, positional parses and Hinnant civil-date math, with no host
round trip, so a cast runs inside a captured stage program. Spark
semantics (Cast.scala / UTF8String), as the JAX package implements them:

- string -> integral: ASCII control/space trim, optional sign, digits
  only (the CPU oracle rejects fractions), null on malformed input or
  overflow;
- string -> boolean: t/true/y/yes/1 and f/false/n/no/0, any case;
- string -> date: ``y-m-d`` with 1-7 digit years (1..9999) and 1-2 digit
  month and day, calendar-checked;
- integral/bool/date -> string: Java's rendering (``Long.toString``,
  ``true``/``false``, ``yyyy-MM-dd`` with wider or signed years as
  Python's ``f"{y:04d}"`` prints them).

torch has no uint64 arithmetic: a 19-digit magnitude is checked against
the int64 limit from its first 18 digits and its last one, and
``long_to_string`` takes digits from the signed value with truncating
division, so ``Long.MIN_VALUE`` needs no negation.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence, Tuple

import torch

_CONSTS: Dict[tuple, torch.Tensor] = {}
_CONSTS_LOCK = threading.Lock()


def const_tensor(values: Sequence, dtype: torch.dtype, device
                 ) -> torch.Tensor:
    """A small constant table on ``device``, made once per (values,
    dtype, device) and kept: a stage program's eager first run makes it,
    so its capture as a CUDA graph copies nothing from the host (a
    pageable host-to-device copy cannot be captured)."""
    key = (tuple(values), dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        with _CONSTS_LOCK:
            t = _CONSTS.get(key)
            if t is None:
                t = _CONSTS[key] = torch.tensor(list(values), dtype=dtype,
                                                device=device)
    return t


_POW10 = [10 ** k for k in range(19)]
_I64_MAX_DIV10 = 922337203685477580  # (2**63 - 1) // 10


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _gather_bytes(chars: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """chars[i, idx[i, j]] with the index clamped into the row, as int64."""
    cc = chars.shape[1]
    return torch.gather(chars, 1, idx.clamp(0, cc - 1).to(torch.int64)
                        ).to(torch.int64)


def _take_byte(chars: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _gather_bytes(chars, idx[:, None])[:, 0]


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True per row (0 when none)."""
    return torch.argmax(m.to(torch.int8), dim=1)


def _trim_bounds(chars: torch.Tensor, lengths: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, end) after trimming ASCII control/space bytes (<= 0x20),
    as UTF8String.trimAll does on the cast paths."""
    cc = chars.shape[1]
    pos = _arange(cc, chars.device)[None, :]
    in_str = pos < lengths.to(torch.int64)[:, None]
    non_ws = in_str & (chars > 0x20)
    any_nw = non_ws.any(dim=1)
    first = _first_true(non_ws)
    last = cc - 1 - _first_true(torch.flip(non_ws, [1]))
    start = torch.where(any_nw, first, 0)
    end = torch.where(any_nw, last + 1, 0)  # exclusive
    return start, end


def parse_string_to_long(chars: torch.Tensor, lengths: torch.Tensor,
                         validity: torch.Tensor):
    """``(value int64, ok, overflow)``: ok False means malformed;
    overflow means well-formed but beyond int64."""
    cc = chars.shape[1]
    dev = chars.device
    start, end = _trim_bounds(chars, lengths)
    first = _take_byte(chars, start)
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg = first == ord("-")
    int_start = start + has_sign.to(torch.int64)
    pos = _arange(cc, dev)[None, :]
    in_tok = (pos >= int_start[:, None]) & (pos < end[:, None])
    is_digit = (chars >= ord("0")) & (chars <= ord("9"))
    int_ok = torch.where(in_tok, is_digit, True).all(dim=1)
    n_dig = end - int_start
    ok = validity & (end > start) & (n_dig > 0) & int_ok
    # leading zeros do not count toward the digit budget
    nz = in_tok & is_digit & (chars != ord("0"))
    any_nz = nz.any(dim=1)
    int_start = torch.where(any_nz, _first_true(nz),
                            torch.maximum(end - 1, int_start))
    n_dig = end - int_start
    k = _arange(19, dev)
    dig = _gather_bytes(chars, int_start[:, None] + k[None, :]) - ord("0")
    n18 = torch.clamp(n_dig, max=18)
    live = k[None, :] < n18[:, None]
    p10 = const_tensor(_POW10, torch.int64, dev)
    exp = torch.clamp(n18[:, None] - 1 - k[None, :], 0, 18)
    mag18 = torch.where(live, dig * p10[exp], 0).sum(dim=1)
    d19 = dig[:, 18]
    is19 = n_dig == 19
    over19 = is19 & ((mag18 > _I64_MAX_DIV10)
                     | ((mag18 == _I64_MAX_DIV10)
                        & (d19 > torch.where(neg, 8, 7))))
    overflow = ok & ((n_dig > 19) | over19)
    m = torch.clamp(mag18, max=_I64_MAX_DIV10)
    wide = torch.where(neg, -(m * 10) - d19, m * 10 + d19)
    value = torch.where(is19, wide, torch.where(neg, -mag18, mag18))
    value = torch.where(ok & ~overflow, value, 0)
    return value, ok, overflow


def parse_string_to_bool(chars: torch.Tensor, lengths: torch.Tensor,
                         validity: torch.Tensor):
    """``(value, ok)``: Spark StringUtils.isTrueString / isFalseString."""
    start, end = _trim_bounds(chars, lengths)
    n = end - start
    k = _arange(5, chars.device)
    b = _gather_bytes(chars, start[:, None] + k[None, :])
    lower = torch.where((b >= ord("A")) & (b <= ord("Z")), b + 32, b)

    def word(w: str) -> torch.Tensor:
        match = n == len(w)
        for i, ch in enumerate(w):
            match = match & (lower[:, i] == ord(ch))
        return match

    t = word("t") | word("true") | word("y") | word("yes") | word("1")
    f = word("f") | word("false") | word("n") | word("no") | word("0")
    return t, validity & (t | f)


def parse_string_to_date(chars: torch.Tensor, lengths: torch.Tensor,
                         validity: torch.Tensor):
    """``(epoch days int32, ok)``: ``y-m-d`` with 1-2 digit month and
    day, years 1..9999, no sign on the year."""
    cc = chars.shape[1]
    dev = chars.device
    start, end = _trim_bounds(chars, lengths)
    first = _take_byte(chars, start)
    has_sign = (first == ord("-")) | (first == ord("+"))
    neg_year = first == ord("-")
    ystart = start + has_sign.to(torch.int64)
    pos = _arange(cc, dev)[None, :]
    in_tok = (pos >= ystart[:, None]) & (pos < end[:, None])
    dash = in_tok & (chars == ord("-"))
    n_dash = dash.sum(dim=1)
    d1 = torch.where(dash.any(dim=1), _first_true(dash), end)
    after1 = dash & (pos > d1[:, None])
    d2 = torch.where(after1.any(dim=1), _first_true(after1), end)
    p10 = const_tensor(_POW10[:8], torch.int64, dev)

    def seg_value(s, e, lo, hi):
        """Digits chars[s:e): ok iff lo <= len <= hi and all digits."""
        ln = e - s
        k = _arange(7, dev)
        b = _gather_bytes(chars, s[:, None] + k[None, :])
        live = k[None, :] < torch.clamp(ln, max=7)[:, None]
        digits = torch.where(live, (b >= ord("0")) & (b <= ord("9")),
                             True).all(dim=1)
        exp = torch.clamp(ln[:, None] - 1 - k[None, :], 0, 7)
        val = torch.where(live, (b - ord("0")) * p10[exp], 0).sum(dim=1)
        return val, (ln >= lo) & (ln <= hi) & digits

    y, y_ok = seg_value(ystart, torch.minimum(d1, end), 1, 7)
    m, m_ok = seg_value(d1 + 1, torch.minimum(d2, end), 1, 2)
    d, d_ok = seg_value(d2 + 1, end, 1, 2)
    shape_ok = y_ok & m_ok & d_ok & (n_dash == 2) & (end > start)
    shape_ok = shape_ok & ~neg_year & (y >= 1) & (y <= 9999)
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    dim = torch.where(m == 2, torch.where(leap, 29, 28),
                      torch.where((m == 4) | (m == 6) | (m == 9)
                                  | (m == 11), 30, 31))
    cal_ok = (m >= 1) & (m <= 12) & (d >= 1) & (d <= dim)
    ok = validity & shape_ok & cal_ok
    return civil_to_days(y, m, d).to(torch.int32), ok


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_to_days(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                  ) -> torch.Tensor:
    """Hinnant days_from_civil, proleptic Gregorian (Spark's LocalDate)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def civil_from_days(days: torch.Tensor):
    """``(year, month, day)`` int64 of epoch days (floor division, so
    days before 1970 are right)."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def _decimal_digits(v: torch.Tensor, n: int) -> torch.Tensor:
    """``[cap, n]`` decimal digits of |v|, least significant first, taken
    with truncating division (exact for Long.MIN_VALUE)."""
    out = []
    q = v
    for _ in range(n):
        out.append(torch.abs(torch.fmod(q, 10)))
        q = torch.div(q, 10, rounding_mode="trunc")
    return torch.stack(out, dim=1)


def long_to_string(data: torch.Tensor, validity: torch.Tensor):
    """``(chars uint8[cap, 24], lengths int32)``: Java Long.toString."""
    dev = data.device
    data = data.to(torch.int64)
    neg = data < 0
    digits = _decimal_digits(data, 20)
    idx20 = _arange(20, dev)[None, :] + 1
    ndig = torch.clamp(torch.where(digits > 0, idx20, 0).max(dim=1).values,
                       min=1)
    negi = neg.to(torch.int64)
    length = ndig + negi
    p = _arange(24, dev)[None, :]
    digit_idx = ndig[:, None] - 1 - (p - negi[:, None])
    dig = torch.gather(digits, 1, digit_idx.clamp(0, 19))
    ch = ord("0") + dig
    ch = torch.where((p == 0) & neg[:, None], ord("-"), ch)
    ch = torch.where((p < length[:, None]) & validity[:, None], ch, 0)
    return ch.to(torch.uint8), torch.where(validity, length, 0).to(
        torch.int32)


def bool_to_string(data: torch.Tensor, validity: torch.Tensor):
    dev = data.device
    t = const_tensor(b"true\0\0\0\0", torch.uint8, dev)
    f = const_tensor(b"false\0\0\0", torch.uint8, dev)
    b = data.to(torch.bool)
    ch = torch.where(b[:, None], t[None, :], f[None, :])
    ch = torch.where(validity[:, None], ch, 0)
    length = torch.where(b, 4, 5)
    return ch, torch.where(validity, length, 0).to(torch.int32)


def date_to_string(days: torch.Tensor, validity: torch.Tensor):
    """Variable-width year as Python's ``f"{y:04d}"`` (the CPU oracle):
    4 digits zero-padded up to 9999, wider beyond, a '-' sign for
    negative years."""
    dev = days.device
    y, m, d = civil_from_days(days)
    neg = y < 0
    negi = neg.to(torch.int64)
    ydig = _decimal_digits(y, 8)
    nd = torch.clamp(torch.where(ydig > 0, _arange(8, dev)[None, :] + 1,
                                 0).max(dim=1).values, min=1)
    ylen = torch.maximum(nd, 4 - negi)
    yfield = ylen + negi
    length = yfield + 6
    p = _arange(16, dev)[None, :]
    digit_idx = ylen[:, None] - 1 - (p - negi[:, None])
    ych = ord("0") + torch.gather(ydig, 1, digit_idx.clamp(0, 7))
    ych = torch.where((p == 0) & neg[:, None], ord("-"), ych)
    rel = p - yfield[:, None]
    md = torch.zeros_like(rel)
    for r, v in ((0, ord("-")), (1, ord("0") + m // 10),
                 (2, ord("0") + m % 10), (3, ord("-")),
                 (4, ord("0") + d // 10), (5, ord("0") + d % 10)):
        vv = v[:, None] if isinstance(v, torch.Tensor) else v
        md = torch.where(rel == r, vv, md)
    ch = torch.where(rel < 0, ych, md)
    ch = torch.where((p < length[:, None]) & validity[:, None], ch, 0)
    return ch.to(torch.uint8), torch.where(validity, length, 0).to(
        torch.int32)
