"""User-facing Column API and function constructors (pyspark.sql.functions
shape). Handles binary-op type coercion by inserting Casts, like Spark's
TypeCoercion rules, so expression trees are fully typed at construction.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

from spark_rapids_tpu_torch.sql import types as T
from spark_rapids_tpu_torch.sql import expressions as E


class Column:
    def __init__(self, expr: E.Expression):
        self.expr = expr

    # -- naming
    def alias(self, name: str) -> "Column":
        return Column(E.Alias(self.expr, name))

    name = alias

    # -- arithmetic with coercion
    def _bin(self, other: Any, cls, swap: bool = False) -> "Column":
        o = _to_expr(other)
        a, b = (o, self.expr) if swap else (self.expr, o)
        # ONLY +,-,*,/ use DecimalPrecision's no-widen operand rule;
        # %/pmod (and comparisons) coerce to a common wider decimal
        a, b = _coerce_pair(a, b, arith=issubclass(
            cls, (E.Add, E.Subtract, E.Multiply, E.Divide)))
        return Column(cls(a, b))

    def __add__(self, other):
        return self._bin(other, E.Add)

    def __radd__(self, other):
        return self._bin(other, E.Add, swap=True)

    def __sub__(self, other):
        return self._bin(other, E.Subtract)

    def __rsub__(self, other):
        return self._bin(other, E.Subtract, swap=True)

    def __mul__(self, other):
        return self._bin(other, E.Multiply)

    def __rmul__(self, other):
        return self._bin(other, E.Multiply, swap=True)

    def __truediv__(self, other):
        return _divide(self.expr, _to_expr(other))

    def __rtruediv__(self, other):
        return _divide(_to_expr(other), self.expr)

    def __mod__(self, other):
        return self._bin(other, E.Remainder)

    def __neg__(self):
        return Column(E.UnaryMinus(self.expr))

    # -- comparisons
    def __eq__(self, other):  # type: ignore[override]
        return self._bin(other, E.EqualTo)

    def __ne__(self, other):  # type: ignore[override]
        return Column(E.Not(self._bin(other, E.EqualTo).expr))

    def __lt__(self, other):
        return self._bin(other, E.LessThan)

    def __le__(self, other):
        return self._bin(other, E.LessThanOrEqual)

    def __gt__(self, other):
        return self._bin(other, E.GreaterThan)

    def __ge__(self, other):
        return self._bin(other, E.GreaterThanOrEqual)

    def eqNullSafe(self, other):
        return self._bin(other, E.EqualNullSafe)

    # -- logic
    def __and__(self, other):
        return Column(E.And(self.expr, _to_expr(other)))

    def __or__(self, other):
        return Column(E.Or(self.expr, _to_expr(other)))

    def __invert__(self):
        return Column(E.Not(self.expr))

    # -- null / membership
    def isNull(self):
        return Column(E.IsNull(self.expr))

    def isNotNull(self):
        return Column(E.IsNotNull(self.expr))

    def isin(self, *values):
        items = [_to_expr(v) for v in
                 (values[0] if len(values) == 1
                  and isinstance(values[0], (list, tuple)) else values)]
        return Column(E.In(self.expr, items))

    def getItem(self, key) -> "Column":
        return Column(E.GetArrayItem(self.expr, _to_expr(key)))

    def __getitem__(self, key) -> "Column":
        return self.getItem(key)

    def bitwiseAND(self, other) -> "Column":
        return Column(E.BitwiseAnd(self.expr, _to_expr(other)))

    def bitwiseOR(self, other) -> "Column":
        return Column(E.BitwiseOr(self.expr, _to_expr(other)))

    def bitwiseXOR(self, other) -> "Column":
        return Column(E.BitwiseXor(self.expr, _to_expr(other)))

    # -- casts & misc
    def cast(self, dtype: Union[T.DataType, str]) -> "Column":
        return Column(E.Cast(self.expr, _parse_type(dtype)))

    astype = cast

    def substr(self, pos, length):
        return Column(E.Substring(self.expr, _to_expr(pos),
                                  _to_expr(length)))

    def startswith(self, other):
        return Column(E.StartsWith(self.expr, _to_expr(other)))

    def endswith(self, other):
        return Column(E.EndsWith(self.expr, _to_expr(other)))

    def contains(self, other):
        return Column(E.Contains(self.expr, _to_expr(other)))

    def like(self, pattern: str):
        return Column(E.Like(self.expr, E.Literal(pattern)))

    def rlike(self, pattern: str):
        return Column(E.RLike(self.expr, E.Literal(pattern)))

    def getField(self, name: str):
        return Column(E.GetStructField(self.expr, name=name))

    def between(self, low, high):
        return (self >= low) & (self <= high)

    # -- window
    def over(self, spec: "WindowSpec") -> "Column":
        return Column(E.WindowExpression(
            self.expr, spec._partition, spec._order, spec._frame))

    # -- sort orders
    def asc(self):
        return Column(E.SortOrder(self.expr, ascending=True))

    def desc(self):
        return Column(E.SortOrder(self.expr, ascending=False))

    def asc_nulls_first(self):
        return Column(E.SortOrder(self.expr, True, nulls_first=True))

    def asc_nulls_last(self):
        return Column(E.SortOrder(self.expr, True, nulls_first=False))

    def desc_nulls_first(self):
        return Column(E.SortOrder(self.expr, False, nulls_first=True))

    def desc_nulls_last(self):
        return Column(E.SortOrder(self.expr, False, nulls_first=False))

    def when(self, condition: "Column", value) -> "Column":
        raise TypeError("use functions.when(...) to start a CASE expression")

    def otherwise(self, value) -> "Column":
        expr = self.expr
        if not isinstance(expr, E.CaseWhen) or expr.has_else:
            raise TypeError("otherwise() follows when()")
        branches = [(expr.children[i], expr.children[i + 1])
                    for i in range(0, len(expr.children), 2)]
        return Column(E.CaseWhen(branches, _to_expr(value)))

    def __repr__(self):
        return f"Column<{self.expr!r}>"


def _to_expr(v: Any) -> E.Expression:
    if isinstance(v, Column):
        return v.expr
    if isinstance(v, E.Expression):
        return v
    return E.Literal(v)


def _expr_type(e: E.Expression) -> Optional[T.DataType]:
    try:
        return e.data_type
    except Exception:
        return None  # unresolved; coercion re-checked at plan build


def _coerce_pair(a: E.Expression, b: E.Expression, arith: bool = False):
    ta, tb = _expr_type(a), _expr_type(b)
    if ta is None or tb is None or ta == tb:
        return a, b
    if arith and (isinstance(ta, T.DecimalType)
                  or isinstance(tb, T.DecimalType)):
        # Spark DecimalPrecision: arithmetic operands are NOT widened to
        # a common decimal (that would change mul/div result types);
        # integrals lift to their exact decimal, fractionals win whole
        if isinstance(ta, (T.FloatType, T.DoubleType)) or \
                isinstance(tb, (T.FloatType, T.DoubleType)):
            return (a if isinstance(ta, T.DoubleType)
                    else E.Cast(a, T.DoubleT),
                    b if isinstance(tb, T.DoubleType)
                    else E.Cast(b, T.DoubleT))
        if not isinstance(ta, T.DecimalType) and T.is_integral(ta):
            a = E.Cast(a, T.decimal_for_integral(ta))
        if not isinstance(tb, T.DecimalType) and T.is_integral(tb):
            b = E.Cast(b, T.decimal_for_integral(tb))
        return a, b
    common = T.tightest_common_type(ta, tb)
    if common is None:
        return a, b
    if ta != common:
        a = E.Cast(a, common)
    if tb != common:
        b = E.Cast(b, common)
    return a, b


def _divide(a: E.Expression, b: E.Expression) -> Column:
    """Spark: `/` on non-decimal operands is double division."""
    ta, tb = _expr_type(a), _expr_type(b)
    if ta is None or tb is None:
        # unresolved: the post-resolution coercion pass (dataframe
        # _coerce_resolved) applies the double-vs-decimal rule
        return Column(E.Divide(a, b))
    if isinstance(ta, T.DecimalType) or isinstance(tb, T.DecimalType):
        a2, b2 = _coerce_pair(a, b, arith=True)
        return Column(E.Divide(a2, b2))
    if not isinstance(ta, T.DoubleType):
        a = E.Cast(a, T.DoubleT)
    if not isinstance(tb, T.DoubleType):
        b = E.Cast(b, T.DoubleT)
    return Column(E.Divide(a, b))


_TYPE_NAMES = {
    "boolean": T.BooleanT, "bool": T.BooleanT,
    "tinyint": T.ByteT, "byte": T.ByteT,
    "smallint": T.ShortT, "short": T.ShortT,
    "int": T.IntegerT, "integer": T.IntegerT,
    "bigint": T.LongT, "long": T.LongT,
    "float": T.FloatT, "double": T.DoubleT,
    "string": T.StringT, "binary": T.BinaryT,
    "date": T.DateT, "timestamp": T.TimestampT,
}


def split_top_level(s: str, sep: str = ",") -> List[str]:
    """Split on ``sep`` at nesting depth 0 (ignoring separators inside
    <> and ()); shared by the DDL schema parser and struct/map type
    strings."""
    parts: List[str] = []
    depth = 0
    cur = ""
    for ch in s:
        if ch == sep and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        if ch in "(<":
            depth += 1
        elif ch in ")>":
            depth -= 1
        cur += ch
    if cur.strip():
        parts.append(cur)
    return parts


def _parse_type(dt: Union[T.DataType, str]) -> T.DataType:
    if isinstance(dt, T.DataType):
        return dt
    orig = dt.strip()
    s = orig.lower()
    if s in _TYPE_NAMES:
        return _TYPE_NAMES[s]
    if s.startswith("decimal"):
        if "(" in s:
            inner = s[s.index("(") + 1: s.index(")")]
            p, sc = inner.split(",")
            return T.DecimalType(int(p), int(sc))
        return T.DecimalType(10, 0)
    # nested types parse from the ORIGINAL string: field names keep case
    if s.startswith("array<") and s.endswith(">"):
        return T.ArrayType(_parse_type(orig[6:-1]))
    if s.startswith("struct<") and s.endswith(">"):
        out = []
        for f in split_top_level(orig[7:-1]):
            name, _, tp = f.strip().partition(":")
            out.append(T.StructField(name.strip(), _parse_type(tp.strip())))
        return T.StructType(out)
    if s.startswith("map<") and s.endswith(">"):
        kv = split_top_level(orig[4:-1])
        if len(kv) == 2:
            return T.MapType(_parse_type(kv[0]), _parse_type(kv[1]))
    raise ValueError(f"unknown type string {dt!r}")




def _to_col_expr(c: Any) -> E.Expression:
    """In function position, a bare string names a column (pyspark
    convention); elsewhere strings are literals."""
    if isinstance(c, str):
        return E.UnresolvedAttribute(c)
    return _to_expr(c)

# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

def col(name: str) -> Column:
    return Column(E.UnresolvedAttribute(name))


column = col


def lit(v: Any) -> Column:
    return Column(E.Literal(v))


def expr_col(e: E.Expression) -> Column:
    return Column(e)


def when(condition: Column, value) -> Column:
    return Column(E.CaseWhen([(_to_expr(condition), _to_expr(value))], None))


def coalesce(*cols) -> Column:
    return Column(E.Coalesce([_to_col_expr(c) for c in cols]))


def isnull(c) -> Column:
    return Column(E.IsNull(_to_col_expr(c)))


def isnan(c) -> Column:
    return Column(E.IsNan(_to_col_expr(c)))


# aggregates
def _agg(fn: E.AggregateFunction) -> Column:
    return Column(E.AggregateExpression(fn))


def sum(c) -> Column:  # noqa: A001 - mirrors pyspark.sql.functions
    return _agg(E.Sum(_to_col_expr(c)))


def count(c="*") -> Column:
    if isinstance(c, str) and c == "*":
        return _agg(E.Count([]))
    return _agg(E.Count([_to_col_expr(c)]))


def avg(c) -> Column:
    return _agg(E.Average(_to_col_expr(c)))


mean = avg


def _parse_duration_us(s: str) -> int:
    import re as _re
    m = _re.fullmatch(
        r"\s*(\d+)\s*(microsecond|millisecond|second|minute|hour|day|"
        r"week)s?\s*", s)
    if not m:
        raise ValueError(f"cannot parse interval {s!r}")
    n = int(m.group(1))
    mult = {"microsecond": 1, "millisecond": 1000, "second": 10**6,
            "minute": 60 * 10**6, "hour": 3600 * 10**6,
            "day": 86400 * 10**6, "week": 7 * 86400 * 10**6}[m.group(2)]
    return n * mult


def window(c, windowDuration: str, slideDuration=None,
           startTime=None) -> Column:
    """Tumbling time window: struct<start, end> (Spark TimeWindow;
    sliding windows are unsupported)."""
    w = _parse_duration_us(windowDuration)
    if w <= 0:
        raise ValueError("window duration must be positive")
    if slideDuration is not None and \
            _parse_duration_us(slideDuration) != w:
        raise NotImplementedError(
            "sliding time windows (slide != duration) are not supported")
    start = _parse_duration_us(startTime) if startTime else 0
    return Column(E.TimeWindow(_to_col_expr(c), w, start))


def struct(*cols) -> Column:
    exprs = [_to_col_expr(c) for c in cols]
    names = [getattr(e, "name", None) or f"col{i + 1}"
             for i, e in enumerate(exprs)]
    return Column(E.CreateNamedStruct(names, exprs))


def named_struct(*name_col_pairs) -> Column:
    names = [str(x) for x in name_col_pairs[0::2]]
    exprs = [_to_col_expr(c) for c in name_col_pairs[1::2]]
    return Column(E.CreateNamedStruct(names, exprs))


def monotonically_increasing_id() -> Column:
    return Column(E.MonotonicallyIncreasingID())


def spark_partition_id() -> Column:
    return Column(E.SparkPartitionID())


def input_file_name() -> Column:
    return Column(E.InputFileName())


def collect_list(c) -> Column:
    return _agg(E.CollectList(_to_col_expr(c)))


def collect_set(c) -> Column:
    return _agg(E.CollectSet(_to_col_expr(c)))


def stddev_samp(c) -> Column:
    return _agg(E.StddevSamp(_to_col_expr(c)))


stddev = stddev_samp


def stddev_pop(c) -> Column:
    return _agg(E.StddevPop(_to_col_expr(c)))


def var_samp(c) -> Column:
    return _agg(E.VarianceSamp(_to_col_expr(c)))


variance = var_samp


def var_pop(c) -> Column:
    return _agg(E.VariancePop(_to_col_expr(c)))


def min(c) -> Column:  # noqa: A001
    return _agg(E.Min(_to_col_expr(c)))


def max(c) -> Column:  # noqa: A001
    return _agg(E.Max(_to_col_expr(c)))


def first(c, ignorenulls: bool = False) -> Column:
    return _agg(E.First(_to_col_expr(c), ignorenulls))


def last(c, ignorenulls: bool = False) -> Column:
    return _agg(E.Last(_to_col_expr(c), ignorenulls))


def countDistinct(c) -> Column:
    return Column(E.AggregateExpression(E.Count([_to_col_expr(c)]),
                                        is_distinct=True))


# math
def sqrt(c) -> Column:
    return Column(E.Sqrt(_to_col_expr(c)))


def exp(c) -> Column:
    return Column(E.Exp(_to_col_expr(c)))


def log(c) -> Column:
    return Column(E.Log(_to_col_expr(c)))


def log10(c) -> Column:
    return Column(E.Log10(_to_col_expr(c)))


def abs(c) -> Column:  # noqa: A001
    return Column(E.Abs(_to_col_expr(c)))


def floor(c) -> Column:
    return Column(E.Floor(_to_col_expr(c)))


def ceil(c) -> Column:
    return Column(E.Ceil(_to_col_expr(c)))


def pow(a, b) -> Column:  # noqa: A001
    return Column(E.Pow(E.Cast(_to_col_expr(a), T.DoubleT),
                        E.Cast(_to_col_expr(b), T.DoubleT)))


def round(c, scale: int = 0) -> Column:  # noqa: A001
    return Column(E.Round(_to_col_expr(c), E.Literal(scale)))


def signum(c) -> Column:
    return Column(E.Signum(_to_col_expr(c)))


def sin(c) -> Column:
    return Column(E.Sin(_to_col_expr(c)))


def cos(c) -> Column:
    return Column(E.Cos(_to_col_expr(c)))


def tan(c) -> Column:
    return Column(E.Tan(_to_col_expr(c)))


# strings
def upper(c) -> Column:
    return Column(E.Upper(_to_col_expr(c)))


def lower(c) -> Column:
    return Column(E.Lower(_to_col_expr(c)))


def length(c) -> Column:
    return Column(E.Length(_to_col_expr(c)))


def trim(c) -> Column:
    return Column(E.StringTrim(_to_col_expr(c)))


def substring(c, pos: int, length_: int) -> Column:
    return Column(E.Substring(_to_col_expr(c), E.Literal(pos),
                              E.Literal(length_)))


def concat(*cols) -> Column:
    return Column(E.ConcatStr([_to_col_expr(c) for c in cols]))


# datetime
def year(c) -> Column:
    return Column(E.Year(_to_col_expr(c)))


def month(c) -> Column:
    return Column(E.Month(_to_col_expr(c)))


def dayofmonth(c) -> Column:
    return Column(E.DayOfMonth(_to_col_expr(c)))


def hour(c) -> Column:
    return Column(E.Hour(_to_col_expr(c)))


def minute(c) -> Column:
    return Column(E.Minute(_to_col_expr(c)))


def second(c) -> Column:
    return Column(E.Second(_to_col_expr(c)))


def date_add(c, days) -> Column:
    return Column(E.DateAdd(_to_col_expr(c), _to_col_expr(days)))


def date_sub(c, days) -> Column:
    return Column(E.DateSub(_to_col_expr(c), _to_col_expr(days)))


def datediff(end, start) -> Column:
    return Column(E.DateDiff(_to_col_expr(end), _to_col_expr(start)))


def hash(*cols) -> Column:  # noqa: A001
    return Column(E.Murmur3Hash([_to_col_expr(c) for c in cols]))


def xxhash64(*cols) -> Column:
    return Column(E.XxHash64([_to_col_expr(c) for c in cols]))


# collections / generators
def array(*cols) -> Column:
    return Column(E.CreateArray([_to_col_expr(c) for c in cols]))


def size(c) -> Column:
    return Column(E.Size(_to_col_expr(c)))


def element_at(c, idx) -> Column:
    return Column(E.ElementAt(_to_col_expr(c), _to_expr(idx)))


def array_contains(c, value) -> Column:
    return Column(E.ArrayContains(_to_col_expr(c), _to_expr(value)))


def explode(c) -> Column:
    return Column(E.Explode(_to_col_expr(c)))


def explode_outer(c) -> Column:
    return Column(E.Explode(_to_col_expr(c), outer=True))


def posexplode(c) -> Column:
    return Column(E.Explode(_to_col_expr(c), position=True))


def posexplode_outer(c) -> Column:
    return Column(E.Explode(_to_col_expr(c), position=True, outer=True))


# bitwise
def shiftleft(c, n) -> Column:
    return Column(E.ShiftLeft(_to_col_expr(c), _to_expr(n)))


def shiftright(c, n) -> Column:
    return Column(E.ShiftRight(_to_col_expr(c), _to_expr(n)))


def shiftrightunsigned(c, n) -> Column:
    return Column(E.ShiftRightUnsigned(_to_col_expr(c), _to_expr(n)))


def bitwise_not(c) -> Column:
    return Column(E.BitwiseNot(_to_col_expr(c)))


# more math
def log2(c) -> Column:
    return Column(E.Log2(_to_col_expr(c)))


def log1p(c) -> Column:
    return Column(E.Log1p(_to_col_expr(c)))


def expm1(c) -> Column:
    return Column(E.Expm1(_to_col_expr(c)))


def cbrt(c) -> Column:
    return Column(E.Cbrt(_to_col_expr(c)))


def rint(c) -> Column:
    return Column(E.Rint(_to_col_expr(c)))


def degrees(c) -> Column:
    return Column(E.ToDegrees(_to_col_expr(c)))


def radians(c) -> Column:
    return Column(E.ToRadians(_to_col_expr(c)))


def atan2(a, b) -> Column:
    return Column(E.Atan2(E.Cast(_to_col_expr(a), T.DoubleT),
                          E.Cast(_to_col_expr(b), T.DoubleT)))


def hypot(a, b) -> Column:
    return Column(E.Hypot(E.Cast(_to_col_expr(a), T.DoubleT),
                          E.Cast(_to_col_expr(b), T.DoubleT)))


def greatest(*cols) -> Column:
    return Column(E.Greatest([_to_col_expr(c) for c in cols]))


def least(*cols) -> Column:
    return Column(E.Least([_to_col_expr(c) for c in cols]))


# more strings
def concat_ws(sep: str, *cols) -> Column:
    return Column(E.ConcatWs([E.Literal(sep)]
                             + [_to_col_expr(c) for c in cols]))


def repeat(c, n: int) -> Column:
    return Column(E.StringRepeat(_to_col_expr(c), E.Literal(n)))


def lpad(c, length_: int, pad: str) -> Column:
    return Column(E.StringLPad(_to_col_expr(c), E.Literal(length_),
                               E.Literal(pad)))


def rpad(c, length_: int, pad: str) -> Column:
    return Column(E.StringRPad(_to_col_expr(c), E.Literal(length_),
                               E.Literal(pad)))


def translate(c, matching: str, replace: str) -> Column:
    return Column(E.StringTranslate(_to_col_expr(c), E.Literal(matching),
                                    E.Literal(replace)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    # literal (non-regex) patterns only would be StringReplace; the
    # regex engine is not implemented yet
    raise NotImplementedError("regexp_replace is not implemented")


def replace(c, search, replacement="") -> Column:
    return Column(E.StringReplace(_to_col_expr(c), _to_expr(search),
                                  _to_expr(replacement)))


def instr(c, substr: str) -> Column:
    return Column(E.StringInstr(_to_col_expr(c), E.Literal(substr)))


def locate(substr: str, c, pos: int = 1) -> Column:
    return Column(E.StringLocate(E.Literal(substr), _to_col_expr(c),
                                 E.Literal(pos)))


def split(c, pattern: str, limit: int = -1) -> Column:
    return Column(E.StringSplit(_to_col_expr(c), E.Literal(pattern),
                                E.Literal(limit)))


def regexp_replace(c, pattern: str, replacement: str) -> Column:
    return Column(E.RegExpReplace(_to_col_expr(c), E.Literal(pattern),
                                  E.Literal(replacement)))


def regexp_extract(c, pattern: str, idx: int) -> Column:
    return Column(E.RegExpExtract(_to_col_expr(c), E.Literal(pattern),
                                  E.Literal(idx)))


def initcap(c) -> Column:
    return Column(E.InitCap(_to_col_expr(c)))


def reverse(c) -> Column:
    return Column(E.StringReverse(_to_col_expr(c)))


def ltrim(c) -> Column:
    return Column(E.StringTrimLeft(_to_col_expr(c)))


def rtrim(c) -> Column:
    return Column(E.StringTrimRight(_to_col_expr(c)))


def ascii(c) -> Column:
    return Column(E.Ascii(_to_col_expr(c)))


def chr(c) -> Column:  # noqa: A001
    return Column(E.Chr(_to_col_expr(c)))


# more datetime
def quarter(c) -> Column:
    return Column(E.Quarter(_to_col_expr(c)))


def dayofweek(c) -> Column:
    return Column(E.DayOfWeek(_to_col_expr(c)))


def weekday(c) -> Column:
    return Column(E.WeekDay(_to_col_expr(c)))


def dayofyear(c) -> Column:
    return Column(E.DayOfYear(_to_col_expr(c)))


def weekofyear(c) -> Column:
    return Column(E.WeekOfYear(_to_col_expr(c)))


def last_day(c) -> Column:
    return Column(E.LastDay(_to_col_expr(c)))


def add_months(c, months) -> Column:
    return Column(E.AddMonths(_to_col_expr(c), _to_expr(months)))


def months_between(end, start) -> Column:
    return Column(E.MonthsBetween(_to_col_expr(end), _to_col_expr(start)))


def trunc(c, fmt: str) -> Column:
    return Column(E.TruncDate(_to_col_expr(c), E.Literal(fmt)))


def date_format(c, fmt: str) -> Column:
    return Column(E.DateFormatClass(_to_col_expr(c), E.Literal(fmt)))


def unix_timestamp(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    return Column(E.UnixTimestamp(_to_col_expr(c), E.Literal(fmt)))


def from_unixtime(c, fmt: str = "yyyy-MM-dd HH:mm:ss") -> Column:
    return Column(E.FromUnixTime(_to_col_expr(c), E.Literal(fmt)))


def to_date(c, fmt: Optional[str] = None) -> Column:
    if fmt is None:
        return Column(E.Cast(_to_col_expr(c), T.DateT))
    return Column(E.Cast(E.GetTimestamp(_to_col_expr(c), E.Literal(fmt)),
                         T.DateT))


def to_timestamp(c, fmt: Optional[str] = None) -> Column:
    if fmt is None:
        return Column(E.Cast(_to_col_expr(c), T.TimestampT))
    return Column(E.GetTimestamp(_to_col_expr(c), E.Literal(fmt)))


# ---------------------------------------------------------------------------
# Window API (pyspark.sql.window.Window / WindowSpec shape)
# ---------------------------------------------------------------------------

class WindowSpec:
    def __init__(self, partition_spec=None, order_spec=None, frame=None):
        self._partition = list(partition_spec or [])
        self._order = list(order_spec or [])
        self._frame = frame

    def partitionBy(self, *cols) -> "WindowSpec":
        exprs = [_to_expr(c if not isinstance(c, str) else col(c))
                 for c in cols]
        return WindowSpec(exprs, self._order, self._frame)

    def orderBy(self, *cols) -> "WindowSpec":
        order = []
        for c in cols:
            e = _to_expr(c if not isinstance(c, str) else col(c))
            order.append(e if isinstance(e, E.SortOrder)
                         else E.SortOrder(e, ascending=True))
        return WindowSpec(self._partition, order, self._frame)

    def rowsBetween(self, start: int, end: int) -> "WindowSpec":
        lo = None if start <= Window.unboundedPreceding else int(start)
        hi = None if end >= Window.unboundedFollowing else int(end)
        return WindowSpec(self._partition, self._order,
                          E.WindowFrame("rows", lo, hi))

    def rangeBetween(self, start: int, end: int) -> "WindowSpec":
        lo = None if start <= Window.unboundedPreceding else int(start)
        hi = None if end >= Window.unboundedFollowing else int(end)
        # (None, 0) is the running-with-peers frame; any finite offset
        # makes a VALUE-bounded range frame (requires a single numeric
        # order expression, checked at evaluation like Spark's
        # RangeFrame resolution)
        return WindowSpec(self._partition, self._order,
                          E.WindowFrame("range", lo, hi))


class Window:
    """pyspark.sql.Window twin (static constructors)."""

    unboundedPreceding = -(1 << 63)
    unboundedFollowing = (1 << 63)
    currentRow = 0

    @staticmethod
    def partitionBy(*cols) -> WindowSpec:
        return WindowSpec().partitionBy(*cols)

    @staticmethod
    def orderBy(*cols) -> WindowSpec:
        return WindowSpec().orderBy(*cols)

    @staticmethod
    def rowsBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rowsBetween(start, end)

    @staticmethod
    def rangeBetween(start: int, end: int) -> WindowSpec:
        return WindowSpec().rangeBetween(start, end)


def row_number() -> Column:
    return Column(E.RowNumber())


def rank() -> Column:
    return Column(E.Rank())


def dense_rank() -> Column:
    return Column(E.DenseRank())


def ntile(n: int) -> Column:
    return Column(E.NTile(int(n)))


def lag(c, offset: int = 1, default=None) -> Column:
    e = _to_expr(col(c) if isinstance(c, str) else c)
    d = None if default is None else _to_expr(lit(default))
    return Column(E.Lag(e, int(offset), d))


def lead(c, offset: int = 1, default=None) -> Column:
    e = _to_expr(col(c) if isinstance(c, str) else c)
    d = None if default is None else _to_expr(lit(default))
    return Column(E.Lead(e, int(offset), d))


def pandas_udf(f=None, returnType=None):
    """pyspark.sql.functions.pandas_udf twin (SCALAR evalType): the
    function receives pandas Series and returns a Series. Evaluated
    vectorized through the python worker pool (Arrow IPC) by
    ArrowEvalPythonExec — on the TPU session the surrounding plan stays
    on device (GpuArrowEvalPythonExec.scala:487 role)."""
    if f is not None and not callable(f):
        f, returnType = None, f
    if returnType is None:
        # pyspark requires a return type for SCALAR pandas UDFs too —
        # silently defaulting would coerce results to the wrong type
        raise ValueError("pandas_udf requires a returnType, e.g. "
                         "@pandas_udf('long')")
    rt = _parse_type(returnType)

    def wrap(fn):
        def call(*cols) -> Column:
            exprs = [_to_expr(col(c) if isinstance(c, str) else c)
                     for c in cols]
            return Column(E.PandasUDF(
                fn, getattr(fn, "__name__", "pandas_udf"), rt, exprs))
        return call
    if f is not None:
        return wrap(f)
    return wrap


def udf(f=None, returnType=None):
    """pyspark.sql.functions.udf twin: a host-evaluated Python UDF. The
    plan rewrite reports it NOT_ON_GPU (same placement the reference
    gives un-compiled UDFs; its udf-compiler translates a Scala subset —
    arbitrary Python bodies stay on the CPU here too)."""
    # pyspark form @udf("int"): a non-callable first positional arg is
    # the return type
    if f is not None and not callable(f):
        f, returnType = None, f
    rt = _parse_type(returnType) if returnType is not None else T.StringT

    def wrap(fn):
        def call(*cols) -> Column:
            exprs = [_to_expr(col(c) if isinstance(c, str) else c)
                     for c in cols]
            return Column(E.PythonUDF(fn, getattr(fn, "__name__", "udf"),
                                      rt, exprs))
        return call
    if f is not None:
        return wrap(f)
    return wrap
