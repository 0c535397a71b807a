"""SQL text -> logical plan (the role Spark's Catalyst parser plays for
the reference, which inherits it for free; this build supplies its own).

Hand-written tokenizer + recursive-descent parser covering the dialect
the engine executes: SELECT [DISTINCT] ... FROM (tables, subqueries,
joins) WHERE / GROUP BY / HAVING / ORDER BY / LIMIT, UNION ALL, CASE,
CAST, IN/LIKE/BETWEEN/IS NULL, window functions with OVER, and the
engine's function library. Expressions are built through the Column API
(spark_rapids_tpu_torch.sql.functions) so SQL gets exactly the same coercion
rules as the DataFrame surface.

Aggregation follows Spark's analyzer shape: aggregate subtrees in the
select/having lists are extracted into an Aggregate node and the select
list becomes a Project over its output.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import logical as L
from spark_rapids_tpu_torch.sql.functions import Column, WindowSpec, _parse_type

# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|\d+(?:[eE][-+]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<qid>`[^`]+`|"[^"]+")
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><=|>=|<>|!=|==|\|\||[-+*/%=<>(),.])
""", re.VERBOSE)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"SQL syntax error near: {text[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "id":
            out.append(("id", val))
        elif kind == "qid":
            out.append(("id", val[1:-1]))
        else:
            out.append((kind, val))
    out.append(("eof", ""))
    return out


_JOIN_TYPES = {
    ("inner",): "inner", ("cross",): "cross",
    ("left",): "left", ("left", "outer"): "left",
    ("right",): "right", ("right", "outer"): "right",
    ("full",): "full", ("full", "outer"): "full",
    ("left", "semi"): "leftsemi", ("left", "anti"): "leftanti",
    ("semi",): "leftsemi", ("anti",): "leftanti",
}

_RESERVED_AFTER_RELATION = {
    "where", "group", "having", "order", "limit", "union", "on", "join",
    "inner", "left", "right", "full", "cross", "semi", "anti", "outer",
}


class _Parser:
    def __init__(self, text: str, session=None):
        self.toks = _tokenize(text)
        self.i = 0
        self.session = session

    # -- token helpers -----------------------------------------------------

    def peek(self, k: int = 0) -> Tuple[str, str]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def kw(self, *words: str) -> bool:
        """Consume the keyword sequence if present (case-insensitive)."""
        for k, w in enumerate(words):
            kind, val = self.peek(k)
            if kind != "id" or val.lower() != w:
                return False
        self.i += len(words)
        return True

    def at_kw(self, word: str) -> bool:
        kind, val = self.peek()
        return kind == "id" and val.lower() == word

    def expect(self, tok: str) -> str:
        kind, val = self.next()
        if val.lower() != tok and kind != tok:
            raise ValueError(f"expected {tok!r}, got {val!r}")
        return val

    # -- query -------------------------------------------------------------

    def query(self):
        """select_core (UNION [ALL] select_core)* [ORDER BY] [LIMIT] —
        a trailing ORDER BY/LIMIT binds to the WHOLE union (SQL spec),
        not the last branch."""
        df = self.select_stmt()
        while self.kw("union"):
            all_ = self.kw("all")
            right = self.select_stmt()
            df = df.union(right)
            if not all_:
                df = df.distinct()
        if self.kw("order", "by"):
            df = df.orderBy(*self._order_list())
        if self.kw("limit"):
            kind, val = self.next()
            assert kind == "num", f"LIMIT expects a number, got {val!r}"
            df = df.limit(int(val))
        return df

    def select_stmt(self):
        self.expect("select")
        distinct = self.kw("distinct")
        items: List[Tuple[Optional[Column], Optional[str]]] = []
        while True:
            if self.peek()[1] == "*":
                self.next()
                items.append((None, None))  # star
            else:
                c = self.expr()
                name = self._opt_alias()
                items.append((c, name))
            if self.peek()[1] == ",":
                self.next()
                continue
            break
        self.expect("from")
        df = self.from_clause()
        if self.kw("where"):
            df = df.filter(self.expr())
        group: Optional[List[Column]] = None
        if self.kw("group", "by"):
            group = [self.expr()]
            while self.peek()[1] == ",":
                self.next()
                group.append(self.expr())
        having = self.expr() if self.kw("having") else None
        df = self._project(df, items, group, having)
        # DISTINCT applies to the projected rows (ORDER BY/LIMIT are
        # parsed by query(), after any UNION branches)
        if distinct:
            df = df.distinct()
        return df

    def _opt_alias(self) -> Optional[str]:
        if self.kw("as"):
            return self.next()[1]
        kind, val = self.peek()
        if kind == "id" and val.lower() not in _RESERVED_AFTER_RELATION \
                and val.lower() not in ("from", "as"):
            # bare alias only valid in select list before , or FROM
            nk = self.peek(1)[1]
            if nk in (",",) or self.peek(1)[0] == "eof" \
                    or (self.peek(1)[0] == "id"
                        and self.peek(1)[1].lower() == "from") \
                    or nk == ")":
                self.next()
                return val
        return None

    def _order_list(self) -> List[Column]:
        out: List[Column] = []
        while True:
            c = self.expr()
            asc = True
            if self.kw("asc"):
                asc = True
            elif self.kw("desc"):
                asc = False
            nulls_first = None
            if self.kw("nulls", "first"):
                nulls_first = True
            elif self.kw("nulls", "last"):
                nulls_first = False
            out.append(Column(E.SortOrder(c.expr, asc, nulls_first)))
            if self.peek()[1] == ",":
                self.next()
                continue
            return out

    # -- FROM / joins ------------------------------------------------------

    def from_clause(self):
        df = self.relation()
        while True:
            jt = None
            for words, how in _JOIN_TYPES.items():
                if self.kw(*words, "join"):
                    jt = how
                    break
            if jt is None:
                if self.kw("join"):
                    jt = "inner"
                else:
                    break
            right = self.relation()
            cond = self.expr() if self.kw("on") else None
            df = df.join(right, on=cond, how=jt)
        return df

    def relation(self):
        if self.peek()[1] == "(":
            self.next()
            df = self.query()
            self.expect(")")
            alias = self._relation_alias()
            return df.alias(alias) if alias else df
        kind, name = self.next()
        assert kind == "id", f"expected table name, got {name!r}"
        df = self.session.table(name)
        alias = self._relation_alias()
        return df.alias(alias) if alias else df

    def _relation_alias(self) -> Optional[str]:
        if self.kw("as"):
            return self.next()[1]
        kind, val = self.peek()
        if kind == "id" and val.lower() not in _RESERVED_AFTER_RELATION:
            self.next()
            return val
        return None

    # -- aggregation shaping ----------------------------------------------

    def _project(self, df, items, group: Optional[List[Column]],
                 having: Optional[Column]):
        from spark_rapids_tpu_torch.sql.dataframe import DataFrame

        def has_group_agg(e: E.Expression) -> bool:
            """Aggregate NOT under an OVER clause (window aggs project)."""
            if isinstance(e, E.WindowExpression):
                return False
            if isinstance(e, E.AggregateExpression):
                return True
            return any(has_group_agg(c) for c in e.children)

        resolved: List[Tuple[Optional[E.Expression], Optional[str]]] = []
        has_agg = False
        for c, name in items:
            if c is None:
                resolved.append((None, None))
                continue
            e = df._resolve(c)
            if has_group_agg(e):
                has_agg = True
            resolved.append((e, name))
        having_e = df._resolve(having) if having is not None else None
        if having_e is not None and has_group_agg(having_e):
            has_agg = True

        if group is None and not has_agg:
            cols = []
            for e, name in resolved:
                if e is None:
                    cols.extend(Column(a) for a in df.plan.output)
                else:
                    cols.append(Column(e).alias(name) if name
                                else Column(e))
            return df.select(*cols)

        # Aggregate + Project (Spark analyzer shape)
        group_exprs = [df._resolve(g) for g in (group or [])]
        grouping: List[E.Expression] = []
        group_attr_by_repr = {}
        for g in group_exprs:
            if isinstance(g, E.AttributeReference):
                grouping.append(g)
                group_attr_by_repr[repr(g)] = g
            else:
                alias = E.Alias(g, f"_g{len(grouping)}")
                grouping.append(alias)
                group_attr_by_repr[repr(g)] = alias.to_attribute()
        agg_aliases: List[E.Expression] = []

        def extract(e: E.Expression) -> E.Expression:
            """Replace agg subtrees (and grouping-expr matches) with
            attribute refs into the Aggregate's output."""
            rg = group_attr_by_repr.get(repr(e))
            if rg is not None:
                return rg

            def rule(x):
                if isinstance(x, E.AggregateExpression):
                    alias = E.Alias(x, f"_a{len(agg_aliases)}")
                    agg_aliases.append(alias)
                    return alias.to_attribute()
                return None
            return e.transform(rule)

        out_items: List[E.Expression] = []
        for e, name in resolved:
            assert e is not None, "SELECT * is not valid with GROUP BY"
            r = extract(e)
            if name:
                r = E.Alias(r, name)
            elif not isinstance(r, (E.AttributeReference, E.Alias)):
                r = E.Alias(r, _sql_name(e))
            out_items.append(r)
        having_r = extract(having_e) if having_e is not None else None

        plan = L.Aggregate(list(grouping),
                           list(grouping) + agg_aliases, df.plan)
        out = DataFrame(plan, df.session)
        if having_r is not None:
            out = DataFrame(L.Filter(having_r, out.plan), out.session)
        return out.select(*[Column(e) for e in out_items])

    # -- expressions -------------------------------------------------------

    def expr(self) -> Column:
        return self.or_expr()

    def or_expr(self) -> Column:
        left = self.and_expr()
        while self.kw("or"):
            left = left | self.and_expr()
        return left

    def and_expr(self) -> Column:
        left = self.not_expr()
        while self.kw("and"):
            left = left & self.not_expr()
        return left

    def not_expr(self) -> Column:
        if self.kw("not"):
            return ~self.not_expr()
        return self.comparison()

    def comparison(self) -> Column:
        left = self.add_expr()
        while True:
            kind, val = self.peek()
            if val in ("=", "=="):
                self.next()
                left = left == self.add_expr()
            elif val in ("!=", "<>"):
                self.next()
                left = left != self.add_expr()
            elif val == "<":
                self.next()
                left = left < self.add_expr()
            elif val == "<=":
                self.next()
                left = left <= self.add_expr()
            elif val == ">":
                self.next()
                left = left > self.add_expr()
            elif val == ">=":
                self.next()
                left = left >= self.add_expr()
            elif self.kw("is", "not", "null"):
                left = left.isNotNull()
            elif self.kw("is", "null"):
                left = left.isNull()
            elif self.kw("not", "in"):
                left = ~self._in_list(left)
            elif self.at_kw("in"):
                self.kw("in")
                left = self._in_list(left)
            elif self.kw("not", "like"):
                left = ~left.like(self._string_lit())
            elif self.kw("like"):
                left = left.like(self._string_lit())
            elif self.kw("not", "rlike"):
                left = ~left.rlike(self._string_lit())
            elif self.kw("rlike") or self.kw("regexp"):
                left = left.rlike(self._string_lit())
            elif self.kw("not", "between"):
                lo = self.add_expr()
                self.expect("and")
                left = ~left.between(lo, self.add_expr())
            elif self.kw("between"):
                lo = self.add_expr()
                self.expect("and")
                left = left.between(lo, self.add_expr())
            else:
                return left

    def _in_list(self, left: Column) -> Column:
        self.expect("(")
        vals = [self._literal_value()]
        while self.peek()[1] == ",":
            self.next()
            vals.append(self._literal_value())
        self.expect(")")
        return left.isin(*vals)

    def _literal_value(self):
        kind, val = self.next()
        if kind == "op" and val in ("-", "+"):
            sign = -1 if val == "-" else 1
            kind, val = self.next()
            assert kind == "num", f"expected number after {val!r}"
            return sign * (float(val) if any(c in val for c in ".eE")
                           else int(val))
        if kind == "num":
            return float(val) if any(c in val for c in ".eE") else int(val)
        if kind == "str":
            return val[1:-1].replace("''", "'")
        if kind == "id" and val.lower() in ("true", "false"):
            return val.lower() == "true"
        raise ValueError(f"expected literal in IN list, got {val!r}")

    def _string_lit(self) -> str:
        kind, val = self.next()
        assert kind == "str", f"expected string literal, got {val!r}"
        return val[1:-1].replace("''", "'")

    def add_expr(self) -> Column:
        left = self.mul_expr()
        while True:
            kind, val = self.peek()
            if val == "+":
                self.next()
                left = left + self.mul_expr()
            elif val == "-":
                self.next()
                left = left - self.mul_expr()
            elif val == "||":
                self.next()
                left = F.concat(left, self.mul_expr())
            else:
                return left

    def mul_expr(self) -> Column:
        left = self.unary()
        while True:
            kind, val = self.peek()
            if val == "*":
                self.next()
                left = left * self.unary()
            elif val == "/":
                self.next()
                left = left / self.unary()
            elif val == "%":
                self.next()
                left = left % self.unary()
            else:
                return left

    def unary(self) -> Column:
        kind, val = self.peek()
        if val == "-":
            self.next()
            return -self.unary()
        if val == "+":
            self.next()
            return self.unary()
        return self.primary()

    def primary(self) -> Column:
        kind, val = self.peek()
        if val == "(":
            if self.peek(1)[1].lower() == "select":
                # uncorrelated scalar subquery (Catalyst ScalarSubquery;
                # materialized to a Literal before physical planning)
                self.next()
                sub = self.query()
                self.expect(")")
                out = sub.plan.output
                if len(out) != 1:
                    raise ValueError(
                        "scalar subquery must return one column, got "
                        f"{len(out)}")
                return Column(E.ScalarSubquery(sub.plan,
                                               out[0].data_type))
            self.next()
            c = self.expr()
            self.expect(")")
            return c
        if kind == "num":
            self.next()
            v = float(val) if any(ch in val for ch in ".eE") else int(val)
            return F.lit(v)
        if kind == "str":
            self.next()
            return F.lit(val[1:-1].replace("''", "'"))
        if kind != "id":
            raise ValueError(f"unexpected token {val!r}")
        low = val.lower()
        if low == "null":
            self.next()
            return Column(E.Literal(None))
        if low in ("true", "false"):
            self.next()
            return F.lit(low == "true")
        if low == "case":
            return self._case()
        if low in ("date", "timestamp") and self.peek(1)[0] == "str":
            # ANSI typed literals: DATE '1998-09-02' (Spark AstBuilder
            # visitTypeConstructor semantics = cast of the string)
            self.next()
            s = self._string_lit()
            from spark_rapids_tpu_torch.sql import types as T
            return Column(E.Cast(
                E.Literal(s),
                T.DateT if low == "date" else T.TimestampT))
        if low == "cast":
            self.next()
            self.expect("(")
            c = self.expr()
            self.expect("as")
            tp = self._type_name()
            self.expect(")")
            return Column(E.Cast(c.expr, _parse_type(tp)))
        if self.peek(1)[1] == "(":
            return self._function_call()
        # column reference; qualified names keep every dotted part — the
        # resolver matches relation aliases then walks struct fields
        # (Catalyst's resolution order)
        self.next()
        parts = [val]
        while self.peek()[1] == "." and self.peek(1)[0] == "id":
            self.next()
            parts.append(self.next()[1])
        return F.col(".".join(parts))

    def _type_name(self) -> str:
        parts = [self.next()[1]]
        if self.peek()[1] == "(":
            while True:
                _, v = self.next()
                parts.append(v)
                if v == ")":
                    break
        return "".join(parts)

    def _case(self) -> Column:
        self.kw("case")
        simple = None
        if not self.at_kw("when"):
            simple = self.expr()
        branches = []
        while self.kw("when"):
            cond = self.expr()
            if simple is not None:
                cond = simple == cond
            self.expect("then")
            branches.append((cond.expr, self.expr().expr))
        default = self.expr().expr if self.kw("else") else None
        self.expect("end")
        return Column(E.CaseWhen(branches, default))

    def _function_call(self) -> Column:
        _, name = self.next()
        low = name.lower()
        self.expect("(")
        distinct = self.kw("distinct")
        args: List[Column] = []
        star = False
        if self.peek()[1] == "*":
            self.next()
            star = True
        elif self.peek()[1] != ")":
            args.append(self.expr())
            while self.peek()[1] == ",":
                self.next()
                args.append(self.expr())
        self.expect(")")
        c = self._build_function(low, args, star, distinct)
        if self.kw("over"):
            c = c.over(self._window_spec())
        return c

    def _window_spec(self) -> WindowSpec:
        self.expect("(")
        spec = WindowSpec()
        if self.kw("partition", "by"):
            parts = [self.expr()]
            while self.peek()[1] == ",":
                self.next()
                parts.append(self.expr())
            spec = spec.partitionBy(*parts)
        if self.kw("order", "by"):
            spec = spec.orderBy(*self._order_list())
        if self.kw("rows", "between"):
            lo = self._frame_bound()
            self.expect("and")
            hi = self._frame_bound()
            spec = spec.rowsBetween(lo, hi)
        self.expect(")")
        return spec

    def _frame_bound(self) -> int:
        if self.kw("unbounded", "preceding"):
            return F.Window.unboundedPreceding
        if self.kw("unbounded", "following"):
            return F.Window.unboundedFollowing
        if self.kw("current", "row"):
            return 0
        kind, val = self.next()
        assert kind == "num", f"bad frame bound {val!r}"
        n = int(val)
        if self.kw("preceding"):
            return -n
        self.expect("following")
        return n

    def _build_function(self, low: str, args: List[Column], star: bool,
                        distinct: bool) -> Column:
        if low == "count":
            if star or not args:
                return F.count("*")
            # multi-arg count: rows where ALL args are non-null
            c = Column(E.AggregateExpression(
                E.Count([a.expr for a in args]), is_distinct=distinct))
            return c
        if low == "if":
            return F.when(args[0], args[1]).otherwise(args[2])
        if low in ("nvl", "ifnull"):
            return F.coalesce(*args)
        if low in ("substr", "substring"):
            return F.substring(args[0],
                               int(_lit_value(args[1])),
                               int(_lit_value(args[2])))
        if low in ("power",):
            low = "pow"
        if low in ("mean",):
            low = "avg"
        if low in ("day",):
            low = "dayofmonth"
        if low in ("ucase",):
            low = "upper"
        if low in ("lcase",):
            low = "lower"
        fn = _FUNCTIONS.get(low)
        if fn is None:
            raise ValueError(f"unknown SQL function {low!r}")
        c = fn(*args)
        if distinct:
            # sum(DISTINCT x) etc. — flag the AggregateExpression; the
            # planner's dedup-then-aggregate rewrite executes it
            if not isinstance(c.expr, E.AggregateExpression):
                raise ValueError(
                    f"DISTINCT is not valid for function {low!r}")
            c = Column(E.AggregateExpression(c.expr.func, is_distinct=True))
        return c


def _lit_value(c: Column):
    assert isinstance(c.expr, E.Literal), \
        f"expected a literal argument, got {c.expr!r}"
    return c.expr.value


def _sql_name(e: E.Expression) -> str:
    return repr(e)[:60]


_FUNCTIONS = {
    "sum": F.sum, "avg": F.avg, "min": F.min, "max": F.max,
    "first": F.first, "last": F.last,
    "collect_list": F.collect_list, "collect_set": F.collect_set,
    "monotonically_increasing_id": F.monotonically_increasing_id,
    "window": lambda c, *a: F.window(c, *[_lit_value(x) for x in a]),
    "spark_partition_id": F.spark_partition_id,
    "input_file_name": F.input_file_name,
    "stddev": F.stddev_samp, "stddev_samp": F.stddev_samp,
    "std": F.stddev_samp, "stddev_pop": F.stddev_pop,
    "variance": F.var_samp, "var_samp": F.var_samp,
    "var_pop": F.var_pop,
    "abs": F.abs, "sqrt": F.sqrt, "exp": F.exp, "log": F.log,
    "ln": F.log, "log10": F.log10, "floor": F.floor, "ceil": F.ceil,
    "ceiling": F.ceil, "pow": F.pow, "round": F.round,
    "signum": F.signum, "sign": F.signum, "sin": F.sin, "cos": F.cos,
    "tan": F.tan, "upper": F.upper, "lower": F.lower,
    "length": F.length, "char_length": F.length, "trim": F.trim,
    "concat": F.concat, "coalesce": F.coalesce, "isnull": F.isnull,
    "isnan": F.isnan, "year": F.year, "month": F.month,
    "dayofmonth": F.dayofmonth, "hour": F.hour, "minute": F.minute,
    "second": F.second, "date_add": F.date_add, "date_sub": F.date_sub,
    "datediff": F.datediff, "hash": F.hash, "xxhash64": F.xxhash64,
    "array": F.array, "size": F.size, "element_at": F.element_at,
    "array_contains": F.array_contains, "explode": F.explode,
    "explode_outer": F.explode_outer, "posexplode": F.posexplode,
    "posexplode_outer": F.posexplode_outer,
    "shiftleft": F.shiftleft, "shiftright": F.shiftright,
    "shiftrightunsigned": F.shiftrightunsigned,
    "log2": F.log2, "log1p": F.log1p, "expm1": F.expm1, "cbrt": F.cbrt,
    "rint": F.rint, "degrees": F.degrees, "radians": F.radians,
    "atan2": F.atan2, "hypot": F.hypot,
    "greatest": F.greatest, "least": F.least,
    "concat_ws": lambda sep, *cols: F.concat_ws(_lit_value(sep), *cols),
    "repeat": lambda c, n: F.repeat(c, int(_lit_value(n))),
    "lpad": lambda c, n, p: F.lpad(c, int(_lit_value(n)), _lit_value(p)),
    "rpad": lambda c, n, p: F.rpad(c, int(_lit_value(n)), _lit_value(p)),
    "translate": lambda c, m, r: F.translate(c, _lit_value(m),
                                             _lit_value(r)),
    "replace": F.replace, "instr": lambda c, s: F.instr(c, _lit_value(s)),
    "locate": lambda s, c, *p: F.locate(
        _lit_value(s), c, *[int(_lit_value(x)) for x in p]),
    "initcap": F.initcap, "reverse": F.reverse,
    "split": lambda c, p, *l: F.split(c, _lit_value(p),
                                      *[int(_lit_value(x)) for x in l]),
    "regexp_replace": lambda c, p, r: F.regexp_replace(
        c, _lit_value(p), _lit_value(r)),
    "regexp_extract": lambda c, p, i: F.regexp_extract(
        c, _lit_value(p), int(_lit_value(i))),
    "ltrim": F.ltrim, "rtrim": F.rtrim,
    "ascii": F.ascii, "char": F.chr, "chr": F.chr,
    "quarter": F.quarter, "dayofweek": F.dayofweek,
    "weekday": F.weekday, "dayofyear": F.dayofyear,
    "weekofyear": F.weekofyear, "last_day": F.last_day,
    "add_months": F.add_months, "months_between": F.months_between,
    "trunc": lambda c, f: F.trunc(c, _lit_value(f)),
    "date_format": lambda c, f: F.date_format(c, _lit_value(f)),
    "unix_timestamp": lambda c, *f: F.unix_timestamp(
        c, *[_lit_value(x) for x in f]),
    "from_unixtime": lambda c, *f: F.from_unixtime(
        c, *[_lit_value(x) for x in f]),
    "to_date": lambda c, *f: F.to_date(c, *[_lit_value(x) for x in f]),
    "to_timestamp": lambda c, *f: F.to_timestamp(
        c, *[_lit_value(x) for x in f]),
    "row_number": F.row_number, "rank": F.rank,
    "dense_rank": F.dense_rank, "ntile": lambda n: F.ntile(
        int(_lit_value(n))),
    "lag": lambda c, *a: F.lag(c, *[int(_lit_value(x)) if i == 0
                                    else _lit_value(x)
                                    for i, x in enumerate(a)]),
    "lead": lambda c, *a: F.lead(c, *[int(_lit_value(x)) if i == 0
                                      else _lit_value(x)
                                      for i, x in enumerate(a)]),
}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def parse_expression(text: str) -> E.Expression:
    """One expression (selectExpr / string filter)."""
    p = _Parser(text)
    c = p.expr()
    name = p._opt_alias()
    kind, _ = p.peek()
    if kind != "eof":
        raise ValueError(f"trailing tokens in expression: {text!r}")
    e = c.expr
    if name:
        e = E.Alias(e, name)
    return e


def parse_sql(query: str, session):
    """Full SELECT statement -> DataFrame."""
    p = _Parser(query, session)
    df = p.query()
    kind, val = p.peek()
    if kind != "eof":
        raise ValueError(f"trailing tokens near {val!r}")
    return df
