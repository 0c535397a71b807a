"""udf-compiler: translate simple Python lambdas into Catalyst-style
expression trees (the port's copy of ``spark_rapids_tpu.udf_compiler``;
the reference's udf-compiler module,
udf-compiler/src/main/scala/com/nvidia/spark/udf/
CatalystExpressionBuilder.scala:29-43, re-based on CPython bytecode).

A tiny symbolic executor walks ``dis`` instructions with a stack of
Column objects, so every arithmetic/comparison/conditional the lambda
performs is rebuilt through the SAME operator overloads user queries go
through — type coercion (decimal rules included) comes for free, and
the resulting tree runs wherever any expression runs, device included.

Scope (v1): arithmetic (+ - * / and % with Python's
sign-follows-divisor semantics built from SQL Remainder), comparisons,
boolean and/or/not, ternary conditionals, LOCAL VARIABLES
(STORE_FAST/LOAD_FAST dataflow, per-branch scoped), builtin calls
(abs/min/max/len/float), ``math.*`` calls, and string methods
(upper/lower/strip/lstrip/rstrip/startswith/endswith/replace). Anything
else (loops, subscripts, other calls) makes ``compile_udf`` return None
and the UDF stays a row-at-a-time Python evaluation — the same
silent-fallback contract as the reference (Plugin.scala:27-37).

Note the documented semantic shift the reference also makes: a compiled
UDF gets SQL NULL semantics (null propagates through operators; min/max
become Least/Greatest, which SKIP nulls) instead of Python's None
handling inside the lambda (which would raise TypeError).
"""

from __future__ import annotations

import dis
from typing import Dict, List, Optional

from spark_rapids_tpu_torch.sql import expressions as E
from spark_rapids_tpu_torch.sql import types as T


class _Unsupported(Exception):
    pass


_SKIP_OPS = {"RESUME", "CACHE", "NOP", "PRECALL", "COPY_FREE_VARS",
             "MAKE_CELL", "TO_BOOL", "NOT_TAKEN"}


def compile_udf(fn, arg_exprs: List[E.Expression],
                return_type: T.DataType) -> Optional[E.Expression]:
    """Expression tree equivalent of ``fn(*arg_exprs)``, or None when
    the lambda uses anything beyond the supported subset."""
    from spark_rapids_tpu_torch.sql.functions import Column
    try:
        code = fn.__code__
    except AttributeError:
        return None
    if code.co_argcount != len(arg_exprs) or code.co_kwonlyargcount:
        return None
    params: Dict[str, Column] = {
        name: Column(e)
        for name, e in zip(code.co_varnames, arg_exprs)}
    instrs = list(dis.get_instructions(fn))
    by_offset = {ins.offset: i for i, ins in enumerate(instrs)}
    try:
        out = _exec(instrs, by_offset, 0, [], params,
                    getattr(fn, "__globals__", {}))
    except (_Unsupported, IndexError, KeyError, TypeError,
            AttributeError):
        return None
    if not isinstance(out, Column):
        return None
    expr = out.expr
    try:
        if expr.data_type != return_type:
            expr = E.Cast(expr, return_type)
    except Exception:
        return None
    return expr


_NULL = object()  # the NULL slot LOAD_GLOBAL/PUSH_NULL leave for CALL

# Python <= 3.10 per-operator bytecodes (3.11+ folded them into
# BINARY_OP); '//' intentionally absent, see the BINARY_OP note
_LEGACY_BINOPS = {
    "BINARY_ADD": "+", "INPLACE_ADD": "+",
    "BINARY_SUBTRACT": "-", "INPLACE_SUBTRACT": "-",
    "BINARY_MULTIPLY": "*", "INPLACE_MULTIPLY": "*",
    "BINARY_TRUE_DIVIDE": "/", "INPLACE_TRUE_DIVIDE": "/",
    "BINARY_MODULO": "%", "INPLACE_MODULO": "%",
}


def _py_mod(a, b):
    """Python's sign-follows-divisor ``%`` from SQL Remainder (whose
    sign follows the dividend): ((a % b) + b) % b — exact for INTEGRAL
    operands across all sign combinations (the Pmod-style correction).
    Float operands stay untranslated: the ``r + b`` step can round a
    tiny remainder away."""
    for c in (a, b):
        try:
            if not T.is_integral(c.expr.data_type):
                raise _Unsupported("float %")
        except _Unsupported:
            raise
        except Exception:
            raise _Unsupported("% operand type unknown")
    return ((a % b) + b) % b


def _apply_global(name: str, args):
    from spark_rapids_tpu_torch.sql import functions as F
    if name == "abs" and len(args) == 1:
        return F.abs(args[0])
    if name == "min" and len(args) >= 2:
        return F.least(*args)
    if name == "max" and len(args) >= 2:
        return F.greatest(*args)
    if name == "len" and len(args) == 1:
        return F.length(args[0])
    if name == "float" and len(args) == 1:
        from spark_rapids_tpu_torch.sql.functions import Column
        return Column(E.Cast(args[0].expr, T.DoubleT))
    raise _Unsupported(f"call to {name}")


_MATH_FNS = ("sqrt", "exp", "log", "log10", "log2", "log1p", "expm1",
             "floor", "ceil", "sin", "cos", "tan", "atan2", "hypot",
             "pow", "cbrt", "radians", "degrees")


def _apply_math(name: str, args):
    from spark_rapids_tpu_torch.sql import functions as F
    if name not in _MATH_FNS:
        raise _Unsupported(f"math.{name}")
    return getattr(F, name)(*args)


def _apply_method(name: str, recv, args):
    from spark_rapids_tpu_torch.sql import functions as F
    if name == "upper" and not args:
        return F.upper(recv)
    if name == "lower" and not args:
        return F.lower(recv)
    # strip/lstrip/rstrip are NOT translated: Python strips all
    # whitespace, SQL trim strips spaces only
    if name == "startswith" and len(args) == 1:
        return recv.startswith(args[0])
    if name == "endswith" and len(args) == 1:
        return recv.endswith(args[0])
    if name == "replace" and len(args) == 2:
        return F.replace(recv, args[0], args[1])
    raise _Unsupported(f"method .{name}")


def _exec(instrs, by_offset, i: int, stack: List, params,
          fn_globals=None) -> Optional:
    from spark_rapids_tpu_torch.sql import functions as F
    from spark_rapids_tpu_torch.sql.functions import Column

    def lit(v) -> Column:
        if v is None:
            return Column(E.Literal(None, T.NullT))
        return F.lit(v)

    while i < len(instrs):
        ins = instrs[i]
        op = ins.opname
        if op in _SKIP_OPS:
            i += 1
            continue
        if op in ("LOAD_FAST", "LOAD_FAST_CHECK", "LOAD_FAST_BORROW"):
            stack.append(params[ins.argval])
        elif op == "STORE_FAST":
            v = stack.pop()
            if not isinstance(v, Column):
                raise _Unsupported("STORE_FAST of non-expression")
            params[ins.argval] = v
        elif op == "LOAD_CONST":
            stack.append(lit(ins.argval))
        elif op == "RETURN_CONST":
            return lit(ins.argval)
        elif op == "RETURN_VALUE":
            return stack.pop()
        elif op == "PUSH_NULL":
            stack.append(_NULL)
        elif op == "LOAD_GLOBAL":
            # shadowed builtins must NOT silently become SQL builtins:
            # the name has to resolve to the real object
            import builtins as _bi
            import math as _math
            name = ins.argval
            resolved = (fn_globals or {}).get(
                name, getattr(_bi, name, None))
            expected = _math if name == "math" else \
                getattr(_bi, name, None)
            if resolved is not expected or expected is None:
                raise _Unsupported(f"global {name} is shadowed/unknown")
            if ins.argrepr.startswith("NULL + "):
                stack.append(_NULL)
            stack.append(("global", name))
        elif op in ("LOAD_ATTR", "LOAD_METHOD"):
            base = stack.pop()
            if ins.argrepr.startswith("NULL|self + ") \
                    or op == "LOAD_METHOD":
                # method call shape: [..., marker, self]
                if not isinstance(base, Column):
                    raise _Unsupported("method on non-expression")
                stack.append(("method", ins.argval))
                stack.append(base)
            else:
                if not (isinstance(base, tuple) and base[0] == "global"
                        and base[1] == "math"):
                    raise _Unsupported(f"attribute {ins.argval}")
                stack.append(("mathfn", ins.argval))
        elif op in ("CALL", "CALL_FUNCTION", "CALL_METHOD"):
            argc = ins.arg or 0
            args = [stack.pop() for _ in range(argc)][::-1]
            f = stack.pop()
            if any(not isinstance(a, Column) for a in args):
                raise _Unsupported("non-expression call argument")
            if isinstance(f, Column):
                # method shape: f is the receiver, marker beneath
                marker = stack.pop()
                if not (isinstance(marker, tuple)
                        and marker[0] == "method"):
                    raise _Unsupported("unsupported callable")
                stack.append(_apply_method(marker[1], f, args))
            elif isinstance(f, tuple) and f[0] == "global":
                if stack and stack[-1] is _NULL:
                    stack.pop()
                stack.append(_apply_global(f[1], args))
            elif isinstance(f, tuple) and f[0] == "mathfn":
                if stack and stack[-1] is _NULL:
                    stack.pop()
                stack.append(_apply_math(f[1], args))
            else:
                raise _Unsupported("unsupported callable")
        elif op == "BINARY_OP" or op in _LEGACY_BINOPS:
            # _LEGACY_BINOPS: Python <= 3.10 emits one opcode per
            # operator (BINARY_ADD, INPLACE_ADD, ...) where 3.11+
            # emits BINARY_OP with the symbol in argrepr
            r = stack.pop()
            a = stack.pop()
            sym = _LEGACY_BINOPS.get(op) or ins.argrepr.replace("=", "")
            if sym == "+":
                stack.append(a + r)
            elif sym == "-":
                stack.append(a - r)
            elif sym == "*":
                stack.append(a * r)
            elif sym == "/":
                stack.append(a / r)
            elif sym == "%":
                stack.append(_py_mod(a, r))
            # '//' stays untranslated: floor(a / b) via double loses
            # exactness past 2^53 and returns the wrong TYPE for floats
            else:
                raise _Unsupported(sym)
        elif op == "COMPARE_OP":
            r = stack.pop()
            a = stack.pop()
            sym = ins.argval if isinstance(ins.argval, str) else \
                ins.argrepr
            sym = sym.replace("bool(", "").replace(")", "").strip()
            ops = {"<": a < r, "<=": a <= r, ">": a > r, ">=": a >= r,
                   "==": a == r, "!=": a != r}
            if sym not in ops:
                raise _Unsupported(sym)
            stack.append(ops[sym])
        elif op == "UNARY_NEGATIVE":
            stack.append(-stack.pop())
        elif op == "UNARY_NOT":
            stack.append(~stack.pop())
        elif op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                    "POP_JUMP_FORWARD_IF_FALSE",
                    "POP_JUMP_FORWARD_IF_TRUE"):
            cond = stack.pop()
            tgt = by_offset[ins.argval]
            taken_first = op.endswith("IF_FALSE")
            then_v = _exec(instrs, by_offset, i + 1, list(stack),
                           dict(params), fn_globals)
            else_v = _exec(instrs, by_offset, tgt, list(stack),
                           dict(params), fn_globals)
            if then_v is None or else_v is None:
                raise _Unsupported(op)
            if not taken_first:
                then_v, else_v = else_v, then_v
            return F.when(cond, then_v).otherwise(else_v)
        elif op in ("JUMP_IF_FALSE_OR_POP", "JUMP_IF_TRUE_OR_POP"):
            # `and` / `or`: left kept on one path, popped on the other
            cond = stack.pop()
            tgt = by_offset[ins.argval]
            rest = _exec(instrs, by_offset, i + 1, list(stack),
                         dict(params), fn_globals)
            if rest is None:
                raise _Unsupported(op)
            if op == "JUMP_IF_FALSE_OR_POP":
                short = _exec(instrs, by_offset, tgt,
                              list(stack) + [cond], dict(params),
                              fn_globals)
                return F.when(cond, rest).otherwise(short)
            short = _exec(instrs, by_offset, tgt,
                          list(stack) + [cond], dict(params),
                          fn_globals)
            return F.when(cond, short).otherwise(rest)
        else:
            raise _Unsupported(op)
        i += 1
    raise _Unsupported("fell off the end")


def rewrite_plan(plan, conf) -> object:
    """Replace compilable PythonUDF expressions across a RESOLVED
    logical plan (both engines see the same rewrite, so dual-session
    parity holds). Returns the (possibly) rewritten plan."""
    from spark_rapids_tpu_torch.conf import UDF_COMPILER_ENABLED
    if not conf.get(UDF_COMPILER_ENABLED):
        return plan

    def fix_expr(e: E.Expression) -> Optional[E.Expression]:
        if isinstance(e, E.PythonUDF):
            compiled = compile_udf(e.fn, e.children, e.data_type)
            if compiled is not None:
                return compiled
        return None

    def walk(node):
        import copy
        if node.children:
            new_kids = [walk(c) for c in node.children]
            if any(a is not b for a, b in zip(new_kids, node.children)):
                node = copy.copy(node)
                node.children = new_kids
        changed = False
        updates = {}
        for attr, val in list(vars(node).items()):
            if isinstance(val, E.Expression):
                nv = val.transform(fix_expr)
                if nv is not val:
                    updates[attr] = nv
                    changed = True
            elif isinstance(val, list) and val and all(
                    isinstance(x, E.Expression) for x in val):
                nv = [x.transform(fix_expr) for x in val]
                if any(a is not b for a, b in zip(nv, val)):
                    updates[attr] = nv
                    changed = True
        if changed:
            import copy
            node = copy.copy(node)
            for attr, nv in updates.items():
                setattr(node, attr, nv)
        return node

    return walk(plan)
