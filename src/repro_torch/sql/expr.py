"""Schemas and the expression language for the DataFrame surface.

A ``Schema`` is an ordered list of (name, dtype) fields; dtypes are the
four scalar types the columnar wire format speaks natively ("int",
"float", "str", "bool") plus "list:<dtype>" for collect_list outputs.
Because the schema is declared, every lowered shuffle ships
schema-declared typed columnar batches (core.shuffle.batch) instead of
sniffing types per batch.

Expressions are small trees (``col``, ``lit``, arithmetic / comparison /
boolean operators, ``substr``, ``cast``, ``udf``) that know three things:

  * their output dtype given an input schema (schema propagation),
  * the column names they reference (drives projection pruning), and
  * whether they are DETERMINISTIC (a non-deterministic expression blocks
    predicate pushdown — re-evaluating it below a project or join would
    change results).

``bind(schema)`` compiles an expression to a plain row -> value closure;
the lowering maps those over RDD partitions, and core.serde ships them to
executors like any other task function (closures over lists of compiled
sub-expressions are why serde walks containers).

NULL semantics (SQL three-valued logic): outer joins pad unmatched rows
with None, so every operator here treats None as SQL NULL — arithmetic,
comparisons, substr and cast return None when an operand is None, and
``and``/``or`` follow the three-valued truth tables (False AND x is
False, True OR x is True, anything else involving NULL is NULL). A
Filter drops rows whose predicate evaluates to NULL, same as False. The
vectorized kernels keep row/vector parity by falling back to these row
closures whenever a batch carries None (repro_torch.sql.vectorized). Udf is
the exception: user functions see the raw None and apply their own
semantics.
"""

from __future__ import annotations

import operator
from typing import Callable, Iterable

SCALAR_DTYPES = ("int", "float", "str", "bool")
_SERDE_CHAR = {"int": "i", "float": "f", "str": "s", "bool": "b"}


def dtype_serde_char(dtype: str) -> str:
    """Map a DataFrame dtype to the serde column-schema grammar."""
    if dtype.startswith("list:"):
        return "l(%s)" % dtype_serde_char(dtype[5:])
    return _SERDE_CHAR[dtype]


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "t", "yes")


#: CSV field parsers (scan-time) — bools parse from text
CASTS: dict = {"int": int, "float": float, "str": str, "bool": _parse_bool}
#: cast() expression semantics on live values — bools follow Python truth
_RUNTIME_CASTS: dict = {"int": int, "float": float, "str": str,
                        "bool": bool}


class Schema:
    """Ordered, uniquely named, typed columns."""

    __slots__ = ("fields",)

    def __init__(self, fields: Iterable):
        fields = tuple((str(n), str(t)) for n, t in fields)
        seen = set()
        for name, dtype in fields:
            if name in seen:
                raise ValueError(f"duplicate column name {name!r} "
                                 f"(alias aggregate/select outputs)")
            seen.add(name)
            base = dtype[5:] if dtype.startswith("list:") else dtype
            if base not in SCALAR_DTYPES:
                raise ValueError(f"unknown dtype {dtype!r} for column "
                                 f"{name!r} (have {SCALAR_DTYPES})")
        self.fields = fields

    @property
    def names(self) -> tuple:
        return tuple(n for n, _ in self.fields)

    def index(self, name: str) -> int:
        for i, (n, _) in enumerate(self.fields):
            if n == name:
                return i
        raise KeyError(f"no column {name!r} in schema "
                       f"[{', '.join(self.names)}]")

    def dtype_of(self, name: str) -> str:
        return self.fields[self.index(name)][1]

    def select(self, names: Iterable[str]) -> "Schema":
        return Schema((n, self.dtype_of(n)) for n in names)

    def serde_tuple(self, names: Iterable[str] | None = None) -> str | None:
        """Declared key/value batch schema ("t(i,s,...)") for a tuple of
        these columns, or None for zero columns (nothing to declare)."""
        names = self.names if names is None else tuple(names)
        if not names:
            return None
        return "t(%s)" % ",".join(
            dtype_serde_char(self.dtype_of(n)) for n in names)

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def __hash__(self):
        return hash(self.fields)

    def __repr__(self):
        return "Schema([%s])" % ", ".join(f"{n}:{t}"
                                          for n, t in self.fields)


# ------------------------------------------------------------ expressions


class Expr:
    def children(self) -> list:
        return []

    def refs(self) -> set:
        out: set = set()
        for c in self.children():
            out |= c.refs()
        return out

    @property
    def deterministic(self) -> bool:
        return all(c.deterministic for c in self.children())

    def dtype(self, schema: Schema) -> str:
        raise NotImplementedError

    def bind(self, schema: Schema) -> Callable:
        raise NotImplementedError

    def bind_vec(self, schema: Schema) -> Callable:
        """Vectorized sibling of ``bind()``: compile to a whole-batch
        closure ``fn(cols, n) -> column`` evaluating numpy arrays /
        Python lists over a column batch (repro_torch.sql.vectorized,
        docs/vectorized_execution.md). Raises
        ``vectorized.VectorizeUnsupported`` for expressions with no
        array form (udf, non-scalar operands) — the lowering then keeps
        the per-row closures for that operator."""
        from repro_torch.sql.vectorized import compile_expr
        return compile_expr(self, schema)

    def substitute(self, mapping: dict) -> "Expr":
        """Replace column references per ``mapping`` (name -> Expr) —
        predicate pushdown through a Project rewrites in terms of the
        project's inputs."""
        raise NotImplementedError

    def sql(self) -> str:
        raise NotImplementedError

    # ------------------------------------------------- operator building
    def _bin(self, op: str, other) -> "BinOp":
        return BinOp(op, self, _as_expr(other))

    def __add__(self, other):
        return self._bin("+", other)

    def __sub__(self, other):
        return self._bin("-", other)

    def __mul__(self, other):
        return self._bin("*", other)

    def __truediv__(self, other):
        return self._bin("/", other)

    def __mod__(self, other):
        return self._bin("%", other)

    def __eq__(self, other):  # noqa: builds an expression, not a bool
        return self._bin("=", other)

    def __ne__(self, other):
        return self._bin("!=", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __and__(self, other):
        return self._bin("and", other)

    def __or__(self, other):
        return self._bin("or", other)

    def __invert__(self):
        return Not(self)

    __hash__ = object.__hash__  # __eq__ builds exprs; identity hash is fine

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def substr(self, start: int, length: int) -> "Substr":
        """1-based substring, SQL-style."""
        return Substr(self, start, length)

    def cast(self, dtype: str) -> "Cast":
        return Cast(self, dtype)

    def __repr__(self):
        return f"<expr {self.sql()}>"


def _as_expr(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def refs(self):
        return {self.name}

    def dtype(self, schema):
        return schema.dtype_of(self.name)

    def bind(self, schema):
        return operator.itemgetter(schema.index(self.name))

    def substitute(self, mapping):
        return mapping.get(self.name, self)

    def sql(self):
        return self.name


_LIT_DTYPE = {bool: "bool", int: "int", float: "float", str: "str"}


class Lit(Expr):
    def __init__(self, value):
        if type(value) not in _LIT_DTYPE:
            raise TypeError(f"unsupported literal {value!r} "
                            f"(int/float/str/bool)")
        self.value = value

    def dtype(self, schema):
        return _LIT_DTYPE[type(self.value)]

    def bind(self, schema):
        v = self.value
        return lambda row: v

    def substitute(self, mapping):
        return self

    def sql(self):
        return repr(self.value)


def _div(a, b):
    return a / b


_OPS: dict = {
    "+": operator.add, "-": operator.sub, "*": operator.mul,
    "/": _div, "%": operator.mod,
    "=": operator.eq, "!=": operator.ne, "<": operator.lt,
    "<=": operator.le, ">": operator.gt, ">=": operator.ge,
    "and": operator.and_, "or": operator.or_,
}
_ARITH = ("+", "-", "*", "%")
_NUMERIC = ("int", "float")


class BinOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in _OPS:
            raise ValueError(f"unknown operator {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def children(self):
        return [self.left, self.right]

    def dtype(self, schema):
        lt, rt = self.left.dtype(schema), self.right.dtype(schema)
        if self.op in _ARITH:
            if lt not in _NUMERIC or rt not in _NUMERIC:
                if self.op == "+" and lt == rt == "str":
                    return "str"  # concatenation
                raise TypeError(f"{self.sql()}: arithmetic needs numeric "
                                f"operands, got {lt}/{rt}")
            return "float" if "float" in (lt, rt) else "int"
        if self.op == "/":
            if lt not in _NUMERIC or rt not in _NUMERIC:
                raise TypeError(f"{self.sql()}: division needs numeric "
                                f"operands, got {lt}/{rt}")
            return "float"
        if self.op in ("and", "or"):
            if not (lt == rt == "bool"):
                raise TypeError(f"{self.sql()}: boolean operands "
                                f"required, got {lt}/{rt}")
            return "bool"
        # comparisons: mismatched operand dtypes fail at PLAN time like
        # every other type error, not mid-execution on a billed task
        if lt != rt and not (lt in _NUMERIC and rt in _NUMERIC):
            raise TypeError(f"{self.sql()}: cannot compare {lt} with "
                            f"{rt}")
        return "bool"

    def bind(self, schema):
        lf, rf = self.left.bind(schema), self.right.bind(schema)
        if self.op == "and":
            # SHORT-CIRCUIT, not operator.and_: the optimizer merges
            # sequential filters into one conjunction, and the later
            # guard must never evaluate on rows the earlier one excludes
            # (e.g. `n != 0` guarding `100 / n`). Three-valued: a False
            # side wins without looking at the other; NULL otherwise
            # taints the result unless the other side is False.
            def and_(row):
                a = lf(row)
                if a is not None and not a:
                    return False
                b = rf(row)
                if b is not None and not b:
                    return False
                return None if a is None or b is None else True
            return and_
        if self.op == "or":
            def or_(row):
                a = lf(row)
                if a is not None and a:
                    return True
                b = rf(row)
                if b is not None and b:
                    return True
                return None if a is None or b is None else False
            return or_
        fn = _OPS[self.op]

        def apply(row):
            a = lf(row)
            if a is None:
                return None
            b = rf(row)
            return None if b is None else fn(a, b)
        return apply

    def substitute(self, mapping):
        return BinOp(self.op, self.left.substitute(mapping),
                     self.right.substitute(mapping))

    def sql(self):
        return f"({self.left.sql()} {self.op} {self.right.sql()})"


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def children(self):
        return [self.child]

    def dtype(self, schema):
        if self.child.dtype(schema) != "bool":
            raise TypeError(f"{self.sql()}: boolean operand required")
        return "bool"

    def bind(self, schema):
        f = self.child.bind(schema)

        def not_(row):
            v = f(row)
            return None if v is None else not v
        return not_

    def substitute(self, mapping):
        return Not(self.child.substitute(mapping))

    def sql(self):
        return f"(not {self.child.sql()})"


class Substr(Expr):
    """1-based fixed-length substring (SQL SUBSTR)."""

    def __init__(self, child: Expr, start: int, length: int):
        if start < 1 or length < 0:
            # a 0-based habit would silently slice s[-1:...] to ""
            raise ValueError(f"substr is 1-based: start >= 1 and "
                             f"length >= 0 (got {start}, {length})")
        self.child = child
        self.start = start
        self.length = length

    def children(self):
        return [self.child]

    def dtype(self, schema):
        if self.child.dtype(schema) != "str":
            raise TypeError(f"{self.sql()}: substr needs a str operand")
        return "str"

    def bind(self, schema):
        f = self.child.bind(schema)
        lo = self.start - 1
        hi = lo + self.length

        def substr(row):
            s = f(row)
            return None if s is None else s[lo:hi]
        return substr

    def substitute(self, mapping):
        return Substr(self.child.substitute(mapping), self.start,
                      self.length)

    def sql(self):
        return f"substr({self.child.sql()}, {self.start}, {self.length})"


class Cast(Expr):
    def __init__(self, child: Expr, to: str):
        if to not in SCALAR_DTYPES:
            raise ValueError(f"cannot cast to {to!r}")
        self.child = child
        self.to = to

    def children(self):
        return [self.child]

    def dtype(self, schema):
        self.child.dtype(schema)  # validate the subtree
        return self.to

    def bind(self, schema):
        f = self.child.bind(schema)
        caster = _RUNTIME_CASTS[self.to]

        def cast(row):
            v = f(row)
            return None if v is None else caster(v)
        return cast

    def substitute(self, mapping):
        return Cast(self.child.substitute(mapping), self.to)

    def sql(self):
        return f"cast({self.child.sql()} as {self.to})"


class Udf(Expr):
    """A user function lifted to an expression. ``deterministic=False``
    marks it as a pushdown barrier (see optimizer)."""

    def __init__(self, fn: Callable, dtype: str, args: list,
                 name: str | None = None, deterministic: bool = True):
        self.fn = fn
        self._dtype = dtype
        self.args = [_as_expr(a) for a in args]
        self.name = name or getattr(fn, "__name__", "udf")
        self._deterministic = deterministic

    def children(self):
        return list(self.args)

    @property
    def deterministic(self):
        return self._deterministic and super().deterministic

    def dtype(self, schema):
        for a in self.args:
            a.dtype(schema)
        return self._dtype

    def bind(self, schema):
        fn = self.fn
        bound = [a.bind(schema) for a in self.args]
        return lambda row: fn(*[b(row) for b in bound])

    def substitute(self, mapping):
        return Udf(self.fn, self._dtype,
                   [a.substitute(mapping) for a in self.args],
                   name=self.name, deterministic=self._deterministic)

    def sql(self):
        tag = "" if self._deterministic else "!"
        return f"{self.name}{tag}({', '.join(a.sql() for a in self.args)})"


class Alias(Expr):
    """Names an expression for select/agg output; transparent otherwise."""

    def __init__(self, child: Expr, name: str):
        self.child = child
        self.name = name

    def children(self):
        return [self.child]

    def dtype(self, schema):
        return self.child.dtype(schema)

    def bind(self, schema):
        return self.child.bind(schema)

    def substitute(self, mapping):
        return Alias(self.child.substitute(mapping), self.name)

    def sql(self):
        return self.child.sql()


# -------------------------------------------------------------- aggregates

AGG_OPS = ("sum", "count", "min", "max", "avg", "collect_list")


class AggExpr:
    """An aggregate over a group. All ops except collect_list are
    ALGEBRAIC — they decompose into per-partition partials merged by an
    associative combiner, which is what lets the optimizer select the
    map-side-combine (reduceByKey) lowering."""

    def __init__(self, op: str, child: Expr | None = None,
                 name: str | None = None):
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregate {op!r}")
        if child is None and op != "count":
            raise ValueError(f"{op} needs an argument expression")
        self.op = op
        self.child = child
        self.name = name or self.sql()

    @property
    def algebraic(self) -> bool:
        return self.op != "collect_list"

    def refs(self) -> set:
        return self.child.refs() if self.child is not None else set()

    def dtype(self, schema: Schema) -> str:
        ct = self.child.dtype(schema) if self.child is not None else None
        if self.op == "count":
            return "int"
        if self.op == "avg":
            if ct not in _NUMERIC:
                raise TypeError(f"{self.sql()}: avg needs a numeric arg")
            return "float"
        if self.op == "sum" and ct not in _NUMERIC:
            raise TypeError(f"{self.sql()}: sum needs a numeric arg")
        if self.op == "collect_list":
            return f"list:{ct}"
        return ct  # sum/min/max keep the argument dtype

    def alias(self, name: str) -> "AggExpr":
        return AggExpr(self.op, self.child, name=name)

    def substitute(self, mapping) -> "AggExpr":
        child = (self.child.substitute(mapping)
                 if self.child is not None else None)
        return AggExpr(self.op, child, name=self.name)

    def sql(self) -> str:
        arg = self.child.sql() if self.child is not None else "*"
        return f"{self.op}({arg})"

    def __repr__(self):
        return f"<agg {self.name}:={self.sql()}>"


# ------------------------------------------------------------- public API


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def udf(fn: Callable, dtype: str, *, name: str | None = None,
        deterministic: bool = True) -> Callable:
    """Lift ``fn`` into the expression language:
    ``hour = udf(int, "int"); hour(col("h"))``."""
    def build(*args) -> Udf:
        return Udf(fn, dtype, list(args), name=name,
                   deterministic=deterministic)
    return build


def sum_(e) -> AggExpr:
    return AggExpr("sum", _as_expr(e))


def count_(e=None) -> AggExpr:
    return AggExpr("count", _as_expr(e) if e is not None else None)


def min_(e) -> AggExpr:
    return AggExpr("min", _as_expr(e))


def max_(e) -> AggExpr:
    return AggExpr("max", _as_expr(e))


def avg_(e) -> AggExpr:
    return AggExpr("avg", _as_expr(e))


def collect_list(e) -> AggExpr:
    return AggExpr("collect_list", _as_expr(e))


def split_conjuncts(pred: Expr) -> list:
    """Flatten an AND tree into its conjuncts (predicate pushdown splits
    a filter and pushes each conjunct as far down as it can go)."""
    if isinstance(pred, BinOp) and pred.op == "and":
        return split_conjuncts(pred.left) + split_conjuncts(pred.right)
    if isinstance(pred, Alias):
        return split_conjuncts(pred.child)
    return [pred]


def join_conjuncts(preds: list) -> Expr:
    out = preds[0]
    for p in preds[1:]:
        out = BinOp("and", out, p)
    return out
