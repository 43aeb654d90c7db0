"""Vectorized columnar execution: compile the expression language to
array kernels over whole column batches (docs/vectorized_execution.md).

``compile_expr(expr, schema)`` is the vectorized sibling of
``Expr.bind()``: instead of a row -> value closure it produces a
``fn(cols, n) -> column`` closure evaluating a whole batch at once. A
column is one of three shapes, fixed by dtype:

  * "int" / "float" / "bool"  -> a numpy int64 / float64 / bool array
  * "str" and "list:..."      -> a plain Python list
  * a literal                 -> a bare Python scalar (broadcasts)

The contract with the row path is BIT-IDENTICAL RESULTS. Wherever a
numpy shortcut could diverge from the Python semantics of the bound row
closures, the compiled code either takes an exact path or raises
``VectorFallback`` so the fused operator re-runs the chunk through the
original row closures:

  * int64 arithmetic wraps silently in numpy (and ``np.errstate`` does
    NOT trap it) — every int +/-/* is shadowed in float64 and any result
    magnitude past 2**62 falls back (Python ints are unbounded);
  * division/modulo by zero raises in Python but yields inf/nan/0 in
    numpy — numeric stages run under ``errstate(divide="raise",
    invalid="raise")`` and the FloatingPointError falls back, which also
    preserves the short-circuit guarantee of ``a and b`` filters (the
    row path never evaluates ``b`` on rows ``a`` excluded);
  * mixed int/float comparisons promote int64 -> float64 in numpy but
    compare exactly in Python — ints past 2**53 fall back;
  * float group sums fold with first-occurrence initialization
    (``acc = vals[first]`` then ordered ``np.add.at``) so -0.0 and the
    fold order match the row path's left fold; float min/max fall back
    per-slot when NaN is present (Python's min/max keep the FIRST value
    on NaN, numpy propagates or ignores it).

In fact the fused operator treats ANY exception from a vectorized chunk
as a fallback signal and re-runs the chunk through the row closures, so
a divergence can only ever cost speed, never correctness — except a
``KernelError``: a kernel that fails to build or launch is a fault of
the device path, and it propagates out of the query instead of being
hidden by the row path.
"""

from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core.shuffle import KVBatch
from repro_torch.kernels._build import KernelError

_NP_DTYPE = {"int": np.int64, "float": np.float64, "bool": np.bool_}
_NUMERIC = ("int", "float")
#: int results whose float64 shadow exceeds this may be near the int64
#: wrap point (float error cannot bridge the 2**62..2**63 gap)
_INT_GUARD = float(2**62)
#: ints beyond 2**53 lose precision as float64 — exact mixed comparison
#: requires falling back to Python's exact int/float comparison
_EXACT_F64 = float(2**53)


class VectorizeUnsupported(Exception):
    """Raised at COMPILE time: this expression has no vectorized form
    (udf, non-scalar operand) — the lowering keeps the row closures and
    explain() marks the operator ``[row-fallback: ...]``."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class VectorFallback(Exception):
    """Raised at RUN time, per chunk: the data hit a case where the array
    path would diverge from row semantics (int64 overflow risk, ints past
    2**53 in a float comparison, non-conforming input rows). The fused
    operator re-runs just that chunk through the bound row closures."""


# ---------------------------------------------------------- column helpers


def to_list(col, n: int) -> list:
    """Materialize a column as a list of exact Python values."""
    if isinstance(col, np.ndarray):
        return col.tolist()  # yields Python int/float/bool
    if isinstance(col, list):
        return col
    return [col] * n  # broadcast scalar


def _elems(col, n: int):
    """Iterable view for elementwise Python loops (str ops)."""
    if isinstance(col, np.ndarray):
        return col.tolist()
    if isinstance(col, list):
        return col
    return itertools.repeat(col, n)


def _is_scalar(col) -> bool:
    return not isinstance(col, (np.ndarray, list))


def _as_float(col):
    if isinstance(col, np.ndarray):
        return col if col.dtype == np.float64 else col.astype(np.float64)
    return float(col)


# --------------------------------------------------------------- compiler


def compile_expr(expr, schema):
    """Vectorized sibling of ``Expr.bind``: expr -> fn(cols, n) -> column.
    Raises VectorizeUnsupported for udfs and non-scalar operands."""
    from repro_torch.sql import expr as E  # local import: expr imports us lazily

    if isinstance(expr, E.Alias):
        return compile_expr(expr.child, schema)
    if isinstance(expr, E.Col):
        i = schema.index(expr.name)
        return lambda cols, n: cols[i]
    if isinstance(expr, E.Lit):
        v = expr.value
        return lambda cols, n: v
    if isinstance(expr, E.BinOp):
        return _compile_binop(expr, schema)
    if isinstance(expr, E.Not):
        f = compile_expr(expr.child, schema)
        return lambda cols, n: _not(f(cols, n))
    if isinstance(expr, E.Substr):
        f = compile_expr(expr.child, schema)
        lo = expr.start - 1
        hi = lo + expr.length

        def f_substr(cols, n):
            v = f(cols, n)
            if _is_scalar(v):
                return v[lo:hi]
            return [s[lo:hi] for s in _elems(v, n)]
        return f_substr
    if isinstance(expr, E.Cast):
        return _compile_cast(expr, schema)
    if isinstance(expr, E.Udf):
        raise VectorizeUnsupported("udf")
    raise VectorizeUnsupported(type(expr).__name__)


def _not(v):
    if _is_scalar(v):
        return not v
    return ~np.asarray(v)


def _compile_binop(expr, schema):
    from repro_torch.sql import expr as E

    lt, rt = expr.left.dtype(schema), expr.right.dtype(schema)
    lf = compile_expr(expr.left, schema)
    rf = compile_expr(expr.right, schema)
    op = expr.op

    if op in ("and", "or"):
        # both operands evaluate EAGERLY here; the row path short-circuits.
        # Any case where the unguarded operand would misbehave (divide by
        # zero, overflow) raises out of the array op and the chunk falls
        # back to the short-circuiting row closures — so eager evaluation
        # is only ever a fast path, never a semantic change.
        def f_bool(cols, n, _and=(op == "and")):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return (a and b) if _and else (a or b)
            return (a & b) if _and else (a | b)
        return f_bool

    if op == "+" and lt == rt == "str":
        def f_concat(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return a + b
            return [x + y for x, y in zip(_elems(a, n), _elems(b, n))]
        return f_concat

    if op in ("+", "-", "*", "/", "%"):
        both_int = lt == rt == "int" and op != "/"
        npop = {"+": np.add, "-": np.subtract, "*": np.multiply,
                "/": np.divide, "%": np.mod}[op]
        pyop = {"+": lambda a, b: a + b, "-": lambda a, b: a - b,
                "*": lambda a, b: a * b, "/": lambda a, b: a / b,
                "%": lambda a, b: a % b}[op]

        def f_arith(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return pyop(a, b)  # exact Python semantics
            if both_int:
                r = npop(a, b)  # int64 — may have wrapped silently
                if op in ("+", "-", "*"):
                    shadow = npop(_as_float(a), _as_float(b))
                    if np.any(np.abs(shadow) > _INT_GUARD):
                        raise VectorFallback("int64 overflow risk")
                return r
            # float result: int operands promote via exact int64->float64
            return npop(_as_float(a) if lt == "int" else a,
                        _as_float(b) if rt == "int" else b)
        return f_arith

    # comparisons
    npop = {"=": np.equal, "!=": np.not_equal, "<": np.less,
            "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}
    pyop = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
            "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
            ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}
    if lt in _NUMERIC and rt in _NUMERIC:
        mixed = lt != rt
        cmp_np, cmp_py = npop[expr.op], pyop[expr.op]

        def f_numcmp(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return cmp_py(a, b)
            if mixed:
                # int64 -> float64 promotion is lossy past 2**53; Python
                # compares int vs float EXACTLY
                iv = a if lt == "int" else b
                if np.any(np.abs(np.asarray(iv, dtype=np.float64))
                          > _EXACT_F64):
                    raise VectorFallback("int past 2**53 in float compare")
            return cmp_np(a, b)
        return f_numcmp
    if lt == rt == "bool":
        cmp_np, cmp_py = npop[expr.op], pyop[expr.op]

        def f_boolcmp(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return cmp_py(a, b)
            return cmp_np(a, b)
        return f_boolcmp
    if lt == rt == "str":
        cmp_py = pyop[expr.op]

        def cmp_nn(x, y):
            # None (NULL from outer-join padding) must yield NULL, but
            # Python's ==/!= on None return a bool — punt to row closures
            if x is None or y is None:
                raise VectorFallback("NULL in str comparison")
            return cmp_py(x, y)

        def f_strcmp(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if _is_scalar(a) and _is_scalar(b):
                return cmp_py(a, b)
            return np.fromiter((cmp_nn(x, y) for x, y in
                                zip(_elems(a, n), _elems(b, n))),
                               dtype=np.bool_, count=n)
        return f_strcmp
    raise VectorizeUnsupported(f"compare {lt}/{rt}")


def _compile_cast(expr, schema):
    f = compile_expr(expr.child, schema)
    src = expr.child.dtype(schema)
    to = expr.to
    if src.startswith("list:"):
        raise VectorizeUnsupported("cast from list")

    def g(cols, n):
        v = f(cols, n)
        if _is_scalar(v):
            return {"int": int, "float": float, "str": str, "bool": bool}[to](v)
        if to == src:
            return v  # passthrough keeps None as NULL, same as the row path
        if src == "str" and any(x is None for x in v):
            # str(None)/bool(None) would produce a value where the row
            # path now yields NULL — only arrays-free columns carry None
            raise VectorFallback("NULL in str column cast")
        if to == "int":
            if src == "float":
                arr = np.asarray(v)
                # Python int(f) is exact and unbounded; astype(int64) is
                # only exact for finite values inside the int64 range
                if (not np.all(np.isfinite(arr))
                        or np.any(arr >= float(2**63))
                        or np.any(arr < -float(2**63))):
                    raise VectorFallback("float->int out of int64 range")
                return arr.astype(np.int64)
            if src == "bool":
                return np.asarray(v).astype(np.int64)
            # str: Python parse (may exceed int64 -> numpy refuses -> the
            # chunk falls back and the row path returns the big int)
            return np.array([int(s) for s in v], dtype=np.int64)
        if to == "float":
            if src in ("int", "bool"):
                return np.asarray(v).astype(np.float64)
            return np.fromiter(map(float, v), dtype=np.float64, count=n)
        if to == "str":
            return [str(x) for x in to_list(v, n)]
        # to bool: Python truth — nonzero numbers / nonempty strings
        if src in ("int", "float"):
            return np.asarray(v) != 0  # NaN != 0 is True, matching bool(nan)
        return np.fromiter(map(bool, v), dtype=np.bool_, count=n)
    return g


# ------------------------------------------------------------- ingestion


def scan_ingest(specs):
    """Vectorized CSV parse: ``specs`` is [(field_idx, dtype, cast_fn)]
    per pruned output column. Parsing itself is the exact Python cast
    (int()/float()/bool-parse per field) collected straight into arrays —
    C-speed collection, Python-identical values."""
    def ingest(lines):
        parts = [ln.split(",") for ln in lines]
        n = len(parts)
        cols = []
        for idx, dtype, cast in specs:
            raw = [p[idx] for p in parts]
            if dtype == "str":
                cols.append([cast(r) for r in raw])
            else:
                cols.append(np.fromiter(map(cast, raw),
                                        dtype=_NP_DTYPE[dtype], count=n))
        return cols, n
    return ingest


def rows_ingest(dtypes):
    """Columnize a chunk of already-materialized rows, checking exact
    concrete types (bool is not int, 1.0 is not 1 — same conformance rule
    as the wire format). Non-conforming chunks fall back to row closures."""
    def ingest(rows):
        n = len(rows)
        cols = []
        for j, dtype in enumerate(dtypes):
            vals = [r[j] for r in rows]
            if dtype == "int":
                if not all(type(v) is int for v in vals):
                    raise VectorFallback("non-int value in int column")
                cols.append(np.array(vals, dtype=np.int64))  # may overflow
            elif dtype == "float":
                if not all(type(v) is float for v in vals):
                    raise VectorFallback("non-float value in float column")
                cols.append(np.array(vals, dtype=np.float64))
            elif dtype == "bool":
                if not all(type(v) is bool for v in vals):
                    raise VectorFallback("non-bool value in bool column")
                cols.append(np.array(vals, dtype=np.bool_))
            else:  # str / list:* stay Python lists (ragged-safe)
                cols.append(vals)
        return cols, n
    return ingest


# ----------------------------------------------------------- fused stages


def filter_stage(pred_fn):
    def stage(cols, n):
        mask = pred_fn(cols, n)
        if _is_scalar(mask):
            if mask:
                return cols, n
            return [c[:0] if isinstance(c, (np.ndarray, list)) else c
                    for c in cols], 0
        kept = int(mask.sum())
        ml = None
        out = []
        for c in cols:
            if isinstance(c, np.ndarray):
                out.append(c[mask])
            elif isinstance(c, list):
                if ml is None:
                    ml = mask.tolist()
                out.append([v for v, m in zip(c, ml) if m])
            else:
                out.append(c)
        return out, kept
    return stage


def project_stage(fns):
    def stage(cols, n):
        return [f(cols, n) for f in fns], n
    return stage


# ------------------------------------------------------------- emissions


def rows_emit(cols, n):
    lists = [to_list(c, n) for c in cols]
    return list(zip(*lists)) if lists else []


def col_selector(i):
    """Vectorized sibling of ``operator.itemgetter(i)`` over columns."""
    return lambda cols, n: cols[i]


def make_kv_plain_emit(key_fns, rest_idx, kschema, vschema):
    """Join/groupByKey map side: (key-tuple, rest-tuple) records carried
    column-major so the shuffle writer packs without transposing.
    ``key_fns`` are compiled column closures (keys may be computed)."""
    def emit(cols, n):
        if n == 0:
            return []
        kcols = [to_list(f(cols, n), n) for f in key_fns]
        vcols = [to_list(cols[i], n) for i in rest_idx]
        return [KVBatch(kcols, vcols, kschema, vschema)]
    return emit


def make_kv_agg_emit(key_fns, slot_fns, slot_ops, backend, device="cuda"):
    """Partial aggregation: group the batch by key and fold each slot
    column, emitting one (key, partials) record per distinct key in
    FIRST-OCCURRENCE order — the same order the row path's combine dict
    discovers keys, so writer flush boundaries and wire bodies match."""
    def emit(cols, n):
        key_cols = [f(cols, n) for f in key_fns]
        slot_cols = [f(cols, n) for f in slot_fns]
        return grouped_records(key_cols, slot_cols, slot_ops, n, backend,
                               device)
    return emit


def grouped_records(key_cols, slot_cols, slot_ops, n, backend="numpy",
                    device="cuda"):
    if n == 0:
        return []
    keys = list(zip(*[to_list(c, n) for c in key_cols]))
    index: dict = {}
    gids = np.empty(n, dtype=np.int64)
    first = []
    for i, k in enumerate(keys):
        g = index.get(k)
        if g is None:
            g = len(index)
            index[k] = g
            first.append(i)
        gids[i] = g
    ng = len(index)
    first_arr = np.array(first, dtype=np.int64)
    out_slots = [to_list(_fold_slot(op, c, gids, ng, first_arr, n, backend,
                                    device), ng)
                 for op, c in zip(slot_ops, slot_cols)]
    uniq = list(index)  # insertion order == first occurrence
    return [(k, tuple(s[g] for s in out_slots))
            for g, k in enumerate(uniq)]


def _fold_slot(op, col, gids, ng, first, n, backend, device):
    """Fold one slot column per group, reproducing the row path's left
    fold exactly: init from the group's FIRST value, accumulate the rest
    in row order (np.<op>.at applies sequentially)."""
    if _is_scalar(col):
        if op == "sum" and type(col) is int:
            counts = np.bincount(gids, minlength=ng)
            if abs(col) * n <= 2**62:
                return counts * col  # exact: repeated int addition
            return _py_fold(op, [col] * n, gids, ng)
        col = np.array([col] * n) if type(col) is not str else [col] * n
    if isinstance(col, list):  # str / list: columns — Python fold
        return _py_fold(op, col, gids, ng)
    if op == "sum":
        if col.dtype == np.int64:
            if backend == "torch":
                folded = _torch_int_sum(col, gids, ng, device)
                if folded is not None:
                    return folded
            # bound the worst-case partial: if even the sum of |v| stays
            # far from the wrap point, int64 accumulation is exact
            if float(np.abs(col).astype(np.float64).sum()) > _INT_GUARD:
                return _py_fold(op, col.tolist(), gids, ng)
            acc = np.zeros(ng, dtype=np.int64)
            np.add.at(acc, gids, col)
            return acc
        if col.dtype == np.bool_:
            raise VectorFallback("sum over bool column")
        acc = col[first].copy()  # float: -0.0-exact first-value init
        rest = np.ones(n, dtype=np.bool_)
        rest[first] = False
        np.add.at(acc, gids[rest], col[rest])
        return acc
    if op in ("min", "max"):
        if col.dtype == np.float64 and np.isnan(col).any():
            # Python's min/max keep the FIRST operand on NaN; numpy
            # either propagates (minimum) or ignores (fmin) it
            return _py_fold(op, col.tolist(), gids, ng)
        acc = col[first].copy()
        rest = np.ones(n, dtype=np.bool_)
        rest[first] = False
        ufunc = np.minimum if op == "min" else np.maximum
        ufunc.at(acc, gids[rest], col[rest])
        return acc
    raise VectorFallback(f"slot op {op!r}")


def _py_fold(op, vals, gids, ng):
    import operator as _op
    fold = {"sum": _op.add, "min": min, "max": max}[op]
    acc = [None] * ng
    seen = [False] * ng
    for g, v in zip(gids.tolist() if isinstance(gids, np.ndarray) else gids,
                    vals):
        if seen[g]:
            acc[g] = fold(acc[g], v)
        else:
            acc[g] = v
            seen[g] = True
    return acc


def _torch_int_sum(col, gids, ng, device):
    """Route an int64 group sum through the bucket_reduce kernel on
    ``device`` (vector_backend="torch"). Integer addition is associative,
    so an order-free segment sum is exact as long as it cannot overflow —
    the same magnitude bound as the numpy path. Returns None to defer to
    the numpy path only when that bound fails; any failure of the kernel
    propagates. torch is imported here, so a numpy-backend engine never
    loads it."""
    from repro_torch.kernels.ops import grouped_reduce
    out = grouped_reduce(col, gids, ng, device=device)
    return None if out is None else np.asarray(out, dtype=np.int64)


# ---------------------------------------------------------- fused operator


def _chunks(it, size):
    it = iter(it)
    while True:
        chunk = list(itertools.islice(it, size))
        if not chunk:
            return
        yield chunk


def make_fused(ingest, stages, emit, row_chain, batch_rows):
    """Build the batch-in/batch-out fused operator for RDD.mapBatches:
    chunk the partition iterator, run ingest -> stages -> emit per chunk
    under strict float error traps, and re-run any chunk that raises
    through ``row_chain`` (the exact per-row closure pipeline for the
    same plan segment). Emissions are materialized per chunk BEFORE
    yielding so a mid-chunk fallback never double-emits. A KernelError
    is not a fallback signal: it propagates."""
    def fused(it):
        for chunk in _chunks(it, batch_rows):
            try:
                with np.errstate(divide="raise", invalid="raise",
                                 over="ignore", under="ignore"):
                    cols, n = ingest(chunk)
                    for stage in stages:
                        cols, n = stage(cols, n)
                    out = emit(cols, n)
            except KernelError:
                raise
            except Exception:
                out = list(row_chain(iter(chunk)))
            yield from out
    return fused
