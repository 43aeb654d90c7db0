"""Logical plan for the DataFrame surface.

A query is a tree of relational operators over a schema-carrying source
(CSV scan or an RDD of tuples). ``explain_str`` renders the tree the way
the golden plan-shape tests pin it — one node per line, two-space
indents, child after parent:

    Limit[5]
      Sort[tips desc]
        Aggregate[keys=[hour], aggs=[tips:=sum(tip)], combine=map_side]
          Project[hour:=substr(pickup, 12, 2), tip]
            Filter[(payment_type = 'credit')]
              Scan[taxi.csv, cols=[pickup, payment_type, tip], parts=8]

The optimizer (repro_torch.sql.optimizer) rewrites this tree; the lowering
(repro_torch.sql.lower) turns it into the existing RDD lineage. ``orderBy`` and
``limit`` are FINAL operators: the engine is unordered, so Sort/Limit
live only at the plan root where the lowering can split them between a
per-partition op and a driver-side finish.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.sql.expr import BinOp, Col, Expr, Lit, Schema


class Plan:
    _schema: Schema | None = None

    def children(self) -> list:
        raise NotImplementedError

    def with_children(self, kids: list) -> "Plan":
        raise NotImplementedError

    def _compute_schema(self) -> Schema:
        raise NotImplementedError

    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._compute_schema()
        return self._schema

    def describe(self) -> str:
        raise NotImplementedError

    def __repr__(self):
        return explain_str(self)


def explain_str(plan: Plan, markers: dict | None = None) -> str:
    """Render the tree; ``markers`` (id(node) -> suffix, from
    repro_torch.sql.lower.vector_markers) annotates operators with their
    execution mode, e.g. ``[vectorized]`` / ``[row-fallback: udf]``."""
    lines: list[str] = []
    marks = markers or {}

    def walk(node: Plan, depth: int):
        lines.append("  " * depth + node.describe() + marks.get(id(node), ""))
        for c in node.children():
            walk(c, depth + 1)

    walk(plan, 0)
    return "\n".join(lines)


def _fmt_named(pairs: Iterable) -> str:
    """name for a plain column passthrough, name:=expr otherwise."""
    out = []
    for name, e in pairs:
        if isinstance(e, Col) and e.name == name:
            out.append(name)
        else:  # computed column or aggregate — both print name:=sql
            out.append(f"{name}:={e.sql()}")
    return ", ".join(out)


class Scan(Plan):
    """CSV object in the store. ``columns`` is the pruned projection the
    optimizer pushes into the scan — only these fields are parsed/cast."""

    def __init__(self, key: str, full_schema: Schema, nparts: int,
                 columns: tuple | None = None):
        self.key = key
        self.full_schema = full_schema
        self.nparts = nparts
        self.columns = tuple(columns) if columns is not None else None

    def children(self):
        return []

    def with_children(self, kids):
        return self

    def _compute_schema(self):
        if self.columns is None:
            return self.full_schema
        return self.full_schema.select(self.columns)

    def describe(self):
        return (f"Scan[{self.key}, "
                f"cols=[{', '.join(self.schema().names)}], "
                f"parts={self.nparts}]")


class RddScan(Plan):
    """An RDD of tuples lifted by ``rdd.toDF(schema)``."""

    def __init__(self, rdd, schema: Schema):
        self.rdd = rdd
        self.rdd_schema = schema

    def children(self):
        return []

    def with_children(self, kids):
        return self

    def _compute_schema(self):
        return self.rdd_schema

    def describe(self):
        return (f"RddScan[cols=[{', '.join(self.rdd_schema.names)}], "
                f"parts={self.rdd.nparts}]")


class Project(Plan):
    def __init__(self, child: Plan, cols: Iterable):
        self.child = child
        self.cols = tuple(cols)  # ((name, Expr), ...)

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Project(kids[0], self.cols)

    def _compute_schema(self):
        base = self.child.schema()
        return Schema((n, e.dtype(base)) for n, e in self.cols)

    def describe(self):
        return f"Project[{_fmt_named(self.cols)}]"


class Window(Project):
    """Event-time window (pane) assignment for tumbling/sliding windows
    (docs/streaming.md). Structurally a Project — every input column
    passes through plus one computed column ``name`` holding the PANE
    start ``ts - ts % slide`` (plain expression arithmetic, so it
    vectorizes and lowers like any Project). A tumbling window
    (slide == size) is its own pane; a sliding window decomposes into
    ``size/slide`` panes that the consumer (the streaming driver, or a
    batch reference reduction) recombines per window — which is why
    ``size % slide == 0`` is required. The optimizer treats it as a
    Project for pushdown/pruning but preserves the node identity so
    explain() shows the window spec."""

    def __init__(self, child: Plan, ts_col: str, size: int,
                 slide: int | None = None, name: str = "window_start"):
        size = int(size)
        slide = size if slide is None else int(slide)
        if size <= 0 or slide <= 0:
            raise ValueError(f"window size/slide must be positive "
                             f"(got {size}/{slide})")
        if size % slide != 0:
            raise ValueError(f"window size {size} must be a multiple of "
                             f"slide {slide} (panes recombine exactly)")
        base = child.schema()
        if base.dtype_of(ts_col) != "int":
            raise TypeError(f"window over {ts_col!r} needs an int "
                            f"event-time column, got "
                            f"{base.dtype_of(ts_col)!r}")
        pane = BinOp("-", Col(ts_col), BinOp("%", Col(ts_col), Lit(slide)))
        cols = [(n, Col(n)) for n in base.names] + [(name, pane)]
        super().__init__(child, cols)
        self.ts_col = ts_col
        self.size = size
        self.slide = slide
        self.name = name

    def with_children(self, kids):
        return Window(kids[0], self.ts_col, self.size, self.slide,
                      self.name)

    def describe(self):
        return (f"Window[{self.name}:=pane({self.ts_col}), "
                f"size={self.size}, slide={self.slide}]")


class Filter(Plan):
    def __init__(self, child: Plan, pred: Expr):
        self.child = child
        self.pred = pred

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Filter(kids[0], self.pred)

    def _compute_schema(self):
        base = self.child.schema()
        if self.pred.dtype(base) != "bool":
            raise TypeError(f"filter predicate {self.pred.sql()} is not "
                            f"boolean")
        return base

    def describe(self):
        return f"Filter[{self.pred.sql()}]"


class Aggregate(Plan):
    """groupBy().agg(). ``partial`` (map-side combine, the reduceByKey
    lowering) and ``transport`` are chosen by the optimizer."""

    def __init__(self, child: Plan, keys: Iterable, aggs: Iterable,
                 nparts: int | None = None, partial: bool = False,
                 transport: str | None = None):
        self.child = child
        self.keys = tuple(keys)  # ((name, Expr), ...)
        self.aggs = tuple(aggs)  # ((name, AggExpr), ...)
        self.nparts = nparts
        self.partial = partial
        self.transport = transport

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Aggregate(kids[0], self.keys, self.aggs, self.nparts,
                         self.partial, self.transport)

    def _compute_schema(self):
        base = self.child.schema()
        fields = [(n, e.dtype(base)) for n, e in self.keys]
        fields += [(n, a.dtype(base)) for n, a in self.aggs]
        return Schema(fields)

    def describe(self):
        parts = [f"keys=[{_fmt_named(self.keys)}]",
                 f"aggs=[{_fmt_named(self.aggs)}]",
                 f"combine={'map_side' if self.partial else 'none'}"]
        if self.transport:
            parts.append(f"transport={self.transport}")
        return f"Aggregate[{', '.join(parts)}]"


class Join(Plan):
    """Equi-join on shared column names (how: inner/left/right/outer).
    Output: the key columns, then the left side's remaining columns,
    then the right side's; the unmatched half of an outer row carries
    None in the absent side's columns."""

    JOIN_HOWS = ("inner", "left", "right", "outer")

    def __init__(self, left: Plan, right: Plan, on: Iterable[str],
                 nparts: int | None = None, how: str = "inner",
                 transport: str | None = None):
        if how not in self.JOIN_HOWS:
            raise ValueError(f"unsupported join how={how!r}; expected "
                             f"one of {'/'.join(self.JOIN_HOWS)}")
        self.left = left
        self.right = right
        self.on = tuple(on)
        self.nparts = nparts
        self.how = how
        self.transport = transport

    def children(self):
        return [self.left, self.right]

    def with_children(self, kids):
        return Join(kids[0], kids[1], self.on, self.nparts, self.how,
                    self.transport)

    def rest_names(self, side: Plan) -> tuple:
        return tuple(n for n in side.schema().names if n not in self.on)

    def _compute_schema(self):
        ls, rs = self.left.schema(), self.right.schema()
        for n in self.on:
            if ls.dtype_of(n) != rs.dtype_of(n):
                raise TypeError(
                    f"join key {n!r} dtypes differ: "
                    f"{ls.dtype_of(n)} vs {rs.dtype_of(n)}")
        lrest = self.rest_names(self.left)
        rrest = self.rest_names(self.right)
        clash = set(lrest) & set(rrest)
        if clash:
            raise ValueError(f"join sides share non-key columns "
                             f"{sorted(clash)}; rename before joining")
        fields = [(n, ls.dtype_of(n)) for n in self.on]
        fields += [(n, ls.dtype_of(n)) for n in lrest]
        fields += [(n, rs.dtype_of(n)) for n in rrest]
        return Schema(fields)

    def describe(self):
        parts = [f"on=[{', '.join(self.on)}]", f"how={self.how}"]
        if self.transport:
            parts.append(f"transport={self.transport}")
        return f"Join[{', '.join(parts)}]"


class Cached(Plan):
    """DataFrame.cache(): materialize THIS subtree's lowered lineage
    (RDD.cache underneath) on first evaluation; every query derived from
    the cached frame replans from the one materialization. The node is an
    OPTIMIZER BARRIER — pushing filters/pruning below it would specialize
    the materialization per derived query and no two queries would ever
    share it."""

    def __init__(self, child: Plan):
        self.child = child

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Cached(kids[0])

    def _compute_schema(self):
        return self.child.schema()

    def describe(self):
        return "Cached[]"


class Sort(Plan):
    """Total order over the full result — a FINAL operator; the engine
    stays unordered and the driver applies the order (with a
    per-partition top-n when a Limit sits directly above)."""

    def __init__(self, child: Plan, keys: Iterable):
        self.child = child
        self.keys = tuple(keys)  # ((Expr, ascending), ...)

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Sort(kids[0], self.keys)

    def _compute_schema(self):
        base = self.child.schema()
        for e, _ in self.keys:
            e.dtype(base)  # validate references
        return base

    def describe(self):
        keys = ", ".join(f"{e.sql()} {'asc' if asc else 'desc'}"
                         for e, asc in self.keys)
        return f"Sort[{keys}]"


class Limit(Plan):
    def __init__(self, child: Plan, n: int):
        self.child = child
        self.n = n

    def children(self):
        return [self.child]

    def with_children(self, kids):
        return Limit(kids[0], self.n)

    def _compute_schema(self):
        return self.child.schema()

    def describe(self):
        return f"Limit[{self.n}]"
