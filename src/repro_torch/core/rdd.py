"""RDD lineage — the user-facing dataflow API (PySpark-compatible subset).

An RDD is a lazy lineage node; nothing executes until an action. The DAG
scheduler (core.dag) cuts the lineage into stages at wide dependencies,
exactly as the paper describes reusing Spark's physical planning. Because
every wide dependency's producer task count is fixed at plan time, stage
plans carry those counts down to the scheduler, which pipelines consumer
stages concurrently with their producers (EOS shuffle protocol — see
docs/eos_shuffle.md) instead of barrier-scheduling them.

Supported transformations: map, filter, flatMap, mapPartitions (narrow);
reduceByKey, groupByKey, join, repartition (wide); union; cache (lineage
materialization). Actions: collect, count, take, reduce, saveAsTextFile.
Shared lineages (self-joins, diamonds, unions of two derivations) are
planned once via shuffle CSE — see docs/dag_fanout.md.

``toDF(schema)`` lifts an RDD of tuples onto the structured DataFrame
surface (repro_torch.sql, docs/dataframe.md), whose optimizer lowers back onto
this lineage API. Wide ops accept a ``batch_schema`` declaring the typed
columnar wire format at plan time — the SQL lowering knows its row types,
so its shuffles skip per-batch type sniffing.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

_next_id = itertools.count()


class RDD:
    #: set by .cache() — the planner materializes this node's partitions
    #: to content-addressed object-store keys on first evaluation and
    #: reads them back on later actions (docs/dag_fanout.md)
    cached = False

    def __init__(self, ctx, nparts: int):
        self.ctx = ctx
        self.id = next(_next_id)
        self.nparts = nparts

    # ------------------------------------------------------ transformations
    def map(self, fn: Callable) -> "RDD":
        return Narrow(self, "map", fn)

    def filter(self, fn: Callable) -> "RDD":
        return Narrow(self, "filter", fn)

    def flatMap(self, fn: Callable) -> "RDD":
        return Narrow(self, "flatmap", fn)

    def mapPartitions(self, fn: Callable) -> "RDD":
        return Narrow(self, "mappartitions", fn)

    def mapBatches(self, fn: Callable) -> "RDD":
        """Batch-level narrow op: ``fn(record_iter)`` consumes a whole
        partition and yields records OR column-major ``KVBatch`` carriers
        (core.shuffle.KVBatch). The vectorized SQL lowering fuses
        scan→filter→project→partial-agg chains into one such operator so
        data stays columnar from the scan to the shuffle pack
        (docs/vectorized_execution.md); executors expand any KVBatch back
        to rows wherever a row consumer needs them."""
        return Narrow(self, "mapbatches", fn)

    def reduceByKey(self, fn: Callable, numPartitions: int | None = None,
                    transport: str | None = None,
                    batch_schema: tuple | None = None) -> "RDD":
        return ShuffleAgg(self, fn, numPartitions or self.nparts,
                          map_side_combine=True, transport=transport,
                          batch_schema=batch_schema)

    def groupByKey(self, numPartitions: int | None = None,
                   transport: str | None = None,
                   batch_schema: tuple | None = None) -> "RDD":
        return ShuffleAgg(self, None, numPartitions or self.nparts,
                          map_side_combine=False, transport=transport,
                          batch_schema=batch_schema)

    def join(self, other: "RDD", numPartitions: int | None = None,
             transport: str | None = None,
             batch_schemas: tuple | None = None,
             how: str = "inner") -> "RDD":
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join how={how!r}")
        return Join(self, other,
                    numPartitions or max(self.nparts, other.nparts),
                    transport=transport, batch_schemas=batch_schemas,
                    how=how)

    def repartition(self, numPartitions: int,
                    transport: str | None = None,
                    partition_fn: Callable | None = None) -> "RDD":
        """``partition_fn(record) -> int`` routes each record to a
        partition index (modulo numPartitions) instead of the default
        round-robin — the range partitioner behind distributed orderBy."""
        return Repartition(self, numPartitions, transport=transport,
                           partition_fn=partition_fn)

    def union(self, other: "RDD") -> "RDD":
        return Union(self, other)

    def cache(self) -> "RDD":
        """Materialize this RDD's partitions (columnar batches under
        ``_cache/``) the first time an action evaluates them; later
        actions on the same lineage read the materialization instead of
        replanning upstream stages. Storage is billed through the cost
        ledger and reclaimed by ``ctx.clear_cache()`` (stale entries by
        the job-scoped GC)."""
        self.cached = True
        return self

    def cache_token(self) -> str | None:
        """Content-addressed identity of this lineage's cache() entry
        (None when the lineage holds an unserializable callable — such
        lineages never materialize)."""
        from repro_torch.core.dag import cache_token  # lazy: dag imports rdd
        return cache_token(self)

    def uncache(self) -> int:
        """Drop this RDD's cache() materialization and registration
        (clears the ``cached`` mark too, so the next action recomputes
        from source without re-materializing); returns the number of
        store keys removed."""
        self.cached = False
        token = self.cache_token()
        return self.ctx.uncache(token) if token else 0

    def toDF(self, schema) -> "Any":
        """Lift an RDD whose records are tuples matching ``schema`` (a
        repro_torch.sql Schema or a list of (name, dtype) pairs) onto the
        DataFrame surface — see docs/dataframe.md."""
        from repro_torch.sql import DataFrame  # lazy: sql imports core
        return DataFrame.from_rdd(self, schema)

    # ------------------------------------------------------------- actions
    def collect(self) -> list:
        return self.ctx.run_action(self, "collect")

    def count(self) -> int:
        return self.ctx.run_action(self.mapPartitions(_count_iter), "sum")

    def reduce(self, fn: Callable):
        partials = self.ctx.run_action(self.mapPartitions(_reduce_with(fn)),
                                       "collect")
        vals = [p for p in partials if p is not _EMPTY]
        out = vals[0]
        for v in vals[1:]:
            out = fn(out, v)
        return out

    def take(self, n: int) -> list:
        """First n records in partition order. Plans a per-partition
        ``limit`` op (each partition stops evaluating — and a source task
        stops READING — after its first n records) and short-circuits the
        action merge at n, instead of the old full collect()."""
        if n <= 0:
            return []
        return self.ctx.run_action(Narrow(self, "limit", n), "collect",
                                   limit=n)

    def saveAsTextFile(self, key_prefix: str):
        return self.ctx.run_action(self, "save", save_prefix=key_prefix)


class _Empty:
    def __repr__(self):
        return "<empty>"


_EMPTY = _Empty()


def _count_iter(it):
    n = 0
    for _ in it:
        n += 1
    yield n


def _reduce_with(fn):
    def part_reduce(it):
        acc = _EMPTY
        for x in it:
            acc = x if acc is _EMPTY else fn(acc, x)
        yield acc
    return part_reduce


class Source(RDD):
    """Byte-range-partitioned text object in the object store."""

    def __init__(self, ctx, key: str, nparts: int):
        super().__init__(ctx, nparts)
        self.key = key


class ParallelCollection(RDD):
    """Driver-side data distributed into partitions (ctx.parallelize)."""

    def __init__(self, ctx, key: str, nparts: int):
        super().__init__(ctx, nparts)
        self.key = key  # pre-uploaded pickled partitions under this prefix


class Narrow(RDD):
    def __init__(self, parent: RDD, kind: str, fn: Callable):
        super().__init__(parent.ctx, parent.nparts)
        self.parent = parent
        self.kind = kind
        self.fn = fn


class ShuffleAgg(RDD):
    """reduceByKey / groupByKey. ``transport`` is the per-shuffle backend
    hint (core.shuffle registry name); None defers to the engine default
    (which may be the planner's cost-model choice — docs/dataframe.md).
    ``batch_schema`` is an optional declared (key, value) column-schema
    pair for the shuffle's typed columnar batches."""

    def __init__(self, parent: RDD, fn, nparts: int, *,
                 map_side_combine: bool, transport: str | None = None,
                 batch_schema: tuple | None = None):
        super().__init__(parent.ctx, nparts)
        self.parent = parent
        self.fn = fn
        self.map_side_combine = map_side_combine
        self.transport = transport
        self.batch_schema = batch_schema


class Repartition(RDD):
    def __init__(self, parent: RDD, nparts: int,
                 transport: str | None = None,
                 partition_fn: Callable | None = None):
        super().__init__(parent.ctx, nparts)
        self.parent = parent
        self.transport = transport
        self.partition_fn = partition_fn


class Join(RDD):
    """``batch_schemas`` declares (key-schema, left-value-schema,
    right-value-schema) for the two side shuffles' columnar batches.
    ``how`` selects inner/left/right/outer semantics — unmatched rows of
    a preserved side pair with None."""

    def __init__(self, left: RDD, right: RDD, nparts: int,
                 transport: str | None = None,
                 batch_schemas: tuple | None = None,
                 how: str = "inner"):
        super().__init__(left.ctx, nparts)
        self.left = left
        self.right = right
        self.transport = transport
        self.batch_schemas = batch_schemas
        self.how = how


class Union(RDD):
    def __init__(self, a: RDD, b: RDD):
        super().__init__(a.ctx, a.nparts + b.nparts)
        self.a = a
        self.b = b
