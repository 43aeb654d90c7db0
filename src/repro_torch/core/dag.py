"""DAG scheduler: cut the RDD lineage into stages at wide dependencies.

Faithful to the paper's division of labor: this layer produces the physical
plan (stages of tasks + shuffle specs); the pluggable backend
(core.scheduler.FlintScheduler or core.cluster.ClusterScheduler) only ever
sees stages and tasks.

A TaskDef is fully self-describing: an input spec (source byte-range,
driver collection partition, shuffle read, or cached-partition read) plus
the chain of narrow ops to apply. Functions are shipped with core.serde
(mini-cloudpickle).

Two plan-level optimizations live here (docs/dag_fanout.md):

COMMON-SUBEXPRESSION ELIMINATION: the planner fingerprints every lineage
node (structure + serialized functions), so when the same shuffle — same
input lineage, mode, partition count, combiner, and transport — is needed
by more than one consumer (a self-join, a diamond where one RDD feeds two
wide ops, a union of two derivations of one RDD), its producer stage is
planned exactly ONCE and the shared ``ShuffleWrite`` is tagged with one
CONSUMER GROUP per read site. Each ``ShuffleRead`` carries its group
index; transports fan data out (or multi-read it non-destructively) per
group, so every consumer sees the full stream independently. A self-join
collapses further: both sides fingerprint identically, so the join reads
a single shuffle once (``ShuffleRead.self_join``) instead of draining two
copies of the same data.

CACHE MATERIALIZATION: an RDD marked ``.cache()`` gets a per-task
``("cache", ...)`` op that tees its computed partitions to
content-addressed ``_cache/{token}/{nparts}/p{i}/`` object-store keys
(columnar batches). A later ACTION whose lineage reaches the same
fingerprint reads ``CacheInput`` partitions instead of replanning the
upstream stages. The token is the lineage fingerprint, so caching assumes
the same determinism the rest of the fault-tolerance story already does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import pickle
from typing import Any

from repro_torch.core import costs
from repro_torch.core import rdd as R
from repro_torch.core import serde

_next_shuffle = itertools.count()


@dataclasses.dataclass
class SourceInput:
    key: str
    start: int
    end: int
    size: int


@dataclasses.dataclass
class CollectionInput:
    key: str
    index: int


@dataclasses.dataclass
class CacheInput:
    """One materialized partition of a cached lineage: columnar batches
    under ``_cache/{token}/{nparts}/p{index}/``."""
    token: str
    nparts: int
    index: int


@dataclasses.dataclass
class ShuffleRead:
    """One or two (join) shuffle inputs feeding a task."""
    parts: list  # list of (shuffle_id, mode) — mode: agg|group|join|repart
    partition: int
    combine_fn: Any = None  # serialized via serde at task-build time
    # shuffle_id -> transport name, mirroring the producing ShuffleWrite's
    # hint so both ends of a shuffle always agree on the backend
    transports: dict | None = None
    # consumer-group index per ``parts`` entry (None => group 0): each read
    # site of a CSE-shared shuffle drains its own group, so sibling
    # consumers never steal each other's messages
    groups: list | None = None
    # a self-join reads ONE shared shuffle and uses the drained aggregate
    # as both sides, instead of shipping the same data twice
    self_join: bool = False
    # join semantics: inner | left | right | outer — which side's
    # unmatched rows survive (paired with None)
    join_how: str = "inner"
    # adaptive partition coalescing (runtime rewrite only — never set at
    # plan time): the CONTIGUOUS list of producer partitions this task
    # drains instead of just ``partition``; order is preserved so an
    # index-ordered merge still yields globally sorted output
    partitions: list | None = None


@dataclasses.dataclass
class ShuffleWrite:
    shuffle_id: int
    nparts: int
    mode: str  # agg | group | join | repart
    combine_fn: Any = None  # map-side combine (reduceByKey)
    key_side: str = ""  # join: 'left' | 'right'
    # per-shuffle transport hint (core.shuffle registry name); "" defers
    # to FlintConfig.shuffle_backend — the Flock-style per-shuffle choice
    transport: str = ""
    # number of independent consumer groups reading this shuffle (CSE fans
    # one producer stage out to N consuming read sites); fixed by the time
    # planning completes, before any channel opens
    consumer_groups: int = 1
    # declared (key, value) column schemas for this shuffle's typed
    # columnar batches (serde schema grammar); None => per-batch sniffing.
    # The SQL lowering sets this — it knows row types at plan time.
    batch_schema: tuple | None = None
    # repart mode: explicit record -> partition routing (range
    # partitioner for distributed orderBy); None => round-robin
    partition_fn: Any = None
    # planner's shuffle-volume estimate (bytes) — the adaptive scheduler
    # compares it against measured stage output at runtime
    est_bytes: float = 0.0
    # True when ``transport`` was resolved by the cost model ("auto"
    # default, no per-shuffle hint): only those choices may be revisited
    # at runtime from measured volume — explicit hints stay pinned
    auto_transport: bool = False


@dataclasses.dataclass
class TaskDef:
    stage_id: int
    index: int
    input: Any  # SourceInput | CollectionInput | CacheInput | ShuffleRead
    ops: list  # [(kind, fn), ...]
    write: ShuffleWrite | None  # None => result/save stage


@dataclasses.dataclass
class StagePlan:
    id: int
    tasks: list
    write: ShuffleWrite | None
    action: str | None = None  # set on the final stage
    save_prefix: str | None = None
    # RDD.take(n) / DataFrame.limit(n): the action merge stops consuming
    # partition results once this many records have accumulated (each
    # partition also carries a per-task "limit" op capping evaluation)
    limit: int | None = None
    # shuffle_id -> number of producer TASKS feeding it. Known at plan time
    # (it is just the producing stage's task count), which is what lets the
    # scheduler hand consumers an EOS quorum up front and launch them
    # concurrently with their producers instead of waiting for post-hoc
    # per-queue message-count expectations.
    producer_counts: dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------ lineage fingerprints


def _fn_fingerprint(fn, memo: dict | None = None) -> bytes:
    if fn is None:
        return b"-"
    try:
        return serde.dumps_fn(fn)
    except Exception:
        # unserializable callable: the id() keeps it distinct from every
        # OTHER live object, so within one plan (where the RDD graph pins
        # the objects) CSE stays conservative. Across actions id reuse
        # could alias a released function, so the walk is flagged
        # unstable and cache_token refuses to content-address it.
        if memo is not None:
            memo["unstable"] = True
        return f"unserializable:{id(fn)}".encode()


def lineage_fingerprint(node, _memo: dict | None = None) -> bytes:
    """Structural content hash of a lineage: node types, parameters, and
    the serialized bytes of every user function. Two RDDs with equal
    fingerprints compute the same partitions, so the planner may share
    their shuffles — separately-constructed but identical derivations
    merge just like reuse of one RDD object. Falls back to object
    identity for anything it cannot serialize (no false merges)."""
    memo = {} if _memo is None else _memo
    got = memo.get(id(node))
    if got is not None:
        return got
    if isinstance(node, R.Source):
        parts: tuple = (b"src", node.key, node.nparts)
    elif isinstance(node, R.ParallelCollection):
        parts = (b"coll", node.key, node.nparts)
    elif isinstance(node, R.Narrow):
        parts = (b"narrow", node.kind, _fn_fingerprint(node.fn, memo),
                 lineage_fingerprint(node.parent, memo))
    elif isinstance(node, R.ShuffleAgg):
        parts = (b"agg", node.map_side_combine, node.nparts,
                 node.transport or "", _fn_fingerprint(node.fn, memo),
                 lineage_fingerprint(node.parent, memo))
    elif isinstance(node, R.Repartition):
        parts = (b"repart", node.nparts, node.transport or "",
                 _fn_fingerprint(getattr(node, "partition_fn", None), memo),
                 lineage_fingerprint(node.parent, memo))
    elif isinstance(node, R.Join):
        parts = (b"join", node.nparts, node.transport or "",
                 getattr(node, "how", "inner"),
                 lineage_fingerprint(node.left, memo),
                 lineage_fingerprint(node.right, memo))
    elif isinstance(node, R.Union):
        parts = (b"union", lineage_fingerprint(node.a, memo),
                 lineage_fingerprint(node.b, memo))
    else:
        raise TypeError(f"unknown RDD node {type(node).__name__}")
    digest = hashlib.sha1(pickle.dumps(parts)).digest()
    memo[id(node)] = digest
    return digest


def cache_token(node) -> str | None:
    """Content-addressed cache identity for ``RDD.cache()`` partitions,
    or None when the lineage contains an unserializable callable — its
    identity-based fingerprint is not stable across actions (CPython id
    reuse could alias a different function), so such lineages simply
    recompute instead of risking a false cache hit."""
    memo: dict = {}
    fp = lineage_fingerprint(node, memo)
    if memo.get("unstable"):
        return None
    return fp.hex()[:24]


class _Chain:
    """A stage under construction: per-task (input, ops)."""

    def __init__(self, task_inputs, producer_counts=None):
        self.task_inputs = task_inputs  # list of input specs
        self.ops_per_task = [[] for _ in task_inputs]
        self.producer_counts = dict(producer_counts or {})

    def add_op(self, kind, fn):
        for ops in self.ops_per_task:
            ops.append((kind, fn))


class _Planner:
    """One build_plan invocation: carries the stage list, the CSE memo of
    closed shuffles, and the cache registry shared with the context."""

    def __init__(self, mult: int, cse: bool, cache_index: dict | None,
                 default_transport: str = "", share=None):
        self.stages: list[StagePlan] = []
        self.mult = mult
        self.cse = cse
        self.cache_index = cache_index
        self.default_transport = default_transport
        # service-wide CSE (docs/multi_tenant.md): a per-job view of the
        # share registry. ``lookup(key)`` answers with another LIVE job's
        # identical shuffle — this plan then reads it as a FOREIGN input
        # (no producer stage of its own) via a fresh consumer group;
        # ``publish`` offers this plan's own closed shuffles in return
        self.share = share
        self._fps: dict[int, bytes] = {}
        # close-site key -> (sid, n_producer_tasks, ShuffleWrite)
        self._shared: dict[tuple, tuple] = {}
        # close-site key -> (sid, n_prod) for foreign (cross-job) hits
        self._foreign: dict[tuple, tuple] = {}
        self._materializing: set[str] = set()
        # id(node) -> (node, estimate). The node reference is kept ON
        # PURPOSE: a memo keyed by bare id() could hand a GC'd node's
        # reused id the estimate of an unrelated lineage; pinning the
        # node makes the id stable for this planner's lifetime and the
        # identity check below rejects any entry that isn't ours.
        self._est_memo: dict[int, tuple] = {}

    def fp(self, node) -> bytes:
        return lineage_fingerprint(node, self._fps)

    # ------------------------------------------ adaptive transport choice
    def _cache_entry(self, node) -> dict | None:
        if not getattr(node, "cached", False) or self.cache_index is None:
            return None
        entry = self.cache_index.get(cache_token(node))
        return entry if entry and entry.get("ready") else None

    def _est_bytes(self, node) -> float:
        """Planner-side shuffle-volume estimate: source object sizes
        scaled by textbook selectivity constants, or the ACTUAL stored
        batch sizes when the lineage is a ready cache() materialization.
        Drives the cost-model transport choice — it only has to land on
        the right side of the SQS/S3 crossover, not be exact."""
        got = self._est_memo.get(id(node))
        if got is not None and got[0] is node:
            return got[1]
        val = None
        entry = self._cache_entry(node)
        if entry is not None:
            token = cache_token(node)
            stored = float(node.ctx.store.prefix_bytes(
                f"_cache/{token}/{entry['nparts']}/"))
            # staleness check: a just-uncache()d token can linger in the
            # index while its prefix is already swept — 0 stored bytes
            # for a "ready" entry means fall through to the lineage walk
            # instead of estimating a non-empty dataset at zero
            if stored > 0:
                val = stored
        if val is not None:
            pass
        elif isinstance(node, R.Source):
            val = float(node.ctx.store.size(node.key))
        elif isinstance(node, R.ParallelCollection):
            val = float(sum(node.ctx.store.size(f"{node.key}/{i}")
                            for i in range(node.nparts)))
        elif isinstance(node, R.Narrow):
            factor = (costs.EST_FILTER_SELECTIVITY
                      if node.kind == "filter" else 1.0)
            val = self._est_bytes(node.parent) * factor
        elif isinstance(node, R.ShuffleAgg):
            val = self._est_bytes(node.parent) * costs.EST_AGG_OUTPUT_FACTOR
        elif isinstance(node, R.Repartition):
            val = self._est_bytes(node.parent)
        elif isinstance(node, R.Join):
            val = self._est_bytes(node.left) + self._est_bytes(node.right)
        elif isinstance(node, R.Union):
            val = self._est_bytes(node.a) + self._est_bytes(node.b)
        else:
            raise TypeError(f"unknown RDD node {type(node).__name__}")
        self._est_memo[id(node)] = (node, val)
        return val

    def _est_producers(self, node) -> int:
        """Approximate producer TASK count for a shuffle fed by ``node`` —
        per-channel object/request overheads scale with it."""
        entry = self._cache_entry(node)
        if entry is not None:
            return entry["nparts"]
        if isinstance(node, R.Source):
            return node.nparts * self.mult
        if isinstance(node, R.ParallelCollection):
            return node.nparts
        if isinstance(node, R.Narrow):
            return self._est_producers(node.parent)
        if isinstance(node, R.Union):
            return (self._est_producers(node.a)
                    + self._est_producers(node.b))
        return node.nparts * self.mult  # wide op: its own partition count

    def _auto_transport(self, parent, nparts: int) -> str:
        """Cost-model SQS-vs-S3 choice for one shuffle (engine default
        "auto", no per-shuffle hint). Falls back to the paper's SQS when
        the lineage offers no size information."""
        try:
            est = self._est_bytes(parent)
        except Exception:
            return "sqs"
        return costs.pick_shuffle_transport(est,
                                            self._est_producers(parent),
                                            nparts)

    def _transport_for(self, node_hint: str | None, parent,
                       nparts: int) -> tuple[str, bool]:
        """Resolve one shuffle's transport; the second element records
        whether the COST MODEL chose it (vs an explicit hint / engine
        default), i.e. whether the adaptive runtime may re-choose it."""
        tr = node_hint or ""
        if not tr and self.default_transport == "auto":
            return self._auto_transport(parent, nparts), True
        return tr, False

    # ------------------------------------------------------------- visit
    def visit(self, node) -> _Chain:
        """Returns the open chain for ``node``; completed upstream stages
        land in ``self.stages`` in topological order."""
        token = None
        if getattr(node, "cached", False) and self.cache_index is not None:
            token = cache_token(node)
            entry = self.cache_index.get(token)
            if entry and entry.get("ready"):
                n = entry["nparts"]
                return _Chain([CacheInput(token, n, i)
                               for i in range(n)])
        chain = self._visit(node)
        if token is not None and token not in self._materializing:
            # first read site of this cached lineage in this plan tees its
            # partitions to the store; later sites share the CSE'd shuffle
            # instead of writing the same bytes twice
            self._materializing.add(token)
            n = len(chain.task_inputs)
            self.cache_index[token] = {"nparts": n, "ready": False}
            for i, ops in enumerate(chain.ops_per_task):
                ops.append(("cache", (token, n, i)))
        return chain

    def _visit(self, node) -> _Chain:
        if isinstance(node, R.Source):
            # byte-range splits re-cut freely, so the elasticity
            # multiplier scales them too — a source-rooted task past the
            # memory cap (e.g. a cache() materialization) must shrink on
            # the re-plan like any wide partition would
            nparts = node.nparts * self.mult
            size = node.ctx.store.size(node.key)
            step = max(1, -(-size // nparts))
            inputs = [SourceInput(node.key, i * step,
                                  min(size, (i + 1) * step), size)
                      for i in range(nparts)]
            return _Chain(inputs)
        if isinstance(node, R.ParallelCollection):
            return _Chain([CollectionInput(node.key, i)
                           for i in range(node.nparts)])
        if isinstance(node, R.Narrow):
            chain = self.visit(node.parent)
            chain.add_op(node.kind, node.fn)
            return chain
        if isinstance(node, R.Union):
            ca = self.visit(node.a)
            cb = self.visit(node.b)
            merged = _Chain(ca.task_inputs + cb.task_inputs,
                            {**ca.producer_counts, **cb.producer_counts})
            merged.ops_per_task = ca.ops_per_task + cb.ops_per_task
            return merged
        if isinstance(node, R.ShuffleAgg):
            mode = "agg" if node.map_side_combine else "group"
            nparts = node.nparts * self.mult
            tr, auto = self._transport_for(node.transport, node.parent,
                                           nparts)
            sid, n_prod, group = self._close_shared(
                node.parent, mode, nparts, node.fn, tr,
                batch_schema=node.batch_schema, auto_transport=auto)
            inputs = [ShuffleRead([(sid, mode)], p, combine_fn=node.fn,
                                  transports={sid: tr}, groups=[group])
                      for p in range(nparts)]
            return _Chain(inputs, {sid: n_prod})
        if isinstance(node, R.Repartition):
            nparts = node.nparts * self.mult
            tr, auto = self._transport_for(node.transport, node.parent,
                                           nparts)
            sid, n_prod, group = self._close_shared(
                node.parent, "repart", nparts, None, tr,
                partition_fn=node.partition_fn, auto_transport=auto)
            inputs = [ShuffleRead([(sid, "repart")], p,
                                  transports={sid: tr}, groups=[group])
                      for p in range(nparts)]
            return _Chain(inputs, {sid: n_prod})
        if isinstance(node, R.Join):
            nparts = node.nparts * self.mult
            how = node.how
            tr_l, auto_l = self._transport_for(node.transport, node.left,
                                               nparts)
            tr_r, auto_r = self._transport_for(node.transport, node.right,
                                               nparts)
            schemas = node.batch_schemas or (None, None, None)
            bs_l = (schemas[0], schemas[1]) if schemas[0] else None
            bs_r = (schemas[0], schemas[2]) if schemas[0] else None
            sid_l, n_left, g_l = self._close_shared(
                node.left, "join", nparts, None, tr_l, key_side="left",
                batch_schema=bs_l, auto_transport=auto_l)
            if (self.cse and self._close_key(node.right, "join", nparts,
                                             None, tr_r, bs_r)
                    == self._close_key(node.left, "join", nparts, None,
                                       tr_l, bs_l)):
                # SELF-JOIN: both sides are the same lineage — one shared
                # shuffle, drained once, used as left AND right (every
                # outer-join variant degenerates to inner here: a key
                # always matches itself)
                inputs = [ShuffleRead([(sid_l, "join")], p,
                                      transports={sid_l: tr_l},
                                      groups=[g_l], self_join=True,
                                      join_how=how)
                          for p in range(nparts)]
                return _Chain(inputs, {sid_l: n_left})
            sid_r, n_right, g_r = self._close_shared(
                node.right, "join", nparts, None, tr_r, key_side="right",
                batch_schema=bs_r, auto_transport=auto_r)
            inputs = [ShuffleRead([(sid_l, "join"), (sid_r, "join")], p,
                                  transports={sid_l: tr_l, sid_r: tr_r},
                                  groups=[g_l, g_r], join_how=how)
                      for p in range(nparts)]
            return _Chain(inputs, {sid_l: n_left, sid_r: n_right})
        raise TypeError(f"unknown RDD node {type(node).__name__}")

    # ------------------------------------------------------- shuffle CSE
    def _close_key(self, node, mode: str, nparts: int, combine,
                   transport: str, batch_schema: tuple | None = None,
                   partition_fn=None) -> tuple:
        """What makes two shuffles interchangeable: identical input
        lineage, mode, partition count, combiner, transport, declared
        batch schema, and (repart) partition function. A join's
        ``key_side`` is deliberately EXCLUDED — a self-join's two sides
        carry identical data."""
        return (self.fp(node), mode, nparts, _fn_fingerprint(combine),
                transport, batch_schema, _fn_fingerprint(partition_fn))

    def _close_shared(self, node, mode: str, nparts: int, combine,
                      transport: str, key_side: str = "",
                      batch_schema: tuple | None = None,
                      partition_fn=None,
                      auto_transport: bool = False) -> tuple[int, int, int]:
        """Close (or reuse) the producer stage for one shuffle. Returns
        (shuffle_id, producer task count, consumer-group index for this
        read site)."""
        key = self._close_key(node, mode, nparts, combine, transport,
                              batch_schema, partition_fn) \
            if self.cse else None
        if key is not None:
            hit = self._shared.get(key)
            if hit is not None:
                sid, n_prod, write = hit
                write.consumer_groups += 1
                return sid, n_prod, write.consumer_groups - 1
            if self.share is not None:
                fhit = self._foreign.get(key)
                if fhit is None:
                    fhit = self.share.lookup(key)
                    if fhit is not None:
                        self._foreign[key] = fhit
                if fhit is not None:
                    # another live job already plans (or ran) this exact
                    # shuffle: skip the producer stage entirely and drain
                    # its stream through a fresh consumer group. Only
                    # S3-routed shuffles resolve here — the registry
                    # refuses destructive (queue) transports
                    sid, n_prod = fhit
                    return sid, n_prod, self.share.join_group(sid)
        try:
            est = float(self._est_bytes(node))
        except Exception:
            est = 0.0
        write = ShuffleWrite(next(_next_shuffle), nparts, mode,
                             combine_fn=combine, key_side=key_side,
                             transport=transport,
                             batch_schema=batch_schema,
                             partition_fn=partition_fn,
                             est_bytes=est,
                             auto_transport=auto_transport)
        chain = self.visit(node)
        sid = write.shuffle_id
        stage_id = len(self.stages)
        tasks = [TaskDef(stage_id, i, inp, ops, write)
                 for i, (inp, ops) in enumerate(
                     zip(chain.task_inputs, chain.ops_per_task))]
        self.stages.append(StagePlan(stage_id, tasks, write,
                                     producer_counts=chain.producer_counts))
        n_prod = len(tasks)
        if key is not None:
            self._shared[key] = (sid, n_prod, write)
            if self.share is not None:
                self.share.publish(key, sid, n_prod, write)
        return sid, n_prod, 0


def estimate_lineage_bytes(node, cache_index: dict | None = None) -> float:
    """Standalone shuffle-volume estimate for an RDD lineage (the SQL
    optimizer prices toDF sources with it; the planner uses the same walk
    internally for "auto" transport resolution)."""
    return _Planner(1, True, cache_index)._est_bytes(node)


def build_plan(node, action: str, save_prefix: str | None = None,
               partition_multiplier: int = 1, *, cse: bool = True,
               cache_index: dict | None = None,
               default_transport: str = "",
               limit: int | None = None, share=None) -> list[StagePlan]:
    """Physical plan for one action. ``partition_multiplier`` scales wide-op
    partition counts — the paper's elasticity answer to the executor memory
    cap. ``cse=False`` restores the one-consumer-per-shuffle planner (kept
    for the fan-out A/B benchmark); ``cache_index`` is the context-owned
    registry of materialized ``RDD.cache()`` lineages.

    ``default_transport="auto"`` makes the planner resolve every unhinted
    shuffle to SQS or the S3 exchange via the cost model (estimated volume
    x the ledger's price constants); any other value leaves unhinted
    shuffles to the runtime fallback (FlintConfig.shuffle_backend).
    ``limit`` caps the action merge (RDD.take / DataFrame.limit).
    ``share`` is a per-job view of the multi-tenant service's cross-job
    CSE registry (repro_torch.svc.share) — None outside the service."""
    planner = _Planner(partition_multiplier, cse, cache_index,
                       default_transport, share=share)
    chain = planner.visit(node)
    stages = planner.stages
    stage_id = len(stages)
    tasks = [TaskDef(stage_id, i, inp, ops, None)
             for i, (inp, ops) in enumerate(
                 zip(chain.task_inputs, chain.ops_per_task))]
    stages.append(StagePlan(stage_id, tasks, None, action=action,
                            save_prefix=save_prefix, limit=limit,
                            producer_counts=chain.producer_counts))
    return stages
