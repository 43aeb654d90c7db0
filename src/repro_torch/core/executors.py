"""The Flint executor — a process inside a (simulated) Lambda invocation —
plus the Lambda runtime simulation itself.

Semantics preserved from the paper (§III-A/B):
  * one task per invocation; executors are stateless between invocations;
  * input iterator reads an S3 byte range (stage 0) or drains a shuffle
    transport (intermediate stages) — a pluggable backend behind the
    ``core.shuffle.ShuffleTransport`` contract, chosen per shuffle
    (``ShuffleWrite.transport`` hint, default ``cfg.shuffle_backend``).
    Both execution modes terminate the drain on per-producer EOS at the
    plan-time quorum (docs/eos_shuffle.md); dedup of at-least-once,
    unordered delivery by (producer task, sequence id) is shared drain
    state, and ACK-AFTER-FOLD (docs/shuffle_transports.md) means the
    drained input is released only once the task's OUTPUT is durable;
  * outputs are hash-partitioned, buffered in memory, and FLUSHED to the
    transport as columnar record batches (shuffle.batch) when the buffer
    grows past its cap (the 3008 MB limit made concrete as a record-count
    proxy);
  * executor CHAINING: when the invocation lease is nearly exhausted the
    executor stops ingesting, flushes, and returns a continuation cursor
    that the scheduler re-invokes on a warm container (map-side combine
    partials are safe to flush early because combiners are associative);
  * responses above the payload cap spill to the object store (6 MB cap,
    both directions).

Failure injection + the record-count lease hook make chaining, retry and
straggler behavior deterministic in tests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import pickle
import threading
import time
import zlib
from typing import Any

from repro_torch.core import serde
from repro_torch.core.costs import (LAMBDA_PAYLOAD_LIMIT,
                              S3_EXCHANGE_BATCH_LIMIT, CostLedger)
from repro_torch.core.dag import (CacheInput, CollectionInput, ShuffleRead,
                            SourceInput, TaskDef)
from repro_torch.core.faults import ConcurrencyGauge
from repro_torch.core.queues import ObjectStoreSim, SQSSim
from repro_torch.core.retry import (RetryBudget, RetryBudgetExhausted,
                              RetryExhausted, RetryingStore, RetryPolicy,
                              TransientServiceError)
from repro_torch.core.shuffle import (KVBatch, TransportSet, iter_records,
                                pack_batch, pack_batch_columns, queue_name,
                                unpack_batch)
from repro_torch.core.shuffle.base import AbortedError  # noqa: F401 (re-export:
#                       pre-subsystem callers import it from here)
from repro_torch.core.shuffle.base import LostShuffleInput


class InjectedFailure(RuntimeError):
    pass


class InvocationTimeout(RuntimeError):
    """The invocation lease expired mid-task: the container is killed with
    no final flush — whatever full batches already flushed are durable
    (partial shuffle writes LAND), and the retry re-emits byte-identical
    batches that downstream (src, seq) dedup absorbs."""


class LostCacheInput(RuntimeError):
    """A cache partition's manifest disagrees with the batches actually on
    the store: a materialized batch was acknowledged and then lost.
    Retrying the reading task cannot help — the context must replan and
    re-materialize the cached lineage (docs/fault_tolerance.md)."""

    def __init__(self, msg: str, token: str = ""):
        super().__init__(msg)
        self.detail = {"token": token}


class LostBroadcastInput(RuntimeError):
    """A broadcast object's manifest disagrees with the batches actually
    on the store: the small-side data a broadcast hash join depends on
    was acknowledged and then lost. Retrying the reading task cannot
    help — the scheduler must re-run the small side's lineage and
    re-publish the broadcast (docs/adaptive_execution.md)."""

    def __init__(self, msg: str, prefix: str = ""):
        super().__init__(msg)
        self.detail = {"broadcast_prefix": prefix}


class MemoryCapExceeded(RuntimeError):
    """Aggregation state outgrew the executor memory cap — the paper's
    answer is elasticity: raise the partition count and re-run."""


@dataclasses.dataclass
class FlintConfig:
    memory_mb: int = 3008
    time_limit_s: float = 300.0
    # default intermediate-data transport: "auto" lets the planner pick
    # SQS or the Lambada-style S3 exchange PER SHUFFLE from estimated
    # volume and the cost model (docs/dataframe.md); "sqs" (the paper's
    # choice) or "s3" pin one engine-wide. A ShuffleWrite.transport hint
    # overrides either, per shuffle. The env var lets CI run the whole
    # tier-1 suite under each backend without touching test code.
    shuffle_backend: str = dataclasses.field(
        default_factory=lambda: os.environ.get("FLINT_SHUFFLE_BACKEND",
                                               "auto"))
    # frame shuffle batches as typed key/value columns where the data is
    # homogeneous (shuffle.batch); False forces per-record pickle framing
    # everywhere (the pre-columnar wire format, kept for A/B measurement)
    columnar_batches: bool = True
    # pipelined stage execution: launch consumer tasks concurrently with
    # their producers; consumers terminate on per-producer EOS control
    # messages. False restores barrier scheduling (A/B comparison).
    pipeline_stages: bool = True
    # plan-time common-subexpression elimination: shared lineages
    # (self-joins, diamonds, unions of two derivations) plan ONE producer
    # stage with per-read-site consumer groups. False restores the
    # one-consumer-per-shuffle planner (A/B comparison).
    plan_cse: bool = True
    # adaptive query execution (docs/adaptive_execution.md): collect
    # per-stage shuffle-output statistics and re-optimize the REMAINING
    # plan at stage boundaries — broadcast-join conversion, tiny-partition
    # coalescing, measured-volume transport re-choice, and the sampled
    # range partitioner behind distributed orderBy. False freezes the
    # static plan (A/B comparison).
    adaptive: bool = dataclasses.field(
        default_factory=lambda: os.environ.get("FLINT_ADAPTIVE",
                                               "1") not in ("0", "false"))
    # measured small-side cap for switching a planned shuffle join to a
    # broadcast hash join (the small side ships as a content-addressed
    # _broadcast/ object every map task reads — no shuffle for either
    # side, the join fuses into the large side's producer stage)
    broadcast_threshold_bytes: int = 512 * 2**10
    # coalesce adjacent reduce partitions whose measured input falls
    # below this floor into one consumer task (0 disables)
    coalesce_min_bytes: int = 16 * 2**10
    # vectorized columnar execution (docs/vectorized_execution.md): the SQL
    # lowering fuses scan→filter→project→partial-agg chains into one
    # batch-in/batch-out operator evaluating whole column arrays; False
    # keeps the pure-Python per-row closures (A/B comparison). The backend
    # picks the array engine for grouped aggregation ("torch" routes integer
    # sums through the bucket_reduce kernel on ``vector_device`` — see
    # kernels.ops.grouped_reduce; "numpy" keeps them on the host). The
    # device is the card unless the caller asks for "cpu"; without a card
    # validate() raises rather than carry on on the CPU.
    vectorize: bool = True
    vector_backend: str = dataclasses.field(
        default_factory=lambda: os.environ.get("FLINT_VECTOR_BACKEND",
                                               "torch"))
    vector_device: str = "cuda"
    vector_batch_rows: int = 8192  # rows per column batch in fused ops
    lease_safety: float = 0.8  # stop ingesting at this fraction of the lease
    concurrency: int = 80
    cold_start_s: float = 0.4
    warm_start_s: float = 0.01
    start_latency_scale: float = 0.0  # 0 => don't actually sleep in tests
    flush_records: int = 20_000  # shuffle buffer cap (memory proxy)
    agg_memory_records: int = 2_000_000  # consumer-side aggregation cap
    max_records_per_invoke: int = 0  # test hook: deterministic chaining
    max_task_retries: int = 3
    speculation_factor: float = 4.0  # straggler duplicate threshold
    speculation_min_done: int = 4
    drain_timeout_s: float = 30.0
    # SQS visibility timeout: how long a received-but-unacked message stays
    # invisible before redelivery. Must stay below drain_timeout_s or a
    # retried consumer times out waiting for its predecessor's claims to
    # expire.
    visibility_timeout_s: float = 10.0
    duplicate_prob: float = 0.0  # SQS at-least-once duplication rate
    chunk_fetch_bytes: int = 4 * 2**20
    # --- resilience knobs (docs/fault_tolerance.md) ---
    # lineage recovery: how many times one producing stage may be
    # resubmitted to re-create permanently missing exchange/cache input
    max_stage_retries: int = 2
    # service-call retry layer: per-call attempt cap, decorrelated-jitter
    # backoff bounds, and the job-wide retry budget
    retry_max_attempts: int = 5
    retry_base_s: float = 0.002
    retry_cap_s: float = 0.05
    retry_budget: int = 100_000
    # scheduler dispatch backoff after a 429-throttled invocation
    dispatch_backoff_base_s: float = 0.05
    dispatch_backoff_cap_s: float = 1.0

    @property
    def fallback_backend(self) -> str:
        """Concrete transport for shuffles whose plan carries no resolved
        hint. The planner resolves "auto" per shuffle at plan time; this
        runtime fallback only fires for hand-built plans, where it keeps
        the paper's SQS default."""
        return "sqs" if self.shuffle_backend == "auto" \
            else self.shuffle_backend

    @property
    def invocation_timeout_s(self) -> float:
        """The Lambda lease: a task is killed this many seconds in."""
        return self.time_limit_s

    def validate(self):
        """Reject incoherent resilience knobs at construction, mirroring
        the scheduler's visibility_timeout_s < drain_timeout_s check."""
        if self.retry_budget <= 0:
            raise ValueError(
                f"retry_budget must be > 0, got {self.retry_budget}")
        if self.retry_max_attempts < 1:
            raise ValueError(f"retry_max_attempts must be >= 1, got "
                             f"{self.retry_max_attempts}")
        if not 0 < self.retry_base_s <= self.retry_cap_s:
            raise ValueError(
                f"retry backoff must satisfy 0 < retry_base_s <= "
                f"retry_cap_s, got base {self.retry_base_s} / cap "
                f"{self.retry_cap_s}")
        if not 0 < self.dispatch_backoff_base_s <= self.dispatch_backoff_cap_s:
            raise ValueError(
                f"dispatch backoff must satisfy 0 < base <= cap, got base "
                f"{self.dispatch_backoff_base_s} / cap "
                f"{self.dispatch_backoff_cap_s}")
        if self.max_stage_retries < 0:
            raise ValueError(f"max_stage_retries must be >= 0, got "
                             f"{self.max_stage_retries}")
        if self.vector_backend not in ("numpy", "torch"):
            raise ValueError(f"vector_backend must be 'numpy' or 'torch', "
                             f"got {self.vector_backend!r}")
        if self.vectorize and self.vector_backend == "torch":
            from repro_torch.common.device import resolve_device
            resolve_device(self.vector_device)
        if self.vector_batch_rows < 1:
            raise ValueError(f"vector_batch_rows must be >= 1, got "
                             f"{self.vector_batch_rows}")
        if self.broadcast_threshold_bytes < 0:
            raise ValueError(f"broadcast_threshold_bytes must be >= 0, "
                             f"got {self.broadcast_threshold_bytes}")
        if self.coalesce_min_bytes < 0:
            raise ValueError(f"coalesce_min_bytes must be >= 0, got "
                             f"{self.coalesce_min_bytes}")
        if self.drain_timeout_s >= self.invocation_timeout_s * self.lease_safety:
            # a drain allowed to out-wait the invocation lease converts
            # every slow producer into an invocation timeout instead of a
            # clean drain timeout — the same shape of incoherence as
            # visibility_timeout_s >= drain_timeout_s
            raise ValueError(
                f"drain_timeout_s ({self.drain_timeout_s}) must be < "
                f"invocation_timeout_s * lease_safety "
                f"({self.invocation_timeout_s} * {self.lease_safety}) or "
                f"consumers time out their own invocation before the drain "
                f"deadline can fire")


# --------------------------------------------------------------- payloads


def serialize_task(task: TaskDef, attempt: int, extra: dict | None = None
                   ) -> dict:
    # a ("cache", (token, nparts, index)), ("limit", n) or ("bcjoin",
    # spec) op carries plan data, not a user function — it ships as-is
    ops = [(kind, fn if kind in ("cache", "limit", "bcjoin")
            else serde.dumps_fn(fn))
           for kind, fn in task.ops]
    inp = task.input
    if isinstance(inp, ShuffleRead) and inp.combine_fn is not None:
        inp = dataclasses.replace(inp, combine_fn=serde.dumps_fn(inp.combine_fn))
    write = task.write
    if write is not None and (write.combine_fn is not None
                              or write.partition_fn is not None):
        write = dataclasses.replace(
            write,
            combine_fn=(serde.dumps_fn(write.combine_fn)
                        if write.combine_fn is not None else None),
            partition_fn=(serde.dumps_fn(write.partition_fn)
                          if write.partition_fn is not None else None))
    return {"stage": task.stage_id, "index": task.index, "input": inp,
            "ops": ops, "write": write, "attempt": attempt,
            **(extra or {})}


# ------------------------------------------------------------ the Lambda


class LambdaSim:
    """Invocation environment: containers (cold/warm), leases, payload caps,
    per-invocation billing."""

    def __init__(self, cfg: FlintConfig, ledger: CostLedger,
                 store: ObjectStoreSim, sqs: SQSSim,
                 transports: TransportSet | None = None, *,
                 faults=None, budget: RetryBudget | None = None,
                 gauge=None):
        self.cfg = cfg
        self.ledger = ledger
        self.store = store
        self.sqs = sqs
        self.transports = transports or TransportSet(cfg, ledger, store, sqs)
        # chaos admission hook (FaultInjector) + the executors' retrying
        # view of the store: every in-task store access rides rstore so
        # transient S3 errors are absorbed by the call-level retry layer
        self.faults = faults
        self.rstore = RetryingStore(store, RetryPolicy.from_config(
            cfg, budget=budget))
        self._warm = 0
        self._lock = threading.Lock()
        # account-concurrency gauge: private by default; the multi-tenant
        # service passes ONE shared ConcurrencyGauge so every session's
        # in-flight invocations count against the same account cap
        self.gauge = gauge if gauge is not None else ConcurrencyGauge()
        # key-space scope for this sim's transient spill keys ("" outside
        # the service; "j{n}/" per job under it, so the job-scoped GC can
        # sweep _payload/_result without touching other live jobs' keys)
        self.scope = ""
        self.invocations = 0
        self.cold_starts = 0
        self.throttles = 0

    def _acquire_container(self) -> bool:
        """Returns True on a cold start."""
        with self._lock:
            self.invocations += 1
            if self._warm > 0:
                self._warm -= 1
                return False
            self.cold_starts += 1
            return True

    def _release_container(self):
        with self._lock:
            self._warm += 1

    def invoke(self, payload: dict) -> dict:
        # the account-concurrency gauge counts this invocation from request
        # arrival (incremented BEFORE the admission check, so simultaneous
        # dispatches see each other) until the response is produced
        running = self.gauge.enter()
        try:
            return self._invoke(payload, running)
        finally:
            self.gauge.exit()

    def _invoke(self, payload: dict, running: int) -> dict:
        if self.faults is not None:
            # admission control BEFORE any container is acquired: a 429
            # never runs (and never bills GB-seconds)
            kind = self.faults.invoke_fault(
                payload.get("stage", -1), payload.get("index", -1),
                payload.get("attempt", 0), running)
            if kind == "throttle":
                with self._lock:
                    self.throttles += 1
                self.ledger.add_lambda_throttle()
                return {"status": "throttled", "error_type": "Throttled",
                        "error": "Rate exceeded (429)"}
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) > LAMBDA_PAYLOAD_LIMIT:
            # paper §III-B: split/spill oversized payloads through S3
            key = (f"_payload/{self.scope}{payload['stage']}/"
                   f"{payload['index']}/{time.monotonic_ns()}")
            try:
                self.rstore.put(key, blob)
            except (RetryExhausted, RetryBudgetExhausted) as e:
                # the invocation request itself failed — no container ran
                return {"status": "error", "error_type": type(e).__name__,
                        "error": str(e)}
            payload = {"spilled": key}
        cold = self._acquire_container()
        start = (self.cfg.cold_start_s if cold else self.cfg.warm_start_s)
        if self.cfg.start_latency_scale > 0:
            time.sleep(start * self.cfg.start_latency_scale)
        t0 = time.monotonic()
        try:
            if "spilled" in payload:
                payload = pickle.loads(self.rstore.get(payload["spilled"]))
            if self.faults is not None:
                t = self.faults.timeout_after(payload.get("stage", -1),
                                              payload.get("index", -1),
                                              payload.get("attempt", 0))
                if t:
                    payload = dict(payload, timeout_after_records=t)
            resp = executor_main(payload, self)
        except (InjectedFailure, InvocationTimeout, MemoryCapExceeded,
                AbortedError, TimeoutError, KeyError, LostShuffleInput,
                LostCacheInput, LostBroadcastInput, RetryExhausted,
                RetryBudgetExhausted, TransientServiceError) as e:
            resp = {"status": "error", "error_type": type(e).__name__,
                    "error": str(e)}
            detail = getattr(e, "detail", None)
            if detail:
                resp["detail"] = detail
        finally:
            # billed for the time actually consumed — an invocation
            # timeout bills what ran, not the full lease
            duration = time.monotonic() - t0 + start
            self.ledger.add_lambda(duration, self.cfg.memory_mb)
            self._release_container()
        resp.setdefault("duration_s", time.monotonic() - t0)
        blob = pickle.dumps(resp, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) > LAMBDA_PAYLOAD_LIMIT:
            key = f"_result/{self.scope}{time.monotonic_ns()}"
            try:
                self.rstore.put(key, blob)
            except (RetryExhausted, RetryBudgetExhausted) as e:
                return {"status": "error", "error_type": type(e).__name__,
                        "error": str(e),
                        "duration_s": resp["duration_s"]}
            resp = {"status": resp.get("status", "ok"), "spilled": key,
                    "duration_s": resp["duration_s"]}
        return resp


# ------------------------------------------------------ executor internals


class _Lease:
    def __init__(self, cfg: FlintConfig):
        self.deadline = time.monotonic() + cfg.time_limit_s * cfg.lease_safety
        self.max_records = cfg.max_records_per_invoke or None
        self.records = 0

    def consumed(self, n: int = 1) -> bool:
        """Count ingested records; True when the lease is exhausted."""
        self.records += n
        if self.max_records is not None and self.records >= self.max_records:
            return True
        if (self.records & 0xFF) == 0 and time.monotonic() > self.deadline:
            return True
        return False


class _SourceReader:
    """Line records over a byte range with Hadoop LineRecordReader
    semantics: a non-first split always skips its first (possibly partial)
    line, and every split reads lines whose start offset is <= end — so the
    line starting exactly at a boundary belongs to the EARLIER split.
    ``consumed_until`` is the absolute offset of the first unconsumed line
    (the chaining cursor)."""

    def __init__(self, inp: SourceInput, store: ObjectStoreSim,
                 cfg: FlintConfig, resume_offset: int | None):
        self.inp = inp
        self.store = store
        self.cfg = cfg
        self.offset = resume_offset  # absolute byte offset to resume at
        self.consumed_until = resume_offset if resume_offset is not None \
            else inp.start

    def _find_line_start(self, pos: int) -> int:
        """First line start at or after pos (skipping a partial line)."""
        scan = pos
        while scan < self.inp.size:
            probe = self.store.get(self.inp.key, scan,
                                   min(self.inp.size,
                                       scan + self.cfg.chunk_fetch_bytes))
            nl = probe.find(b"\n")
            if nl >= 0:
                return scan + nl + 1
            scan += len(probe)
        return self.inp.size

    def __iter__(self):
        inp, store, chunk = self.inp, self.store, self.cfg.chunk_fetch_bytes
        if self.offset is not None:
            line_start = self.offset
        elif inp.start == 0:
            line_start = 0
        else:
            line_start = self._find_line_start(inp.start)
        self.consumed_until = line_start
        pos = line_start  # next byte to fetch
        carry = b""
        while line_start <= inp.end:
            if pos >= inp.size:
                if carry and line_start <= inp.end:
                    # final line without trailing newline
                    self.consumed_until = inp.size
                    yield carry.decode("utf-8", "replace")
                return
            data = store.get(inp.key, pos, min(inp.size, pos + chunk))
            pos += len(data)
            data = carry + data
            lines = data.split(b"\n")
            carry = lines.pop()
            for ln in lines:
                if line_start > inp.end:
                    return
                line_start += len(ln) + 1
                self.consumed_until = line_start
                yield ln.decode("utf-8", "replace")


def _stable_order(rec) -> bytes:
    """Deterministic total order on records (their pickle bytes) — used to
    make a shuffle-reading task's re-emission byte-identical across
    attempts whose drains arrived in different orders."""
    return pickle.dumps(rec, protocol=pickle.HIGHEST_PROTOCOL)


def _read_transport_name(read: ShuffleRead, sid: int, cfg: FlintConfig
                         ) -> str:
    """The per-shuffle transport hint recorded at plan time, falling back
    to the engine default."""
    return (read.transports or {}).get(sid) or cfg.fallback_backend


def _drain_shuffle(read: ShuffleRead, env: LambdaSim, n_producers: dict, *,
                   sort_groups: bool = False) -> tuple:
    """Drain this partition's shuffle input(s) through their transports,
    folding each record batch into the aggregate AS IT ARRIVES (streaming —
    transport time overlaps the fold). Termination, dedup of at-least-once
    unordered delivery, claim leases and abort detection all live in the
    transport's DrainHandle; the per-producer EOS quorum comes from
    ``n_producers`` (fixed at plan time) in BOTH scheduler modes.

    Returns ({(sid, mode): folded-aggregate}, stats, ack) where ``ack``
    releases every drained input for good — the caller invokes it only
    once the task's output is durable (ack-after-fold), so an earlier
    death leaves the whole input to redeliver for the retry.

    ``sort_groups`` (set when this task WRITES another shuffle): group/
    join value-lists collect in arrival order, which differs across
    attempts — sort them so the records this task re-emits are
    byte-identical and downstream (src, seq) dedup stays sound."""
    out = {}
    stats = {"messages": 0, "duplicates": 0, "records": 0}
    combine = (serde.loads_fn(read.combine_fn)
               if isinstance(read.combine_fn, bytes) else read.combine_fn)

    def fold(agg, records, mode):
        if mode == "agg":
            for k, v in records:
                agg[k] = combine(agg[k], v) if k in agg else v
        elif mode in ("group", "join"):
            for k, v in records:
                agg.setdefault(k, []).append(v)
        else:  # repart
            agg.extend(records)
        if (mode in ("agg", "group", "join")
                and len(agg) > env.cfg.agg_memory_records):
            raise MemoryCapExceeded(
                f"aggregation state {len(agg)} records > cap "
                f"{env.cfg.agg_memory_records}")

    # the task-scoped claim group: a join drains two shuffles in sequence,
    # and lease-based transports must keep the first drain's claims alive
    # through the second's folds (heartbeats extend the whole group)
    claim_group: list = []
    handles = []
    groups = read.groups or [0] * len(read.parts)
    # adaptive coalescing: one task may drain SEVERAL contiguous producer
    # partitions (read.partitions), folding them in listed order into one
    # aggregate — repart streams stay globally ordered because the merge
    # concatenates in partition-index order
    partitions = read.partitions or [read.partition]
    for (sid, mode), consumer_group in zip(read.parts, groups):
        transport = env.transports.get(_read_transport_name(read, sid,
                                                            env.cfg))
        agg: Any = {} if mode in ("agg", "group", "join") else []
        for part in partitions:
            handle = transport.open_drain(sid, part,
                                          int(n_producers.get(str(sid), 0)),
                                          group=claim_group,
                                          consumer_group=consumer_group)
            for _src, _seq, body in handle:
                records = unpack_batch(body, env.rstore)
                stats["records"] += len(records)
                fold(agg, records, mode)
            stats["messages"] += handle.stats["messages"]
            stats["duplicates"] += handle.stats["duplicates"]
            handles.append(handle)
        if sort_groups and mode in ("group", "join"):
            for vals in agg.values():
                vals.sort(key=_stable_order)
        out[(sid, mode)] = agg

    def ack():
        for handle in handles:
            handle.ack()

    return out, stats, ack


def _shuffle_input_iter(read: ShuffleRead, env: LambdaSim,
                        n_producers: dict, *, sort_groups: bool = False):
    data, stats, ack = _drain_shuffle(read, env, n_producers,
                                      sort_groups=sort_groups)
    if read.self_join or len(read.parts) == 2:  # join
        if read.self_join:
            # CSE collapsed both sides onto one shared shuffle: the single
            # drained aggregate IS both the left and the right input
            left = right = data[read.parts[0]]
        else:
            left, right = data[read.parts[0]], data[read.parts[1]]
        how = read.join_how
        def it():
            for k, lvals in left.items():
                rvals = right.get(k)
                if rvals:
                    for lv in lvals:
                        for rv in rvals:
                            yield (k, (lv, rv))
                elif how in ("left", "outer"):
                    # left/full outer: unmatched left rows survive,
                    # paired with None
                    for lv in lvals:
                        yield (k, (lv, None))
            if how in ("right", "outer"):
                for k, rvals in right.items():
                    if k not in left:
                        for rv in rvals:
                            yield (k, (None, rv))
        return it(), stats, ack
    (sid, mode) = read.parts[0]
    agg = data[(sid, mode)]
    if mode in ("agg", "group"):
        return iter(agg.items()), stats, ack
    return iter(agg), stats, ack


def _flatmap_iter(it, fn):  # immediate fn binding (no late closure capture)
    for x in it:
        yield from fn(x)


def _cache_partition_prefix(token: str, nparts: int, index: int) -> str:
    return f"_cache/{token}/{nparts}/p{index}/"


def _cache_tee(it, spec, store, cap=None):
    """The ("cache", ...) plan op: materialize this partition at the
    cached lineage point, persist it as content-addressed columnar batches
    (billed PUTs), and pass the records on. Sorting the FULL partition
    first makes the pack a pure function of the record multiset, so
    retries and speculative twins overwrite the same keys with the same
    bytes instead of accumulating divergent copies — which is why tasks
    carrying a cache op never chain (per-link slices would pack with
    attempt-dependent boundaries). The materialization is executor state
    like any other: past the memory cap the answer is elasticity."""
    token, nparts, index = spec
    records = sorted(it, key=_stable_order)
    if cap is not None and len(records) > cap:
        raise MemoryCapExceeded(
            f"cache materialization {len(records)} records > cap {cap}")
    if store is not None:
        prefix = _cache_partition_prefix(token, nparts, index)
        bodies = pack_batch(records, limit=S3_EXCHANGE_BATCH_LIMIT)
        for seq, body in enumerate(bodies):
            digest = hashlib.sha1(body).hexdigest()[:12]
            store.put(f"{prefix}{seq:06d}-{digest}", body)
        # batch-count manifest, written LAST: a reader can tell a lost
        # batch (manifest disagrees with the store) from an unreadable or
        # partial materialization. Deterministic across attempts — the
        # sorted pack yields the same bodies every time.
        store.put_obj(f"{prefix}manifest", len(bodies))
    return iter(records)


def cache_partition_iter(inp: CacheInput, store):
    """Read one materialized cache partition back (billed LIST + GETs),
    verifying the batch-count manifest first: an acknowledged-then-lost
    batch (or a vanished manifest) raises LostCacheInput so the CONTEXT
    replans the cached lineage — retrying the reading task cannot recreate
    durable data that no longer exists."""
    prefix = _cache_partition_prefix(inp.token, inp.nparts, inp.index)
    expected = None
    data_keys = []
    for key in store.list(prefix):
        if key.endswith("manifest"):
            expected = store.get_obj(key)
        else:
            data_keys.append(key)
    if expected != len(data_keys):
        raise LostCacheInput(
            f"cache partition {prefix} incomplete: manifest says "
            f"{expected!r} batches, store holds {len(data_keys)} — a "
            f"materialized batch was lost after being written",
            token=inp.token)
    for key in data_keys:
        yield from unpack_batch(store.get(key), store)


def broadcast_read(prefix: str, store) -> dict:
    """Read a broadcast hash-join build side back from its
    content-addressed ``_broadcast/`` object(s) (billed LIST + GETs per
    reading task — the cost the threshold weighs against a shuffle),
    verifying the batch-count manifest first: an acknowledged-then-lost
    batch raises LostBroadcastInput so the scheduler re-runs the small
    side's lineage and re-publishes identical bytes."""
    expected = None
    data_keys = []
    for key in store.list(prefix):
        if key.endswith("manifest"):
            expected = store.get_obj(key)
        else:
            data_keys.append(key)
    if expected is None or expected != len(data_keys):
        raise LostBroadcastInput(
            f"broadcast {prefix} incomplete: manifest says {expected!r} "
            f"batches, store holds {len(data_keys)}", prefix=prefix)
    build: dict = {}
    for key in data_keys:
        for k, v in unpack_batch(store.get(key), store):
            build.setdefault(k, []).append(v)
    return build


def _bcjoin_iter(it, spec: dict, store):
    """The ("bcjoin", spec) plan op the adaptive scheduler splices into a
    large-side producer stage: hash-join the streaming records against the
    broadcast build side. ``spec['side']`` names which JOIN side the
    broadcast data is; the stream is the other side. Only non-preserved
    broadcast sides are ever planned (inner either; left join broadcasts
    right; right join broadcasts left), so unmatched BUILD rows — which a
    single map task could not decide globally — never need emitting."""
    build = broadcast_read(spec["prefix"], store)
    side, how = spec["side"], spec["how"]
    for k, v in it:
        hits = build.get(k)
        if side == "right":  # stream is the left side
            if hits:
                for rv in hits:
                    yield (k, (v, rv))
            elif how in ("left", "outer"):
                yield (k, (v, None))
        else:  # broadcast left, stream is the right side
            if hits:
                for lv in hits:
                    yield (k, (lv, v))
            elif how in ("right", "outer"):
                yield (k, (None, v))


def _apply_ops(it, ops, store=None, cap=None):
    for kind, blob in ops:
        fn = serde.loads_fn(blob) if isinstance(blob, bytes) else blob
        if kind == "map":
            it = map(fn, it)
        elif kind == "filter":
            it = filter(fn, it)
        elif kind == "flatmap":
            it = _flatmap_iter(it, fn)
        elif kind == "mappartitions":
            it = fn(it)
        elif kind == "mapbatches":
            # batch-level narrow op (RDD.mapBatches): fn consumes the whole
            # partition iterator and may yield KVBatch column carriers
            # alongside plain records — row consumers downstream expand
            # them via shuffle.iter_records
            it = fn(it)
        elif kind == "cache":
            it = _cache_tee(it, fn, store, cap)
        elif kind == "bcjoin":
            it = _bcjoin_iter(it, fn, store)
        elif kind == "limit":
            # RDD.take / DataFrame.limit: stop pulling from upstream —
            # and therefore stop READING the source — after fn records
            it = itertools.islice(it, fn)
        else:
            raise ValueError(f"unknown op {kind}")
    return it


def _canonical_key(key):
    """Normalize keys that compare equal but pickle differently, so they
    route to the same partition: Python guarantees 1 == 1.0 == True (and
    dict folding merges them), so the partitioner must agree. Integral
    floats and bools collapse to int; tuples normalize recursively."""
    if isinstance(key, bool):
        return int(key)
    if isinstance(key, float) and key.is_integer():
        return int(key)
    if isinstance(key, tuple):
        return tuple(_canonical_key(k) for k in key)
    return key


class _ColumnBuffer:
    """Per-partition column-major output buffer: rows routed here from
    KVBatch carriers never transpose back to tuples — flush packs wire
    bodies straight from the columns (shuffle.pack_batch_columns). Falls
    back to a plain record list if a row with a different shape shows up
    mid-stream (e.g. a per-row fallback chunk emitting ragged data)."""

    __slots__ = ("kcols", "vcols", "kschema", "vschema", "n")

    def __init__(self, batch: KVBatch):
        self.kcols = [[] for _ in batch.kcols]
        self.vcols = [[] for _ in batch.vcols]
        self.kschema = batch.kschema
        self.vschema = batch.vschema
        self.n = 0

    def matches(self, batch: KVBatch) -> bool:
        return (len(batch.kcols) == len(self.kcols)
                and len(batch.vcols) == len(self.vcols)
                and batch.kschema == self.kschema
                and batch.vschema == self.vschema)

    def extend(self, batch: KVBatch, idxs: list[int]):
        for dst, src in zip(self.kcols, batch.kcols):
            dst.extend(src[i] for i in idxs)
        for dst, src in zip(self.vcols, batch.vcols):
            dst.extend(src[i] for i in idxs)
        self.n += len(idxs)

    def append_row(self, record) -> bool:
        """True if the row fit the column layout, False to demote."""
        if (type(record) is not tuple or len(record) != 2
                or type(record[0]) is not tuple
                or len(record[0]) != len(self.kcols)
                or type(record[1]) is not tuple
                or len(record[1]) != len(self.vcols)):
            return False
        for dst, x in zip(self.kcols, record[0]):
            dst.append(x)
        for dst, x in zip(self.vcols, record[1]):
            dst.append(x)
        self.n += 1
        return True

    def to_records(self) -> list:
        return list(zip(zip(*self.kcols), zip(*self.vcols)))

    def to_batch(self) -> KVBatch:
        return KVBatch(self.kcols, self.vcols, self.kschema, self.vschema)


class _ShuffleWriter:
    """Hash-partitioned buffered writer with overflow flush (§III-A),
    shipping columnar record batches over the shuffle's transport."""

    def __init__(self, write, env: LambdaSim, task_src: str,
                 seq_start: dict | None):
        self.write = write
        self.env = env
        self.src = task_src
        self.combine = (serde.loads_fn(write.combine_fn)
                        if isinstance(write.combine_fn, bytes)
                        else write.combine_fn)
        self.partition_fn = (serde.loads_fn(write.partition_fn)
                             if isinstance(write.partition_fn, bytes)
                             else write.partition_fn)
        self.buffers: dict[int, Any] = {}
        self.buffered = 0
        self.seq = {int(k): v for k, v in (seq_start or {}).items()}
        # per-output-partition [wire bytes, records] — reported back to
        # the scheduler as stats["shuffle_out"], the measured volume the
        # adaptive planner replaces its estimates with
        self.out_stats: dict[int, list] = {}

    def _transport(self):
        return self.env.transports.get(self.write.transport
                                       or self.env.cfg.fallback_backend)

    def _partition_of(self, key) -> int:
        # stable across interpreter runs / PYTHONHASHSEED — a retried or
        # speculated re-invocation MUST route every key to the same
        # partition with the same sequence ids, or dedup breaks
        blob = pickle.dumps(_canonical_key(key),
                            protocol=pickle.HIGHEST_PROTOCOL)
        return zlib.crc32(blob) % self.write.nparts

    def add(self, record):
        w = self.write
        if w.mode == "repart":
            if self.partition_fn is not None:
                # explicit routing (range partitioner): deterministic per
                # record, so retries re-route identically with no cursor
                p = int(self.partition_fn(record)) % w.nparts
            else:
                p = self.seq.get(-1, 0) % w.nparts  # round-robin
                self.seq[-1] = self.seq.get(-1, 0) + 1
            self._append(p, record)
        else:
            k, v = record
            p = self._partition_of(k)
            if w.mode == "agg" and self.combine is not None:
                buf = self.buffers.setdefault(p, {})
                before = len(buf)
                buf[k] = self.combine(buf[k], v) if k in buf else v
                self.buffered += len(buf) - before
                if self.buffered >= self.env.cfg.flush_records:
                    self.flush()
                return
            self._append(p, record)
        self.buffered += 1
        if self.buffered >= self.env.cfg.flush_records:
            self.flush()

    def _append(self, p: int, record):
        buf = self.buffers.get(p)
        if buf is None:
            buf = self.buffers[p] = []
        elif isinstance(buf, _ColumnBuffer):
            if buf.append_row(record):
                return
            # shape mismatch: demote the partition buffer to a record list
            buf = self.buffers[p] = buf.to_records()
        buf.append(record)

    def add_batch(self, batch: KVBatch):
        """Column-major fast path for fused vectorized operators. Map-side
        combine still folds record-at-a-time (the combine dict's insertion
        order and flush boundaries must not depend on how the stream was
        batched); group/join/plain shuffles keep the columns intact per
        output partition so flush() packs without transposing."""
        w = self.write
        if w.mode == "repart" or (w.mode == "agg" and self.combine is not None):
            for rec in batch.iter_rows():
                self.add(rec)
            return
        by_p: dict[int, list[int]] = {}
        for i, k in enumerate(batch.key_tuples()):
            by_p.setdefault(self._partition_of(k), []).append(i)
        for p, idxs in by_p.items():
            buf = self.buffers.get(p)
            if buf is None:
                buf = self.buffers[p] = _ColumnBuffer(batch)
            if isinstance(buf, _ColumnBuffer) and buf.matches(batch):
                buf.extend(batch, idxs)
            else:
                if isinstance(buf, _ColumnBuffer):
                    buf = self.buffers[p] = buf.to_records()
                kt, vt = zip(*batch.kcols), zip(*batch.vcols)
                rows = list(zip(kt, vt))
                buf.extend(rows[i] for i in idxs)
        self.buffered += batch.n
        if self.buffered >= self.env.cfg.flush_records:
            self.flush()

    def flush(self):
        transport = self._transport()
        for p, buf in self.buffers.items():
            if isinstance(buf, _ColumnBuffer):
                if not buf.n:
                    continue
                nrecs = buf.n
                # schema from the plan when declared, else the batch's own
                cb = buf.to_batch()
                if self.write.batch_schema is not None:
                    cb.kschema, cb.vschema = self.write.batch_schema
                bodies = pack_batch_columns(
                    cb, limit=transport.batch_limit, spill=transport.spill,
                    columnar=self.env.cfg.columnar_batches)
            else:
                records = list(buf.items()) if isinstance(buf, dict) else buf
                if not records:
                    continue
                nrecs = len(records)
                bodies = pack_batch(records, limit=transport.batch_limit,
                                    spill=transport.spill,
                                    columnar=self.env.cfg.columnar_batches,
                                    schema=self.write.batch_schema)
            seq = self.seq.get(p, 0)
            transport.send(self.write.shuffle_id, p, self.src, seq, bodies)
            self.seq[p] = seq + len(bodies)
            st = self.out_stats.setdefault(p, [0, 0])
            st[0] += sum(len(b) for b in bodies)
            st[1] += nrecs
        self.buffers = {}
        self.buffered = 0

    def finalize(self):
        """Emit EOS on every output partition — INCLUDING partitions this
        task never wrote to (total 0) — carrying the total sequence count,
        so consumers can count down a fixed producer quorum. Only the final
        (non-continuation) link of a chained task calls this; a retried/
        speculated duplicate re-emits identical EOS (partitioning and
        sequence assignment are deterministic), which consumers dedup by
        producer id."""
        self._transport().emit_eos(self.write.shuffle_id, self.write.nparts,
                                   self.src, self.seq)


def executor_main(payload: dict, env: LambdaSim) -> dict:
    """The Lambda function body: deserialize task, build input iterator,
    run the pipeline, sink outputs, chain if the lease runs out."""
    fail_after = payload.get("fail_after_records")
    timeout_after = payload.get("timeout_after_records")
    inject = payload.get("inject_failure")
    if inject:
        raise InjectedFailure(f"injected failure for task "
                              f"{payload['stage']}/{payload['index']}")
    slow = payload.get("straggle_s", 0.0)
    if slow:
        time.sleep(slow)

    lease = _Lease(env.cfg)
    src_id = f"s{payload['stage']}t{payload['index']}"
    stats: dict[str, Any] = {"records_in": 0}
    inp = payload["input"]
    # a task carrying a cache op never chains: the tee must see the FULL
    # partition in one link so its content-addressed pack is deterministic
    # across attempts (per-link slices would cut at lease-dependent
    # boundaries and leave divergent key sets behind)
    chainable = (isinstance(inp, SourceInput)
                 and not any(kind == "cache" for kind, _ in payload["ops"]))

    ack_shuffle = None
    if isinstance(inp, SourceInput):
        reader = _SourceReader(inp, env.rstore, env.cfg,
                               payload.get("resume_offset"))
        base_iter = iter(reader)
    elif isinstance(inp, CollectionInput):
        base_iter = iter(env.rstore.get_obj(f"{inp.key}/{inp.index}"))
        reader = None
    elif isinstance(inp, CacheInput):
        # a cached lineage hit: the upstream stages were never planned
        base_iter = cache_partition_iter(inp, env.rstore)
        reader = None
    else:
        base_iter, drain_stats, ack_shuffle = _shuffle_input_iter(
            inp, env, payload.get("n_producers") or {},
            sort_groups=payload["write"] is not None)
        stats.update(drain_stats)
        reader = None

    exhausted = {"flag": False}

    def metered():
        n = 0
        try:
            for rec in base_iter:
                n += 1
                if fail_after and n > fail_after:
                    raise InjectedFailure("injected mid-task failure")
                if timeout_after and n > timeout_after:
                    # the simulated lease expiry: killed mid-flight with NO
                    # final flush — only count-boundary flushes that
                    # already happened are durable, so the retry's
                    # byte-identical re-emission overlaps them exactly
                    raise InvocationTimeout(
                        f"invocation lease expired after {n} records "
                        f"(simulated Lambda timeout)")
                yield rec
                if lease.consumed() and chainable:
                    exhausted["flag"] = True
                    return
        finally:
            # also on the early (chaining) return — every link reports
            # what it actually ingested, not just the last one
            stats["records_in"] = n

    out_iter = _apply_ops(metered(), payload["ops"], env.rstore,
                          env.cfg.agg_memory_records)

    write = payload["write"]
    if write is not None:
        writer = _ShuffleWriter(write, env, src_id, payload.get("seq_start"))
        if ack_shuffle is not None:
            # a shuffle-reading task's output follows its drain's arrival
            # order, which differs across attempts. Downstream dedup keys
            # on (src, seq), so a retry or speculative twin MUST re-emit
            # byte-identical messages: materialize and sort before
            # partitioning/packing (sorted input makes partition routing,
            # flush boundaries, and body framing all deterministic).
            # KVBatch carriers expand to rows first — a batch boundary is
            # an artifact of this attempt's drain, not of the data.
            out_iter = sorted(iter_records(out_iter), key=_stable_order)
            if len(out_iter) > env.cfg.agg_memory_records:
                # the materialized output (e.g. a join cross-product) is
                # state too — answer overflow with elasticity, like the
                # drain aggregate
                raise MemoryCapExceeded(
                    f"materialized shuffle output {len(out_iter)} records "
                    f"> cap {env.cfg.agg_memory_records}")
        for rec in out_iter:
            if isinstance(rec, KVBatch):
                writer.add_batch(rec)
            else:
                writer.add(rec)
        writer.flush()
        # per-link deltas: the scheduler sums links/attempts per shuffle
        stats["shuffle_out"] = {p: list(v)
                                for p, v in writer.out_stats.items()}
        if not exhausted["flag"]:
            # EOS protocol (both scheduler modes): the LAST link of the
            # (possibly chained) task closes the stream for this producer
            writer.finalize()
        if ack_shuffle is not None:
            # input acked only now that the output is durable downstream;
            # dying any earlier leaves it all to redeliver for the retry
            ack_shuffle()
        resp = {"status": "ok", "stats": stats}
        if exhausted["flag"]:
            resp["continuation"] = {
                "resume_offset": reader.consumed_until,
                "seq_start": writer.seq,
            }
        return resp

    result = list(iter_records(out_iter))
    resp = {"status": "ok", "stats": stats}
    if payload.get("save_prefix"):
        key = f"{payload['save_prefix']}/part-{payload['index']:05d}"
        env.rstore.put(key, "\n".join(str(r) for r in result).encode())
        resp["saved_key"] = key
    else:
        resp["result"] = result
    if ack_shuffle is not None:
        ack_shuffle()  # input acked only once the sink is durable
    if exhausted["flag"]:
        resp["continuation"] = {"resume_offset": reader.consumed_until,
                                "partial": True}
    return resp
