"""The ShuffleTransport contract — intermediate data movement as a
first-class pluggable subsystem (docs/shuffle_transports.md).

The engine was hard-wired to SQS; Lambada showed a serverless exchange
operator over S3 objects scales better for analytical volumes, and Flock
that the transport should be a per-shuffle decision. Everything above this
interface (executors, scheduler, DAG planner) speaks only the contract:

  * ``open(sid, nparts, groups)``— scheduler-side channel setup, before any
                                   producer launches; ``groups`` is the
                                   plan-time CONSUMER-GROUP count (CSE fans
                                   one producer stage out to N read sites,
                                   each draining the full stream);
  * ``send(...)`` / ``emit_eos`` — producer-side: ship packed record-batch
                                   bodies, then close the stream with the
                                   per-partition sequence totals (EOS quorum
                                   is fixed at plan time);
  * ``open_drain(...)``          — consumer-side: an iterator of fresh
                                   ``(src, seq, body)`` batches that
                                   terminates on EOS quorum, plus ``ack()``
                                   invoked only once the task's output is
                                   durable (ack-after-fold);
  * ``release_partition``        — a completed consumer's channel is dead:
                                   losing speculative twins must abort fast;
  * ``destroy`` / ``gc``         — stage-end sweep and job-end garbage
                                   collection (zero leaked keys/queues);
  * ``service_cost``             — cost hook: the transport's share of the
                                   ledger, for per-transport cost A/Bs.

Delivery may be at-least-once and unordered; ``DrainState`` centralizes the
(src, seq) dedup + EOS-quorum bookkeeping every conforming backend shares.
A transport MUST tolerate byte-identical re-emission of the same (src, seq)
batches (retries and speculative twins re-send deterministically) and MUST
deliver each distinct batch exactly once per drain handle.
"""

from __future__ import annotations

import hashlib
from typing import Iterator

from repro_torch.core.retry import RetryPolicy


class AbortedError(RuntimeError):
    """The shuffle channel disappeared under a live drain — the scheduler
    shut the transport down (fatal failure / re-plan), or a competing
    attempt already completed this partition. Unblock and exit quietly."""


class LostShuffleInput(RuntimeError):
    """The drain is CERTAIN its missing input will never arrive on its
    own: the producer quorum's EOS manifests are all in, yet advertised
    batches are absent past the drain deadline with no release tombstone
    to explain them — an acknowledged durable write was lost. Retrying
    the consumer cannot help; the scheduler answers with lineage-based
    resubmission of the producing stage (docs/fault_tolerance.md)."""


class DrainState:
    """Shared drain bookkeeping: (src, seq) dedup, per-producer counts, and
    the plan-time EOS quorum that terminates the drain."""

    __slots__ = ("quorum", "seen", "per_src", "eos_total", "stats")

    def __init__(self, quorum: int):
        self.quorum = quorum
        self.seen: set = set()
        self.per_src: dict[str, int] = {}
        self.eos_total: dict[str, int] = {}
        self.stats = {"messages": 0, "duplicates": 0}

    def register_eos(self, src: str, total: int) -> bool:
        """Record a producer's end-of-stream (total = its sequence count).
        Duplicate EOS (speculation, redelivery) is idempotent."""
        if src in self.eos_total:
            return False
        self.eos_total[src] = total
        return True

    def register_data(self, src: str, seq: int) -> bool:
        """True if (src, seq) is fresh; duplicates are counted and dropped."""
        if (src, seq) in self.seen:
            self.stats["duplicates"] += 1
            return False
        self.seen.add((src, seq))
        self.per_src[src] = self.per_src.get(src, 0) + 1
        self.stats["messages"] += 1
        return True

    def done(self) -> bool:
        """EOS from the full producer quorum AND every producer's advertised
        sequence count seen (EOS may outrun data — no ordering guarantee)."""
        return (len(self.eos_total) >= self.quorum
                and all(self.per_src.get(s, 0) >= t
                        for s, t in self.eos_total.items()))


class DrainHandle:
    """Iterator of fresh ``(src, seq, body)`` data batches for one
    (shuffle, partition). ``ack()`` is called by the executor only once the
    task's output is durable; ``stats`` mirrors DrainState.stats."""

    state: DrainState

    @property
    def stats(self) -> dict:
        return self.state.stats

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        raise NotImplementedError

    def ack(self):
        """Release the drained input for good. Must be idempotent; on
        transports with non-destructive reads this is a no-op."""


class ShuffleTransport:
    """Abstract transport. Concrete backends: shuffle.sqs.SQSTransport
    (queue semantics, the paper's choice) and shuffle.s3.S3ExchangeTransport
    (Lambada-style object exchange — no queues at all)."""

    name = "?"
    #: largest packed batch body this transport ships in one unit
    batch_limit = 0

    def __init__(self, cfg, ledger, store, sqs):
        self.cfg = cfg
        self.ledger = ledger
        self.store = store
        self.sqs = sqs  # SQSSim doubles as the job-wide abort signal
        # call-level retry around every service call this transport makes;
        # TransportSet replaces this with its shared, budget-backed policy
        self.retry = RetryPolicy.from_config(cfg)

    # ---------------------------------------------------- producer side
    def spill(self, blob: bytes) -> str:
        """Out-of-band home for a single record pickle too large for one
        batch body: content-addressed, so a retry or speculative twin
        re-spilling the same record overwrites idempotently."""
        key = f"_spill/{hashlib.sha1(blob).hexdigest()}"
        self.retry.call(self.store.put, key, blob)
        return key

    def send(self, shuffle_id: int, partition: int, src: str,
             first_seq: int, bodies: list[bytes]):
        raise NotImplementedError

    def emit_eos(self, shuffle_id: int, nparts: int, src: str,
                 totals: dict[int, int]):
        """Close ``src``'s stream on EVERY partition (total 0 where it wrote
        nothing), so consumers can count down a fixed producer quorum."""
        raise NotImplementedError

    # ---------------------------------------------------- consumer side
    def open_drain(self, shuffle_id: int, partition: int, quorum: int,
                   group: list | None = None,
                   consumer_group: int = 0) -> DrainHandle:
        """``group`` is the task-scoped claim group: a join task drains two
        shuffles and transports with leases (SQS visibility) must keep the
        first drain's claims alive while the second drains.
        ``consumer_group`` selects which fan-out copy of the stream this
        drain consumes — sibling groups are fully independent (their own
        dedup, their own claims/recovery, their own release)."""
        raise NotImplementedError

    # ------------------------------------------------- lifecycle + cost
    def open(self, shuffle_id: int, nparts: int, groups: int = 1):
        """Create channels before any producer of this shuffle launches.
        ``groups`` consumer groups will each drain the full stream."""

    def partition_drainable(self, shuffle_id: int, partition: int,
                            consumer_group: int = 0) -> bool:
        """True while a FRESH drain of this (partition, group) could still
        complete — i.e. the group has not released it. Lineage recovery
        consults this before resubmitting a mid-chain task: a released
        partition's channel aborts new drains (and its data may be
        reclaimed), so the upstream producers must be replayed through
        ``reopen`` first."""
        return True

    def release_partition(self, shuffle_id: int, partition: int,
                          consumer_group: int = 0):
        """A consumer completed this partition for its group: free that
        group's channel and make any competing drain OF THE SAME GROUP
        abort fast (idempotent). Sibling groups must stay drainable —
        the shuffle's data is only reclaimed once every group released."""

    def destroy(self, shuffle_id: int, nparts: int):
        """All-consumer-stages-done sweep (every group) of whatever
        ``release_partition`` didn't cover."""

    def reopen(self, shuffle_id: int, nparts: int, groups: int = 1):
        """Lineage recovery (docs/fault_tolerance.md): make a previously
        released/destroyed shuffle's channels writable and drainable
        again so the producing stage can be resubmitted. Must clear any
        per-partition release state for the shuffle; re-emitted batches
        are byte-identical, so consumers mid-drain dedup the overlap."""
        self.open(shuffle_id, nparts, groups)

    def gc(self) -> dict[str, int]:
        """Job-end cleanup; returns {resource: count} actually removed."""
        return {}

    def gc_sids(self, sids) -> dict[str, int]:
        """Targeted job-end sweep of ONLY the named shuffles' channels.
        Service mode (docs/multi_tenant.md) shares the backing store
        across concurrently-running jobs, so the blanket ``gc`` — which
        reaps the whole channel namespace — would destroy other jobs'
        live shuffles; each job sweeps just the shuffle ids it owns."""
        return {}

    def service_cost(self) -> float:
        """This transport's share of the ledger, in USD (cost hook)."""
        raise NotImplementedError
