"""SQSTransport — the paper's queue shuffle behind the ShuffleTransport
contract, semantics preserved exactly: per-partition queues, batched sends
under the 256 KiB / 10-message caps, visibility-timeout receives with
ack-after-fold (docs/eos_shuffle.md), per-producer EOS control messages,
and QueueGone-based fast abort for losing speculative twins.

MULTI-CONSUMER fan-out (docs/dag_fanout.md): queues are destructive, so a
CSE-shared shuffle with N consumer groups materializes N per-partition
queue SETS (``shuffle{sid}-g{g}-p{p}``) and every producer send/EOS fans
out to all of them at emit time. Each group then keeps the full
single-consumer story independently: its own (src, seq) dedup, its own
visibility-claim recovery, its own byte-identical re-emission absorption,
and its own QueueGone release — one group's completion or death never
touches a sibling's stream.
"""

from __future__ import annotations

import time
from collections import deque

from repro_torch.core.costs import SQS_BATCH_MESSAGES, SQS_MESSAGE_LIMIT
from repro_torch.core.queues import Message, QueueGone, eos_message
from repro_torch.core.shuffle.base import (AbortedError, DrainHandle, DrainState,
                                     ShuffleTransport)


def queue_name(shuffle_id: int, partition: int, group: int = 0) -> str:
    return f"shuffle{shuffle_id}-g{group}-p{partition}"


class SQSTransport(ShuffleTransport):
    name = "sqs"
    batch_limit = SQS_MESSAGE_LIMIT

    def __init__(self, cfg, ledger, store, sqs):
        super().__init__(cfg, ledger, store, sqs)
        self._live: set = set()      # queues created and not yet deleted
        self._released: set = set()  # deleted (each delete bills — once)
        self._groups: dict[int, int] = {}  # sid -> consumer-group count

    # ---------------------------------------------------- producer side
    def send(self, shuffle_id, partition, src, first_seq, bodies):
        names = [queue_name(shuffle_id, partition, g)
                 for g in range(self._groups.get(shuffle_id, 1))]
        batch: list[tuple] = []

        def flush(batch):
            # fan out to every consumer group's queue set; each send is a
            # real (billed) request — queues cannot be read twice. Every
            # queue gets its OWN Message objects: the sim enqueues caller
            # objects directly and Message.receipt is a mutable
            # per-receive slot, so sharing one object across queues would
            # let concurrent sibling-group receives clobber each other's
            # receipt handles
            for name in names:
                # transient send errors retry at the call layer: nothing
                # was enqueued, so the re-send cannot duplicate
                self.retry.call(self.sqs.send_batch, name,
                                [Message(body, seq, src)
                                 for body, seq in batch])

        for i, body in enumerate(bodies):
            batch.append((body, first_seq + i))
            if len(batch) == SQS_BATCH_MESSAGES:
                flush(batch)
                batch = []
        if batch:
            flush(batch)

    def emit_eos(self, shuffle_id, nparts, src, totals):
        for g in range(self._groups.get(shuffle_id, 1)):
            for p in range(nparts):
                self.retry.call(self.sqs.send_batch,
                                queue_name(shuffle_id, p, g),
                                [eos_message(src, totals.get(p, 0))])

    # ---------------------------------------------------- consumer side
    def open_drain(self, shuffle_id, partition, quorum, group=None,
                   consumer_group=0):
        return _SQSDrain(self,
                         queue_name(shuffle_id, partition, consumer_group),
                         quorum, group)

    # ------------------------------------------------- lifecycle + cost
    def open(self, shuffle_id, nparts, groups=1):
        self._groups[shuffle_id] = groups
        for g in range(groups):
            for p in range(nparts):
                name = queue_name(shuffle_id, p, g)
                self._live.add(name)
                self.sqs.create_queue(name)

    def partition_drainable(self, shuffle_id, partition, consumer_group=0):
        """False once this group's queue was deleted — its messages are
        gone with it, so a replayed consumer needs ``reopen`` + upstream
        re-production first."""
        return (queue_name(shuffle_id, partition, consumer_group)
                not in self._released)

    def release_partition(self, shuffle_id, partition, consumer_group=0):
        """Delete this GROUP's queue so a losing speculative duplicate (or
        a late retry of a task that already won) aborts on QueueGone
        immediately instead of blocking a pool thread until the drain
        timeout. Sibling groups' queues stay — their consumers may still
        be draining."""
        name = queue_name(shuffle_id, partition, consumer_group)
        if name not in self._released:
            self._released.add(name)
            self._live.discard(name)
            self.sqs.delete_queue(name)

    def destroy(self, shuffle_id, nparts):
        for g in range(self._groups.get(shuffle_id, 1)):
            for p in range(nparts):
                self.release_partition(shuffle_id, p, g)

    def reopen(self, shuffle_id, nparts, groups=1):
        """Lineage recovery: recreate this shuffle's queues (idempotent
        creates) and forget their released state so a resubmitted producer
        stage can re-fill them and a retried consumer can re-drain."""
        groups = max(groups, self._groups.get(shuffle_id, 1))
        self._groups[shuffle_id] = groups
        for g in range(groups):
            for p in range(nparts):
                name = queue_name(shuffle_id, p, g)
                self._released.discard(name)
                self._live.add(name)
                self.sqs.create_queue(name)

    def gc(self):
        """Queues normally die with their consuming stage; after an abort
        some survive — sweep them so nothing leaks past the job."""
        doomed = list(self._live)
        for name in doomed:
            self._released.add(name)
            self._live.discard(name)
            self.sqs.delete_queue(name)
        return {"queues": len(doomed)} if doomed else {}

    def gc_sids(self, sids):
        """Targeted sweep of only the named shuffles' surviving queues
        (service mode: the blanket ``gc`` would also count queues of
        shuffles this job never owned)."""
        want = {f"shuffle{sid}-" for sid in sids}
        doomed = [name for name in list(self._live)
                  if any(name.startswith(w) for w in want)]
        for name in doomed:
            self._released.add(name)
            self._live.discard(name)
            self.sqs.delete_queue(name)
        return {"queues": len(doomed)} if doomed else {}

    def service_cost(self):
        return self.ledger.sqs_usd


class _SQSDrain(DrainHandle):
    """Visibility-timeout drain of one queue: receives claim messages under
    receipt handles, heartbeats through long folds (never while idle — see
    docs/eos_shuffle.md on livelock-freedom), and defers the batched ack to
    task completion. Port of the pre-subsystem ``_drain_shuffle`` loop."""

    def __init__(self, tr: SQSTransport, name: str, quorum: int,
                 group: list | None):
        self.tr = tr
        self.name = name
        self.state = DrainState(quorum)
        self.held: dict = {}  # (src, seq, kind) -> latest receipt handle
        self._buf: deque = deque()
        self._timeout = tr.cfg.drain_timeout_s
        self._deadline = time.monotonic() + self._timeout
        vis = tr.cfg.visibility_timeout_s
        self._hb_deadline = time.monotonic() + vis / 2
        self._want = None  # None => query the backlog estimate
        # the task-scoped claim group: a join's second drain must keep the
        # first drain's claims alive through its own long folds
        self._group = group if group is not None else []
        self._group.append(self)

    def __next__(self):
        while True:
            if self._buf:
                if time.monotonic() > self._hb_deadline:
                    self._heartbeat()
                return self._buf.popleft()
            if self.state.done():
                raise StopIteration
            self._refill()

    def _refill(self):
        """One receive step, sized from the backlog estimate (the estimate
        is a billable GetQueueAttributes, re-queried only while receives
        keep coming back full)."""
        sqs = self.tr.sqs
        if self._want is None:
            self._want = min(1000, max(SQS_BATCH_MESSAGES,
                                       sqs.approx_len(self.name)))
        try:
            # transient receive errors (nothing claimed) retry at the
            # call layer; QueueGone passes through untouched
            msgs = self.tr.retry.call(sqs.receive_many, self.name,
                                      self._want)
        except QueueGone:
            raise AbortedError(
                f"queue {self.name} deleted — a competing attempt already "
                f"completed this partition") from None
        now = time.monotonic()
        if not msgs:
            self._want = SQS_BATCH_MESSAGES
            if sqs.closed:
                raise AbortedError(f"queue {self.name}: aborted")
            if now > self._deadline:
                raise TimeoutError(
                    f"queue {self.name} incomplete: "
                    f"{len(self.state.seen)} data msgs, eos "
                    f"{len(self.state.eos_total)}/{self.state.quorum}")
            # block on arrival instead of sleep-spinning. Held claims are
            # deliberately NOT heartbeated while idle: when a retry and a
            # speculative twin race on one queue, each needs the OTHER's
            # claims to lapse — idle heartbeats on both sides split the
            # queue permanently. An idle drain instead re-receives its
            # claimed backlog each visibility period (re-billed, deduped).
            sqs.wait_for_messages(self.name, 0.25)
            return
        self._want = None if len(msgs) == self._want else SQS_BATCH_MESSAGES
        progressed = False
        for m in msgs:
            self.held[(m.src, m.seq, m.kind)] = m.receipt
            if m.kind == "eos":
                progressed |= self.state.register_eos(m.src, m.seq)
            elif self.state.register_data(m.src, m.seq):
                progressed = True
                self._buf.append((m.src, m.seq, m.body))
        if progressed:
            self._deadline = now + self._timeout
        elif now > self._deadline:
            # a batch of pure duplicates (e.g. this drain's own lapsed
            # claims redelivering while a producer is stuck) is not
            # progress — without this the inactivity timeout could never
            # fire once the drain held a single claim
            raise TimeoutError(
                f"queue {self.name} stalled: {len(self.state.seen)} data "
                f"msgs, eos {len(self.state.eos_total)}/{self.state.quorum}")

    def _heartbeat(self):
        """Extend every claim the TASK holds — including sibling drains'
        (a join's left-side claims must survive its right-side fold)."""
        vis = self.tr.cfg.visibility_timeout_s
        for handle in self._group:
            receipts = list(handle.held.values())
            for i in range(0, len(receipts), SQS_BATCH_MESSAGES):
                self.tr.sqs.change_visibility(
                    handle.name, receipts[i:i + SQS_BATCH_MESSAGES], vis)
        self._hb_deadline = time.monotonic() + vis / 2

    def ack(self):
        """Batched ack-after-fold, deferred to task completion; stale or
        duplicate receipts are idempotent no-ops inside delete_batch."""
        receipts = list(self.held.values())
        for i in range(0, len(receipts), SQS_BATCH_MESSAGES):
            self.tr.sqs.delete_batch(self.name,
                                     receipts[i:i + SQS_BATCH_MESSAGES])
        self.held = {}
