"""S3ExchangeTransport — a Lambada-style serverless exchange operator over
object storage: no queues at all.

Producers write one CONTENT-ADDRESSED object per packed output batch,

    _exchange/{sid}/p{partition}/{src}-{seq:08d}-{sha1(body)[:12]}

so a retry or speculative twin re-emitting the byte-identical batch
overwrites idempotently instead of duplicating. End-of-stream rides the
manifest object ``eos-{src}`` (one per partition, value = the producer's
total sequence count there), written by the final link of a chained task —
the consumer's EOS quorum comes from ``StagePlan.producer_counts`` exactly
as on the queue transport.

Consumers DISCOVER work by polling LIST (S3 has no arrival notification —
the recurring cost of an object-store shuffle, billed per LIST), GET fresh
batches as they appear, and terminate on the manifest quorum. Discovery is
BATCHED at the shuffle level: all of a shuffle's drains share one
``_SidIndex`` that LISTs ``_exchange/{sid}/`` once and buckets the result
per partition, so a 16-partition fan-in costs ~one LIST per poll interval
instead of sixteen. Reads are non-destructive, so ``ack`` is a no-op and a
consumer that dies mid-drain recovers by simply re-listing — no visibility
leases, no claim races.

MULTI-CONSUMER fan-out (docs/dag_fanout.md) is where an object exchange
shines: the batch objects are written ONCE and every consumer group reads
them non-destructively — no per-group copies, unlike the queue transport.
Only the release protocol is per group: ``release_partition`` drops a
``.released-g{g}`` tombstone (aborting that group's losing twins on their
next poll, the moral equivalent of QueueGone) and the partition's data
objects are deleted only once EVERY group has tombstoned it.

Unlike SQS's 256 KiB messages, one exchange object may be tens of MiB
(costs.S3_EXCHANGE_BATCH_LIMIT); objects past the multipart threshold bill
as Create + UploadParts + Complete. ``gc`` removes the whole
``_exchange/`` tree at job end, tombstones included.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import deque

from repro_torch.core.costs import S3_EXCHANGE_BATCH_LIMIT
from repro_torch.core.shuffle.base import (AbortedError, DrainHandle, DrainState,
                                     LostShuffleInput, ShuffleTransport)

EXCHANGE_PREFIX = "_exchange/"
_TOMBSTONE = ".released-g"


def _shuffle_prefix(shuffle_id: int) -> str:
    return f"{EXCHANGE_PREFIX}{shuffle_id}/"


def _partition_prefix(shuffle_id: int, partition: int) -> str:
    return f"{_shuffle_prefix(shuffle_id)}p{partition}/"


class _SidIndex:
    """Shared discovery state for one shuffle: a single LIST of
    ``_exchange/{sid}/`` feeds every partition's drain (and every consumer
    group — the keys are the same objects). The interval between LISTs
    backs off while nothing new appears and snaps back on fresh keys, so
    idle polling stays cheap without adding arrival latency."""

    def __init__(self):
        self.lock = threading.Lock()
        self.known: set[str] = set()
        self.by_partition: dict[int, list[str]] = {}
        self.last_list = float("-inf")
        self.interval = 0.0


class S3ExchangeTransport(ShuffleTransport):
    name = "s3"
    batch_limit = S3_EXCHANGE_BATCH_LIMIT

    def __init__(self, cfg, ledger, store, sqs):
        super().__init__(cfg, ledger, store, sqs)
        self._released: set = set()  # (sid, partition, group) tombstoned
        self._groups: dict[int, int] = {}  # sid -> consumer-group count
        self._index: dict[int, _SidIndex] = {}
        self._index_lock = threading.Lock()

    # ---------------------------------------------------- producer side
    def send(self, shuffle_id, partition, src, first_seq, bodies):
        prefix = _partition_prefix(shuffle_id, partition)
        for i, body in enumerate(bodies):
            digest = hashlib.sha1(body).hexdigest()[:12]
            # content-addressed: a PUT retried after a transient 503
            # overwrites itself idempotently
            self.retry.call(self.store.put,
                            f"{prefix}{src}-{first_seq + i:08d}-{digest}",
                            body)

    def emit_eos(self, shuffle_id, nparts, src, totals):
        for p in range(nparts):
            self.retry.call(
                self.store.put_obj,
                f"{_partition_prefix(shuffle_id, p)}eos-{src}",
                totals.get(p, 0))

    # ---------------------------------------------------- consumer side
    def open_drain(self, shuffle_id, partition, quorum, group=None,
                   consumer_group=0):
        return _S3Drain(self, shuffle_id, partition, quorum, consumer_group)

    def _sid_index(self, shuffle_id: int) -> _SidIndex:
        with self._index_lock:
            idx = self._index.get(shuffle_id)
            if idx is None:
                idx = self._index[shuffle_id] = _SidIndex()
            return idx

    def discover(self, shuffle_id: int):
        """One shared, rate-limited LIST of the whole shuffle prefix;
        fresh keys are bucketed per partition for every drain to consume.
        This is the batched-discovery path: N partitions' (and G groups')
        drains cost ONE LIST per poll interval, not N."""
        idx = self._sid_index(shuffle_id)
        with idx.lock:
            now = time.monotonic()
            if now - idx.last_list < idx.interval:
                return
            idx.last_list = now
            prefix = _shuffle_prefix(shuffle_id)
            fresh = [k for k in self.retry.call(self.store.list, prefix)
                     if k not in idx.known]
            if fresh:
                # snap back to the FLOOR, not zero: during active
                # production nearly every LIST finds something fresh, and
                # a zero interval would let every drain re-LIST on its own
                # poll — exactly the per-partition request storm batching
                # is meant to end
                idx.interval = 0.002
                for key in fresh:
                    idx.known.add(key)
                    tail = key[len(prefix):]  # "p{n}/..."
                    p = int(tail[1:tail.index("/")])
                    idx.by_partition.setdefault(p, []).append(key)
            else:
                idx.interval = min(max(idx.interval * 2, 0.002), 0.05)

    def partition_keys(self, shuffle_id: int, partition: int) -> list[str]:
        idx = self._sid_index(shuffle_id)
        with idx.lock:
            return list(idx.by_partition.get(partition, ()))

    # ------------------------------------------------- lifecycle + cost
    def open(self, shuffle_id, nparts, groups=1):
        self._groups[shuffle_id] = groups
        self._sid_index(shuffle_id)  # prefixes are implicit; index is not

    def add_group(self, shuffle_id, groups):
        """A consumer group joined AFTER ``open`` — a cross-job reader of
        a service-shared shuffle (docs/multi_tenant.md). Reads are
        non-destructive so the newcomer needs no channel setup; only the
        all-groups-released data reclaim in ``release_partition`` must
        learn to wait for it."""
        self._groups[shuffle_id] = max(self._groups.get(shuffle_id, 1),
                                       groups)

    def partition_drainable(self, shuffle_id, partition, consumer_group=0):
        """False once this group released the partition: the tombstone
        aborts any new drain and the data objects may already be deleted,
        so a replayed consumer needs ``reopen`` + upstream re-production
        first."""
        return (shuffle_id, partition, consumer_group) not in self._released

    def release_partition(self, shuffle_id, partition, consumer_group=0):
        key = (shuffle_id, partition, consumer_group)
        if key in self._released:
            return
        self._released.add(key)
        prefix = _partition_prefix(shuffle_id, partition)
        # abort marker for THIS group's competing drains first
        self.retry.call(self.store.put,
                        f"{prefix}{_TOMBSTONE}{consumer_group}", b"")
        groups = self._groups.get(shuffle_id, 1)
        if all((shuffle_id, partition, g) in self._released
               for g in range(groups)):
            # every consumer group drained this partition: the data is
            # dead (tombstones stay until gc so late losers still abort)
            for obj in self.retry.call(self.store.list, prefix):
                if _TOMBSTONE not in obj:
                    self.store.delete(obj)

    def destroy(self, shuffle_id, nparts):
        for p in range(nparts):
            for g in range(self._groups.get(shuffle_id, 1)):
                self.release_partition(shuffle_id, p, g)

    def reopen(self, shuffle_id, nparts, groups=1):
        """Lineage recovery: un-release this shuffle so a resubmitted
        producer stage can re-fill it. Deletes the partition tombstones
        (data objects are content-addressed — re-emission recreates them
        in place) and purges those tombstone keys from the shared
        discovery index, or a resumed drain would abort on the stale
        marker it discovered before the recovery."""
        self._groups.setdefault(shuffle_id, groups)
        self._released = {k for k in self._released
                          if k[0] != shuffle_id}
        prefix = _shuffle_prefix(shuffle_id)
        doomed = [k for k in self.retry.call(self.store.list, prefix)
                  if _TOMBSTONE in k]
        for k in doomed:
            self.store.delete(k)
        # purge only the authoritative ``known`` set: the per-partition
        # bucket lists keep their entries (live drains hold cursor
        # positions into them) and drains re-check a tombstone against
        # ``known`` before aborting on it
        idx = self._sid_index(shuffle_id)
        with idx.lock:
            idx.known = {k for k in idx.known if _TOMBSTONE not in k}

    def tombstone_active(self, shuffle_id: int, key: str) -> bool:
        """False once ``reopen`` retired this tombstone — a drain that
        discovered it before the recovery must not abort on it."""
        idx = self._sid_index(shuffle_id)
        with idx.lock:
            return key in idx.known

    def gc(self):
        n = self.store.delete_prefix(EXCHANGE_PREFIX)
        self._released.clear()
        with self._index_lock:
            self._index.clear()
        return {EXCHANGE_PREFIX: n} if n else {}

    def gc_sids(self, sids):
        """Targeted sweep of only the named shuffles (service mode: the
        blanket ``gc`` reaps ``_exchange/`` wholesale and would delete
        shuffles other live jobs are still draining). ``delete_prefix``
        bypasses fault injection, so this sweep cannot flake under a
        service-wide chaos plan."""
        n = 0
        for sid in sids:
            n += self.store.delete_prefix(_shuffle_prefix(sid))
            self._released = {k for k in self._released if k[0] != sid}
            with self._index_lock:
                self._index.pop(sid, None)
        return {EXCHANGE_PREFIX: n} if n else {}

    def service_cost(self):
        return self.ledger.s3_usd


class _S3Drain(DrainHandle):
    """Shared-LIST discovery with per-drain exponential backoff (an early
    pipelined consumer must not spin while its producers compute), GET per
    fresh batch, manifest-quorum termination. The drain keeps a cursor
    into its partition's shared key bucket, so work discovered by ANY
    drain of this shuffle is visible to all of them."""

    def __init__(self, tr: S3ExchangeTransport, shuffle_id: int,
                 partition: int, quorum: int, consumer_group: int):
        self.tr = tr
        self.sid = shuffle_id
        self.partition = partition
        self.consumer_group = consumer_group
        self.prefix = _partition_prefix(shuffle_id, partition)
        self.state = DrainState(quorum)
        self._pending: deque = deque()  # (src, seq, key) discovered, un-GET
        self._deferred: list = []  # discovered keys whose GET found nothing
        self._eos_pending: list = []  # eos manifests awaiting a readable GET
        self._cursor = 0  # position in the shared partition bucket
        self._timeout = tr.cfg.drain_timeout_s
        self._deadline = time.monotonic() + self._timeout
        self._backoff = 0.002

    def __next__(self):
        while True:
            if self._pending:
                src, seq, key = self._pending.popleft()
                try:
                    body = self.tr.retry.call(self.tr.store.get, key)
                except KeyError:
                    # the advertised object is GONE. Either a release
                    # deleted it (a tombstone explains that — the next
                    # poll aborts on it) or an acknowledged write was
                    # LOST. Defer instead of deciding: a concurrent
                    # stage resubmission may rewrite the byte-identical
                    # key; the drain deadline arbitrates.
                    self._deferred.append((src, seq, key))
                    continue
                return (src, seq, body)
            if self.state.done() and not self._deferred:
                raise StopIteration
            self._poll()

    def _poll(self):
        if self.tr.sqs.closed:
            raise AbortedError(f"s3 exchange {self.prefix}: aborted")
        self.tr.discover(self.sid)
        bucket = self.tr.partition_keys(self.sid, self.partition)
        progressed = False
        for key in bucket[self._cursor:]:
            tail = key[len(self.prefix):]
            if tail.startswith(_TOMBSTONE):
                if (int(tail[len(_TOMBSTONE):]) == self.consumer_group
                        and self.tr.tombstone_active(self.sid, key)):
                    raise AbortedError(
                        f"s3 exchange {self.prefix} released for group "
                        f"{self.consumer_group} — a competing attempt "
                        f"already completed this partition")
                continue  # a sibling group's (or a retired) release
            if tail.startswith("eos-"):
                self._eos_pending.append(key)
            else:
                src, seq, _digest = tail.split("-")
                if self.state.register_data(src, int(seq)):
                    self._pending.append((src, int(seq), key))
                    progressed = True
        self._cursor = len(bucket)
        if self._eos_pending:
            # a discovered EOS manifest that GETs to nothing is either a
            # released partition (the tombstone branch above handles that
            # on a later poll) or a LOST object — keep trying until the
            # manifest reappears (stage resubmission rewrites it) or the
            # deadline arbitrates
            still = []
            for key in self._eos_pending:
                try:
                    total = self.tr.retry.call(self.tr.store.get_obj, key)
                except KeyError:
                    still.append(key)
                    continue
                progressed |= self.state.register_eos(
                    key[len(self.prefix) + 4:], total)
            self._eos_pending = still
        # vanished-object re-check: a resubmitted producer rewrites the
        # byte-identical key in place — promote it back to pending the
        # moment it reappears (HEAD, unbilled metadata)
        if self._deferred:
            still_gone = []
            for src, seq, key in self._deferred:
                if self.tr.store.exists(key):
                    self._pending.append((src, seq, key))
                    progressed = True
                else:
                    still_gone.append((src, seq, key))
            self._deferred = still_gone
        now = time.monotonic()
        if progressed:
            self._deadline = now + self._timeout
            self._backoff = 0.002
            return
        if self._pending or (self.state.done() and not self._deferred):
            return
        if now > self._deadline:
            if len(self.state.eos_total) >= self.state.quorum > 0:
                # every producer finished and closed its stream, yet
                # advertised batches never materialized: an acknowledged
                # durable write was lost. Only producing-stage
                # resubmission can recreate it.
                # name the producers whose output vanished so the
                # scheduler can resubmit exactly those tasks instead of
                # the whole stage (src encodes stage/index): a producer is
                # short when its EOS-advertised count exceeds what was
                # received — whether the object vanished AFTER discovery
                # (deferred) or was lost before any LIST ever saw it
                short = {src for src, total in self.state.eos_total.items()
                         if self.state.per_src.get(src, 0) < total}
                short |= {src for src, _, _ in self._deferred}
                missing = sum(
                    total - self.state.per_src.get(src, 0)
                    for src, total in self.state.eos_total.items()
                ) + len(self._deferred)
                err = LostShuffleInput(
                    f"s3 exchange {self.prefix}: producer quorum complete "
                    f"but {missing} advertised batch(es) from "
                    f"{sorted(short)} missing past the drain deadline — "
                    f"exchange object(s) lost after write")
                err.detail = {"srcs": sorted(short)}
                raise err
            # quorum incomplete: name the producers whose EOS manifest DID
            # arrive so the scheduler — once it knows every producing
            # stage finished — can resubmit exactly the absent ones (a
            # lost eos-{src} manifest is indistinguishable from a slow
            # producer down here; the scheduler has the stage ledger)
            err2 = TimeoutError(
                f"s3 exchange {self.prefix} incomplete: "
                f"{len(self.state.seen)} batches, eos "
                f"{len(self.state.eos_total)}/{self.state.quorum}")
            err2.detail = {"sid": self.sid,
                           "have_eos": sorted(self.state.eos_total)}
            raise err2
        time.sleep(self._backoff)
        self._backoff = min(self._backoff * 2, 0.1)

    def ack(self):
        pass  # reads are non-destructive; a retry recovers by re-listing
