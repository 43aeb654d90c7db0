"""Simulated state-as-a-service backends: SQS (queue shuffle) and S3
(object store) — semantics matched to the paper's execution environment.

SQSSim reproduces what matters for Flint's correctness story:
  * batched sends (<=10 messages, <=256 KiB each), billing per 64 KiB chunk;
  * AT-LEAST-ONCE delivery: a seeded duplicator re-delivers a configurable
    fraction of messages (paper §VI flags this; core.dedup handles it);
  * no ordering guarantees (receive shuffles within the visible set);
  * VISIBILITY-TIMEOUT receives: a receive does not pop a message — it
    moves it to a per-queue in-flight set under a fresh receipt handle and
    a visibility deadline. ``delete_batch`` (the ack) removes in-flight
    messages for good; ``change_visibility`` extends a consumer's claim
    (the heartbeat). A lazy sweep returns expired in-flight messages to
    the visible set, where their redelivery bills as a fresh receive —
    so a consumer that dies without acking leaves everything it read to
    reappear for its retry (paper §III/§VI: "retry with the same
    identity"), and two competing drains merely race on acks instead of
    destructively splitting a queue;
  * three message kinds: "data" (packed record batches), "eos" — the
    per-producer end-of-stream control message that lets consumers start
    draining BEFORE their producers finish (pipelined stage execution);
    an EOS message carries the producer's total sequence count in ``seq``
    — and "wmark", the streaming generalization of EOS: where EOS closes
    a finite stream at a plan-time quorum, a watermark message closes an
    event-time WINDOW of an unbounded stream, carrying the max event
    time a producer (micro-batch) has observed (repro_torch.streaming,
    docs/streaming.md);
  * a condition variable on arrival, so consumers block instead of
    sleep-spinning while their producers are still computing.

ObjectStoreSim is the S3 stand-in: ranged GETs over byte blobs for input
splits, PUT/GET/LIST (with multipart-aware billing) for the Lambada-style
exchange shuffle (core.shuffle.s3), the >6 MB payload spill (paper
§III-B), and the >256 KiB record spill (SpillPointer messages).

The shuffle data plane itself — transport selection, drain protocol,
batch framing — lives in core.shuffle; this module only simulates the
services. pack_records/unpack_records remain here as the length-prefixed
pickle framing that core.shuffle.batch falls back to for ragged data.
"""

from __future__ import annotations

import itertools
import pickle
import random
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable

from repro_torch.core.costs import (SQS_BATCH_MESSAGES, SQS_MESSAGE_LIMIT,
                              CostLedger)


class QueueGone(RuntimeError):
    """Receive from a deleted queue — like SQS's QueueDoesNotExist. Raised
    so a losing speculative consumer aborts the moment the winner's
    completion deletes the queue, instead of waiting out the drain
    timeout."""


class Message:
    __slots__ = ("body", "seq", "src", "kind", "receipt")

    def __init__(self, body: bytes, seq: int, src: str, kind: str = "data"):
        self.body = body
        self.seq = seq
        self.src = src
        self.kind = kind
        self.receipt = None  # set per receive; a redelivery gets a new one


def eos_message(src: str, total: int) -> Message:
    """End-of-stream control message: ``total`` is the number of data
    messages (sequence ids 0..total-1) this producer sent to the queue."""
    return Message(b"", total, src, kind="eos")


def watermark_message(src: str, ts: float, batch: int = 0) -> Message:
    """Event-time watermark control message — the streaming sibling of
    ``eos_message``. ``src`` identifies the emitting micro-batch/source,
    ``ts`` is the maximum event time it has observed (packed in ``body``,
    read back with ``watermark_ts``), ``batch`` rides in ``seq``. The
    micro-batch driver folds these monotonically and closes every window
    whose end the folded watermark has passed (docs/streaming.md); a
    drained finite stream is signalled with ``ts=float("inf")``, which
    degenerates to EOS — every window closes."""
    return Message(struct.pack("<d", float(ts)), batch, src, kind="wmark")


def watermark_ts(msg: Message) -> float:
    """The event-time carried by a ``watermark_message``."""
    if msg.kind != "wmark":
        raise ValueError(f"not a watermark message (kind={msg.kind!r})")
    return struct.unpack("<d", msg.body)[0]


class _QueueState:
    __slots__ = ("visible", "inflight", "delayed")

    def __init__(self):
        self.visible: deque[Message] = deque()
        self.inflight: dict[int, tuple[Message, float]] = {}  # receipt ->
        #                                           (message, visibility deadline)
        # injected delivery delay: (deliver_at, message), moved to visible
        # by the lazy sweep — SQS makes no latency promise
        self.delayed: list[tuple[float, Message]] = []


class SQSSim:
    """In-process SQS with at-least-once + visibility-timeout semantics and
    per-request billing."""

    def __init__(self, ledger: CostLedger, *, duplicate_prob: float = 0.0,
                 seed: int = 0, visibility_timeout: float = 30.0):
        self.ledger = ledger
        self.duplicate_prob = duplicate_prob
        self.visibility_timeout = visibility_timeout
        self._rng = random.Random(seed)
        self._queues: dict[str, _QueueState] = {}
        self._receipts = itertools.count(1)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self.redeliveries = 0  # expired in-flight messages returned visible
        # chaos hook: a FaultInjector installed by the scheduler for the
        # duration of a run; consulted on every data-plane call
        self.faults = None

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self):
        """Release every blocked consumer (scheduler shutdown/abort)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def create_queue(self, name: str):
        with self._cond:
            self._queues.setdefault(name, _QueueState())
        self.ledger.add_sqs_control()

    def delete_queue(self, name: str):
        with self._cond:
            self._queues.pop(name, None)
            # a consumer blocked in wait_for_messages must wake and observe
            # QueueGone on its next receive
            self._cond.notify_all()
        self.ledger.add_sqs_control()

    def _sweep(self, q: _QueueState):
        """Lazy redelivery: return expired in-flight messages to the
        visible set (their next receive bills fresh), and surface delayed
        deliveries whose time has come. Caller holds lock."""
        now = time.monotonic()
        if q.delayed:
            due = [m for t, m in q.delayed if t <= now]
            if due:
                q.delayed = [(t, m) for t, m in q.delayed if t > now]
                q.visible.extend(due)
                self._cond.notify_all()
        if not q.inflight:
            return
        expired = [r for r, (_, dl) in q.inflight.items() if dl <= now]
        for r in expired:
            msg, _ = q.inflight.pop(r)
            msg.receipt = None  # the old receipt handle is now stale
            q.visible.append(msg)
        if expired:
            self.redeliveries += len(expired)
            self._cond.notify_all()

    def send_batch(self, name: str, messages: list[Message]):
        if len(messages) > SQS_BATCH_MESSAGES:
            raise ValueError("SQS batch send limited to 10 messages")
        payload = 0
        for m in messages:
            if len(m.body) > SQS_MESSAGE_LIMIT:
                raise ValueError("SQS message exceeds 256 KiB")
            payload += len(m.body)
        inj = self.faults
        delay = 0.0
        if inj is not None:
            # an injected 5xx fails the request before anything is
            # enqueued or billed (AWS does not bill server errors)
            inj.sqs_call("send", name)
            delay = inj.delivery_delay(name)
        self.ledger.add_sqs(payload)  # a rejected send still bills
        deliver_at = time.monotonic() + delay if delay else 0.0
        with self._cond:
            q = self._queues.get(name)
            if q is None:
                # queue was deleted (e.g. a losing speculative duplicate
                # still flushing after its stage completed) — like real
                # SQS's QueueDoesNotExist, the send goes nowhere; it must
                # NOT resurrect the queue and strand messages
                return
            for m in messages:
                if deliver_at:
                    q.delayed.append((deliver_at, m))
                else:
                    q.visible.append(m)
                # at-least-once: occasionally deliver a duplicate
                if self._rng.random() < self.duplicate_prob:
                    dup = Message(m.body, m.seq, m.src, m.kind)
                    if deliver_at:
                        q.delayed.append((deliver_at, dup))
                    else:
                        q.visible.append(dup)
            self._cond.notify_all()

    def _take_visible(self, q: _QueueState, max_messages: int
                      ) -> list[Message]:
        """Move up to ``max_messages`` from visible to in-flight under
        fresh receipt handles. Caller holds lock."""
        self._sweep(q)
        out: list[Message] = []
        vis = q.visible
        k = min(max_messages, len(vis))
        if k:
            # no ordering guarantee: rotate by a random offset
            if len(vis) > k and self._rng.random() < 0.5:
                vis.rotate(-self._rng.randrange(len(vis) - k + 1))
            deadline = time.monotonic() + self.visibility_timeout
            for _ in range(k):
                m = vis.popleft()
                m.receipt = next(self._receipts)
                q.inflight[m.receipt] = (m, deadline)
                out.append(m)
        return out

    def receive_batch(self, name: str, max_messages: int = SQS_BATCH_MESSAGES
                      ) -> list[Message]:
        """One batch-receive API call (<=10 messages)."""
        return self.receive_many(name, min(max_messages, SQS_BATCH_MESSAGES))

    def receive_many(self, name: str, max_messages: int = 100
                     ) -> list[Message]:
        """Drain up to ``max_messages`` in one scheduler step. Physically
        this is ceil(n/10) batch-receive API calls, and it bills as such."""
        with self._cond:
            q = self._queues.get(name)
            if q is None:
                raise QueueGone(name)
            if self.faults is not None:
                # transient receive error: fails the request before any
                # message is claimed, and before billing
                self.faults.sqs_call("receive", name)
            out = self._take_visible(q, max_messages)
        if not out:
            self.ledger.add_sqs(1, receive=True)  # one empty receive
            return out
        for i in range(0, len(out), SQS_BATCH_MESSAGES):
            chunk = out[i:i + SQS_BATCH_MESSAGES]
            payload = sum(len(m.body) for m in chunk)
            self.ledger.add_sqs(max(payload, 1), receive=True)
        return out

    def delete_batch(self, name: str, receipts: list[int]):
        """Ack: remove in-flight messages for good. Stale receipts (already
        acked, or expired and redelivered under a new handle) and deleted
        queues are no-ops, so duplicate acks from racing attempts are
        idempotent."""
        if len(receipts) > SQS_BATCH_MESSAGES:
            raise ValueError("SQS batch delete limited to 10 receipts")
        self.ledger.add_sqs_control()
        with self._cond:
            q = self._queues.get(name)
            if q is None:
                return
            for r in receipts:
                q.inflight.pop(r, None)

    def change_visibility(self, name: str, receipts: list[int],
                          timeout: float):
        """Heartbeat: extend the visibility deadline of held messages so a
        long fold does not leak them to a rival mid-task. Stale receipts
        are no-ops."""
        if len(receipts) > SQS_BATCH_MESSAGES:
            raise ValueError("SQS visibility batch limited to 10 receipts")
        self.ledger.add_sqs_control()
        deadline = time.monotonic() + timeout
        with self._cond:
            q = self._queues.get(name)
            if q is None:
                return
            for r in receipts:
                entry = q.inflight.get(r)
                if entry is not None:
                    q.inflight[r] = (entry[0], deadline)

    def wait_for_messages(self, name: str, timeout: float) -> bool:
        """Block until the queue has a visible message, the queue is gone,
        or the sim is closed. Long polling: waiting itself is not a
        billable request."""
        def ready() -> bool:
            if self._closed:
                return True
            q = self._queues.get(name)
            if q is None:
                return True  # wake: the next receive raises QueueGone
            self._sweep(q)
            return bool(q.visible)

        with self._cond:
            return self._cond.wait_for(ready, timeout)

    def approx_len(self, name: str) -> int:
        """Visible-message backlog estimate (SQS's
        ApproximateNumberOfMessages — in-flight messages excluded). A
        GetQueueAttributes call, so it bills like any other request."""
        self.ledger.add_sqs_control()
        with self._cond:
            q = self._queues.get(name)
            if q is None:
                return 0
            self._sweep(q)
            return len(q.visible)

    def inflight_len(self, name: str) -> int:
        with self._cond:
            q = self._queues.get(name)
            return len(q.inflight) if q is not None else 0


class ObjectStoreSim:
    """S3 stand-in: named byte blobs with ranged reads and listing.

    Billing matches the request it models: a put above the multipart
    threshold bills as Create + UploadParts + Complete, every ``list`` is a
    LIST request (the recurring cost of the S3-exchange shuffle's polling
    discovery), and deletes are free but counted."""

    def __init__(self, ledger: CostLedger):
        self.ledger = ledger
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()
        # chaos hook: a FaultInjector installed by the scheduler for the
        # duration of a run; consulted on the billable data-plane calls
        # (PUT/GET/LIST — never on deletes or metadata, so GC stays clean)
        self.faults = None

    def put(self, key: str, data: bytes):
        inj = self.faults
        if inj is not None:
            inj.s3_call("put", key)  # 5xx: nothing stored, nothing billed
        with self._lock:
            self._objects[key] = bytes(data)
        self.ledger.add_s3_put(len(data))
        if inj is not None and inj.object_written(key):
            # the durability fault: the write was ACKNOWLEDGED (billed,
            # caller saw success) and the object silently vanishes
            with self._lock:
                self._objects.pop(key, None)

    def get(self, key: str, start: int = 0, end: int | None = None) -> bytes:
        inj = self.faults
        if inj is not None:
            inj.s3_call("get", key)
        with self._lock:
            data = self._objects[key]
        out = data[start:end]
        self.ledger.add_s3(len(out))
        return out

    def size(self, key: str) -> int:
        with self._lock:
            return len(self._objects[key])

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def list(self, prefix: str) -> list[str]:
        if self.faults is not None:
            self.faults.s3_call("list", prefix)
        self.ledger.add_s3_list()
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def prefix_bytes(self, prefix: str) -> int:
        """Total stored bytes under a prefix, unbilled: object sizes are
        metadata a real driver already holds (LIST responses carry them,
        and the driver wrote these keys' registry itself) — the planner's
        cost model reads them like any other client-side bookkeeping."""
        with self._lock:
            return sum(len(v) for k, v in self._objects.items()
                       if k.startswith(prefix))

    def delete(self, key: str):
        self.ledger.add_s3_delete()
        with self._lock:
            self._objects.pop(key, None)

    def delete_prefix(self, prefix: str) -> int:
        """Job-scoped GC sweep: one LIST + a (free) DELETE per key."""
        self.ledger.add_s3_list()
        with self._lock:
            doomed = [k for k in self._objects if k.startswith(prefix)]
            for k in doomed:
                del self._objects[k]
        for _ in doomed:
            self.ledger.add_s3_delete()
        return len(doomed)

    # convenience for pickled python values (payload spill, shuffle blobs)
    def put_obj(self, key: str, value: Any):
        self.put(key, pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))

    def get_obj(self, key: str) -> Any:
        return pickle.loads(self.get(key))


_FRAME = struct.Struct("<I")  # 4-byte little-endian record-length prefix


class SpillPointer:
    """Stand-in record for a single pickle too large for one SQS message:
    the real bytes ride the object store (paper §III-B large-payload
    handling) and the queue carries this pointer instead."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key

    def __reduce__(self):
        return (SpillPointer, (self.key,))


def pack_records(records: Iterable[Any], limit: int = SQS_MESSAGE_LIMIT,
                 spill: Callable[[bytes], str] | None = None) -> list[bytes]:
    """Pack records into length-prefixed message bodies under the 256 KiB
    SQS cap, pickling each record EXACTLY once (single-pass incremental
    framing — the old implementation pickled twice: once to estimate the
    size, once inside the batch pickle).

    A single record whose pickle alone exceeds the cap would make every
    ``send_batch`` of its body raise — an unrecoverable task. With
    ``spill`` given (blob -> object-store key), the oversized pickle is
    stored out-of-band and a small SpillPointer record is framed in its
    place; ``unpack_records`` resolves it against the store."""
    bodies: list[bytes] = []
    frames: list[bytes] = []
    size = 0
    for r in records:
        blob = pickle.dumps(r, protocol=pickle.HIGHEST_PROTOCOL)
        need = _FRAME.size + len(blob)
        if spill is not None and need > limit:
            blob = pickle.dumps(SpillPointer(spill(blob)),
                                protocol=pickle.HIGHEST_PROTOCOL)
            need = _FRAME.size + len(blob)
        if frames and size + need > limit:
            bodies.append(b"".join(frames))
            frames, size = [], 0
        frames.append(_FRAME.pack(len(blob)))
        frames.append(blob)
        size += need
    if frames:
        bodies.append(b"".join(frames))
    return bodies


def unpack_records(body: bytes, store: ObjectStoreSim | None = None
                   ) -> list[Any]:
    out = []
    off, n = 0, len(body)
    while off < n:
        (ln,) = _FRAME.unpack_from(body, off)
        off += _FRAME.size
        rec = pickle.loads(body[off:off + ln])
        off += ln
        if isinstance(rec, SpillPointer):
            if store is None:
                raise ValueError(
                    f"spilled record {rec.key} needs an object store")
            rec = pickle.loads(store.get(rec.key))
        out.append(rec)
    return out
