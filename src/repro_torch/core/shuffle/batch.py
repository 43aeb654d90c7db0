"""Columnar record batches — the shuffle wire format shared by every
transport (docs/shuffle_transports.md).

Per-record pickling dominated shuffled bytes: a `((month, hour, payment),
count)` record costs ~60 pickle bytes where its data is ~25. When a batch's
key and value columns are homogeneous (same concrete type throughout —
ints, floats, bools, strings, or fixed-arity tuples of those), the batch is
framed as typed arrays instead (core.serde column codecs):

    b"C" | u32 n | (u16 schema-len | schema | u32 payload-len | payload) x2

Ragged data — mixed types, non-pair records, ints beyond int64, a single
record bigger than the body cap — falls back to the length-prefixed pickle
framing (queues.pack_records, which also handles the oversized-record
object-store spill), tagged:

    b"P" | pickle frames...

Both framings are deterministic functions of the record sequence, which the
fault-tolerance story requires: a retry or speculative twin re-packing the
same records must re-emit byte-identical bodies so (src, seq) dedup and
content-addressed exchange keys stay sound.

Two entry points feed this module. ``pack_batch`` takes row-major records
(the row engine's path). ``pack_batch_columns`` takes the key/value COLUMNS
directly — the vectorized engine (docs/vectorized_execution.md) keeps data
column-major from scan to shuffle via ``KVBatch`` carriers, and packing
straight from columns skips the rows→columns transpose and the per-batch
re-sniff while producing byte-identical bodies to the row path for the
same record sequence (asserted in tests/test_columnar_batches.py).
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Iterable

from repro_torch.core import serde
from repro_torch.core.costs import SQS_MESSAGE_LIMIT
from repro_torch.core.queues import ObjectStoreSim, pack_records, unpack_records

_TAG_COLUMNAR = 0x43  # "C"
_TAG_PICKLE = 0x50    # "P"
_N = struct.Struct("<I")
_SLEN = struct.Struct("<H")
# headroom for tag + count + two (schema, payload-length) headers and the
# nested tuple sub-column prefixes; schemas are tens of bytes, the caps are
# hundreds of KiB, so a flat reserve beats exact bookkeeping
_BODY_RESERVE = 512


def pack_batch(records: Iterable[Any], limit: int = SQS_MESSAGE_LIMIT,
               spill: Callable[[bytes], str] | None = None,
               columnar: bool = True,
               schema: tuple[str, str] | None = None) -> list[bytes]:
    """Pack records into tagged batch bodies, each under ``limit`` bytes.

    ``schema`` is an optional DECLARED (key-schema, value-schema) pair —
    the SQL layer knows its row types at plan time, so its shuffles skip
    the per-batch type sniffing entirely. Records that violate the
    declaration (e.g. a sum outgrowing int64) quietly fall back to the
    sniffing path, which itself falls back to pickle framing."""
    records = records if isinstance(records, list) else list(records)
    if columnar and records:
        if schema is not None:
            try:
                bodies = _pack_columnar(records, limit, declared=schema)
            except Exception:
                bodies = None  # declaration violated: sniff instead
            if bodies is not None:
                return bodies
            bodies = _pack_declared_runs(records, limit, spill, schema)
            if bodies is not None:
                return bodies
        bodies = _pack_columnar(records, limit)
        if bodies is not None:
            return bodies
    return [bytes([_TAG_PICKLE]) + body
            for body in pack_records(records, limit - 1, spill)]


def unpack_batch(body: bytes, store: ObjectStoreSim | None = None
                 ) -> list[Any]:
    tag = body[0]
    if tag == _TAG_PICKLE:
        return unpack_records(body[1:], store)
    if tag == _TAG_COLUMNAR:
        return _unpack_columnar(body)
    raise ValueError(f"unknown batch tag {body[:1]!r}")


def is_columnar(body: bytes) -> bool:
    return bool(body) and body[0] == _TAG_COLUMNAR


# --------------------------------------------------- column-major carrier


class KVBatch:
    """A run of (key, value) records held column-major between a fused
    vectorized operator and the shuffle writer.

    ``kcols``/``vcols`` are plain Python lists — one list per key/value
    tuple field, all the same length ``n`` — so core never needs numpy.
    Keys and values are always tuples on the wire for SQL shuffles, hence
    the per-field layout; ``kschema``/``vschema`` are the matching
    ``t(...)`` serde schemas (or None when the plan declared none)."""

    __slots__ = ("kcols", "vcols", "kschema", "vschema", "n")

    def __init__(self, kcols, vcols, kschema=None, vschema=None):
        if not kcols or not vcols:
            raise ValueError("KVBatch needs at least one key and value col")
        self.kcols = kcols
        self.vcols = vcols
        self.kschema = kschema
        self.vschema = vschema
        self.n = len(kcols[0])

    def key_tuples(self) -> list:
        return list(zip(*self.kcols))

    def iter_rows(self):
        """Expand back to the row representation: (key_tuple, val_tuple)."""
        return zip(zip(*self.kcols), zip(*self.vcols))

    def select(self, idxs) -> "KVBatch":
        """A new batch holding the rows at ``idxs`` (in that order)."""
        return KVBatch([[c[i] for i in idxs] for c in self.kcols],
                       [[c[i] for i in idxs] for c in self.vcols],
                       self.kschema, self.vschema)


def iter_records(it: Iterable[Any]):
    """Expand any KVBatch carriers in ``it`` back into plain records —
    the bridge for consumers that iterate row-at-a-time (result
    collection, the cluster backend's write loops, sorted re-emission)."""
    for rec in it:
        if isinstance(rec, KVBatch):
            yield from rec.iter_rows()
        else:
            yield rec


def pack_batch_columns(batch: KVBatch, limit: int = SQS_MESSAGE_LIMIT,
                       spill: Callable[[bytes], str] | None = None,
                       columnar: bool = True) -> list[bytes]:
    """Pack a column-major batch into wire bodies BYTE-IDENTICAL to
    ``pack_batch(list(batch.iter_rows()), ...)`` with the same declared
    schema — but without transposing to rows or re-sniffing types. Falls
    back to the row path (which run-splits / pickle-frames) whenever a
    column does not conform to its declared schema."""
    ks, vs = batch.kschema, batch.vschema
    if (columnar and ks is not None and vs is not None
            and ks.startswith("t(") and vs.startswith("t(")):
        ksubs = serde._split_tuple_schema(ks)
        vsubs = serde._split_tuple_schema(vs)
        if (len(ksubs) == len(batch.kcols) and len(vsubs) == len(batch.vcols)
                and all(serde.column_conforms(sub, col) for sub, col in
                        zip(ksubs + vsubs, batch.kcols + batch.vcols))):
            bodies = _pack_columnar_cols(batch, ksubs, vsubs, limit)
            if bodies is not None:
                return bodies
    return pack_batch(list(batch.iter_rows()), limit, spill, columnar,
                      schema=(ks, vs))


# ------------------------------------------------------------- internals


def _pack_columnar(records: list, limit: int,
                   declared: tuple[str, str] | None = None
                   ) -> list[bytes] | None:
    """Columnar bodies, or None when the batch is ragged (caller falls back
    to pickle framing). With ``declared`` the schemas come from the plan
    instead of sniffing the batch; a mismatch surfaces as an exception the
    caller treats as a fallback signal."""
    if any(type(r) is not tuple or len(r) != 2 for r in records):
        return None
    keys = [r[0] for r in records]
    vals = [r[1] for r in records]
    if declared is not None:
        kschema, vschema = declared
        if kschema is None or vschema is None:
            return None
        # exact-type conformance, not just encodability: struct.pack
        # would silently coerce int -> float64 / bool -> int64, breaking
        # the round-trip-exactly invariant the sniffing path guarantees
        if not (serde.column_conforms(kschema, keys)
                and serde.column_conforms(vschema, vals)):
            return None
    else:
        kschema = serde.column_schema(keys)
        vschema = serde.column_schema(vals)
    if kschema is None or vschema is None:
        return None
    sizes = [a + b for a, b in zip(serde.column_value_sizes(kschema, keys),
                                   serde.column_value_sizes(vschema, vals))]
    cap = limit - _BODY_RESERVE
    if cap <= 0 or max(sizes) > cap:
        return None  # a single oversized record rides the spill path instead
    bodies: list[bytes] = []
    start, acc = 0, 0
    for i, s in enumerate(sizes):
        if acc + s > cap:
            bodies.append(_encode_chunk(kschema, vschema,
                                        keys[start:i], vals[start:i]))
            start, acc = i, 0
        acc += s
    bodies.append(_encode_chunk(kschema, vschema, keys[start:], vals[start:]))
    if any(len(b) > limit for b in bodies):
        return None  # reserve blown (pathological schema): play it safe
    return bodies


def _encode_chunk(kschema: str, vschema: str, keys: list, vals: list
                  ) -> bytes:
    parts = [bytes([_TAG_COLUMNAR]), _N.pack(len(keys))]
    for schema, col in ((kschema, keys), (vschema, vals)):
        sblob = schema.encode("ascii")
        payload = serde.encode_column(schema, col)
        parts += [_SLEN.pack(len(sblob)), sblob, _N.pack(len(payload)),
                  payload]
    return b"".join(parts)


def _pack_declared_runs(records: list, limit: int,
                        spill: Callable[[bytes], str] | None,
                        schema: tuple[str, str]) -> list[bytes] | None:
    """Mid-stream fallback fix: when SOME records violate the declared
    schema, the old path dropped the whole call to sniffing (usually all
    the way to pickle framing), forcing downstream per-batch re-sniffing.
    Instead split the sequence into maximal runs — conforming runs keep
    the declared columnar framing, violating runs pickle-frame — so a
    single ragged record no longer degrades its neighbours. Still a
    deterministic function of the record sequence. Returns None when no
    record conforms (nothing to salvage: caller sniffs as before)."""
    kschema, vschema = schema
    if kschema is None or vschema is None:
        return None
    flags = [type(r) is tuple and len(r) == 2
             and serde.column_conforms(kschema, [r[0]])
             and serde.column_conforms(vschema, [r[1]])
             for r in records]
    if not any(flags):
        return None
    bodies: list[bytes] = []
    start = 0
    for i in range(1, len(records) + 1):
        if i < len(records) and flags[i] == flags[start]:
            continue
        run = records[start:i]
        packed = None
        if flags[start]:
            try:
                packed = _pack_columnar(run, limit, declared=schema)
            except Exception:
                packed = None
        if packed is None:  # violating run, or oversized record in a run
            packed = [bytes([_TAG_PICKLE]) + body
                      for body in pack_records(run, limit - 1, spill)]
        bodies.extend(packed)
        start = i
    return bodies


def _pack_columnar_cols(batch: KVBatch, ksubs: list[str], vsubs: list[str],
                        limit: int) -> list[bytes] | None:
    """Chunk + encode straight from columns. Mirrors ``_pack_columnar``
    exactly (same size model, same chunk boundaries, same encoding) so the
    bodies are byte-identical to the row path's for the same records."""
    sizes = [0] * batch.n
    for sub, col in zip(ksubs + vsubs, batch.kcols + batch.vcols):
        for i, s in enumerate(serde.column_value_sizes(sub, col)):
            sizes[i] += s
    cap = limit - _BODY_RESERVE
    if cap <= 0 or max(sizes) > cap:
        return None  # oversized record: row path spills it
    bodies: list[bytes] = []
    start, acc = 0, 0
    for i, s in enumerate(sizes):
        if acc + s > cap:
            bodies.append(_encode_chunk_cols(batch, ksubs, vsubs, start, i))
            start, acc = i, 0
        acc += s
    bodies.append(_encode_chunk_cols(batch, ksubs, vsubs, start, batch.n))
    if any(len(b) > limit for b in bodies):
        return None
    return bodies


def _encode_chunk_cols(batch: KVBatch, ksubs: list[str], vsubs: list[str],
                       lo: int, hi: int) -> bytes:
    parts = [bytes([_TAG_COLUMNAR]), _N.pack(hi - lo)]
    for schema, subs, cols in ((batch.kschema, ksubs, batch.kcols),
                               (batch.vschema, vsubs, batch.vcols)):
        sblob = schema.encode("ascii")
        # same layout encode_column emits for "t(...)": u32 length prefix
        # per sub-column blob, concatenated
        payload_parts = []
        for sub, col in zip(subs, cols):
            blob = serde.encode_column(sub, col[lo:hi])
            payload_parts.append(serde._U32.pack(len(blob)))
            payload_parts.append(blob)
        payload = b"".join(payload_parts)
        parts += [_SLEN.pack(len(sblob)), sblob, _N.pack(len(payload)),
                  payload]
    return b"".join(parts)


def _unpack_columnar(body: bytes) -> list:
    (n,) = _N.unpack_from(body, 1)
    off = 1 + _N.size
    cols = []
    for _ in range(2):
        (slen,) = _SLEN.unpack_from(body, off)
        off += _SLEN.size
        schema = body[off:off + slen].decode("ascii")
        off += slen
        (plen,) = _N.unpack_from(body, off)
        off += _N.size
        cols.append(serde.decode_column(schema, body[off:off + plen], n))
        off += plen
    return list(zip(cols[0], cols[1]))
