"""Pluggable shuffle-transport subsystem (docs/shuffle_transports.md).

The transport that moves intermediate data is a per-shuffle decision, not
an engine constant: ``ShuffleWrite.transport`` (the DAG-level hint, e.g.
``rdd.reduceByKey(fn, 8, transport="s3")``) names a backend here, falling
back to ``FlintConfig.shuffle_backend``. Backends conform to
``base.ShuffleTransport`` and share the columnar record-batch wire format
in ``batch``.
"""

from __future__ import annotations

import threading

from repro_torch.core.retry import RetryPolicy
from repro_torch.core.shuffle.base import (AbortedError, DrainHandle, DrainState,
                                     LostShuffleInput, ShuffleTransport)
from repro_torch.core.shuffle.batch import (KVBatch, is_columnar, iter_records,
                                      pack_batch, pack_batch_columns,
                                      unpack_batch)
from repro_torch.core.shuffle.s3 import S3ExchangeTransport
from repro_torch.core.shuffle.sqs import SQSTransport, queue_name

_BACKENDS: dict[str, type] = {
    SQSTransport.name: SQSTransport,
    S3ExchangeTransport.name: S3ExchangeTransport,
}


def register_transport(name: str, cls: type):
    """Extension point: a new backend needs only a conforming class."""
    _BACKENDS[name] = cls


def transport_names() -> list[str]:
    return sorted(_BACKENDS)


class TransportSet:
    """Job-scoped transport instances sharing one (cfg, ledger, store, sqs)
    quartet, constructed lazily so a query that never touches a backend
    never pays its setup."""

    def __init__(self, cfg, ledger, store, sqs, *, budget=None):
        self.cfg = cfg
        self.ledger = ledger
        self.store = store
        self.sqs = sqs
        # one job-wide retry policy for every transport: the per-job retry
        # BUDGET is only meaningful if all backends draw from the same pool
        self.retry = RetryPolicy.from_config(cfg, budget=budget)
        self._instances: dict[str, ShuffleTransport] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> ShuffleTransport:
        with self._lock:
            tr = self._instances.get(name)
            if tr is None:
                cls = _BACKENDS.get(name)
                if cls is None:
                    raise ValueError(
                        f"unknown shuffle transport {name!r} "
                        f"(have: {', '.join(transport_names())})")
                tr = self._instances[name] = cls(self.cfg, self.ledger,
                                                 self.store, self.sqs)
                # attribute swap, not a constructor arg: third-party
                # backends registered via register_transport keep the
                # documented 4-arg signature
                tr.retry = self.retry
            return tr

    def active(self) -> list[ShuffleTransport]:
        with self._lock:
            return list(self._instances.values())


__all__ = ["AbortedError", "DrainHandle", "DrainState", "LostShuffleInput",
           "ShuffleTransport",
           "SQSTransport", "S3ExchangeTransport", "TransportSet",
           "KVBatch", "is_columnar", "iter_records", "pack_batch",
           "pack_batch_columns", "unpack_batch", "queue_name",
           "register_transport", "transport_names"]
