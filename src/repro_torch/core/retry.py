"""Layered retry/backoff for transient service failures
(docs/fault_tolerance.md).

Every service call Flint's data plane makes — SQS send/receive, S3
PUT/GET/LIST, the executors' store access — can fail transiently and
independently (Lambada's S3 throttling experience; ServerMix's
disaggregated-failure framing). This module is the innermost of the three
recovery layers: it retries the *call*, the scheduler retries the *task*,
and lineage resubmission retries the *stage*.

The error taxonomy splits RETRYABLE from FATAL:

  * ``TransientServiceError`` — a 5xx/SlowDown: the request failed but the
    identical call is expected to succeed. Retried here.
  * ``ThrottledError`` — 429: capacity, not failure. Retried here when it
    escapes the scheduler's dispatch backoff.
  * everything else — ``KeyError`` (a missing object is MISSING, not
    flaky; re-GETting it cannot help — that is lost-input territory,
    handled by lineage recovery), ``QueueGone``, ``AbortedError``,
    injected task faults — passes straight through.

``RetryPolicy.call`` wraps one service call with exponential backoff and
DECORRELATED JITTER (sleep ~ U(base, 3*prev) capped at ``cap``), a
per-call attempt cap, and an optional job-wide ``RetryBudget``: every
retry spends one unit, and exhausting the budget raises
``RetryBudgetExhausted`` — a FATAL error, because a job burning its whole
budget is systemically unhealthy, not unlucky.
"""

from __future__ import annotations

import pickle
import random
import threading
import time


class TransientServiceError(RuntimeError):
    """Service-side 5xx/SlowDown: the request failed, nothing happened,
    retrying the identical call is expected to succeed."""

    def __init__(self, msg: str, service: str = "", op: str = ""):
        super().__init__(msg)
        self.service = service
        self.op = op


class ThrottledError(RuntimeError):
    """429 / Rate exceeded: the service is shedding load. Retryable, but
    the right first response is to back off dispatch, not hammer."""


class RetryExhausted(RuntimeError):
    """One call failed transiently more times than the per-call attempt
    cap allows. Carries the last underlying error as ``cause``."""

    def __init__(self, msg: str, cause: BaseException | None = None):
        super().__init__(msg)
        self.cause = cause


class RetryBudgetExhausted(RuntimeError):
    """The job-wide retry budget is spent. Fatal by design: a job that
    needs this many service-call retries is failing systemically and
    should surface that instead of grinding on."""


#: the retryable side of the taxonomy — everything else is fatal here
RETRYABLE_ERRORS = (TransientServiceError, ThrottledError)


def is_retryable(exc: BaseException) -> bool:
    return isinstance(exc, RETRYABLE_ERRORS)


class RetryBudget:
    """Thread-safe job-wide cap on the total number of service-call
    retries (not calls — first attempts are free)."""

    def __init__(self, total: int):
        if total <= 0:
            raise ValueError(f"retry budget must be > 0, got {total}")
        self.total = total
        self.spent = 0
        self._lock = threading.Lock()

    def spend(self, n: int = 1):
        with self._lock:
            if self.spent + n > self.total:
                self.spent = self.total
                raise RetryBudgetExhausted(
                    f"job retry budget exhausted: {self.total} service-call "
                    f"retries spent")
            self.spent += n

    @property
    def remaining(self) -> int:
        with self._lock:
            return self.total - self.spent


class RetryPolicy:
    """Exponential backoff with decorrelated jitter around one service
    call. Instances are shared across threads (one per job or transport
    set); the RNG is locked, the rest is immutable."""

    def __init__(self, max_attempts: int = 5, base_s: float = 0.002,
                 cap_s: float = 0.05, budget: RetryBudget | None = None,
                 seed: int = 0):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        if base_s <= 0 or cap_s < base_s:
            raise ValueError(
                f"backoff must satisfy 0 < base_s <= cap_s, got "
                f"base_s={base_s} cap_s={cap_s}")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.budget = budget
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    @classmethod
    def from_config(cls, cfg, budget: RetryBudget | None = None,
                    seed: int = 0) -> "RetryPolicy":
        return cls(max_attempts=cfg.retry_max_attempts,
                   base_s=cfg.retry_base_s, cap_s=cfg.retry_cap_s,
                   budget=budget, seed=seed)

    def next_sleep(self, prev: float) -> float:
        """Decorrelated jitter (AWS builders'-library flavor): sample
        U(base, 3*prev), clamp to [base, cap]. Spreads retry storms
        without the synchronized waves plain exponential produces."""
        with self._lock:
            s = self._rng.uniform(self.base_s, max(prev * 3, self.base_s))
        return min(self.cap_s, max(self.base_s, s))

    def call(self, fn, *args, **kwargs):
        """Invoke ``fn`` retrying RETRYABLE_ERRORS only. Raises
        ``RetryExhausted`` past the attempt cap, ``RetryBudgetExhausted``
        if the shared budget runs dry first."""
        prev = self.base_s
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except RETRYABLE_ERRORS as e:
                if attempt >= self.max_attempts:
                    raise RetryExhausted(
                        f"{getattr(fn, '__name__', fn)} failed after "
                        f"{attempt} attempts: {e}", cause=e) from e
                if self.budget is not None:
                    self.budget.spend()
                prev = self.next_sleep(prev)
                time.sleep(prev)
        raise AssertionError("unreachable")


class RetryingStore:
    """View of an ObjectStoreSim that routes the billable data-plane calls
    (PUT/GET/LIST) through a RetryPolicy — the executors' store access.
    Control-plane calls (size/exists/delete) delegate untouched: the sim
    never injects faults there, and the GC must not burn retry budget."""

    def __init__(self, store, policy: RetryPolicy):
        self._store = store
        self.retry = policy

    def put(self, key, data):
        return self.retry.call(self._store.put, key, data)

    def get(self, key, start=0, end=None):
        return self.retry.call(self._store.get, key, start, end)

    def list(self, prefix):
        return self.retry.call(self._store.list, prefix)

    def put_obj(self, key, value):
        self.put(key, pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL))

    def get_obj(self, key):
        return pickle.loads(self.get(key))

    def size(self, key):
        return self._store.size(key)

    def exists(self, key):
        return self._store.exists(key)

    def prefix_bytes(self, prefix):
        return self._store.prefix_bytes(prefix)

    def delete(self, key):
        return self._store.delete(key)

    def delete_prefix(self, prefix):
        return self._store.delete_prefix(prefix)
