"""Chaos fault-injection subsystem (docs/fault_tolerance.md).

``FaultPlan`` is THE fault-schedule schema — the legacy per-task dict the
scheduler used to take (``{(stage, index): {"fail_attempts": n}}``) folds
into its ``tasks`` field via ``FaultPlan.coerce``. ``FaultInjector`` turns
a plan into reproducible decisions that the simulated services consult at
every data-plane call: the SQS sim on send/receive, the object store on
PUT/GET/LIST, and ``LambdaSim`` at invocation admission.

Schema (all probabilities per call, in [0, 1]):

  seed                  base for every pseudo-random decision
  tasks                 {(stage, index): {task fault}} — targeted task
                        faults, unchanged from the legacy format:
                          fail_attempts: n          fail the first n attempts
                          straggle_s: s             sleep s on attempt 0
                          fail_after_records: n     die mid-task (attempt 0)
                          fail_on_link: k           die on chained link k
                          timeout_after_records: n  invocation lease expires
                                                    mid-task (attempt 0) —
                                                    partial flushes LAND
  s3_error_prob         transient 503/SlowDown on S3 PUT/GET/LIST
  sqs_error_prob        transient error on SQS send/receive
  sqs_delay_prob        a sent batch is delivered late ...
  sqs_delay_s           ... by this many seconds
  invoke_throttle_prob  Lambda 429 at invocation admission
  invoke_timeout_prob   probabilistic invocation timeout (attempt 0)
  account_concurrency   429 every invocation above this in-flight cap
                        (0 = uncapped)
  lose_object_prob      an ACKNOWLEDGED durable write silently vanishes
  lose_object_prefixes  ... restricted to these key prefixes (default:
                        exchange batches, cache materializations and
                        broadcast objects — the lost-durable-object
                        faults lineage recovery heals)
  lose_keys             targeted loss: first write whose key contains each
                        fragment vanishes (fires once per fragment)
  lose_keys_every       like lose_keys but EVERY matching write vanishes —
                        a permanent black hole, for exhaustion tests

Decisions are pure functions of (seed, call signature, per-signature call
count), not of global call order — so a fixed seed yields the same
schedule for the same call sequence even across thread interleavings.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading

from repro_torch.core.retry import TransientServiceError

#: recognized targeted task-fault keys (the legacy scheduler format)
TASK_FAULT_KEYS = frozenset({
    "fail_attempts", "straggle_s", "fail_after_records", "fail_on_link",
    "timeout_after_records",
})

_PROB_FIELDS = ("s3_error_prob", "sqs_error_prob", "sqs_delay_prob",
                "invoke_throttle_prob", "invoke_timeout_prob",
                "lose_object_prob")


@dataclasses.dataclass
class FaultPlan:
    seed: int = 0
    tasks: dict = dataclasses.field(default_factory=dict)
    s3_error_prob: float = 0.0
    sqs_error_prob: float = 0.0
    sqs_delay_prob: float = 0.0
    sqs_delay_s: float = 0.02
    invoke_throttle_prob: float = 0.0
    invoke_timeout_prob: float = 0.0
    account_concurrency: int = 0
    lose_object_prob: float = 0.0
    lose_object_prefixes: tuple = ("_exchange/", "_cache/",
                                   "_broadcast/")
    lose_keys: tuple = ()
    lose_keys_every: tuple = ()

    def __post_init__(self):
        for f in _PROB_FIELDS:
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultPlan.{f} must be in [0, 1], got {v}")
        if self.account_concurrency < 0:
            raise ValueError("FaultPlan.account_concurrency must be >= 0")
        if self.sqs_delay_s < 0:
            raise ValueError("FaultPlan.sqs_delay_s must be >= 0")
        for key, fault in self.tasks.items():
            if (not isinstance(key, tuple) or len(key) != 2
                    or not all(isinstance(k, int) for k in key)):
                raise ValueError(
                    f"FaultPlan.tasks keys are (stage, index) int pairs, "
                    f"got {key!r}")
            unknown = set(fault) - TASK_FAULT_KEYS
            if unknown:
                raise ValueError(
                    f"unknown task fault keys {sorted(unknown)} for task "
                    f"{key} (known: {sorted(TASK_FAULT_KEYS)})")

    @classmethod
    def coerce(cls, plan) -> "FaultPlan":
        """Accept a FaultPlan, the legacy ``{(stage, index): {...}}`` dict
        (compatibility shim), or None (no faults)."""
        if plan is None:
            return cls()
        if isinstance(plan, FaultPlan):
            return plan
        if isinstance(plan, dict):
            return cls(tasks=dict(plan))
        raise TypeError(
            f"fault_plan must be a FaultPlan or a legacy task-fault dict, "
            f"got {type(plan).__name__}")

    @property
    def has_service_faults(self) -> bool:
        """True when the SERVICE sims need an injector installed (targeted
        task faults alone ride the task payload, as they always did)."""
        return bool(any(getattr(self, f) for f in _PROB_FIELDS)
                    or self.account_concurrency
                    or self.lose_keys or self.lose_keys_every)

    @property
    def empty(self) -> bool:
        return not (self.tasks or self.has_service_faults)


class ConcurrencyGauge:
    """Account-level in-flight invocation counter. Each ``LambdaSim``
    owns one by default; the multi-tenant service (repro_torch.svc) shares a
    single gauge across every session's LambdaSim so that
    ``FaultPlan.account_concurrency`` caps the ACCOUNT — the paper's
    per-account Lambda limit — rather than each job independently
    (docs/multi_tenant.md). ``peak`` is observability for tests and
    benchmarks asserting the shared cap was actually exercised."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0
        self.peak = 0

    def enter(self) -> int:
        """Count an invocation in; returns the in-flight total including
        it (the admission check compares this against the cap)."""
        with self._lock:
            self.value += 1
            if self.value > self.peak:
                self.peak = self.value
            return self.value

    def exit(self):
        with self._lock:
            self.value -= 1


class FaultInjector:
    """Seeded, reproducible fault decisions over one FaultPlan. Installed
    on the sims as a ``.faults`` attribute for the duration of one
    scheduler run; the sims consult it at every data-plane call."""

    def __init__(self, plan: FaultPlan, ledger=None):
        self.plan = plan
        self.ledger = ledger
        self._lock = threading.Lock()
        self._counts: dict = {}     # call signature -> times seen
        self._fired: set = set()    # one-shot faults already delivered
        self.stats = {"s3_errors": 0, "sqs_errors": 0, "sqs_delays": 0,
                      "lost_objects": 0, "throttles": 0, "timeouts": 0}

    def _bump(self, key: str):
        with self._lock:
            self.stats[key] += 1
        if self.ledger is not None and key.endswith("_errors"):
            self.ledger.add_service_fault()

    def _decide(self, prob: float, *sig) -> bool:
        """One seeded coin flip for this (signature, occurrence) pair."""
        if prob <= 0.0:
            return False
        with self._lock:
            n = self._counts.get(sig, 0)
            self._counts[sig] = n + 1
        h = hashlib.sha1(
            repr((self.plan.seed,) + sig + (n,)).encode()).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < prob

    # ------------------------------------------------------ service hooks
    def s3_call(self, op: str, key: str):
        """Raises a transient 5xx BEFORE the operation takes effect (AWS
        does not bill server errors; the ledger counts them separately)."""
        if self._decide(self.plan.s3_error_prob, "s3", op, key):
            self._bump("s3_errors")
            raise TransientServiceError(
                f"S3 {op} {key}: 503 SlowDown (injected)",
                service="s3", op=op)

    def sqs_call(self, op: str, queue: str):
        if self._decide(self.plan.sqs_error_prob, "sqs", op, queue):
            self._bump("sqs_errors")
            raise TransientServiceError(
                f"SQS {op} {queue}: internal error (injected)",
                service="sqs", op=op)

    def delivery_delay(self, queue: str) -> float:
        """Seconds a successfully-sent batch sits invisible before
        delivery (SQS makes no latency promise)."""
        if self._decide(self.plan.sqs_delay_prob, "sqsdelay", queue):
            self._bump("sqs_delays")
            return self.plan.sqs_delay_s
        return 0.0

    def object_written(self, key: str) -> bool:
        """Consulted AFTER a durable write is acknowledged; True means the
        object silently vanishes — the writer saw success. Tombstones are
        exempt (they are release markers, not data)."""
        if ".released" in key:
            return False
        for frag in self.plan.lose_keys_every:
            if frag in key:
                self._bump("lost_objects")
                return True
        for frag in self.plan.lose_keys:
            if frag in key:
                with self._lock:
                    if ("lose_keys", frag) in self._fired:
                        continue
                    self._fired.add(("lose_keys", frag))
                self._bump("lost_objects")
                return True
        if (self.plan.lose_object_prob
                and any(key.startswith(p)
                        for p in self.plan.lose_object_prefixes)
                and self._decide(self.plan.lose_object_prob, "lost", key)):
            self._bump("lost_objects")
            return True
        return False

    # --------------------------------------------------- invocation hooks
    def invoke_fault(self, stage: int, index: int, attempt: int,
                     inflight: int) -> str | None:
        """Admission decision for one invocation: "throttle" (429) or
        None. The concurrency cap throttles deterministically; the
        probabilistic throttle is a fresh coin per (task, occurrence)."""
        cap = self.plan.account_concurrency
        if cap and inflight > cap:
            self._bump("throttles")
            return "throttle"
        if self._decide(self.plan.invoke_throttle_prob,
                        "throttle", stage, index):
            self._bump("throttles")
            return "throttle"
        return None

    def timeout_after(self, stage: int, index: int, attempt: int
                      ) -> int | None:
        """Record count after which this invocation's lease expires
        mid-task (killed WITHOUT a final flush — whatever full batches
        already flushed stay durable, exercising re-emission dedup).
        Attempt 0 only: the retry must be able to finish."""
        if attempt != 0:
            return None
        t = self.plan.tasks.get((stage, index), {}).get(
            "timeout_after_records")
        if t:
            self._bump("timeouts")
            return t
        if self.plan.invoke_timeout_prob and self._decide(
                self.plan.invoke_timeout_prob, "timeout", stage, index):
            self._bump("timeouts")
            h = hashlib.sha1(
                repr((self.plan.seed, "tcount", stage, index)).encode()
            ).digest()
            return 20 + int.from_bytes(h[:4], "big") % 180
        return None

    def task_fault(self, stage: int, index: int) -> dict:
        """Targeted task faults for the scheduler's payload builder."""
        return self.plan.tasks.get((stage, index), {})
