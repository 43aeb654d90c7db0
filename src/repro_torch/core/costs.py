"""Pay-as-you-go cost model (paper §II, Table I).

2018 AWS price sheet constants (us-east-1), the ones Flint's evaluation
used: Lambda GB-seconds + per-request, SQS per-request (each 64 KiB chunk
of a batch send/receive bills as one request), S3 GET/PUT, and the
m4.2xlarge hourly rate for the cluster baseline (11 instances = driver +
10 workers, 80 vCores).

Everything that moves in the simulated services reports here, so the
benchmark can print Table I's cost columns from actual usage — zero idle
cost by construction.
"""

from __future__ import annotations

import dataclasses
import math
import threading

LAMBDA_GB_SECOND = 0.00001667
LAMBDA_PER_REQUEST = 0.20 / 1e6
LAMBDA_MAX_MEMORY_MB = 3008
LAMBDA_TIME_LIMIT_S = 300.0
LAMBDA_PAYLOAD_LIMIT = 6 * 2**20  # 6 MB request payload cap

SQS_PER_REQUEST = 0.40 / 1e6
SQS_BILLING_CHUNK = 64 * 2**10  # every 64 KiB of a request bills separately
SQS_MESSAGE_LIMIT = 256 * 2**10
SQS_BATCH_MESSAGES = 10

S3_PER_GET = 0.0004 / 1e3
S3_PER_PUT = 0.005 / 1e3
# LIST bills at the PUT tier (it is a "LIST request" on the 2018 sheet);
# DELETE is free but counted, because a job-scoped GC that issued millions
# of them would still matter operationally.
S3_PER_LIST = 0.005 / 1e3
# Objects above the threshold upload as multipart: one CreateMultipartUpload
# + ceil(size/part) UploadPart + one CompleteMultipartUpload, each billed at
# the PUT tier. The S3 exchange shuffle is the only writer big enough.
S3_MULTIPART_THRESHOLD = 8 * 2**20
S3_MULTIPART_PART_SIZE = 8 * 2**20
# One S3-exchange batch object may be far larger than an SQS message — the
# whole point of an object-store shuffle (Lambada §4: few large objects
# instead of many tiny requests).
S3_EXCHANGE_BATCH_LIMIT = 64 * 2**20

M4_2XLARGE_HOURLY = 0.40
CLUSTER_INSTANCES = 11  # 1 driver + 10 workers (paper's Databricks cluster)

# ---------------------------------------------- adaptive transport choice
#
# Plan-time defaults for estimating how many bytes a shuffle will move
# (the planner has no statistics beyond source object sizes, so these are
# the textbook selectivity constants):
EST_FILTER_SELECTIVITY = 0.5   # each filter() halves the stream
EST_AGG_OUTPUT_FACTOR = 0.3    # aggregation output vs its input


def shuffle_transport_costs(est_bytes: float, n_producers: int,
                            nparts: int) -> dict:
    """Modeled USD for moving ``est_bytes`` of shuffle data through each
    transport, from the same price constants the ledger bills with.

    SQS bills every 64 KiB chunk on BOTH sides (send + receive) plus one
    send/receive pair per (producer, partition) channel for EOS control
    messages. The S3 exchange writes roughly one object per channel (plus
    one manifest per producer), reads each object once, and pays a few
    LISTs per partition for discovery — so its cost is per-REQUEST, not
    per-byte, which is exactly why large shuffles want it (Lambada §4)
    and tiny ones do not."""
    channels = max(1, n_producers * nparts)
    sqs_chunks = est_bytes / SQS_BILLING_CHUNK + channels  # data + EOS
    sqs = 2 * sqs_chunks * SQS_PER_REQUEST  # send + receive
    s3 = ((channels + n_producers) * S3_PER_PUT
          + channels * S3_PER_GET
          + 2 * nparts * S3_PER_LIST)
    return {"sqs": sqs, "s3": s3}


def pick_shuffle_transport(est_bytes: float, n_producers: int,
                           nparts: int) -> str:
    """The planner's per-shuffle choice when no hint or engine override
    pins one (FlintConfig.shuffle_backend == "auto")."""
    costs = shuffle_transport_costs(est_bytes, n_producers, nparts)
    return "s3" if costs["s3"] < costs["sqs"] else "sqs"


def broadcast_join_cost(small_bytes: float, n_readers: int) -> float:
    """Modeled USD for shipping a measured small join side as a
    content-addressed broadcast object: the driver drains it once (the
    GETs are already paid by the shuffle it replaces), PUTs ~one object
    (+ manifest), and every map task of the large side LISTs + GETs it
    back. Per-reader cost is a couple of requests — no per-byte shuffle
    chunking on either side."""
    n_objects = max(1, math.ceil(small_bytes / S3_EXCHANGE_BATCH_LIMIT))
    return ((n_objects + 1) * S3_PER_PUT
            + n_readers * (S3_PER_LIST + n_objects * S3_PER_GET))


def pick_join_strategy(small_bytes: float, large_bytes: float,
                       n_producers: int, nparts: int, n_readers: int,
                       threshold_bytes: int) -> str:
    """The adaptive scheduler's runtime join choice, from MEASURED sizes:
    "broadcast" when the small side fits the configured threshold AND the
    modeled broadcast cost undercuts shuffling BOTH sides; else
    "shuffle". The threshold is the memory guard (every map task holds
    the whole build side); the cost comparison is what keeps a small
    side with thousands of readers on the shuffle path."""
    if small_bytes > threshold_bytes:
        return "shuffle"
    shuffle_cost = min(shuffle_transport_costs(
        small_bytes + large_bytes, n_producers, nparts).values())
    return ("broadcast"
            if broadcast_join_cost(small_bytes, n_readers) < shuffle_cost
            else "shuffle")


def cluster_cost(wall_seconds: float, instances: int = CLUSTER_INSTANCES) -> float:
    """Per-second billing of a provisioned cluster — accrues while idle,
    which is exactly what the paper's pay-as-you-go goal removes."""
    return wall_seconds * instances * M4_2XLARGE_HOURLY / 3600.0


def sqs_request_units(payload_bytes: int) -> int:
    return max(1, math.ceil(payload_bytes / SQS_BILLING_CHUNK))


@dataclasses.dataclass
class CostLedger:
    """Thread-safe usage accumulator shared by the simulated services.

    ``child()`` creates a TENANT-SCOPED sub-ledger: everything billed to
    the child is billed to this (parent) ledger too, so a multi-tenant
    service can show each tenant its own bill while the root ledger stays
    the account-wide total (docs/multi_tenant.md). Chaining is one level
    deep in practice but composes to any depth."""

    lambda_gb_seconds: float = 0.0
    lambda_requests: int = 0
    sqs_requests: int = 0
    s3_gets: int = 0
    s3_puts: int = 0
    s3_lists: int = 0
    s3_upload_parts: int = 0
    s3_deletes: int = 0
    bytes_to_sqs: int = 0
    bytes_from_sqs: int = 0
    bytes_from_s3: int = 0
    bytes_to_s3: int = 0
    # chaos bookkeeping: injected 5xx are NOT billed (AWS doesn't bill
    # server errors) but the retries they force are — each retried call
    # re-bills above. 429s never reach a container, so no GB-seconds.
    service_faults: int = 0
    lambda_throttles: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._parent: "CostLedger | None" = None

    def child(self) -> "CostLedger":
        """A sub-ledger whose every charge also lands here. The service
        layer hands one to each tenant so per-tenant cost reports and
        dollar quotas come from real metered usage, not attribution
        heuristics."""
        c = CostLedger()
        c._parent = self
        return c

    def add_lambda(self, duration_s: float, memory_mb: int):
        with self._lock:
            self.lambda_requests += 1
            # AWS billed per 100ms slices in 2018
            slices = math.ceil(duration_s / 0.1)
            self.lambda_gb_seconds += slices * 0.1 * (memory_mb / 1024.0)
        if self._parent is not None:
            self._parent.add_lambda(duration_s, memory_mb)

    def add_sqs(self, payload_bytes: int, receive: bool = False):
        with self._lock:
            self.sqs_requests += sqs_request_units(payload_bytes)
            if receive:
                self.bytes_from_sqs += payload_bytes
            else:
                self.bytes_to_sqs += payload_bytes
        if self._parent is not None:
            self._parent.add_sqs(payload_bytes, receive)

    def add_sqs_control(self):
        """Queue create/delete/empty-receive — one billable request."""
        with self._lock:
            self.sqs_requests += 1
        if self._parent is not None:
            self._parent.add_sqs_control()

    def add_s3(self, nbytes: int, put: bool = False):
        if put:
            self.add_s3_put(nbytes)
        else:
            with self._lock:
                self.s3_gets += 1
                self.bytes_from_s3 += nbytes
            if self._parent is not None:
                self._parent.add_s3(nbytes)

    def add_s3_put(self, nbytes: int):
        """A PUT; above the multipart threshold it bills as a multipart
        upload instead: Create + per-part UploadPart + Complete, each a
        PUT-tier request."""
        with self._lock:
            self.bytes_to_s3 += nbytes
            if nbytes > S3_MULTIPART_THRESHOLD:
                self.s3_puts += 2  # CreateMultipartUpload + Complete
                self.s3_upload_parts += math.ceil(
                    nbytes / S3_MULTIPART_PART_SIZE)
            else:
                self.s3_puts += 1
        if self._parent is not None:
            self._parent.add_s3_put(nbytes)

    def add_s3_list(self):
        with self._lock:
            self.s3_lists += 1
        if self._parent is not None:
            self._parent.add_s3_list()

    def add_s3_delete(self):
        """DELETE requests are free on the price sheet; counted anyway."""
        with self._lock:
            self.s3_deletes += 1
        if self._parent is not None:
            self._parent.add_s3_delete()

    def add_service_fault(self):
        """An injected transient service error (unbilled, counted)."""
        with self._lock:
            self.service_faults += 1
        if self._parent is not None:
            self._parent.add_service_fault()

    def add_lambda_throttle(self):
        """A 429-rejected invocation: no container, no GB-seconds."""
        with self._lock:
            self.lambda_throttles += 1
        if self._parent is not None:
            self._parent.add_lambda_throttle()

    # ------------------------------------------------------------- report
    @property
    def lambda_usd(self) -> float:
        return (self.lambda_gb_seconds * LAMBDA_GB_SECOND
                + self.lambda_requests * LAMBDA_PER_REQUEST)

    @property
    def sqs_usd(self) -> float:
        return self.sqs_requests * SQS_PER_REQUEST

    @property
    def s3_usd(self) -> float:
        return (self.s3_gets * S3_PER_GET
                + (self.s3_puts + self.s3_upload_parts) * S3_PER_PUT
                + self.s3_lists * S3_PER_LIST)

    @property
    def total_usd(self) -> float:
        return self.lambda_usd + self.sqs_usd + self.s3_usd

    def service_subtotals(self) -> dict:
        """Per-service / per-operation USD — the Table-I-style breakdown the
        shuffle benchmark prints per transport."""
        return {
            "lambda": round(self.lambda_usd, 6),
            "sqs": round(self.sqs_usd, 6),
            "s3.GET": round(self.s3_gets * S3_PER_GET, 6),
            "s3.PUT": round(self.s3_puts * S3_PER_PUT, 6),
            "s3.UploadPart": round(self.s3_upload_parts * S3_PER_PUT, 6),
            "s3.LIST": round(self.s3_lists * S3_PER_LIST, 6),
        }

    def report(self) -> dict:
        # snapshot under the lock: concurrent jobs bill from many threads
        # and a torn read here would misreport a live tenant's totals
        with self._lock:
            return self._report_locked()

    def _report_locked(self) -> dict:
        return {
            "lambda_usd": round(self.lambda_usd, 6),
            "sqs_usd": round(self.sqs_usd, 6),
            "s3_usd": round(self.s3_usd, 6),
            "total_usd": round(self.total_usd, 6),
            "lambda_gb_seconds": round(self.lambda_gb_seconds, 3),
            "lambda_requests": self.lambda_requests,
            "sqs_requests": self.sqs_requests,
            "s3_gets": self.s3_gets,
            "s3_puts": self.s3_puts,
            "s3_lists": self.s3_lists,
            "s3_upload_parts": self.s3_upload_parts,
            "s3_deletes": self.s3_deletes,
            "bytes_to_sqs": self.bytes_to_sqs,
            "bytes_from_sqs": self.bytes_from_sqs,
            "bytes_to_s3": self.bytes_to_s3,
            "bytes_from_s3": self.bytes_from_s3,
            "service_faults": self.service_faults,
            "lambda_throttles": self.lambda_throttles,
        }
