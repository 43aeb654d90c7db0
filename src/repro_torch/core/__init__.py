"""Flint core — serverless analytics engine (the paper's contribution).

Public API mirrors the PySpark surface the paper targets, on BOTH the RDD
and the structured DataFrame surfaces:

    from repro_torch.core import FlintContext
    ctx = FlintContext()                      # serverless backend
    ctx.upload("taxi.csv", data_bytes)        # stand-in for S3
    arr = (ctx.textFile("taxi.csv", 32)
              .map(lambda x: x.split(','))
              .filter(lambda x: inside(x, goldman))
              .map(lambda x: (get_hour(x[2]), 1))
              .reduceByKey(lambda a, b: a + b, 30)
              .collect())
    print(ctx.cost_report())                  # pure pay-as-you-go USD

    from repro_torch.sql import Schema, col, lit, sum_, count_
    df = ctx.read_csv("taxi.csv", Schema([("pickup", "str"), ...]), 32)
    rows = (df.where(col("payment_type") == lit("credit"))
              .withColumn("hour", col("pickup").substr(12, 2))
              .groupBy("hour")
              .agg(sum_(col("tip")).alias("tips"), count_().alias("n"))
              .collect())
    print(df.explain())                       # optimized logical plan

The DataFrame surface (docs/dataframe.md) carries schemas through a
logical plan, optimizes it (projection pruning, predicate/limit pushdown,
map-side-combine selection, cost-model transport choice), and lowers onto
the same RDD lineage — scheduler, EOS shuffle, transports, CSE and
cache() all apply unchanged.

Backends: "flint" (Lambda+SQS simulation, pay-per-use), "cluster"
(provisioned Spark, per-second billing), "pyspark" (cluster + the
JVM<->Python record pipe overhead).
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.costs import CostLedger, cluster_cost
from repro_torch.core.dag import build_plan
from repro_torch.core.executors import FlintConfig
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.queues import ObjectStoreSim
from repro_torch.core.rdd import RDD, ParallelCollection, Source
from repro_torch.core.cluster import ClusterScheduler
from repro_torch.core.scheduler import FlintScheduler, StageFailure


class FlintContext:
    def __init__(self, backend: str = "flint",
                 config: FlintConfig | None = None, *,
                 fault_plan: FaultPlan | dict | None = None,
                 elastic_retries: int = 2,
                 store: ObjectStoreSim | None = None,
                 ledger: CostLedger | None = None,
                 cache_index=None,
                 verbose: bool = False):
        self.config = config or FlintConfig()
        self.config.validate()  # reject incoherent resilience knobs early
        self.backend_name = backend
        self.ledger = ledger if ledger is not None else CostLedger()
        self.store = store or ObjectStoreSim(self.ledger)
        self.fault_plan = fault_plan or {}
        self.elastic_retries = elastic_retries
        self.verbose = verbose
        self.partition_multiplier = 1
        self.last_scheduler = None
        self._collection_counter = 0
        # RDD.cache() registry: lineage token -> {"nparts", "ready"}.
        # Owned by the context (caches span actions/schedulers); the
        # job-scoped GC keeps only keys registered here. The multi-tenant
        # service substitutes its byte-capped SharedCache (repro_torch.svc) —
        # same mapping protocol, shared across every session
        self._cache_index = (cache_index if cache_index is not None
                             else {})

    # -------------------------------------------------------------- data
    def upload(self, key: str, data: bytes):
        self.store.put(key, data)

    def textFile(self, key: str, numPartitions: int = 8) -> RDD:
        return Source(self, key, numPartitions)

    def read_csv(self, key: str, schema, numPartitions: int = 8):
        """Structured entry point: a DataFrame over a CSV object in the
        store, with a declared schema (repro_torch.sql.Schema or a list of
        (name, dtype) pairs) — see docs/dataframe.md."""
        from repro_torch.sql import DataFrame  # lazy: sql imports core
        return DataFrame.from_csv(self, key, schema, numPartitions)

    def parallelize(self, data: list, numPartitions: int = 8) -> RDD:
        key = f"_collections/{self._collection_counter}"
        self._collection_counter += 1
        n = len(data)
        step = max(1, -(-n // numPartitions))
        parts = [data[i * step:(i + 1) * step] for i in range(numPartitions)]
        while len(parts) < numPartitions:
            parts.append([])
        for i, p in enumerate(parts):
            self.store.put_obj(f"{key}/{i}", p)
        return ParallelCollection(self, key, numPartitions)

    # --------------------------------------------------------- execution
    def _make_scheduler(self):
        if self.backend_name == "flint":
            return FlintScheduler(self.config, self.ledger, self.store,
                                  fault_plan=self.fault_plan,
                                  verbose=self.verbose,
                                  cache_index=self._cache_index)
        if self.backend_name == "cluster":
            return ClusterScheduler(self.config, self.ledger, self.store)
        if self.backend_name == "pyspark":
            return ClusterScheduler(self.config, self.ledger, self.store,
                                    pipe_overhead=True)
        raise ValueError(f"unknown backend {self.backend_name!r}")

    def run_action(self, rdd: RDD, action: str,
                   save_prefix: str | None = None,
                   limit: int | None = None) -> Any:
        mult = self.partition_multiplier
        elastic_left = self.elastic_retries
        # lost durable cache data is recovered by replanning the cached
        # lineage from source — bounded like any stage resubmission
        cache_replans_left = self.config.max_stage_retries
        while True:
            plan = self._build_plan(rdd, action, save_prefix, mult, limit)
            sched = self._make_scheduler()
            self.last_scheduler = sched
            try:
                result = sched.run(plan)
                # materializations this action teed to _cache/ are now
                # durable and complete — later actions may plan from them
                self._mark_caches_ready(plan)
                return result
            except StageFailure as e:
                # a failed materializing action must not pin its partial
                # _cache/ batches: drop the still-pending registrations so
                # the job GC (scheduler shutdown, below) sweeps them; an
                # elastic retry re-registers on the re-plan
                self._unregister_pending_caches(plan)
                if (e.error_type == "MemoryCapExceeded"
                        and elastic_left > 0):
                    # the paper's elasticity move: more partitions, re-run
                    elastic_left -= 1
                    mult *= 2
                    self.partition_multiplier = mult
                    if self.verbose:
                        print(f"[flint] memory cap hit -> partitions x{mult}")
                    continue
                if (e.error_type == "LostCacheInput"
                        and cache_replans_left > 0):
                    # an acknowledged _cache/ batch vanished: retrying the
                    # reading task cannot recreate durable data, so drop
                    # the damaged materialization and replan — the next
                    # plan rebuilds the cached lineage from source and
                    # re-materializes it (docs/fault_tolerance.md)
                    cache_replans_left -= 1
                    token = (e.detail or {}).get("token", "")
                    self._cache_index.pop(token, None)
                    self.store.delete_prefix(f"_cache/{token}/")
                    if self.verbose:
                        print(f"[flint] cache {token or '?'} lost -> "
                              f"replanning from source")
                    continue
                raise
            finally:
                sched.shutdown()

    def _build_plan(self, rdd, action, save_prefix, mult, limit):
        """Planning hook: the service session overrides this to thread
        its cross-job share-registry view into the planner."""
        return build_plan(rdd, action, save_prefix,
                          partition_multiplier=mult,
                          cse=self.config.plan_cse,
                          cache_index=self._cache_index,
                          default_transport=self.config.shuffle_backend,
                          limit=limit)

    def _plan_cache_tokens(self, plan):
        return {arg[0] for stage in plan for task in stage.tasks
                for kind, arg in task.ops if kind == "cache"}

    def _mark_caches_ready(self, plan):
        committed = getattr(self._cache_index, "committed", None)
        for token in self._plan_cache_tokens(plan):
            entry = self._cache_index.get(token)
            if entry is not None:
                entry["ready"] = True
                if committed is not None:
                    # byte-capped shared cache (repro_torch.svc): size the new
                    # materialization and evict LRU entries over the cap
                    committed(token)

    def _unregister_pending_caches(self, plan):
        for token in self._plan_cache_tokens(plan):
            entry = self._cache_index.get(token)
            if entry is not None and not entry.get("ready"):
                del self._cache_index[token]

    def clear_cache(self) -> int:
        """Drop every RDD.cache() materialization (billed free DELETEs);
        returns the number of keys removed. A byte-capped shared index
        (repro_torch.svc.SharedCache) clears through its own ``drop_all`` so
        entries pinned by running jobs survive."""
        drop_all = getattr(self._cache_index, "drop_all", None)
        if drop_all is not None:
            return drop_all()
        self._cache_index.clear()
        return self.store.delete_prefix("_cache/")

    def uncache(self, token: str) -> int:
        """Drop ONE cached lineage's materialization by token (see
        ``RDD.uncache``); returns the number of keys removed. No-op on
        an unknown or already-dropped token."""
        drop = getattr(self._cache_index, "drop", None)
        if drop is not None:
            return drop(token)
        if self._cache_index.pop(token, None) is None:
            return 0
        return self.store.delete_prefix(f"_cache/{token}/")

    # ------------------------------------------------------------- costs
    def cost_report(self) -> dict:
        rep = self.ledger.report()
        if self.backend_name in ("cluster", "pyspark") and self.last_scheduler:
            wall = getattr(self.last_scheduler, "wall_seconds", 0.0)
            rep["cluster_usd"] = round(cluster_cost(wall), 6)
            rep["total_usd"] = rep["cluster_usd"]
        return rep


__all__ = ["FlintContext", "FlintConfig", "FlintScheduler", "ClusterScheduler",
           "CostLedger", "StageFailure", "FaultPlan", "FaultInjector",
           "build_plan"]
