"""Cluster baseline backends (paper Table I comparison conditions).

Runs the SAME physical plan as FlintScheduler, but the way a provisioned
Spark cluster would: a persistent pool of long-running workers, direct
in-memory shuffle (no queue service, no per-invocation billing), cost =
wall-clock x per-second cluster price — including idle time.

``pipe_overhead=True`` models the PySpark condition: every record crosses
the JVM<->Python boundary, simulated as a per-record serialize/deserialize
round-trip (the paper attributes PySpark's 1.5-2x slowdown to exactly
this; Flint avoids it by running Python end-to-end).
"""

from __future__ import annotations

import concurrent.futures as cf
import pickle
import time
from collections import defaultdict
from typing import Any

from repro_torch.core.costs import CLUSTER_INSTANCES, CostLedger, cluster_cost
from repro_torch.core.dag import (CacheInput, CollectionInput, ShuffleRead,
                            SourceInput, StagePlan)
from repro_torch.core.executors import (FlintConfig, _apply_ops, _SourceReader,
                                  cache_partition_iter)
from repro_torch.core.queues import ObjectStoreSim
from repro_torch.core.shuffle import iter_records


class ClusterScheduler:
    def __init__(self, cfg: FlintConfig, ledger: CostLedger | None = None,
                 store: ObjectStoreSim | None = None, *,
                 workers: int = 80, pipe_overhead: bool = False):
        self.cfg = cfg
        self.ledger = ledger or CostLedger()
        self.store = store or ObjectStoreSim(self.ledger)
        self.pool = cf.ThreadPoolExecutor(max_workers=workers)
        self.pipe_overhead = pipe_overhead
        self.wall_seconds = 0.0
        self.stage_stats: list[dict] = []

    # ------------------------------------------------------------------
    def run(self, stages: list[StagePlan]):
        t0 = time.monotonic()
        shuffles: dict[int, dict[int, list]] = defaultdict(
            lambda: defaultdict(list))
        result = None
        for stage in stages:
            result = self._run_stage(stage, shuffles)
        self.wall_seconds += time.monotonic() - t0
        return result

    def _records_in(self, task, shuffles):
        inp = task.input
        if isinstance(inp, SourceInput):
            return iter(_SourceReader(inp, self.store, self.cfg, None))
        if isinstance(inp, CollectionInput):
            return iter(self.store.get_obj(f"{inp.key}/{inp.index}"))
        if isinstance(inp, CacheInput):
            return cache_partition_iter(inp, self.store)
        assert isinstance(inp, ShuffleRead)
        if inp.self_join or len(inp.parts) == 2:  # join
            if inp.self_join:
                sl, _ = inp.parts[0]
                sr = sl  # one shared shuffle feeds both sides
            else:
                (sl, _), (sr, _) = inp.parts
            left: dict = defaultdict(list)
            right: dict = defaultdict(list)
            for k, v in shuffles[sl][inp.partition]:
                left[k].append(v)
            for k, v in shuffles[sr][inp.partition]:
                right[k].append(v)
            how = inp.join_how
            pairs = [(k, (lv, rv)) for k in left if k in right
                     for lv in left[k] for rv in right[k]]
            if how in ("left", "outer"):
                pairs += [(k, (lv, None)) for k in left if k not in right
                          for lv in left[k]]
            if how in ("right", "outer"):
                pairs += [(k, (None, rv)) for k in right if k not in left
                          for rv in right[k]]
            return iter(pairs)
        sid, mode = inp.parts[0]
        records = shuffles[sid][inp.partition]
        if mode == "agg":
            agg: dict = {}
            fn = inp.combine_fn
            for k, v in records:
                agg[k] = fn(agg[k], v) if k in agg else v
            return iter(agg.items())
        if mode == "group":
            g: dict = defaultdict(list)
            for k, v in records:
                g[k].append(v)
            return iter(g.items())
        return iter(records)

    def _run_stage(self, stage: StagePlan, shuffles) -> Any:
        t0 = time.monotonic()

        def run_task(task):
            it = self._records_in(task, shuffles)
            if self.pipe_overhead:  # JVM -> Python pipe: serde per record
                it = (pickle.loads(pickle.dumps(r)) for r in it)
            it = _apply_ops(it, [(k, fn) for k, fn in task.ops], self.store)
            # fused vectorized ops may yield KVBatch column carriers; this
            # backend's write loops iterate row-at-a-time
            it = iter_records(it)
            if stage.write is not None:
                w = stage.write
                out: dict[int, list] = defaultdict(list)
                if w.mode == "repart":
                    if w.partition_fn is not None:
                        for rec in it:
                            out[w.partition_fn(rec) % w.nparts].append(rec)
                    else:
                        for i, rec in enumerate(it):
                            out[i % w.nparts].append(rec)
                elif w.mode == "agg" and w.combine_fn is not None:
                    combined: dict = {}
                    for k, v in it:
                        combined[k] = (w.combine_fn(combined[k], v)
                                       if k in combined else v)
                    for k, v in combined.items():
                        out[hash(k) % w.nparts].append((k, v))
                else:
                    for k, v in it:
                        out[hash(k) % w.nparts].append((k, v))
                return ("shuffle", w.shuffle_id, out)
            result = list(it)
            if stage.save_prefix:
                key = f"{stage.save_prefix}/part-{task.index:05d}"
                self.store.put(key, "\n".join(str(r) for r in result).encode())
                return ("saved", key, None)
            return ("result", task.index, result)

        outs = list(self.pool.map(run_task, stage.tasks))
        self.stage_stats.append({"stage": stage.id, "tasks": len(stage.tasks),
                                 "wall_s": round(time.monotonic() - t0, 4)})
        partials: dict[int, list] = {}
        for kind, a, b in outs:
            if kind == "shuffle":
                for p, recs in b.items():
                    shuffles[a][p].extend(recs)
            elif kind == "result":
                partials[a] = b
        if stage.action in ("collect", "sum"):
            out: list = []
            for i in range(len(stage.tasks)):
                out.extend(partials.get(i, []))
                if stage.limit is not None and len(out) >= stage.limit:
                    return out[:stage.limit]  # take(n) merge short-circuit
            return sum(out) if stage.action == "sum" else out
        if stage.action == "save":
            return [f"{stage.save_prefix}/part-{i:05d}"
                    for i in range(len(stage.tasks))]
        return None

    def cost_usd(self, wall_seconds: float | None = None) -> float:
        return cluster_cost(wall_seconds if wall_seconds is not None
                            else self.wall_seconds, CLUSTER_INSTANCES)

    def shutdown(self):
        self.pool.shutdown(wait=False)
