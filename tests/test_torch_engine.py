"""The port's Flint engine against the JAX package's, on the CPU.

The port keeps its own copy of the engine (``repro_torch.core``,
``repro_torch.sql``, ``repro_torch.data.synthetic``). Its one new route
sends the vectorized engine's int64 group sums through the bucket_reduce
kernel (``vector_backend="torch"``); here ``vector_device="cpu"`` runs
the kernel's plain version. The same inputs, drawn from fixed seeds, go
through both engines, which must agree bit for bit and leave nothing
behind.
"""

import pathlib
import random
import re

import numpy as np
import pytest

from benchmarks.shuffle_backends import SQL_WORKLOADS, TAXI_SCHEMA
from benchmarks.table1_queries import q1
from repro.core import FlintConfig as RefConfig
from repro.core import FlintContext as RefContext
from repro.data import synthetic as ref_synthetic
from repro.sql import vectorized as RV
from repro_torch.core import FlintConfig, FlintContext
from repro_torch.data import synthetic
from repro_torch.kernels import ops as tops
from repro_torch.kernels._build import KernelError
from repro_torch.sql import Schema, col, count_, lit, sum_
from repro_torch.sql import vectorized as V

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRANSIENT_PREFIXES = ("_spill/", "_payload/", "_exchange/", "_result/",
                      "_broadcast/", "_stream/")

# ------------------------------------------------- (a) the grouped fold

_FLOAT_POOL = [0.0, -0.0, 1.5, -2.25, 1e300, -1e300, 1e-300,
               float("nan"), float("inf"), float("-inf"), 2.0**53]
_STR_POOL = ["", "a", "credit", "cash", "é世界", "2015-01-02 03:04:00",
             "x" * 40, "\t", "naïve"]


def _same(a, b):
    """Bit-exact scalar equality: same concrete type; floats compared by
    repr (distinguishes -0.0 from 0.0 and matches NaN to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return repr(a) == repr(b)
    return a == b


def _fold_case(seed):
    """The case mix of tests/test_vectorized.py::
    test_grouped_fold_matches_row_fold (ints, 2**61/2**62 bigints, NaN and
    -0.0 floats, str min/max, empty batches), plus ints large enough for
    grouped_reduce's int64 envelope."""
    rng = random.Random(seed)
    n = rng.choice([0, 1, 5, 40, 300])
    keys = [(rng.randint(0, 4), rng.choice(["a", "b", "é"])) for _ in range(n)]
    ops_, cols = [], []
    for _ in range(rng.randint(1, 3)):
        kind = rng.choice(["int", "mid", "bigint", "float", "str"])
        if kind == "str":
            ops_.append(rng.choice(["min", "max"]))
            cols.append([rng.choice(_STR_POOL) for _ in range(n)])
            continue
        ops_.append(rng.choice(["sum", "sum", "min", "max"]))
        if kind == "int":
            cols.append(np.array([rng.randint(-1000, 1000) for _ in range(n)], np.int64))
        elif kind == "mid":
            cols.append(np.array([rng.randint(-2**40, 2**40) for _ in range(n)], np.int64))
        elif kind == "bigint":
            cols.append(np.array([rng.choice([2**61, -2**61, 2**62, 5]) for _ in range(n)],
                                 np.int64))
        else:
            cols.append(np.array([rng.choice(_FLOAT_POOL) for _ in range(n)], np.float64))
    kcols = [np.array([k[0] for k in keys], np.int64), [k[1] for k in keys]]
    return kcols, cols, ops_, n


def _grouped(mod, backend, kcols, cols, ops_, n, **kw):
    try:
        with np.errstate(divide="raise", invalid="raise", over="ignore", under="ignore"):
            return mod.grouped_records(kcols, [c.copy() if isinstance(c, np.ndarray)
                                               else list(c) for c in cols],
                                       ops_, n, backend, **kw)
    except FloatingPointError as e:  # inf/-inf collisions: the fused op re-runs row-wise
        return ("FloatingPointError", str(e))


@pytest.mark.parametrize("seed", range(40))
def test_torch_fold_bit_identical_to_reference_numpy_fold(seed):
    kcols, cols, ops_, n = _fold_case(seed)
    exp = _grouped(RV, "numpy", kcols, cols, ops_, n)
    got = _grouped(V, "torch", kcols, cols, ops_, n, device="cpu")
    if isinstance(exp, tuple):
        assert got == exp
        return
    assert [k for k, _ in got] == [k for k, _ in exp]
    for (_, a), (_, b) in zip(got, exp):
        assert len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b)), (ops_, a, b)


def test_torch_fold_routes_int_sums_through_grouped_reduce():
    """Every int64 sum slot within the envelope is folded by
    grouped_reduce (one call per slot), float sums and min/max are not,
    and a sum past 2**62 is left to the exact Python fold."""
    gids_col = np.array([3, 1, 3, 2, 1], np.int64)
    before = tops.grouped_reduce.folds
    out = V.grouped_records(
        [gids_col],
        [np.array([5, 6, 7, 8, 9], np.int64), np.array([2**40, 1, 2, 3, 4], np.int64),
         np.array([2**62, 2**62, 1, 1, 1], np.int64), np.array([0.5, -0.0, 1.0, 2.0, 3.0]),
         np.array([4, 3, 2, 1, 0], np.int64)],
        ["sum", "sum", "sum", "sum", "min"], 5, "torch", device="cpu")
    assert tops.grouped_reduce.folds == before + 2
    assert out == [((3,), (12, 2**40 + 2, 2**62 + 1, 1.5, 2)),
                   ((1,), (15, 5, 2**62 + 1, 3.0, 0)),
                   ((2,), (8, 3, 1, 2.0, 1))]


# ------------------------------------------------------ (b) the engine


def _port_queries():
    """The two SQL taxi queries of benchmarks/shuffle_backends.py, written
    against the port's DataFrame API."""
    schema = Schema(list(TAXI_SCHEMA.fields))

    def sql_filter_groupby(ctx):
        df = ctx.read_csv("taxi.csv", schema, 8)
        return (df.where(col("payment_type") == lit("credit"))
                  .withColumn("hour", col("pickup").substr(12, 2))
                  .withColumn("tip_cents", (col("tip") * lit(100.0)).cast("int"))
                  .groupBy("hour")
                  .agg(sum_(col("tip_cents")).alias("tips"), count_().alias("n"))
                  .collect())

    def sql_join_agg(ctx):
        df = ctx.read_csv("taxi.csv", schema, 8)
        hour = col("pickup").substr(12, 2)
        trips = df.withColumn("hour", hour).groupBy("hour").agg(count_().alias("trips"))
        tips = (df.where(col("payment_type") == lit("credit"))
                  .withColumn("hour", hour)
                  .withColumn("tip_cents", (col("tip") * lit(100.0)).cast("int"))
                  .groupBy("hour").agg(sum_(col("tip_cents")).alias("tips")))
        return trips.join(tips, on="hour").collect()

    return {"sql_filter_groupby": sql_filter_groupby, "sql_join_agg": sql_join_agg}


def _assert_no_leaks(ctx):
    leaked = [k for prefix in TRANSIENT_PREFIXES for k in ctx.store.list(prefix)]
    assert not leaked, leaked[:5]
    assert ctx.last_scheduler.sqs._queues == {}, "queues leaked"


_DATA = {}


def _taxi(rows):
    if rows not in _DATA:
        _DATA[rows] = synthetic.taxi_csv(rows, seed=13)
    return _DATA[rows]


def _run(context, config, query, rows=4000):
    ctx = context("flint", config)
    ctx.upload("taxi.csv", _taxi(rows))
    ans = sorted(query(ctx))
    _assert_no_leaks(ctx)
    return ans


@pytest.mark.parametrize("transport", ["sqs", "s3"])
@pytest.mark.parametrize("query", list(SQL_WORKLOADS))
def test_sql_taxi_query_matches_reference_engine(query, transport):
    kw = dict(concurrency=16, flush_records=2000, shuffle_backend=transport)
    exp = _run(RefContext, RefConfig(**kw), SQL_WORKLOADS[query])
    before = tops.grouped_reduce.folds
    got = _run(FlintContext, FlintConfig(vector_backend="torch", vector_device="cpu", **kw),
               _port_queries()[query])
    assert tops.grouped_reduce.folds > before  # the int-sum folds took the torch route
    assert got == exp and len(got) == 24


def test_table1_q1_rdd_matches_reference_engine():
    kw = dict(concurrency=16, flush_records=2000, shuffle_backend="sqs")
    exp = _run(RefContext, RefConfig(**kw), q1, rows=20_000)
    got = _run(FlintContext, FlintConfig(vector_device="cpu", **kw), q1, rows=20_000)
    assert got == exp and sum(n for _, n in got) > 0


# --------------------------------------------- (c) no fallback that hides


def test_kernel_error_propagates_out_of_a_query(monkeypatch):
    """A kernel that fails to build or launch ends the query; the fused
    operator does not rerun the chunk on the row path."""
    def broken(*_a, **_k):
        raise KernelError("bucket_reduce kernel launch failed: test")

    monkeypatch.setattr(tops, "grouped_reduce", broken)
    cfg = FlintConfig(concurrency=4, flush_records=2000, shuffle_backend="sqs",
                      vector_backend="torch", vector_device="cpu")
    with pytest.raises(KernelError, match="test"):
        _run(FlintContext, cfg, _port_queries()["sql_filter_groupby"], rows=500)


def test_device_faults_propagate_out_of_a_query(monkeypatch):
    """A plain RuntimeError from the kernel's wrapper (a fault while the
    kernel runs, or an out-of-memory error) ends the query as KernelError;
    it is not taken for a chunk the row path should rerun."""
    def fault(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tops, "bucket_reduce", fault)
    cfg = FlintConfig(concurrency=4, flush_records=2000, shuffle_backend="sqs",
                      vector_backend="torch", vector_device="cpu")
    with pytest.raises(KernelError, match="illegal memory access"):
        _run(FlintContext, cfg, _port_queries()["sql_filter_groupby"], rows=500)


def test_other_fold_errors_still_rerun_on_the_row_path(monkeypatch):
    """An exception from a vectorized chunk that is not a kernel's (here
    the count slot's host fold, np.bincount) keeps the reference's
    behaviour: the chunk reruns through the row closures, same answer."""
    exp = _run(FlintContext, FlintConfig(vector_backend="numpy", concurrency=4),
               _port_queries()["sql_filter_groupby"], rows=500)
    calls = []

    def broken(*_a, **_k):
        calls.append(1)
        raise ValueError("not a kernel fault")

    monkeypatch.setattr(np, "bincount", broken)
    got = _run(FlintContext, FlintConfig(vector_backend="torch", vector_device="cpu",
                                         concurrency=4),
               _port_queries()["sql_filter_groupby"], rows=500)
    assert calls and got == exp


def test_config_backends():
    with pytest.raises(ValueError, match="'numpy' or 'torch'"):
        FlintConfig(vector_backend="jax").validate()
    FlintConfig(vector_backend="numpy").validate()  # no device needed
    FlintConfig(vectorize=False).validate()
    FlintConfig(vector_device="cpu").validate()
    assert FlintConfig().vector_device == "cuda"


# ------------------------------------------------------------ (d) data


@pytest.mark.parametrize("rows,seed", [(0, 0), (1, 3), (1000, 13), (5000, 7)])
def test_taxi_csv_bytes_identical(rows, seed):
    assert synthetic.taxi_csv(rows, seed) == ref_synthetic.taxi_csv(rows, seed)
    assert (synthetic.GOLDMAN, synthetic.CITIGROUP) == (ref_synthetic.GOLDMAN,
                                                        ref_synthetic.CITIGROUP)


# ------------------------------------------- (e) the copies cannot drift

#: modules copied from src/repro/ with only ``repro.`` renamed; the
#: port's executors.py, sql/vectorized.py and sql/lower.py carry the
#: torch route and are held by the tests above instead
COPIED = ["core/__init__.py", "core/costs.py", "core/retry.py", "core/faults.py",
          "core/serde.py", "core/queues.py", "core/rdd.py", "core/dag.py",
          "core/scheduler.py", "core/cluster.py", "core/shuffle/__init__.py",
          "core/shuffle/base.py", "core/shuffle/batch.py", "core/shuffle/sqs.py",
          "core/shuffle/s3.py", "sql/__init__.py", "sql/expr.py", "sql/plan.py",
          "sql/optimizer.py", "sql/dataframe.py", "data/synthetic.py"]


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_reference(module):
    ref = (ROOT / "src" / "repro" / module).read_text()
    port = (ROOT / "src" / "repro_torch" / module).read_text()
    assert port == re.sub(r"\brepro\.", "repro_torch.", ref)


def test_every_copied_module_is_listed():
    port = ROOT / "src" / "repro_torch"
    held = {"core/executors.py", "sql/vectorized.py", "sql/lower.py"}
    found = {str(p.relative_to(port)) for d in ("core", "sql") for p in (port / d).rglob("*.py")}
    assert found == (set(COPIED) - {"data/synthetic.py"}) | held
