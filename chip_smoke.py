#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. Device and card: a CUDA device of capability (9, 0); prints its name and
   power limit as nvidia-smi reports them.
2. Build: compiles both kernels from src/repro_torch/kernels/csrc/ for
   sm_90a, one nvcc per source, started together, and prints what ptxas
   reports for each.
3. Flash attention against plain: the kernel against its plain PyTorch
   version (repro_torch.kernels.ref) on the five shapes of the JAX
   package's flash-attention sweep plus yi-9b's prefill shape, in f32
   (2e-5) and bf16 (2e-2); per shape the kernel's, the plain version's and
   one PyTorch call's (scaled_dot_product_attention, a yardstick the port
   never calls) times, and the least time the card could take.
4. bucket_reduce against plain: the kernel against bucket_reduce_ref on
   the JAX package's bucket_reduce sweep (n <= 700, p in {4, 16, 33},
   d in {8, 64}, ids of -1 and out of range) in f32 and bf16, on the
   engine's shape (8192 rows, d 1, 24 buckets) in f32 and int64, and on a
   large shape (4,194,304 x 64 values, 4096 buckets, f32); two launches
   must give the same bits. Per shape the kernel's, the plain version's
   and one index_add_'s times (a yardstick the port never calls), and the
   least time the card could take.
5. Serve: yi-9b at full width (48 layers, d_model 4096, bf16), weights
   drawn from a seeded generator on the card, batch 8, prompt 512, 32 new
   tokens, greedy, through repro_torch.models.lm.generate. The kernel's
   launch count must rise by exactly 48 (one per layer, all in prefill),
   two runs must give the same tokens, and a step-by-step replay must give
   finite logits whose greedy picks are those tokens; a reduced yi-9b in
   f32 checks the kernel path against the plain path. A profiler trace of
   one prefill and three decode steps shows where the time goes.
6. Engine: the port's Flint engine runs two taxi SQL queries (filter and
   groupBy; two aggregations and a join) over 2,000,000 rows of
   repro_torch.data.synthetic.taxi_csv in 8 partitions, once with
   vector_backend="torch" on the card and once with "numpy". Results must
   be identical, no transient key or queue may be left, and
   bucket_reduce's launch count must rise by exactly the number of
   grouped_reduce calls that returned an array (more than 0). A profiler
   trace of one torch-route query gives the device's busy time.
7. Prints the kernels line, then the device line last.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and FLOP/s by type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# (b, h, kv heads, sq, skv, d, causal, window): tests/test_kernels.py's
# flash-attention sweep, then yi-9b's prefill (the serve phase's shape)
SWEEP = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 2, 2, 256, 256, 32, True, 64),
    (2, 4, 4, 128, 128, 16, False, 0),
    (1, 8, 2, 128, 384, 64, True, 0),
    (1, 2, 1, 64, 64, 128, True, 0),
]
YI_PREFILL = (8, 32, 4, 512, 512, 128, True, 0)
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}
BATCH, PROMPT, NEW_TOKENS = 8, 512, 32

# bucket_reduce (n, p, d): shapes of tests/test_kernels.py's bucket_reduce
# property (n <= 700, p in {4, 16, 33}, d in {8, 64}); the engine's shape
# (a full column batch of vector_batch_rows rows, 24 hour groups); a large
# shape (1 GB of f32 values) where the card does real work
BR_SWEEP = [(1, 4, 8), (37, 16, 64), (255, 33, 8), (256, 4, 64), (513, 16, 8),
            (700, 33, 64), (699, 4, 8), (128, 33, 64)]
BR_ENGINE = (8192, 24, 1)
BR_LARGE = (4_194_304, 4096, 64)
# |kernel - plain|: f32 within 1e-4 of the plain function evaluated in f64
# (the JAX package's sweep holds its kernel to 1e-4); bf16 output rounds
# once from f32 sums taken in another order (two bf16 ulps); integer-valued
# f32 below 2**24 and int64 are exact
BR_TOLS = {"float32": (1e-4, 0.0), "bfloat16": (1e-2, 2.0**-6), "exact": (0.0, 0.0)}

ENGINE_ROWS, ENGINE_PARTS = 2_000_000, 8


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(case, dtype_name: str, itemsize: int):
    """Least time (ms) the card could take for one call, and what bounds it:
    each input read once and the output written once, against the FLOPs the
    visible (query, key) pairs of this mask need (2*D for the scores and
    2*D for the weighted sum, per pair)."""
    import torch
    b, h, kk, sq, skv, d, causal, window = case
    qpos = torch.arange(sq) + (skv - sq)
    delta = qpos[:, None] - torch.arange(skv)[None, :]
    ok = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        ok &= delta >= 0
    if window:
        ok &= delta < window
    flops = 4.0 * d * int(ok.sum()) * b * h
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * skv * kk * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel(case, dtype, fa, ref):
    """Kernel against the plain version on one shape and dtype; returns the
    row of numbers for it."""
    import torch
    import torch.nn.functional as F
    b, h, kk, sq, skv, d, causal, window = case
    name = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(sum(case[:6]))
    q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, skv, kk, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, skv, kk, d), generator=gen, device="cuda").to(dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return fa.flash_attention_bhsd(qt, kt, vt, causal=causal, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)

    out = kernel().transpose(1, 2)
    torch.cuda.synchronize()
    exp = plain()
    torch.cuda.synchronize()
    tol = TOLS[name]
    err = float((out.float() - exp.float()).abs().max())
    if not torch.allclose(out.float(), exp.float(), atol=tol, rtol=tol):
        fail(f"flash attention {case} {name}: max |kernel - plain| = {err} > {tol}")

    # the yardstick: one PyTorch call for the same function (bottom-right
    # aligned causal and window masks, GQA); timed only, never used
    qpos = torch.arange(sq, device="cuda") + (skv - sq)
    delta = qpos[:, None] - torch.arange(skv, device="cuda")[None, :]
    mask = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        mask &= delta >= 0
    if window:
        mask &= delta < window
    plain_causal = causal and sq == skv and not window
    kw = {"is_causal": True} if plain_causal else {"attn_mask": mask}

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=kk != h, **kw)

    t_kernel = time_ms(kernel)
    t_plain = time_ms(plain, iters=5)
    t_lib = time_ms(library)
    bound, bound_by = attention_bound(case, name, q.element_size())
    row = {"case": list(case), "dtype": name, "max_abs_err": err, "tol": tol,
           "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": bound, "bound_by": bound_by}
    print("  " + json.dumps(row), flush=True)
    return row


def bucket_inputs(n, p, d, dtype, gen):
    """Values and int32 ids on the card: about 1 % of the ids are -1
    (padding) and 1 % lie past the last bucket; they must add nothing.
    Integer dtypes and the engine shape draw integer values, as the engine
    folds; the int64 values are large enough to need the int64 envelope."""
    import torch
    ids = torch.randint(0, p, (n,), generator=gen, device="cuda", dtype=torch.int32)
    u = torch.rand((n,), generator=gen, device="cuda")
    ids = torch.where(u < 0.01, -1, torch.where(u < 0.02, p + 3, ids)).to(torch.int32)
    if dtype == torch.int64:
        vals = torch.randint(-2**40, 2**40, (n, d), generator=gen, device="cuda")
    elif (n, p, d) == BR_ENGINE:
        vals = torch.randint(0, 1000, (n, d), generator=gen, device="cuda").to(dtype)
    else:
        vals = torch.randn((n, d), generator=gen, device="cuda").to(dtype)
    return vals, ids


def bucket_bound(n, p, d, itemsize):
    """Least time (ms) for one call: each value and id read once and each
    sum written once, against N*D additions at the f32 CUDA-core rate."""
    t_bytes = (n * d * itemsize + 4 * n + p * d * itemsize) / HBM_BYTES_S
    t_ops = n * d / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_bucket_reduce(shape, dtype, br, ref):
    """bucket_reduce's kernel against its plain version on one shape and
    dtype: agreement within the stated tolerance, total mass of the
    in-range rows preserved, and two launches bit-identical. Returns the
    row of numbers for it."""
    import torch
    n, p, d = shape
    name = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(n * 131 + p * 7 + d)
    vals, ids = bucket_inputs(n, p, d, dtype, gen)
    exact = dtype == torch.int64 or shape == BR_ENGINE
    atol, rtol = BR_TOLS["exact" if exact else name]

    def kernel():
        return br.bucket_reduce(vals, ids, p)

    def plain():
        return ref.bucket_reduce_ref(vals, ids, p)

    out, out2 = kernel(), kernel()
    torch.cuda.synchronize()
    exp = plain()
    torch.cuda.synchronize()
    if out.dtype != dtype or out.shape != (p, d):
        fail(f"bucket_reduce {shape} {name}: got {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out, out2):
        fail(f"bucket_reduce {shape} {name}: two launches differ")
    extra = {}
    if exact:
        err = float((out - exp).abs().max())
        ok = torch.equal(out, exp)
    elif dtype == torch.float32:
        # the f32 plain version on the card sums with atomics, in an order
        # that changes from run to run; over ~1000 rows a bucket its own
        # rounding error passes 1e-4. So the kernel is held to the same
        # sums taken in f64 on the same inputs, and both f32 results'
        # distances from them are printed, with the distance between two
        # runs of the plain version. The f64 sums are taken here and not by
        # the plain version on f64 values: it accumulates any float input
        # in f32, so its f64 output is one more f32 sum with atomics; the
        # kernel's distance from that is printed too.
        keep = (ids >= 0) & (ids < p)
        exp64 = torch.zeros((p, d), dtype=torch.float64, device="cuda").index_add_(
            0, ids[keep].long(), vals[keep].double())
        err = float((out.double() - exp64).abs().max())
        ok = err <= atol
        again = plain()
        via_plain = ref.bucket_reduce_ref(vals.double(), ids, p)
        extra = {"max_abs_err_vs_f32_plain": float((out - exp).abs().max()),
                 "f32_plain_max_abs_err": float((exp.double() - exp64).abs().max()),
                 "f32_plain_rerun_max_abs_diff": float((exp - again).abs().max()),
                 "max_abs_err_vs_plain_on_f64_input": float(
                     (out.double() - via_plain).abs().max())}
    else:
        diff = (out.double() - exp.double()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * exp.double().abs()).all())
    if not ok:
        fail(f"bucket_reduce {shape} {name}: max |kernel - plain| = {err} "
             f"> atol {atol} + rtol {rtol} {extra}")
    keep = (ids >= 0) & (ids < p)
    if dtype == torch.float32 and shape in BR_SWEEP:
        # as the JAX package's property: nothing lost in the shuffle
        mass = float((out.sum(0) - vals[keep].sum(0)).abs().max())
        if mass > 1e-3:
            fail(f"bucket_reduce {shape} {name}: mass not preserved ({mass})")
    # the yardstick: one index_add_ on the in-range rows, masked outside
    # the timed call; timed only, never used by the port
    lib_vals, lib_ids = vals[keep].contiguous(), ids[keep].long()
    acc = torch.int64 if dtype == torch.int64 else dtype

    def library():
        return torch.zeros((p, d), dtype=acc, device="cuda").index_add_(0, lib_ids, lib_vals)

    big = n * d >= 2**20
    t_kernel = time_ms(kernel, iters=20 if big else 100)
    t_plain = time_ms(plain, iters=5 if big else 20)
    t_lib = time_ms(library, iters=20 if big else 100)
    bound, bound_by = bucket_bound(n, p, d, vals.element_size())
    row = {"shape": [n, p, d], "dtype": name, "max_abs_err": err, "atol": atol,
           "rtol": rtol, "bit_identical": True, "ms": t_kernel, "plain_ms": t_plain,
           "library_ms": t_lib, "bound_ms": bound, "bound_by": bound_by, **extra}
    print("  " + json.dumps(row), flush=True)
    return row


def time_grouped_reduce(card):
    """Host wall time of one engine fold, uncontended: grouped_reduce on
    numpy inputs of the engine's shape (both envelopes), copies to and
    from the card included, against the numpy fold it replaces."""
    import numpy as np
    from repro_torch.kernels import ops
    n, p, _ = BR_ENGINE
    rng = np.random.default_rng(0)
    ids = rng.integers(0, p, n)
    for label, vals in (("f32 envelope", rng.integers(0, 2000, n)),
                        ("int64 envelope", rng.integers(-2**40, 2**40, n))):
        exp = np.zeros(p, np.int64)
        np.add.at(exp, ids, vals)
        got = ops.grouped_reduce(vals, ids, p)
        if got is None or not np.array_equal(got, exp):
            fail(f"grouped_reduce {label} at the engine shape disagrees with np.add.at")
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            ops.grouped_reduce(vals, ids, p)
        t_call = (time.perf_counter() - t0) * 1e3 / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            acc = np.zeros(p, np.int64)
            np.add.at(acc, ids, vals)
        t_np = (time.perf_counter() - t0) * 1e3 / reps
        print(f"  grouped_reduce {label}, {n} rows, {p} groups, one thread, on {card}: "
              f"{t_call:.4f} ms a call with copies; numpy fold {t_np:.4f} ms", flush=True)


def main():
    # ---------------------------------------------------------- 1. card
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"device capability {cap}, need (9, 0) (Hopper)")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"src/repro_torch is not beside {pathlib.Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.common.param import tree_leaves_with_path
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucket_reduce as br
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_paths = _build.build("flash_attention", "bucket_reduce")
    print(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {lib_path.stem.split('-')[0]}: " + line.strip())

    # ----------------------------- 3. flash attention against plain
    print(f"[kernel vs plain] on {card}", flush=True)
    rows = [check_kernel(case, dtype, fa, ref)
            for case in SWEEP + [YI_PREFILL]
            for dtype in (torch.float32, torch.bfloat16)]
    main_row = rows[-1]  # yi-9b prefill, bf16: the shape the serve phase runs

    # on a small input, the kernel path of the model against the plain path
    small = get_config("yi-9b").reduced(n_kv_heads=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    sparams = lm.init(small, gen, device="cuda")
    stoks = torch.randint(0, small.vocab_size, (2, 96), generator=gen, device="cuda")
    lk, ck = lm.prefill(sparams, {"tokens": stoks}, small, attn_impl="kernel")
    lf, cf = lm.prefill(sparams, {"tokens": stoks}, small, attn_impl="full")
    torch.cuda.synchronize()
    small_err = float((lk - lf).abs().max())
    if small_err > 1e-4:
        fail(f"reduced yi-9b f32 prefill, kernel vs plain path: {small_err}")
    print(f"[reduced yi-9b f32 prefill] kernel vs plain path: max |dlogits| {small_err:.3g}")
    del sparams, lk, ck, lf, cf

    # ------------------------------- 4. bucket_reduce against plain
    print(f"[bucket_reduce vs plain] on {card}", flush=True)
    for shape in BR_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            check_bucket_reduce(shape, dtype, br, ref)
    for dtype in (torch.float32, torch.int64):
        check_bucket_reduce(BR_ENGINE, dtype, br, ref)
    br_row = check_bucket_reduce(BR_LARGE, torch.float32, br, ref)
    time_grouped_reduce(card)

    # --------------------------------------------------------- 5. serve
    cfg = get_config("yi-9b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                     generator=gen, device="cuda")}
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in {cfg.param_dtype}, init {init_s:.1f} s", flush=True)

    runs = []
    for _ in range(2):
        fa.flash_attention_bhsd.launches = 0
        timings: dict = {}
        toks = lm.generate(params, batch, cfg, n_steps=NEW_TOKENS, timings=timings)
        launches = fa.flash_attention_bhsd.launches
        if launches != cfg.n_layers:
            fail(f"flash-attention kernel launched {launches} times in a request "
                 f"batch, expected {cfg.n_layers} (one per layer in prefill)")
        runs.append((toks, timings, launches))
    (toks, _, launches), (toks2, timings, _) = runs
    if toks.shape != (BATCH, NEW_TOKENS) or not torch.equal(toks, toks2):
        fail("two greedy runs gave different tokens")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail("generated token out of the vocabulary")

    # replay the request step by step: every logit finite, and each step's
    # greedy pick the token that generate produced
    kv_len = PROMPT + NEW_TOKENS
    logits, caches = lm.prefill(params, batch, cfg)
    caches = lm._grow_caches(caches, cfg, kv_len)
    steps = [logits]
    for i in range(NEW_TOKENS - 1):
        logits, caches = lm.decode_step(params, toks[:, i:i + 1], PROMPT + i, caches, cfg,
                                        kv_len=kv_len)
        steps.append(logits)
    torch.cuda.synchronize()
    for col, lg in enumerate(steps):
        name = "prefill" if col == 0 else f"decode step {col}"
        if lg.shape != (BATCH, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            fail(f"{name} logits: shape {tuple(lg.shape)} or not finite")
        if not torch.equal(lg.argmax(-1), toks[:, col]):
            fail(f"{name} logits disagree with the generated tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = timings["prefill_s"] * 1e3
    decode_ms = timings["decode_s"] * 1e3 / (NEW_TOKENS - 1)
    tok_s = BATCH * NEW_TOKENS / (timings["prefill_s"] + timings["decode_s"])
    print(f"[serve] batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} new tokens, greedy, "
          f"on {card}: prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s, peak memory {peak_gb:.2f} GB, "
          f"{launches} flash-attention launches", flush=True)
    print("sample:", toks[0, :16].tolist())
    del logits, steps, caches
    trace_serve(params, batch, cfg, lm, card)

    del params, batch
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 6. engine
    br_launches = run_engine(card, torch, br)

    # -------------------------------------------------------- 7. report
    def entry(name, source, replaces, n, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:84", launches, main_row),
        entry("bucket_reduce", "src/repro_torch/kernels/csrc/bucket_reduce.cu",
              "src/repro/kernels/bucket_reduce.py:46", br_launches, br_row),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def _trace(label, fn, card):
    """Run ``fn`` under torch.profiler; print the host wall time, the summed
    time of the CUDA kernels it ran, the device's idle share and the
    kernels that took most of it. The profiler's own overhead is in the
    wall time, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not by_name:
        print(f"[trace {label}] wall {wall_ms:.2f} ms; device time not measured "
              "(the profiler recorded no kernels)", flush=True)
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"[trace {label}] on {card}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms, "
          f"device idle {max(0.0, 1 - busy_ms / wall_ms):.1%}", flush=True)
    for name, ms in top:
        print(f"    {ms:9.3f} ms  {ms / max(busy_ms, 1e-9):6.1%}  {name[:90]}")


TRANSIENT_PREFIXES = ("_spill/", "_payload/", "_exchange/", "_result/",
                      "_broadcast/", "_stream/")


def taxi_queries():
    """The two SQL taxi queries of the JAX package's shuffle benchmark
    (per-hour credit tips: filter + groupBy; per-hour trips joined with
    per-hour tips: two aggregations and a join), written against the
    port's DataFrame API."""
    from repro_torch.sql import Schema, col, count_, lit, sum_
    schema = Schema([
        ("pickup", "str"), ("dropoff", "str"), ("dropoff_lon", "float"),
        ("dropoff_lat", "float"), ("trip_miles", "float"),
        ("payment_type", "str"), ("tip", "float"), ("total", "float"),
        ("precip", "float"), ("color", "str"),
    ])

    def sql_filter_groupby(ctx):
        df = ctx.read_csv("taxi.csv", schema, ENGINE_PARTS)
        q = (df.where(col("payment_type") == lit("credit"))
               .withColumn("hour", col("pickup").substr(12, 2))
               .withColumn("tip_cents", (col("tip") * lit(100.0)).cast("int"))
               .groupBy("hour")
               .agg(sum_(col("tip_cents")).alias("tips"), count_().alias("n")))
        return q.collect()

    def sql_join_agg(ctx):
        df = ctx.read_csv("taxi.csv", schema, ENGINE_PARTS)
        hour = col("pickup").substr(12, 2)
        trips = df.withColumn("hour", hour).groupBy("hour").agg(count_().alias("trips"))
        tips = (df.where(col("payment_type") == lit("credit"))
                  .withColumn("hour", hour)
                  .withColumn("tip_cents", (col("tip") * lit(100.0)).cast("int"))
                  .groupBy("hour").agg(sum_(col("tip_cents")).alias("tips")))
        return trips.join(tips, on="hour").collect()

    return {"sql_filter_groupby": sql_filter_groupby, "sql_join_agg": sql_join_agg}


def run_engine(card, torch, br):
    """Both taxi SQL queries through the port's engine, torch route on the
    card against the numpy route; returns bucket_reduce's launches over
    the two torch-route runs."""
    from repro_torch.core import FlintConfig, FlintContext
    from repro_torch.data.synthetic import taxi_csv
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    data = taxi_csv(ENGINE_ROWS, seed=13)
    print(f"[engine] taxi_csv({ENGINE_ROWS}, seed=13): {len(data) / 1e6:.1f} MB "
          f"in {time.perf_counter() - t0:.1f} s, {ENGINE_PARTS} partitions", flush=True)

    def context(backend):
        ctx = FlintContext("flint", FlintConfig(
            concurrency=16, flush_records=2000, shuffle_backend="sqs",
            vector_backend=backend, vector_device="cuda"))
        ctx.upload("taxi.csv", data)
        return ctx

    def check_leaks(ctx, label):
        leaked = [k for prefix in TRANSIENT_PREFIXES for k in ctx.store.list(prefix)]
        if leaked or ctx.last_scheduler.sqs._queues:
            fail(f"engine {label}: leaked keys {leaked[:5]} or queues "
                 f"{list(ctx.last_scheduler.sqs._queues)[:5]}")

    total = 0
    queries = taxi_queries()
    for name, query in queries.items():
        answers = {}
        for backend in ("torch", "numpy"):
            ctx = context(backend)
            br.bucket_reduce.launches = 0
            ops.grouped_reduce.folds, ops.grouped_reduce.seconds = 0, 0.0
            t0 = time.perf_counter()
            ans = query(ctx)
            wall = time.perf_counter() - t0
            launches, folds = br.bucket_reduce.launches, ops.grouped_reduce.folds
            fold_s = ops.grouped_reduce.seconds
            check_leaks(ctx, f"{name}/{backend}")
            if backend == "torch":
                if folds <= 0 or launches != folds:
                    fail(f"engine {name}: {launches} bucket_reduce launches for "
                         f"{folds} grouped_reduce folds (must be equal and > 0)")
                total += launches
            elif launches or folds:
                fail(f"engine {name}: the numpy route reached the kernel")
            answers[backend] = sorted(ans)
            per_call = f"{fold_s * 1e3 / folds:.3f} ms" if folds else "-"
            print(f"[engine] {name} / {backend} on {card}: wall {wall:.3f} s, "
                  f"{ENGINE_ROWS / wall:.0f} rows/s, {len(ans)} result rows, "
                  f"{launches} kernel launches, {folds} folds, "
                  f"{per_call} per fold with copies", flush=True)
            del ctx
        if answers["torch"] != answers["numpy"]:
            fail(f"engine {name}: torch and numpy routes disagree")
        print(f"[engine] {name}: torch and numpy results identical "
              f"({len(answers['torch'])} rows)", flush=True)

    ctx = context("torch")
    br.bucket_reduce.launches = 0
    _trace("engine sql_filter_groupby, torch route",
           lambda: queries["sql_filter_groupby"](ctx), card)
    if br.bucket_reduce.launches <= 0:
        fail("traced engine query launched no bucket_reduce kernel")
    check_leaks(ctx, "traced")
    return total


def trace_serve(params, batch, cfg, lm, card):
    """Where the time of one request batch goes: one prefill, then three
    decode steps, each window traced on its own."""
    kv_len = PROMPT + 4
    state = {}

    def prefill():
        state["logits"], caches = lm.prefill(params, batch, cfg)
        state["caches"] = lm._grow_caches(caches, cfg, kv_len)

    def decode():
        tok = state["logits"].argmax(-1)[:, None]
        for i in range(3):
            logits, _ = lm.decode_step(params, tok, PROMPT + i, state["caches"], cfg,
                                       kv_len=kv_len)
            tok = logits.argmax(-1)[:, None]

    _trace("prefill", prefill, card)
    _trace("3 decode steps", decode, card)


if __name__ == "__main__":
    main()
