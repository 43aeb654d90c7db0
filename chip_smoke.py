#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. Device and card: a CUDA device of capability (9, 0); prints its name and
   power limit as nvidia-smi reports them.
2. Build: compiles the three kernel sources from
   src/repro_torch/kernels/csrc/ (with their shared header hopper.cuh) for
   sm_90a, one nvcc per source, started together, and prints what ptxas
   reports for each kernel.
3. Flash attention against plain: the kernel that the wrapper's variant
   rule picks (fa_fwd_wgmma_kernel for bf16 with head dim 64 or 128,
   fa_fwd_kernel otherwise) against its plain PyTorch version
   (repro_torch.kernels.ref) on the five shapes of the JAX package's
   flash-attention sweep, three shapes at the edges of the wgmma kernel's
   tiles (Skv under one 128-query tile, Sq < Skv, a window), yi-9b's
   prefill shape and mixtral-8x22b's (window 4096), in f32 (2e-5) and
   bf16 (2e-2); two launches must give the same bits, and every bf16 shape
   with head dim 64 or 128 must take the wgmma variant. Per shape the
   kernel's, the plain version's and one PyTorch call's
   (scaled_dot_product_attention, a yardstick the port never calls) times,
   and the least time the card could take; at the two serving shapes also
   the earlier CUDA-core kernel's time on the same inputs.
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
   launch count, set to 0 before each request batch, must read exactly 48
   after it (one per layer, all in prefill), all 48 on
   fa_fwd_wgmma_kernel; two runs must give the same
   tokens, and a step-by-step replay must give finite logits whose greedy
   picks are those tokens; a reduced yi-9b in f32 (phase 3) checks the
   kernel path against the plain path. A profiler trace of one prefill and
   three decode steps shows where the time goes.
6. Engine: the port's Flint engine runs two taxi SQL queries (filter and
   groupBy; two aggregations and a join) over 2,000,000 rows of
   repro_torch.data.synthetic.taxi_csv in 8 partitions, once with
   vector_backend="torch" on the card and once with "numpy". Results must
   be identical, no transient key or queue may be left, and
   bucket_reduce's launch count must rise by exactly the number of
   grouped_reduce calls that returned an array (more than 0). A profiler
   trace of one torch-route query gives the device's busy time.
7. grouped_matmul against plain: the kernel that the wrapper's variant
   rule picks (gmm_wgmma_kernel for bf16 operands that TMA can describe,
   gmm_bf16_kernel for other bf16 layouts, gmm_f32_kernel for f32) against
   grouped_matmul_ref on the four shapes of the JAX package's
   grouped-matmul sweep, two ragged shapes and three at the edges of the
   wgmma kernel's ring (a D that is not a multiple of 64 x 4 stages, a T
   under one tile, E = 1), in f32 (1e-4 * d) and bf16 (1e-5 * d plus one
   bf16 ulp), then on mixtral-8x22b's two prefill products in bf16; two
   launches must give the same bits, and each shape must take the variant
   the rule names. Per shape the kernel's, the plain version's and one
   torch.bmm's times (a yardstick the port never calls), and the least
   time the card could take; at mixtral's shapes also the earlier
   mma.sync kernel's time on the same inputs.
8. MoE paths: mixtral-8x22b at full width with one layer in f32; prefill
   at batch 2 x 512 through the kernel (moe_impl "gmm") against the plain
   einsum path, within 1e-4 of the largest logit, and the layer's MoE
   output alone within 1e-4 of its largest value; then the serve CLI on
   the reduced mixtral with --moe-impl gmm must launch the kernel.
9. Serve MoE: mixtral-8x22b at full width with 8 of its 56 layers (all 56
   do not fit on one card), bf16, moe_impl "gmm", with the gates of phase
   5: exactly 24 grouped_matmul launches (three per layer, all in prefill;
   decode takes the einsum path), all on gmm_wgmma_kernel, and 8
   flash-attention launches, all on fa_fwd_wgmma_kernel, per request
   batch, identical tokens twice, a replay that agrees, and a trace of
   prefill and three decode steps.
10. Prints the kernels line (each entry names the variant its times were
    measured on), then the device line last.
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
# flash-attention sweep; shapes at the edges of the wgmma kernel's tiles
# (128 queries, 64 keys): Skv under one query tile, Sq < Skv with ragged
# lengths, a window narrower than a key tile; then yi-9b's prefill (the
# serve phase's shape) and mixtral-8x22b's (phase 9's)
SWEEP = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 2, 2, 256, 256, 32, True, 64),
    (2, 4, 4, 128, 128, 16, False, 0),
    (1, 8, 2, 128, 384, 64, True, 0),
    (1, 2, 1, 64, 64, 128, True, 0),
]
FA_EDGES = [
    (1, 4, 2, 100, 100, 128, True, 0),
    (1, 4, 2, 70, 300, 128, True, 0),
    (1, 4, 1, 200, 200, 64, True, 48),
]
YI_PREFILL = (8, 32, 4, 512, 512, 128, True, 0)
MIXTRAL_PREFILL = (8, 48, 8, 512, 512, 128, True, 4096)
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

# grouped_matmul (e, t, d, f): tests/test_kernels.py's grouped-matmul sweep,
# two ragged shapes (no dim a multiple of 8 or of a tile), then mixtral-8x22b's
# prefill products at batch 8 x 512 (4 groups of 1024 tokens x capacity 328):
# gate and up, then down
GMM_SWEEP = [(4, 64, 32, 48), (2, 128, 128, 128), (8, 16, 64, 8), (1, 256, 512, 128),
             (3, 100, 72, 40), (2, 37, 50, 13)]
# at the edges of the wgmma kernel's ring (128 x 256 tiles, K step 64, 4
# stages): D = 4160 = 16.25 x 256 with E = 1 and T = 300; T = 1 under one
# tile with E = 1; T, D and F all ragged against the tile
GMM_EDGES = [(1, 300, 4160, 512), (1, 1, 64, 8), (2, 130, 320, 264)]
GMM_MIXTRAL = [(8, 1312, 6144, 16384), (8, 1312, 16384, 6144)]
# |kernel - plain| <= atol + rtol * |plain|. f32: the JAX package's sweep
# bound (1e-4 * d, 1e-4). bf16: both versions sum exact bf16 products in f32
# and round once, so they differ by at most one bf16 ulp (2**-7 relative)
# where their f32 sums straddle a rounding boundary; atol 1e-5 * d covers
# the f32 sums' order, far inside the reference's 5e-2 * d
GMM_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (1e-5, 2.0**-7)}
# mixtral-8x22b: all 56 layers (about 282 GB in bf16) do not fit on one card
SERVE_MOE_LAYERS = 8


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

    variant = fa.variant(qt, kt, vt)
    wants_wgmma = dtype == torch.bfloat16 and d in fa.WGMMA_HEAD_DIMS
    if (variant == fa.WGMMA) != wants_wgmma:
        fail(f"flash attention {case} {name}: the variant rule picked {variant}")
    out, out2 = kernel().transpose(1, 2), kernel().transpose(1, 2)
    torch.cuda.synchronize()
    exp = plain()
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        fail(f"flash attention {case} {name}: two launches differ")
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
    row = {"case": list(case), "dtype": name, "variant": variant, "max_abs_err": err,
           "tol": tol, "bit_identical": True, "ms": t_kernel, "plain_ms": t_plain,
           "library_ms": t_lib, "bound_ms": bound, "bound_by": bound_by}
    if variant == fa.WGMMA and case in (YI_PREFILL, MIXTRAL_PREFILL):
        earlier = earlier_flash_attention(fa, qt, kt, vt, causal, window)
        row["earlier_variant"] = fa.CUDA_CORES
        row["earlier_max_abs_err"] = float(
            (earlier().transpose(1, 2).float() - exp.float()).abs().max())
        row["earlier_ms"] = time_ms(earlier)
    print("  " + json.dumps(row), flush=True)
    return row


def earlier_flash_attention(fa, qt, kt, vt, causal, window):
    """The earlier CUDA-core kernel (fa_fwd_kernel) on the same bf16
    inputs, through the wrapper's own C call (``_launch``), so its time
    stands beside the wgmma kernel's in one run. No launch is counted, and
    no path of the port picks this kernel for these inputs."""
    import torch
    b, h, sq, d = qt.shape
    out = torch.empty((b, sq, h, d), dtype=qt.dtype, device="cuda").transpose(1, 2)

    def run():
        fa._launch(fa.CUDA_CORES, qt, kt, vt, out, causal, window)
        return out
    return run


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


def gmm_bound(e, t, d, f, dtype_name, itemsize):
    """Least time (ms) for one call: x, w read once and out written once,
    against 2*E*T*D*F FLOPs at the dense peak of the inputs' type."""
    t_bytes = itemsize * (e * t * d + e * d * f + e * t * f) / HBM_BYTES_S
    t_ops = 2.0 * e * t * d * f / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_gmm(shape, dtype, gmm, ref, expected):
    """grouped_matmul's kernel against its plain version on one shape and
    dtype, which must take the variant ``expected``; returns the row of
    numbers for it."""
    import torch
    e, t, d, f = shape
    name = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cuda").manual_seed(e * 1009 + t * 31 + d + f)
    x = torch.randn((e, t, d), generator=gen, device="cuda").to(dtype)
    w = torch.randn((e, d, f), generator=gen, device="cuda").to(dtype)

    def kernel():
        return gmm.grouped_matmul(x, w)

    def plain():
        return ref.grouped_matmul_ref(x, w)

    variant = gmm.variant(x, w)
    if variant != expected:
        fail(f"grouped_matmul {shape} {name}: the variant rule picked {variant}, "
             f"expected {expected}")
    out, out2 = kernel(), kernel()
    torch.cuda.synchronize()
    exp = plain()
    torch.cuda.synchronize()
    if out.dtype != dtype or out.shape != (e, t, f):
        fail(f"grouped_matmul {shape} {name}: got {out.dtype} {tuple(out.shape)}")
    if not torch.equal(out, out2):
        fail(f"grouped_matmul {shape} {name}: two launches differ")
    atol_per_d, rtol = GMM_TOLS[name]
    atol = atol_per_d * d
    diff = (out.float() - exp.float()).abs()
    err = float(diff.max())
    if not bool((diff <= atol + rtol * exp.float().abs()).all()):
        fail(f"grouped_matmul {shape} {name}: max |kernel - plain| = {err} "
             f"> atol {atol} + rtol {rtol} * |plain|")

    def library():  # the yardstick: cuBLAS through one torch.bmm; never used by the port
        return torch.bmm(x, w)

    big = e * t * d * f >= 2**36
    t_kernel = time_ms(kernel, iters=5 if big else 50)
    t_plain = time_ms(plain, iters=3 if big else 20)
    t_lib = time_ms(library, iters=5 if big else 50)
    bound, bound_by = gmm_bound(e, t, d, f, name, x.element_size())
    # max_err_scaled: max |kernel - plain| / max(|plain|, 1)
    row = {"shape": [e, t, d, f], "dtype": name, "variant": variant, "max_abs_err": err,
           "atol": atol, "rtol": rtol,
           "max_err_scaled": float((diff / exp.float().abs().clamp_min(1.0)).max()),
           "bit_identical": True, "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
           "bound_ms": bound, "bound_by": bound_by}
    if shape in GMM_MIXTRAL:
        earlier = earlier_grouped_matmul(gmm, x, w)
        row["earlier_variant"] = gmm.MMA_SYNC
        row["earlier_max_abs_err"] = float((earlier().float() - exp.float()).abs().max())
        row["earlier_ms"] = time_ms(earlier, iters=5)
    print("  " + json.dumps(row), flush=True)
    return row


def earlier_grouped_matmul(gmm, x, w):
    """The earlier mma.sync kernel (gmm_bf16_kernel) on the same bf16
    inputs, through the wrapper's own C call (``_launch``), so its time
    stands beside the wgmma kernel's in one run. No launch is counted, and
    no path of the port picks this kernel for these inputs."""
    import torch
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=x.dtype, device="cuda")

    def run():
        gmm._launch(gmm.MMA_SYNC, x, w, out)
        return out
    return run


def check_moe_paths(mixtral, gmm, card):
    """mixtral-8x22b at full width with one layer, in f32: prefill at batch
    2 x 512 through the kernel (moe_impl "gmm") against the plain einsum
    path; the last-token logits must agree within 1e-4 of their largest
    magnitude, and so must the layer's MoE output on a unit-scale input.
    Then the serve CLI on the reduced config with --moe-impl gmm must
    launch the kernel."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import lm, moe
    cfg = mixtral.replace(n_layers=1, param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = lm.init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen,
                                     device="cuda")}
    out = {}
    for impl in ("gmm", "einsum"):
        _build.reset_launches(gmm.grouped_matmul)
        logits, _ = lm.prefill(params, batch, cfg.replace(moe_impl=impl))
        torch.cuda.synchronize()
        out[impl] = (logits, gmm.grouped_matmul.launches)
    (lg, n_gmm), (le, n_einsum) = out["gmm"], out["einsum"]
    if (n_gmm, n_einsum) != (3, 0):
        fail(f"full-width f32 mixtral: {n_gmm} grouped_matmul launches on the gmm path "
             f"(expected 3), {n_einsum} on the einsum path (expected 0)")
    if not bool(torch.isfinite(lg).all()):
        fail("full-width f32 mixtral: gmm-path logits not finite")
    err, scale = float((lg - le).abs().max()), float(le.abs().max())
    # the MoE layer alone, on unit-scale input: its output is not diluted
    # by the residual stream as the logits' is
    mlp = {k: v[0] for k, v in params["stack"]["blocks"]["mlp"].items()}
    h = torch.randn((2, PROMPT, cfg.d_model), generator=gen, device="cuda")
    yg, aux, drop = moe.moe_apply(mlp, h, cfg)
    ye, _, _ = moe.moe_apply(mlp, h, cfg.replace(moe_impl="einsum"))
    y_err, y_scale = float((yg - ye).abs().max()), float(ye.abs().max())
    print(f"[mixtral f32, 1 layer, full width] prefill batch 2 x {PROMPT} on {card}: "
          f"gmm vs einsum max |dlogits| {err:.6g}, max |logits| {scale:.6g} "
          f"({n_gmm} grouped_matmul launches on the gmm path, {n_einsum} on the einsum "
          f"path); MoE layer max |dy| {y_err:.6g}, max |y| {y_scale:.6g}, drop fraction "
          f"{float(drop):.6g}, aux {float(aux):.6g}", flush=True)
    if err > 1e-4 * scale or y_err > 1e-4 * y_scale:
        fail(f"full-width f32 mixtral: gmm vs einsum logits differ by {err} "
             f"(max {scale}), MoE layer outputs by {y_err} (max {y_scale}), over 1e-4")
    del params, lg, le, yg, ye
    torch.cuda.empty_cache()

    _build.reset_launches(gmm.grouped_matmul)
    toks = serve_cli.main(["--arch", "mixtral-8x22b", "--preset", "smoke", "--moe-impl",
                           "gmm", "--batch", "2", "--prompt-len", "32", "--new-tokens", "4"])
    small = mixtral.reduced()
    if gmm.grouped_matmul.launches != 3 * small.n_layers or tuple(toks.shape) != (2, 4):
        fail(f"serve CLI, reduced mixtral, --moe-impl gmm: "
             f"{gmm.grouped_matmul.launches} grouped_matmul launches, expected "
             f"{3 * small.n_layers}")


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

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucket_reduce as br
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_paths = _build.build("flash_attention", "bucket_reduce", "moe_gmm")
    print(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib_path in lib_paths:
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if any(key in line for key in ("Compiling entry", "registers", "spill", "warning")):
                print(f"  ptxas {lib_path.stem.split('-')[0]}: " + line.strip())

    # ----------------------------- 3. flash attention against plain
    print(f"[kernel vs plain] on {card}", flush=True)
    rows = [check_kernel(case, dtype, fa, ref)
            for case in SWEEP + FA_EDGES + [YI_PREFILL, MIXTRAL_PREFILL]
            for dtype in (torch.float32, torch.bfloat16)]
    # yi-9b prefill, bf16: the shape the serve phase runs
    main_row = next(r for r in rows if r["case"] == list(YI_PREFILL) and r["dtype"] == "bfloat16")

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
    launches = serve(cfg, "serve", [("flash-attention", fa.flash_attention_bhsd,
                                     cfg.n_layers, fa.WGMMA)], card,
                     focus=(fa.WGMMA,))[0]
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 6. engine
    br_launches = run_engine(card, torch, br)

    # --------------------------------- 7. grouped_matmul against plain
    print(f"[grouped_matmul vs plain] on {card}", flush=True)
    for shape in GMM_SWEEP + GMM_EDGES:
        # inputs from torch.randn are contiguous: TMA can describe them
        # exactly when D and F are multiples of 8
        tma = shape[2] % 8 == 0 and shape[3] % 8 == 0
        check_gmm(shape, torch.float32, gmm, ref, gmm.F32)
        check_gmm(shape, torch.bfloat16, gmm, ref, gmm.WGMMA if tma else gmm.MMA_SYNC)
    gmm_row = [check_gmm(shape, torch.bfloat16, gmm, ref, gmm.WGMMA)
               for shape in GMM_MIXTRAL][0]

    # ------------- 8. full-width kernel path against the plain path, f32
    mixtral = get_config("mixtral-8x22b").replace(n_layers=SERVE_MOE_LAYERS,
                                                  moe_impl="gmm")
    check_moe_paths(mixtral, gmm, card)

    # --------------------------------------------------- 9. serve MoE
    gmm_launches = serve(
        mixtral, "serve mixtral",
        [("grouped_matmul", gmm.grouped_matmul, 3 * mixtral.n_layers, gmm.WGMMA),
         ("flash-attention", fa.flash_attention_bhsd, mixtral.n_layers, fa.WGMMA)], card,
        focus=(gmm.WGMMA, fa.WGMMA, "direct_copy"))[0]
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 10. report
    def entry(name, source, replaces, n, row, variant):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "variant": variant, "launches": n, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    kernels = [
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:84", launches, main_row,
              main_row["variant"]),
        entry("bucket_reduce", "src/repro_torch/kernels/csrc/bucket_reduce.cu",
              "src/repro/kernels/bucket_reduce.py:46", br_launches, br_row,
              "bucket_reduce"),
        entry("grouped_matmul", "src/repro_torch/kernels/csrc/moe_gmm.cu",
              "src/repro/kernels/moe_gmm.py:35", gmm_launches, gmm_row,
              gmm_row["variant"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def serve(cfg, label, counts, card, focus=()):
    """One request batch through repro_torch.models.lm.generate: weights
    drawn from a seeded generator on the card, batch BATCH, prompt PROMPT,
    NEW_TOKENS greedy tokens. ``counts`` lists (name, wrapper, expected,
    variant): each wrapper's launch counts are set to 0 just before a
    request batch, and its total and its count on ``variant`` must both
    read ``expected`` just after it. Two runs must give the same
    tokens, and a step-by-step replay must give finite logits whose greedy
    picks are those tokens. Then a profiler trace of one prefill and three
    decode steps. Returns the counts of the first run, in order."""
    import torch
    from repro_torch.common.param import tree_leaves_with_path
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                                     generator=gen, device="cuda")}
    extra = f", moe_impl {cfg.moe_impl}" if cfg.n_experts else ""
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in {cfg.param_dtype}{extra}, "
          f"init {init_s:.1f} s", flush=True)

    runs = []
    for _ in range(2):
        for _, wrapper, _, _ in counts:
            _build.reset_launches(wrapper)
        timings: dict = {}
        toks = lm.generate(params, batch, cfg, n_steps=NEW_TOKENS, timings=timings)
        got = [wrapper.launches for _, wrapper, _, _ in counts]
        for (name, wrapper, expected, variant), n in zip(counts, got):
            by_variant = dict(wrapper.launches_by_variant)
            if n != expected or by_variant[variant] != expected:
                fail(f"{label}: {name} kernel launched {n} times in a request batch "
                     f"({by_variant}), expected {expected}, all on {variant}")
        runs.append((toks, timings, got))
    (toks, _, launches), (toks2, timings, _) = runs
    if toks.shape != (BATCH, NEW_TOKENS) or not torch.equal(toks, toks2):
        fail(f"{label}: two greedy runs gave different tokens")
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"{label}: generated token out of the vocabulary")

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
            fail(f"{label}: {name} logits: shape {tuple(lg.shape)} or not finite")
        if not torch.equal(lg.argmax(-1), toks[:, col]):
            fail(f"{label}: {name} logits disagree with the generated tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms = timings["prefill_s"] * 1e3
    decode_ms = timings["decode_s"] * 1e3 / (NEW_TOKENS - 1)
    tok_s = BATCH * NEW_TOKENS / (timings["prefill_s"] + timings["decode_s"])
    counted = ", ".join(f"{n} {name} launches on {variant}"
                        for (name, _, _, variant), n in zip(counts, launches))
    print(f"[{label}] batch {BATCH}, prompt {PROMPT}, {NEW_TOKENS} new tokens, greedy, "
          f"on {card}: prefill {prefill_ms:.2f} ms, decode {decode_ms:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s, peak memory {peak_gb:.2f} GB, {counted}", flush=True)
    print("sample:", toks[0, :16].tolist())
    del logits, steps, caches
    trace_serve(params, batch, cfg, lm, card, label, focus)
    return launches


def _trace(label, fn, card, focus=()):
    """Run ``fn`` under torch.profiler; print the host wall time, the summed
    time of the CUDA kernels it ran, the device's idle share, the kernels
    that took most of it, and the time and share of the kernels whose
    names hold each string of ``focus``. The profiler's own overhead is in
    the wall time, so the idle share is an upper bound."""
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
    for key in focus:
        ms = sum(t for name, t in by_name.items() if key in name)
        print(f"    {key}: {ms:.3f} ms, {ms / busy_ms:.1%} of kernel time")


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


def trace_serve(params, batch, cfg, lm, card, label, focus=()):
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

    _trace(f"{label} prefill", prefill, card, focus)
    _trace(f"{label} 3 decode steps", decode, card, focus)


if __name__ == "__main__":
    main()
