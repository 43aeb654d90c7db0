#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code if it fails:

1. Device and card: a CUDA device of capability (9, 0); prints its name and
   power limit as nvidia-smi reports them.
2. Build: compiles the flash-attention kernel from
   src/repro_torch/kernels/csrc/ for sm_90a.
3. Kernel against plain: the kernel against its plain PyTorch version
   (repro_torch.kernels.ref) on the five shapes of the JAX package's
   flash-attention sweep plus yi-9b's prefill shape, in f32 (2e-5) and
   bf16 (2e-2); per shape the kernel's, the plain version's and one
   PyTorch call's (scaled_dot_product_attention, a yardstick the port never
   calls) times, and the least time the card could take.
4. Serve: yi-9b at full width (48 layers, d_model 4096, bf16), weights
   drawn from a seeded generator on the card, batch 8, prompt 512, 32 new
   tokens, greedy, through repro_torch.models.lm.generate. The kernel's
   launch count must rise by exactly 48 (one per layer, all in prefill),
   two runs must give the same tokens, and a step-by-step replay must give
   finite logits whose greedy picks are those tokens; a reduced yi-9b in
   f32 checks the kernel path against the plain path. A profiler trace of
   one prefill and three decode steps shows where the time goes.
5. Prints the kernels line, then the device line last.
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import lm

    # --------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    lib_path = fa.build()
    print(f"[build] {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())

    # ---------------------------------------- 3. kernel against plain
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

    # --------------------------------------------------------- 4. serve
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

    # -------------------------------------------------------- 5. report
    kernel = {"name": "flash_attention", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "replaces": "src/repro/kernels/flash_attention.py:84",
              "launches": launches, "max_abs_err": main_row["max_abs_err"],
              "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
              "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
              "library_ms": main_row["library_ms"]}
    print(json.dumps({"kernels": [kernel]}))
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
