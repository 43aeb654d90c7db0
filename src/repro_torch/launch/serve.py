"""Serving launcher: batched prefill + greedy decode (torch counterpart of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --preset full
    PYTHONPATH=src python -m repro_torch.launch.serve --preset smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --preset smoke --moe-impl gmm [--device cpu]

Weights are random, drawn from ``--seed``. ``--moe-impl`` sets the
config's ``moe_impl`` (default: the config's own, "einsum"); "gmm" runs the
MoE expert products of prefill through the grouped-matmul kernel on the
card, or its plain version on the CPU.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", help=f"one of {ARCHS}")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-impl", choices=["einsum", "gmm"], default=None,
                    help="MoE expert path (default: the config's moe_impl)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.reduced()
    if args.moe_impl is not None:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = lm.init(cfg, gen, device=device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.randn((args.batch, cfg.frontend_len, cfg.d_model),
                                        generator=gen, device=device).to(cfg.cdtype)

    timings: dict = {}
    t0 = time.perf_counter()
    toks = lm.generate(params, batch, cfg, n_steps=args.new_tokens, timings=timings)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} moe_impl={cfg.moe_impl if cfg.n_experts else '-'} generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.0f} tok/s)")
    print("sample:", toks[0, :16].tolist())
    decode_steps = max(args.new_tokens - 1, 1)
    print(f"prefill {timings['prefill_s'] * 1e3:.2f} ms, decode "
          f"{timings['decode_s'] * 1e3 / decode_steps:.2f} ms/step on {device}")
    return toks


if __name__ == "__main__":
    main()
