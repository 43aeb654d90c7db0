"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``): the contract each hand-written kernel is held to,
and what a kernel wrapper runs for a tensor on the CPU."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) with H % K == 0 (GQA).
    Positions are implicit: q row i sits at absolute position
    (Skv - Sq + i) so prefill (Sq == Skv) and decode both work."""
    b, sq, h, d = q.shape
    skv, kk = k.shape[1], k.shape[2]
    g = h // kk
    qg = q.reshape(b, sq, kk, g, d)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + (skv - sq)
    kpos = torch.arange(skv, device=q.device)
    delta = qpos[:, None] - kpos[None, :]
    ok = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        ok &= delta >= 0
    if window:
        ok &= delta < window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, sq, h, d)
