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


def bucket_reduce_ref(values, bucket_ids, n_buckets: int):
    """values: (N, D), bucket_ids: (N,) ints. Returns (n_buckets, D)
    per-bucket sums — reduceByKey after the hash partitioner, the paper's
    shuffle+aggregate collapsed into one op. Ids outside [0, n_buckets)
    (padding -1) add nothing, as ``jax.nn.one_hot`` gives them a zero row.
    Accumulates in f32 and casts back to values' dtype; int64 values
    accumulate in int64 (the exact variant ``grouped_reduce`` uses)."""
    ids = bucket_ids.long()
    keep = (ids >= 0) & (ids < n_buckets)
    acc = torch.int64 if values.dtype == torch.int64 else torch.float32
    out = torch.zeros((n_buckets, values.shape[1]), dtype=acc, device=values.device)
    out.index_add_(0, ids[keep], values[keep].to(acc))
    return out.to(values.dtype)


def grouped_matmul_ref(x, w):
    """x: (E, T, D), w: (E, D, F) -> (E, T, F): per-expert matmul with an
    f32 accumulator over D, cast once to x's dtype, as the TPU kernel
    computes it (``repro.kernels.moe_gmm._kernel``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)
