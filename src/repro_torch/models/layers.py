"""Shared layer primitives: norms, RoPE, SwiGLU MLP, embeddings (torch
counterpart of ``repro.models.layers``).

All layers follow the same convention: ``<layer>_schema(cfg) -> {name: P}``
and ``<layer>(params, x, ...) -> y``, with the JAX package's parameter
names and logical axis names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig


# ---------------------------------------------------------------- norms


def rmsnorm_schema(dim: int) -> dict:
    return {"scale": P((dim,), (None,), "ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dtype)


def rmsnorm_heads(scale, x, eps: float = 1e-5):
    """Per-head qk-norm (qwen3): x is (..., head_dim), scale (head_dim,)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


# ---------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with even D; positions: (B, S) integer.

    Angles, cos and sin in f32 (large positions); the rotation itself in
    x's dtype, as in the JAX package."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    angles = positions.float()[..., None] * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------- MLP


def swiglu_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    return {
        "w_gate": P((d, f), ("w_embed", "w_mlp")),
        "w_up": P((d, f), ("w_embed", "w_mlp")),
        "w_down": P((f, d), ("w_mlp", "w_embed")),
    }


def swiglu(params, x):
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------- embedding


def embedding_schema(cfg: ModelConfig) -> dict:
    # rows padded to cfg.padded_vocab; ids never index the padding, and
    # unembed slices logits back to vocab_size.
    return {"table": P((cfg.padded_vocab, cfg.d_model),
                       ("w_vocab", "w_embed"), "embed")}


def embed(params, tokens, cfg: ModelConfig):
    # gather first, then cast: the same values as casting the whole table
    return F.embedding(tokens, params["table"]).to(cfg.cdtype)


def unembed_schema(cfg: ModelConfig) -> dict:
    return {"w_out": P((cfg.d_model, cfg.padded_vocab),
                       ("w_embed", "w_vocab"))}


def unembed(params, x, cfg: ModelConfig):
    # x-dtype operands with f32 accumulation and f32 logits, as the JAX
    # package's preferred_element_type=f32: a product of two bf16 values is
    # exact in f32, so upcasting the operands and multiplying in f32 gives
    # those logits. (The upcast weight is a temporary of padded_vocab *
    # d_model f32 values.)
    w = params["w_out"].to(x.dtype)
    logits = x.float() @ w.float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., : cfg.vocab_size]
    return logits
