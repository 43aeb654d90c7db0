"""Attention (torch counterpart of ``repro.models.attention``), GQA half.

Execution paths for full-sequence GQA attention:

* ``full``   — materialized scores; the plain path, and what "auto" picks
               on the CPU up to ``CHUNKED_THRESHOLD`` kv positions.
* ``kernel`` — the hand-written flash-attention kernel through
               ``repro_torch.kernels.ops`` (takes the place of the JAX
               package's ``pallas``); what "auto" picks on a CUDA device.
* ``chunked`` is not ported yet and raises.

Decode reads a (k, v) cache with plain tensor code, as in the JAX package.
MLA has only its schema here (so parameter counts agree for every arch);
its attention paths come with its slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm_heads

NEG_INF = -1e30

# the JAX package's switch from full to chunked attention
CHUNKED_THRESHOLD = 8_192


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1: {item})")


# =================================================================== GQA


def gqa_schema(cfg: ModelConfig, cross: bool = False) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "w_q": P((d, h, hd), ("w_embed", "w_heads", None)),
        "w_k": P((d, k, hd), ("w_embed", "w_kv_heads", None)),
        "w_v": P((d, k, hd), ("w_embed", "w_kv_heads", None)),
        "w_o": P((h, hd, d), ("w_heads", None, "w_embed")),
    }
    if cfg.attn_bias:
        s["b_q"] = P((h, hd), ("w_heads", None), "zeros")
        s["b_k"] = P((k, hd), ("w_kv_heads", None), "zeros")
        s["b_v"] = P((k, hd), ("w_kv_heads", None), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), (None,), "ones")
        s["k_norm"] = P((hd,), (None,), "ones")
    del cross
    return s


def _heads(x, w):
    """(B, S, d) @ (d, H, E) -> (B, S, H, E)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out, w_o):
    """(B, S, H, E) @ (H, E, d) -> (B, S, d)."""
    return out.flatten(-2) @ w_o.reshape(-1, w_o.shape[-1])


def _project_qkv(params, x, kv_x, cfg: ModelConfig, q_pos, kv_pos):
    """Project + (optionally) bias/norm/rope q, k, v."""
    q = _heads(x, params["w_q"].to(x.dtype))
    k = _heads(kv_x, params["w_k"].to(x.dtype))
    v = _heads(kv_x, params["w_v"].to(x.dtype))
    if cfg.attn_bias:
        q = q + params["b_q"].to(x.dtype)
        k = k + params["b_k"].to(x.dtype)
        v = v + params["b_v"].to(x.dtype)
    if cfg.qk_norm:
        q = rmsnorm_heads(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm_heads(params["k_norm"], k, cfg.norm_eps)
    if q_pos is not None:  # rope (self-attention); cross-attn passes None
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, kv_pos, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    """(B, Sq, Skv) additive mask. q_pos/kv_pos: (B, S)."""
    d = q_pos[:, :, None] - kv_pos[:, None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window:
        ok &= d < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa_full(q, k, v, mask_bias):
    """q:(B,Sq,H,D) k:(B,Skv,K,D) v:(B,Skv,K,Dv); grouped-query attention."""
    b, sq, h, dh = q.shape
    kk = k.shape[2]
    g = h // kk
    q = q.reshape(b, sq, kk, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(dh)
    scores = scores + mask_bias[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def gqa_attend(params, x, cfg: ModelConfig, *, positions, causal=True,
               kv_x=None, kv_positions=None, attn_impl: str = "auto"):
    """Full-sequence (prefill) attention. Returns (out, (k, v)) so callers
    may build a cache from k, v."""
    cross = kv_x is not None
    kv_x = x if kv_x is None else kv_x
    kv_positions = positions if kv_positions is None else kv_positions
    q, k, v = _project_qkv(params, x, kv_x, cfg,
                           None if cross else positions,
                           None if cross else kv_positions)
    window = cfg.sliding_window
    skv = k.shape[1]
    if attn_impl == "auto":
        if x.device.type == "cuda":
            attn_impl = "kernel"
        else:
            attn_impl = "chunked" if skv > CHUNKED_THRESHOLD else "full"
    if attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=causal and not cross,
                                   window=window)
    elif attn_impl == "chunked":
        raise _not_ported("chunked attention (_sdpa_chunked)", "long prefill")
    elif attn_impl == "full":
        mb = _mask_bias(positions, kv_positions, causal and not cross, window)
        out = _sdpa_full(q, k, v, mb)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    y = _out_proj(out, params["w_o"].to(x.dtype))
    return y, (k, v)


def gqa_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """SWA archs roll a window-sized cache; full attention keeps max_len."""
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, length, k, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, k, hd), dtype=dtype, device=device),
    }


def gqa_decode(params, x, cache, pos: int, cfg: ModelConfig, *, kv_len):
    """One-token decode. x: (B, 1, d). pos: int, the current position.
    kv_len: the most positions the cache represents.

    Unlike the JAX package, which returns new arrays, this writes the new
    key and value into ``cache`` in place (one slot per layer instead of a
    copy of the whole cache) and returns the same dict."""
    b = x.shape[0]
    p = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, p, p)
    length = cache["k"].shape[1]
    rolling = bool(cfg.sliding_window) and length < kv_len
    slot = pos % length if rolling else min(pos, length - 1)
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    # positions held in each cache slot (for masking): rolling for SWA.
    idx = torch.arange(length, device=x.device)
    if rolling:
        base = pos - (pos % length)
        slot_pos = torch.where(idx <= pos % length, base + idx, base - length + idx)
    else:
        slot_pos = idx
    valid = slot_pos <= pos
    if cfg.sliding_window:
        valid &= slot_pos > pos - cfg.sliding_window
    _, _, h, dh = q.shape
    kk = ck.shape[2]
    g = h // kk
    qg = q.reshape(b, 1, kk, g, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
    s = s / math.sqrt(dh)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(b, 1, h, dh)
    y = _out_proj(out, params["w_o"].to(x.dtype))
    return y, cache


# =================================================================== MLA


def mla_schema(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d = cfg.resolved_head_dim, cfg.rope_head_dim
    vdim = cfg.resolved_v_head_dim
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    s = {
        # KV joint compression: d -> latent(r_kv) + shared rope key
        "w_dkv": P((d, r_kv + rope_d), ("w_embed", None)),
        "kv_norm": P((r_kv,), (None,), "ones"),
        "w_uk": P((r_kv, h, nope), (None, "w_heads", None)),
        "w_uv": P((r_kv, h, vdim), (None, "w_heads", None)),
        "w_o": P((h, vdim, d), ("w_heads", None, "w_embed")),
    }
    if r_q:
        s["w_dq"] = P((d, r_q), ("w_embed", None))
        s["q_norm"] = P((r_q,), (None,), "ones")
        s["w_uq"] = P((r_q, h, nope + rope_d), (None, "w_heads", None))
    else:
        s["w_q"] = P((d, h, nope + rope_d), ("w_embed", "w_heads", None))
    return s

