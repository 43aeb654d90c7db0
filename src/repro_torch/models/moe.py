"""Mixture-of-Experts with GShard-style grouped dispatch (torch counterpart
of ``repro.models.moe``).

Tokens are regrouped into bounded queues of ``group_size``; each expert
takes at most ``capacity`` tokens of a group, and the tokens past it are
dropped (the residual carries them). The bookkeeping (group size, slot
positions by cumulative sum, the one-hot that drops slot -1 and slots at
or past the capacity, the drop fraction) is the reference's, so the same
tokens are dropped.

Two expert-compute paths, chosen by ``cfg.moe_impl``:
  * einsum — dense per-expert SwiGLU through torch matmuls (the reference
             leaves these to XLA);
  * gmm    — the three expert products through ``kernels.ops.grouped_matmul``:
             the hand-written CUDA kernel for a CUDA tensor, its plain
             version for a CPU tensor.

The reference's sharding constraints have no counterpart in serving and
are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu, swiglu_schema


def moe_schema(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "w_router": P((d, e), ("w_embed", None), scale=0.02),
        "w_gate": P((e, d, f), ("w_experts", "w_embed", "w_expert_mlp")),
        "w_up": P((e, d, f), ("w_experts", "w_embed", "w_expert_mlp")),
        "w_down": P((e, f, d), ("w_experts", "w_expert_mlp", "w_embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = swiglu_schema(cfg, cfg.n_shared_experts * cfg.moe_d_ff)
    return s


def _router(params, x, cfg: ModelConfig):
    """x: (..., d) -> (probs, gates, idx); gates and idx (..., top_k), gates
    f32 and renormalised over the chosen experts.

    Operands in x's dtype with f32 logits: a product of two bf16 values is
    exact in f32, so upcasting the operands and multiplying in f32 gives
    the reference's preferred_element_type=f32 logits."""
    w = params["w_router"].to(x.dtype)
    logits = x.float() @ w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _aux_loss(probs, idx, cfg: ModelConfig):
    """Switch/GShard load-balancing loss."""
    e = cfg.n_experts
    me = probs.reshape(-1, e).mean(0)
    chosen = F.one_hot(idx.reshape(-1, idx.shape[-1]), e).sum(1).float()
    ce = chosen.mean(0) / cfg.top_k
    return e * (me * ce).sum()


def _capacity(group_len: int, cfg: ModelConfig) -> int:
    c = int(group_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    # a multiple of 8, and never below top_k
    return max(cfg.top_k, -(-c // 8) * 8)


def _one_hot_slots(pos, cap: int, dtype):
    """(..., e) slot positions -> (..., e, cap) one-hot in ``dtype``; a
    position of -1 (not routed) or at or past ``cap`` (queue overflow,
    dropped) gives an all-zero row, as ``jax.nn.one_hot`` does."""
    slots = torch.arange(cap, device=pos.device)
    return (pos[..., None] == slots).to(dtype)


def _gate_per_expert(gates, onehot, dtype):
    """(g, s, k) gates and (g, s, k, e) one-hot -> (g, s, e): each token's
    gate for each expert (top_k picks distinct experts, so each sum has at
    most one term)."""
    return (gates.to(dtype)[..., None] * onehot.to(dtype)).sum(2)


def moe_apply(params, x, cfg: ModelConfig, group_size: int = 1024):
    """x: (B, S, d) -> (y, aux_loss, drop_frac).

    Tokens are flattened and regrouped into bounded queues of
    ``group_size``, so the dispatch one-hots stay O(T * k * cf * group_size)
    rather than O(T * S)."""
    b, s, d = x.shape
    t = b * s
    gs = min(group_size, t)
    while t % gs:
        gs //= 2
    g = t // gs
    xt = x.reshape(g, gs, d)

    probs, gates, idx = _router(params, xt, cfg)  # (g, gs, k)
    aux = _aux_loss(probs, idx, cfg) * cfg.router_aux_coef

    e, cap = cfg.n_experts, _capacity(gs, cfg)
    # queue slot of each (token, expert) assignment within its expert's
    # queue: top_k returns distinct experts, so the k axis collapses to a
    # 0/1 (g, gs, e) membership before the cumulative sum
    onehot = F.one_hot(idx, e).to(torch.int32)  # (g, gs, k, e)
    onehot_se = onehot.sum(2)  # (g, gs, e) in {0, 1}
    pos_se = torch.cumsum(onehot_se, dim=1) * onehot_se - 1
    gate_se = _gate_per_expert(gates, onehot, x.dtype)
    disp = _one_hot_slots(pos_se, cap, x.dtype)  # (g, gs, e, cap)
    comb = disp * gate_se[..., None]
    drop_frac = 1.0 - disp.sum() / (g * gs * cfg.top_k)

    ex_in = torch.einsum("gsec,gsd->gecd", disp, xt)  # dispatch
    if cfg.moe_impl == "gmm":
        ex_out = _experts_gmm(params, ex_in, cfg)
    else:
        ex_out = _experts_einsum(params, ex_in, cfg)
    y = torch.einsum("gsec,gecd->gsd", comb, ex_out)  # combine

    if cfg.n_shared_experts:
        y = y + swiglu(params["shared"], xt)
    return y.reshape(b, s, d), aux, drop_frac


def _experts_einsum(params, ex_in, cfg: ModelConfig):
    """ex_in: (g, e, cap, d) -> (g, e, cap, d); dense per-expert SwiGLU."""
    wg = params["w_gate"].to(ex_in.dtype)
    wu = params["w_up"].to(ex_in.dtype)
    wd = params["w_down"].to(ex_in.dtype)
    h = F.silu(torch.einsum("gecd,edf->gecf", ex_in, wg))
    h = h * torch.einsum("gecd,edf->gecf", ex_in, wu)
    return torch.einsum("gecf,efd->gecd", h, wd)


def _experts_gmm(params, ex_in, cfg: ModelConfig):
    """ex_in: (g, e, cap, d) -> (g, e, cap, d); the three expert products
    through the grouped matmul, each expert's g * cap tokens gathered into
    one contiguous (T, D) operand (a copy, as in the reference)."""
    from repro_torch.kernels import ops as kops
    g, e, cap, d = ex_in.shape
    flat = ex_in.transpose(0, 1).reshape(e, g * cap, d)
    h = F.silu(kops.grouped_matmul(flat, params["w_gate"].to(flat.dtype)))
    h = h * kops.grouped_matmul(flat, params["w_up"].to(flat.dtype))
    out = kops.grouped_matmul(h, params["w_down"].to(flat.dtype))
    return out.reshape(e, g, cap, d).transpose(0, 1)


def moe_decode(params, x, cfg: ModelConfig):
    """Decode-time MoE on a (B, 1, d) token batch: one group, a capacity
    generous enough that nothing is dropped mid-generation, and the einsum
    expert path (no kernel launch)."""
    b, s, d = x.shape
    xt = x.reshape(1, b * s, d)
    _, gates, idx = _router(params, xt, cfg)
    e = cfg.n_experts
    cap = max(cfg.top_k, min(b * s, -(-b * s * cfg.top_k * 2 // e) // 8 * 8 + 8))
    onehot = F.one_hot(idx, e).to(torch.int32)  # (1, bs, k, e)
    flatoh = onehot.reshape(1, -1, e)
    pos_se = (torch.cumsum(flatoh, dim=1) * flatoh - 1).reshape(
        1, b * s, cfg.top_k, e).amax(dim=2)
    gate_se = _gate_per_expert(gates, onehot, x.dtype)
    disp = _one_hot_slots(pos_se, cap, x.dtype)
    comb = disp * gate_se[..., None]
    ex_in = torch.einsum("gsec,gsd->gecd", disp, xt)
    ex_out = _experts_einsum(params, ex_in, cfg)
    y = torch.einsum("gsec,gecd->gsd", comb, ex_out)
    if cfg.n_shared_experts:
        y = y + swiglu(params["shared"], xt)
    return y.reshape(b, s, d)
