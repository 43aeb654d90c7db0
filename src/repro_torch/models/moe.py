"""Mixture-of-Experts (torch counterpart of ``repro.models.moe``).

Only the parameter schema is ported, so that parameter counts agree for
every arch; routing, dispatch and the expert paths come with the MoE slice
(ROADMAP queue 1: MoE), which also ports the ``grouped_matmul`` kernel.
"""

from __future__ import annotations

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu_schema


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
