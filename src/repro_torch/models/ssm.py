"""Mamba2 blocks (torch counterpart of ``repro.models.ssm``).

Only the parameter schema is ported, so that parameter counts agree for
every arch; the chunked scan and the recurrent decode come with the SSM
slice (ROADMAP queue 1: SSM).
"""

from __future__ import annotations

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig


def mamba2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_state


def mamba2_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, n = mamba2_dims(cfg)
    w = cfg.ssm_conv_width
    return {
        "w_z": P((d, di), ("w_embed", "w_mlp")),
        "w_x": P((d, di), ("w_embed", "w_mlp")),
        "w_bc": P((d, 2 * n), ("w_embed", None)),
        "w_dt": P((d, h), ("w_embed", None)),
        "conv_x_w": P((w, di), (None, "w_mlp"), scale=0.5),
        "conv_x_b": P((di,), ("w_mlp",), "zeros"),
        "conv_bc_w": P((w, 2 * n), (None, None), scale=0.5),
        "conv_bc_b": P((2 * n,), (None,), "zeros"),
        "a_log": P((h,), (None,), "ones"),
        "d_skip": P((h,), (None,), "ones"),
        "dt_bias": P((h,), (None,), "zeros"),
        "norm": P((di,), ("w_mlp",), "ones"),
        "w_out": P((di, d), ("w_mlp", "w_embed")),
    }
