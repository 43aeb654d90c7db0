"""xLSTM blocks (torch counterpart of ``repro.models.xlstm``).

Only the parameter schemas are ported, so that parameter counts agree for
every arch; the mLSTM and sLSTM cells come with the xLSTM slice (ROADMAP
queue 1: xLSTM).
"""

from __future__ import annotations

from repro_torch.common.param import P
from repro_torch.configs.base import ModelConfig


def mlstm_dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model  # projection factor 2 (paper)
    h = cfg.n_heads
    return di, h, di // h


def mlstm_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, p = mlstm_dims(cfg)
    return {
        "w_up": P((d, di), ("w_embed", "w_mlp")),
        "w_gate_up": P((d, di), ("w_embed", "w_mlp")),
        "conv_w": P((cfg.ssm_conv_width, di), (None, "w_mlp"), scale=0.5),
        "conv_b": P((di,), ("w_mlp",), "zeros"),
        "w_q": P((di, di), (None, "w_mlp")),
        "w_k": P((di, di), (None, "w_mlp")),
        "w_v": P((di, di), (None, "w_mlp")),
        "w_i": P((di, h), ("w_mlp", None), scale=0.02),
        "b_i": P((h,), (None,), "zeros"),
        "w_f": P((di, h), ("w_mlp", None), scale=0.02),
        "b_f": P((h,), (None,), "ones"),  # bias toward remembering
        "norm": P((di,), ("w_mlp",), "ones"),
        "w_down": P((di, d), ("w_mlp", "w_embed")),
    }


def slstm_schema(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    p = d // h
    dff = int(d * 4 / 3 / 64) * 64 * 2  # paper: pf=4/3, GeGLU (2 mats fused)
    s = {}
    for g in ("i", "f", "z", "o"):
        s[f"w_{g}"] = P((d, d), ("w_embed", "w_mlp"), scale=0.02)
        s[f"r_{g}"] = P((h, p, p), (None, None, None), scale=0.02)
        s[f"b_{g}"] = P((d,), (None,), "ones" if g == "f" else "zeros")
    s["norm"] = P((d,), (None,), "ones")
    s["w_ff_up"] = P((d, dff), ("w_embed", "w_mlp"))
    s["w_ff_down"] = P((dff // 2, d), ("w_mlp", "w_embed"))
    return s
