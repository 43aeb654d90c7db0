"""Block wiring and layer-stack assembly (torch counterpart of
``repro.models.transformer``): the dense and MoE GQA stacks.

The JAX package runs one ``lax.scan`` over stacked layer params; here a
Python loop walks the layer axis, taking each layer's params as views of
the stacked tensors. Dense prefix layers (``first_dense_layers``) run
unrolled before the loop, as in the reference. Remat and sharding
constraints have no counterpart in serving and are left out.

Every family's schema is here, so parameter counts agree for every arch.
Running another stack (MLA, zamba, xLSTM, encoder-decoder) raises until
its slice.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.param import stack_schema, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm, xlstm
from repro_torch.models.layers import rmsnorm, rmsnorm_schema, swiglu, swiglu_schema

_NOT_DENSE = {"xlstm": "xLSTM", "zamba": "SSM"}


def _check_ported(cfg: ModelConfig):
    """Raise for any stack the port does not run yet."""
    kind = stack_config(cfg)["kind"]
    if kind in _NOT_DENSE:
        raise attn._not_ported(f"the {kind} stack", _NOT_DENSE[kind])
    if cfg.attn_type == "mla":
        raise attn._not_ported("the MLA stack", "MLA")
    if cfg.is_enc_dec:
        raise attn._not_ported("the encoder-decoder stack", "encoder-decoder and VLM inputs")


# ---------------------------------------------------------------- blocks


def decoder_block_schema(cfg: ModelConfig, *, use_moe: bool,
                         cross: bool = False) -> dict:
    s: dict[str, Any] = {"ln1": rmsnorm_schema(cfg.d_model)}
    s["attn"] = (attn.mla_schema(cfg) if cfg.attn_type == "mla"
                 else attn.gqa_schema(cfg))
    if cross:
        s["ln_x"] = rmsnorm_schema(cfg.d_model)
        s["xattn"] = attn.gqa_schema(cfg, cross=True)
    s["ln2"] = rmsnorm_schema(cfg.d_model)
    s["mlp"] = moe_mod.moe_schema(cfg) if use_moe else swiglu_schema(cfg)
    return s


def decoder_block_apply(params, x, positions, cfg: ModelConfig, *,
                        use_moe: bool, causal: bool = True,
                        attn_impl: str = "auto"):
    """GQA block, dense or MoE. Returns (x, kv_for_cache, aux_loss,
    drop_frac) with kv_for_cache = {"self": (k, v)}; aux_loss and
    drop_frac are 0-d f32 tensors for an MoE block, 0.0 for a dense one."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, kv_self = attn.gqa_attend(params["attn"], h, cfg, positions=positions,
                                 causal=causal, attn_impl=attn_impl)
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    if use_moe:
        m, aux, drop = moe_mod.moe_apply(params["mlp"], h, cfg)
        aux, drop = aux.float(), drop.float()
    else:
        m, aux, drop = swiglu(params["mlp"], h), 0.0, 0.0
    return x + m, {"self": kv_self}, aux, drop


def decoder_block_decode(params, x, cache, pos: int, cfg: ModelConfig, *,
                         use_moe: bool, kv_len: int):
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    a, new_cache = attn.gqa_decode(params["attn"], h, cache, pos, cfg,
                                   kv_len=kv_len)
    x = x + a
    h = rmsnorm(params["ln2"], x, cfg.norm_eps)
    m = (moe_mod.moe_decode(params["mlp"], h, cfg) if use_moe
         else swiglu(params["mlp"], h))
    return x + m, new_cache


def mamba_block_schema(cfg: ModelConfig) -> dict:
    return {"ln": rmsnorm_schema(cfg.d_model), "mix": ssm.mamba2_schema(cfg)}


def shared_attn_block_schema(cfg: ModelConfig) -> dict:
    return {
        "ln_a": rmsnorm_schema(cfg.d_model),
        "attn": attn.gqa_schema(cfg),
        "ln_m": rmsnorm_schema(cfg.d_model),
        "mlp": swiglu_schema(cfg),
    }


def xlstm_pair_schema(cfg: ModelConfig) -> dict:
    return {
        "ln_m": rmsnorm_schema(cfg.d_model),
        "mlstm": xlstm.mlstm_schema(cfg),
        "ln_s": rmsnorm_schema(cfg.d_model),
        "slstm": xlstm.slstm_schema(cfg),
    }


# ------------------------------------------------------------- assembly


def stack_config(cfg: ModelConfig) -> dict:
    """Static description of the layer stack (what is looped vs unrolled)."""
    if cfg.block_pattern == "xlstm_pair":
        return {"kind": "xlstm", "scan_len": cfg.n_layers // 2}
    if cfg.block_pattern == "mamba_shared_attn":
        return {"kind": "zamba", "scan_len": cfg.n_layers,
                "n_shared": -(-cfg.n_layers // cfg.shared_attn_every)}
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    return {"kind": "attn", "scan_len": (n_moe or cfg.n_layers),
            "prefix": cfg.first_dense_layers if cfg.n_experts else 0}


def stack_schema_for(cfg: ModelConfig) -> dict:
    sc = stack_config(cfg)
    if sc["kind"] == "xlstm":
        return {"pairs": stack_schema(xlstm_pair_schema(cfg), sc["scan_len"])}
    if sc["kind"] == "zamba":
        return {
            "mamba": stack_schema(mamba_block_schema(cfg), sc["scan_len"]),
            "shared": shared_attn_block_schema(cfg),
        }
    s: dict[str, Any] = {}
    if sc["prefix"]:
        dense = decoder_block_schema(cfg, use_moe=False)
        s["prefix"] = [dense for _ in range(sc["prefix"])]
    s["blocks"] = stack_schema(
        decoder_block_schema(cfg, use_moe=bool(cfg.n_experts),
                             cross=cfg.is_enc_dec), sc["scan_len"])
    return s


def _layer(stacked, i: int):
    """Layer i's params: views into the stacked tensors, no copy."""
    return tree_map(lambda a: a[i], stacked)


def apply_stack(params, x, positions, cfg: ModelConfig, *, attn_impl="auto"):
    """Full-sequence pass through the layer stack. Returns (x, aux, drop):
    the MoE aux losses summed over the layers, and their drop fractions
    averaged over the looped layers, as the reference's ``_scan_apply``
    does (dense prefix layers add nothing to either)."""
    _check_ported(cfg)
    for lp in params.get("prefix", []):
        x, _, _, _ = decoder_block_apply(lp, x, positions, cfg, use_moe=False,
                                         attn_impl=attn_impl)
    n = stack_config(cfg)["scan_len"]
    use_moe = bool(cfg.n_experts)
    aux = drop = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        x, _, a, d = decoder_block_apply(_layer(params["blocks"], i), x, positions,
                                         cfg, use_moe=use_moe, attn_impl=attn_impl)
        aux, drop = aux + a, drop + d
    return x, aux, drop / max(n, 1)


# --------------------------------------------------------------- caches


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    _check_ported(cfg)
    sc = stack_config(cfg)
    one = attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
    out = {}
    if sc["prefix"]:
        out["prefix"] = [attn.gqa_init_cache(cfg, batch, max_len, dtype, device)
                         for _ in range(sc["prefix"])]
    out["blocks"] = {k: a[None].repeat((sc["scan_len"],) + (1,) * a.dim())
                     for k, a in one.items()}
    return out


def prefill_stack(params, x, positions, cfg: ModelConfig, *, attn_impl="auto"):
    """Full-sequence pass that also builds the decode caches.

    Returns (x, caches) with the structure init_stack_cache produces (SWA
    archs get a rolling window-sized cache)."""
    _check_ported(cfg)
    s = x.shape[1]

    def roll(k):  # window-slice for SWA caches
        w = cfg.sliding_window
        if w and s >= w:
            if s % w:
                raise ValueError("prefill length must be a multiple of the window")
            return k[:, s - w:]
        return k

    prefix_caches = []
    for lp in params.get("prefix", []):
        x, kv, _, _ = decoder_block_apply(lp, x, positions, cfg, use_moe=False,
                                          attn_impl=attn_impl)
        prefix_caches.append(_kv_to_cache(kv["self"], cfg, roll))
    use_moe = bool(cfg.n_experts)
    ks, vs = [], []
    for i in range(stack_config(cfg)["scan_len"]):
        x, kv, _, _ = decoder_block_apply(_layer(params["blocks"], i), x, positions,
                                          cfg, use_moe=use_moe, attn_impl=attn_impl)
        c = _kv_to_cache(kv["self"], cfg, roll)
        ks.append(c["k"])
        vs.append(c["v"])
    out = {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    if prefix_caches:
        out["prefix"] = prefix_caches
    return x, out


def _kv_to_cache(kv_self, cfg: ModelConfig, roll):
    k, v = kv_self
    return {"k": roll(k), "v": roll(v)}


def decode_stack(params, x, caches, pos: int, cfg: ModelConfig, *, kv_len: int):
    """One-token pass; returns (x, caches). The caches are updated in place
    (see ``attention.gqa_decode``)."""
    _check_ported(cfg)
    for lp, c in zip(params.get("prefix", []), caches.get("prefix", [])):
        x, _ = decoder_block_decode(lp, x, c, pos, cfg, use_moe=False, kv_len=kv_len)
    use_moe = bool(cfg.n_experts)
    blocks = caches["blocks"]
    for i in range(stack_config(cfg)["scan_len"]):
        x, _ = decoder_block_decode(_layer(params["blocks"], i), x,
                                    _layer(blocks, i), pos, cfg, use_moe=use_moe,
                                    kv_len=kv_len)
    return x, caches
