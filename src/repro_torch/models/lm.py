"""Top-level LM API (torch counterpart of ``repro.models.lm``): schema and
init, forward, prefill, decode and generation.

Plain functions over a nested dict of parameter tensors with the JAX
package's pytree keys. Input batch conventions are the JAX package's:
  * LM:  {"tokens": (B, S) int}
  * VLM: {"frontend": (B, F, d) cdtype, "tokens": (B, S-F) int}
Decode: token (B, 1) int, pos a Python int, caches a nested dict.

The loss (``_chunked_ce``, ``loss_fn``) comes with the training slice.
"""

from __future__ import annotations

import time

import torch

from repro_torch.common import param as pm
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (embed, embedding_schema, rmsnorm,
                                       rmsnorm_schema, unembed, unembed_schema)


def lm_schema(cfg: ModelConfig) -> dict:
    s = {"embed": embedding_schema(cfg), "stack": tfm.stack_schema_for(cfg),
         "ln_f": rmsnorm_schema(cfg.d_model)}
    if cfg.is_enc_dec:
        s["encoder"] = {
            "blocks": pm.stack_schema(
                tfm.decoder_block_schema(cfg, use_moe=False),
                cfg.encoder_layers),
            "ln_f": rmsnorm_schema(cfg.d_model),
        }
    if not cfg.tie_embeddings:
        s["unembed"] = unembed_schema(cfg)
    return s


def init(cfg: ModelConfig, gen: torch.Generator, *, device="cuda") -> dict:
    """Parameters drawn from ``gen`` (a generator on ``device``), in
    ``cfg.pdtype``, straight on the device."""
    return pm.init_params(lm_schema(cfg), gen, cfg.pdtype, resolve_device(device))


def n_params(cfg: ModelConfig) -> int:
    return pm.param_count(lm_schema(cfg))


# ----------------------------------------------------------------- fwd


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Returns (x, positions, n_prefix) where n_prefix = frontend positions
    carrying no next-token loss."""
    tok = embed(params["embed"], batch["tokens"], cfg)
    if cfg.frontend and "frontend" in batch:
        front = batch["frontend"].to(cfg.cdtype)
        x = torch.cat([front, tok], dim=1)
        n_prefix = front.shape[1]
    else:
        x, n_prefix = tok, 0
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    return x, pos, n_prefix


def hidden_states(params, batch, cfg: ModelConfig, attn_impl="auto"):
    """Full-sequence hidden states. Returns (h, n_prefix, aux, drop): the
    MoE aux loss and drop fraction (0-d f32 tensors, zero for a dense
    stack)."""
    x, pos, n_prefix = _embed_inputs(params, batch, cfg)
    x, aux, drop = tfm.apply_stack(params["stack"], x, pos, cfg, attn_impl=attn_impl)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), n_prefix, aux, drop


def _unembed_params(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return {"w_out": params["embed"]["table"].T}
    return params["unembed"]


def forward(params, batch, cfg: ModelConfig, attn_impl="auto"):
    """Full logits (B, S, V), n_prefix, aux and drop, as ``hidden_states``
    — small models only."""
    h, n_prefix, aux, drop = hidden_states(params, batch, cfg, attn_impl)
    return unembed(_unembed_params(params, cfg), h, cfg), n_prefix, aux, drop


# ------------------------------------------------------------- serving


def prefill(params, batch, cfg: ModelConfig, attn_impl="auto"):
    """Returns (last_token_logits (B, V), caches)."""
    x, pos, _ = _embed_inputs(params, batch, cfg)
    x, caches = tfm.prefill_stack(params["stack"], x, pos, cfg,
                                  attn_impl=attn_impl)
    h = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = unembed(_unembed_params(params, cfg), h, cfg)
    return logits[:, 0], caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    return tfm.init_stack_cache(cfg, batch, max_len, cfg.cdtype,
                                resolve_device(device))


def decode_step(params, token, pos: int, caches, cfg: ModelConfig, *, kv_len: int):
    """token: (B, 1) int; pos: int. Returns (logits (B, V), caches); the
    caches are updated in place."""
    x = embed(params["embed"], token, cfg)
    x, caches = tfm.decode_stack(params["stack"], x, caches, pos, cfg,
                                 kv_len=kv_len)
    h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(_unembed_params(params, cfg), h, cfg)
    return logits[:, 0], caches


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, batch, cfg: ModelConfig, n_steps: int, *,
             temperature: float = 0.0, gen: torch.Generator | None = None,
             timings: dict | None = None):
    """Greedy (temperature 0) or sampled generation: prefill, then
    n_steps - 1 decode steps. Returns (B, n_steps) tokens.

    Sampling draws from ``gen`` (a generator on the tokens' device). If
    ``timings`` is given, the device is synchronised at the phase
    boundaries and ``prefill_s`` and ``decode_s`` (host seconds) are written
    into it."""
    device = batch["tokens"].device
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch, cfg)
    start = batch["tokens"].shape[1] + (
        batch["frontend"].shape[1] if (cfg.frontend and "frontend" in batch)
        else 0)
    kv_len = start + n_steps

    # prefill caches have length `start` (or the SWA window); decode needs
    # room for n_steps more — grow along the time axis where applicable.
    caches = _grow_caches(caches, cfg, kv_len)

    def pick(logits):
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    toks = [pick(logits)]
    if timings is not None:
        _sync(device)
        t1 = time.perf_counter()
        timings["prefill_s"] = t1 - t0
    for i in range(n_steps - 1):
        logits, caches = decode_step(params, toks[-1][:, None], start + i,
                                     caches, cfg, kv_len=kv_len)
        toks.append(pick(logits))
    out = torch.stack(toks, dim=1)
    if timings is not None:
        _sync(device)
        timings["decode_s"] = time.perf_counter() - t1
    return out


def _grow_caches(caches, cfg: ModelConfig, kv_len: int):
    """Pad the attention caches along their time axis up to kv_len: axis 2
    of the stacked (L, B, S, K, D) caches, axis 1 of the unstacked
    (B, S, K, D) caches of dense prefix layers (no-op for rolling SWA
    windows already at full size)."""
    tgt = min(kv_len, cfg.sliding_window) if cfg.sliding_window else kv_len

    def grow(a, axis):
        s = a.shape[axis]
        if s >= tgt:
            return a
        out = a.new_zeros(a.shape[:axis] + (tgt,) + a.shape[axis + 1:])
        out.narrow(axis, 0, s).copy_(a)
        return out

    out = {"blocks": {k: grow(a, 2) for k, a in caches["blocks"].items()}}
    if "prefix" in caches:
        out["prefix"] = [{k: grow(a, 1) for k, a in c.items()} for c in caches["prefix"]]
    return out
