"""The port's dense LM against the JAX package, on the CPU, in f32.

Weights are drawn by the JAX package's init and carried across with
``repro_torch.weights.from_jax_flat``; token inputs come from numpy. Each
comparison is held to 1e-4 (absolute) in f32, the bound
``tests/test_models.py::test_prefill_decode_matches_forward`` uses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.weights import from_jax_flat

TOL = 1e-4
BATCH, PROMPT = 2, 16

# the tiny_dense_cfg fixture's shape (tests/conftest.py), yi-9b .reduced(),
# and reduced variants that group two query heads per kv head (as yi-9b's
# 32/4 does) and roll a sliding-window cache in decode
CFGS = {
    "tiny_dense": dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                       head_dim=16, d_ff=64, vocab_size=128),
    "yi9b_reduced": {},
    "yi9b_reduced_gqa": dict(n_kv_heads=2),
    "yi9b_reduced_gqa_swa": dict(n_kv_heads=2, sliding_window=8),
}


@functools.lru_cache(maxsize=None)
def _models(name: str, seed: int = 0):
    """(jax cfg, jax params, port cfg, port params) sharing one init."""
    jcfg = jax_get_config("yi-9b").reduced(**CFGS[name])
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jlm.init(jcfg, jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return jcfg, jparams, tcfg, from_jax_flat(flat, tcfg, device="cpu")


def _tokens(cfg, seed, seq=PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, seq), dtype=np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


def test_tiny_dense_shape_matches_fixture(tiny_dense_cfg):
    assert _models("tiny_dense")[0] == tiny_dense_cfg


@pytest.mark.parametrize("name", list(CFGS))
def test_forward_matches_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    toks = _tokens(jcfg, 1)
    jlogits, _, _, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tlogits, n_prefix, aux, drop = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                               tcfg)
    assert n_prefix == 0 and tlogits.shape == (BATCH, PROMPT, tcfg.vocab_size)
    assert float(aux) == 0.0 and float(drop) == 0.0
    _close(tlogits, jlogits)


@pytest.mark.parametrize("impls", [("pallas", "kernel"), ("full", "full")])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_matches_jax(name, impls):
    jimpl, timpl = impls
    jcfg, jparams, tcfg, tparams = _models(name)
    toks = _tokens(jcfg, 2)
    jlogits, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                  attn_impl=jimpl)
    tlogits, tcache = tlm.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcfg,
                                  attn_impl=timpl)
    _close(tlogits, jlogits)
    for kv in ("k", "v"):
        assert tcache["blocks"][kv].shape == jcache["blocks"][kv].shape
        _close(tcache["blocks"][kv], jcache["blocks"][kv])


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_steps_match_jax(name):
    jcfg, jparams, tcfg, tparams = _models(name)
    steps = 3
    toks = _tokens(jcfg, 3, PROMPT + steps)
    kv_len = PROMPT + steps
    _, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jcfg)
    _, tcache = tlm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, tcfg)
    jcache = jlm._grow_caches(jcache, jcfg, kv_len)
    tcache = tlm._grow_caches(tcache, tcfg, kv_len)
    for i in range(steps):
        pos = PROMPT + i
        tok = toks[:, pos][:, None]
        jl, jcache = jlm.decode_step(jparams, jnp.asarray(tok), pos, jcache, jcfg,
                                     kv_len=kv_len)
        tl, tcache = tlm.decode_step(tparams, torch.from_numpy(tok), pos, tcache, tcfg,
                                     kv_len=kv_len)
        _close(tl, jl)
    for kv in ("k", "v"):
        _close(tcache["blocks"][kv], jcache["blocks"][kv])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CFGS))
def test_generate_matches_jax(name, seed):
    jcfg, jparams, tcfg, tparams = _models(name, seed)
    toks = _tokens(jcfg, 10 + seed)
    jout = jlm.generate(jparams, {"tokens": jnp.asarray(toks)}, jcfg, n_steps=6)
    tout = tlm.generate(tparams, {"tokens": torch.from_numpy(toks)}, tcfg, n_steps=6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_decode_matches_forward(name):
    """Serving path == full-sequence path, token by token (caches, decode
    chaining, rolling SWA windows) — the port's copy of
    tests/test_models.py::test_prefill_decode_matches_forward."""
    _, _, cfg, params = _models(name)
    S, extra = PROMPT, 3  # a multiple of the SWA window, as prefill requires
    toks = torch.from_numpy(_tokens(cfg, 4, S + extra))
    logits_full, _, _, _ = tlm.forward(params, {"tokens": toks}, cfg)
    logits_p, caches = tlm.prefill(params, {"tokens": toks[:, :S]}, cfg)
    kv_len = S + extra
    caches = tlm._grow_caches(caches, cfg, kv_len)
    errs = [float((logits_p - logits_full[:, S - 1]).abs().max())]
    for i in range(extra):
        pos = S + i
        lg, caches = tlm.decode_step(params, toks[:, S + i][:, None], pos,
                                     caches, cfg, kv_len=kv_len)
        errs.append(float((lg - logits_full[:, pos]).abs().max()))
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layers_match_jax(seed):
    """rmsnorm, per-head rmsnorm, rope, swiglu, embed
    and the padded-vocab unembed slice-back, one by one."""
    rng = np.random.default_rng(seed)
    jcfg = jax_get_config("yi-9b").reduced(vocab_size=200)  # padded to 208
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    assert tcfg.padded_vocab == jcfg.padded_vocab == 208
    d, f, hd = jcfg.d_model, jcfg.d_ff, jcfg.resolved_head_dim
    x = rng.standard_normal((2, 5, d), dtype=np.float32)
    xh = rng.standard_normal((2, 5, 3, hd), dtype=np.float32)
    scale = rng.standard_normal((d,), dtype=np.float32)
    hscale = rng.standard_normal((hd,), dtype=np.float32)
    pos = rng.integers(0, 2048, (2, 5)).astype(np.int32)
    mlp = {k: rng.standard_normal(s, dtype=np.float32) * 0.1
           for k, s in (("w_gate", (d, f)), ("w_up", (d, f)), ("w_down", (f, d)))}
    table = rng.standard_normal((jcfg.padded_vocab, d), dtype=np.float32)
    w_out = rng.standard_normal((d, jcfg.padded_vocab), dtype=np.float32)
    ids = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    t = torch.from_numpy

    _close(tlayers.rmsnorm({"scale": t(scale)}, t(x)),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(tlayers.rmsnorm_heads(t(hscale), t(xh)),
           jlayers.rmsnorm_heads(jnp.asarray(hscale), jnp.asarray(xh)))
    _close(tlayers.apply_rope(t(xh), t(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6))
    _close(tlayers.swiglu({k: t(v) for k, v in mlp.items()}, t(x)),
           jlayers.swiglu({k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x)))
    _close(tlayers.embed({"table": t(table)}, t(ids), tcfg),
           jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(ids), jcfg), tol=0)
    tl = tlayers.unembed({"w_out": t(w_out)}, t(x), tcfg)
    assert tl.shape[-1] == tcfg.vocab_size == 200 and tl.dtype == torch.float32
    _close(tl, jlayers.unembed({"w_out": jnp.asarray(w_out)}, jnp.asarray(x), jcfg))


def test_sampled_generate_follows_the_generator():
    """temperature > 0 draws from the caller's torch.Generator: the same
    seed gives the same tokens, and every token is in the vocabulary."""
    _, _, cfg, params = _models("yi9b_reduced_gqa")
    toks = torch.from_numpy(_tokens(cfg, 5))

    def run(seed):
        return tlm.generate(params, {"tokens": toks}, cfg, n_steps=5, temperature=1.0,
                            gen=torch.Generator().manual_seed(seed))

    a, b = run(0), run(0)
    assert a.shape == (BATCH, 5) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size
    assert not all(torch.equal(a, run(s)) for s in range(1, 4))
