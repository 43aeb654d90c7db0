"""The port's MoE layer and MoE model against the JAX package's, on the CPU,
in f32.

Parameters are drawn by the JAX package's init and carried across through
numpy (``repro_torch.weights.from_jax_flat`` for whole models); inputs come
from numpy. ``moe_impl="gmm"`` runs the reference's Pallas grouped matmul
in interpret mode and the port's plain version, as tests/test_models.py
runs the reference. Logits and layer outputs are held to 1e-4 (absolute),
the aux loss to 1e-6, and the drop fraction must be equal: the GShard
bookkeeping is the reference's, so the same tokens are dropped.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten
from repro.common import param as jpm
from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe_gmm
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.weights import from_jax_flat

TOL, AUX_TOL = 1e-4, 1e-6
IMPLS = ["einsum", "gmm"]


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


@functools.lru_cache(maxsize=None)
def _layer_params(arch: str, seed: int):
    """One MoE layer's params, drawn by the reference and carried across."""
    jcfg = jax_get_config(arch).reduced()
    jp = jpm.init_params(jmoe.moe_schema(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jp, _to_torch(jp)


def _moe_pair(arch, seed, x, impl, group_size=1024, **over):
    """(port, reference) moe_apply outputs on the same params and input."""
    jcfg = jax_get_config(arch).reduced(moe_impl=impl, **over)
    jp, tp = _layer_params(arch, seed)
    jy, jaux, jdrop = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, group_size=group_size)
    ty, taux, tdrop = tmoe.moe_apply(tp, torch.from_numpy(x), _port_cfg(jcfg),
                                     group_size=group_size)
    return (ty, taux, tdrop), (jy, jaux, jdrop)


def _x(cfg_arch, shape, seed):
    d = jax_get_config(cfg_arch).reduced().d_model
    return np.random.default_rng(seed).standard_normal(shape + (d,), dtype=np.float32)


# ------------------------------------------------------------- moe_apply

# capacity factors: tight (drops tokens, rounding to 8 cannot hide the
# cap), the configs' default 1.25, and generous (drops none); group sizes:
# one group, and four groups of 32
MOE_CASES = [(0.26, 1024), (0.26, 32), (1.25, 1024), (1.25, 32), (8.0, 1024)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cf,group_size", MOE_CASES)
def test_moe_apply_matches_jax(cf, group_size, impl):
    x = _x("mixtral-8x22b", (2, 64), seed=int(cf * 100) + group_size)
    (ty, taux, tdrop), (jy, jaux, jdrop) = _moe_pair(
        "mixtral-8x22b", 0, x, impl, group_size=group_size, capacity_factor=cf)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert float(tdrop) == float(jdrop)
    if cf < 1:
        assert float(tdrop) > 0.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_with_shared_expert_matches_jax(cf, impl):
    """deepseek-v2 .reduced(): 8 routed experts, top-2 here, plus a shared
    expert added to every token (its full model needs MLA)."""
    jcfg = jax_get_config("deepseek-v2-236b").reduced()
    assert jcfg.n_shared_experts == 1 and "shared" in _layer_params("deepseek-v2-236b", 1)[1]
    x = _x("deepseek-v2-236b", (2, 16), seed=7)
    (ty, taux, tdrop), (jy, jaux, jdrop) = _moe_pair(
        "deepseek-v2-236b", 1, x, impl, capacity_factor=cf)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    assert float(tdrop) == float(jdrop)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_capacity_semantics(seed, impl):
    """The port's copy of tests/test_models.py::test_moe_capacity_semantics:
    a generous capacity drops nothing and matches the decode path; a tight
    one drops tokens (the residual carries them) and stays finite."""
    cfg = get_config("mixtral-8x22b").reduced(capacity_factor=8.0, moe_impl=impl)
    _, params = _layer_params("mixtral-8x22b", 3 + seed)
    x = torch.from_numpy(_x("mixtral-8x22b", (2, 8), seed))
    y, aux, drop = tmoe.moe_apply(params, x, cfg)
    assert y.shape == x.shape and float(drop) == 0.0 and float(aux) >= 0.0
    y2 = tmoe.moe_decode(params, x.reshape(16, 1, cfg.d_model), cfg)
    assert float((y2.reshape(2, 8, -1) - y).abs().max()) < 1e-4

    tight = cfg.replace(capacity_factor=0.26)
    x_big = torch.from_numpy(_x("mixtral-8x22b", (2, 64), seed + 10))
    yt, _, drop_t = tmoe.moe_apply(params, x_big, tight)
    assert 0.0 < float(drop_t) <= 1.0
    assert bool(torch.isfinite(yt).all())


# fixed (capacity factor, seed) cases over the range of the reference's
# property (cf in [0.3, 4.0], seed in [0, 5])
DROP_CASES = [(0.3, 0), (0.5, 1), (0.75, 2), (1.0, 3), (1.25, 4), (2.0, 5),
              (3.0, 0), (4.0, 1)]


@pytest.mark.parametrize("cf,seed", DROP_CASES)
def test_moe_drop_fraction_bounded(cf, seed):
    """The port's copy of tests/test_models.py::test_moe_drop_fraction_bounded
    on deepseek-v2 .reduced(), with the reference's drop fraction beside it."""
    x = _x("deepseek-v2-236b", (2, 16), seed + 20)
    (y, aux, drop), (_, _, jdrop) = _moe_pair("deepseek-v2-236b", seed, x, "einsum",
                                              capacity_factor=cf)
    assert 0.0 <= float(drop) < 1.0 and float(drop) == float(jdrop)
    assert bool(torch.isfinite(y).all()) and float(aux) >= 0.0


def test_capacity_matches_reference():
    for arch in ("mixtral-8x22b", "deepseek-v2-236b"):
        for cf in (0.01, 0.26, 1.0, 1.25, 8.0):
            jcfg = jax_get_config(arch).reduced(capacity_factor=cf)
            for group_len in (1, 7, 16, 64, 1024):
                cap = tmoe._capacity(group_len, _port_cfg(jcfg))
                assert cap == jmoe._capacity(group_len, jcfg)
                assert cap >= jcfg.top_k and (cap % 8 == 0 or cap == jcfg.top_k)


# ------------------------------------------------------------ full models

BATCH, PROMPT = 2, 32  # PROMPT a multiple of the reduced window (32)

# mixtral-8x22b .reduced() (4 MoE layers, window 32), with the generous
# capacity of tests/test_models.py's serving check, and with one dense
# prefix layer (first_dense_layers, as deepseek-v2 has)
CFGS = {
    "mixtral_reduced": {},
    "mixtral_reduced_cf8": dict(capacity_factor=8.0),
    "mixtral_reduced_dense_prefix": dict(first_dense_layers=1),
}


@functools.lru_cache(maxsize=None)
def _models(name: str, impl: str):
    """(jax cfg, jax params, port cfg, port params) sharing one init."""
    jcfg = jax_get_config("mixtral-8x22b").reduced(moe_impl=impl, **CFGS[name])
    tcfg = _port_cfg(jcfg)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return jcfg, jparams, tcfg, from_jax_flat(flat, tcfg, device="cpu")


def _tokens(cfg, seed, seq=PROMPT):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (BATCH, seq), dtype=np.int32)


@pytest.mark.parametrize("name", list(CFGS))
def test_weights_carry_moe_params_bit_for_bit(name):
    jcfg, jparams, tcfg, tparams = _models(name, "einsum")
    flat = _flatten(jparams)
    moe_keys = [k for k in flat if "::mlp::w_" in k and "blocks" in k]
    assert {k.rsplit("::", 1)[1] for k in moe_keys} == {"w_router", "w_gate", "w_up",
                                                         "w_down"}
    for key, arr in flat.items():
        node = tparams
        for part in key.split("::"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert tuple(node.shape) == arr.shape
        assert np.array_equal(node.numpy(), np.asarray(arr)), key
    assert tlm.n_params(tcfg) == jlm.n_params(jcfg)


def test_weights_carry_deepseek_moe_layer_with_shared_expert():
    """deepseek-v2 .reduced(): from_jax_flat carries the whole model; one
    layer's MoE params (shared expert included) give the reference's
    moe_apply output."""
    jcfg = jax_get_config("deepseek-v2-236b").reduced()
    tcfg = _port_cfg(jcfg)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(5))
    tparams = from_jax_flat({k: np.asarray(v) for k, v in _flatten(jparams).items()},
                            tcfg, device="cpu")
    jmlp = jax.tree.map(lambda a: a[0], jparams["stack"]["blocks"]["mlp"])
    tmlp = tfm._layer(tparams["stack"]["blocks"]["mlp"], 0)
    assert set(tmlp) == {"w_router", "w_gate", "w_up", "w_down", "shared"}
    x = _x("deepseek-v2-236b", (2, 16), seed=8)
    jy, jaux, jdrop = jmoe.moe_apply(jmlp, jnp.asarray(x), jcfg)
    ty, taux, tdrop = tmoe.moe_apply(tmlp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL and float(tdrop) == float(jdrop)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CFGS))
def test_forward_matches_jax(name, impl):
    jcfg, jparams, tcfg, tparams = _models(name, impl)
    toks = _tokens(jcfg, 1)
    jlogits, jn, jaux, jdrop = jlm.forward(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    tlogits, tn, taux, tdrop = tlm.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                           tcfg)
    assert tn == jn == 0 and tlogits.shape == (BATCH, PROMPT, tcfg.vocab_size)
    _close(tlogits, jlogits)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL and float(taux) > 0.0
    assert float(tdrop) == float(jdrop)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_steps_match_jax(name, impl):
    """Prefill logits and caches, then 3 decode steps (the einsum path with
    the decode capacity; the reduced window of 32 rolls), against the
    reference."""
    jcfg, jparams, tcfg, tparams = _models(name, impl)
    steps = 3
    toks = _tokens(jcfg, 3, PROMPT + steps)
    kv_len = PROMPT + steps
    jl, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jcfg)
    tl, tcache = tlm.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, tcfg)
    _close(tl, jl)
    assert set(tcache) == set(jcache)
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
        for tc, jc in zip(tcache.get("prefix", []), jcache.get("prefix", [])):
            _close(tc[kv], jc[kv])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(CFGS))
def test_generate_matches_jax(name, impl):
    jcfg, jparams, tcfg, tparams = _models(name, impl)
    toks = _tokens(jcfg, 10)
    jout = jlm.generate(jparams, {"tokens": jnp.asarray(toks)}, jcfg, n_steps=6)
    tout = tlm.generate(tparams, {"tokens": torch.from_numpy(toks)}, tcfg, n_steps=6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode_matches_forward(impl):
    """Serving path == full-sequence path, token by token, for mixtral —
    the port's copy of tests/test_models.py::test_prefill_decode_matches_forward,
    with its generous capacity for MoE archs."""
    _, _, cfg, params = _models("mixtral_reduced_cf8", impl)
    S, extra = PROMPT, 3
    toks = torch.from_numpy(_tokens(cfg, 4, S + extra))
    logits_full, _, _, drop = tlm.forward(params, {"tokens": toks}, cfg)
    assert float(drop) == 0.0
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


def test_decode_tokens_are_not_one_repeated_token():
    """Greedy decode of the reduced mixtral, which matches the reference
    token for token above, moves off its first token: a stuck decode loop
    would repeat it."""
    _, _, cfg, params = _models("mixtral_reduced", "gmm")
    out = tlm.generate(params, {"tokens": torch.from_numpy(_tokens(cfg, 11))}, cfg,
                       n_steps=8)
    assert any(len(set(row.tolist())) > 1 for row in out)


# ------------------------------------------------------------ entry points


def test_serve_cli_moe_impl_on_cpu():
    """--moe-impl gmm runs the expert products through the plain version on
    the CPU (no launch) and gives the einsum path's tokens; the default is
    the config's own moe_impl."""
    argv = ["--arch", "mixtral-8x22b", "--preset", "smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "32", "--new-tokens", "4"]
    before = moe_gmm.grouped_matmul.launches
    gmm_toks = serve.main(argv + ["--moe-impl", "gmm"])
    assert moe_gmm.grouped_matmul.launches == before
    assert torch.equal(gmm_toks, serve.main(argv + ["--moe-impl", "einsum"]))
    assert torch.equal(gmm_toks, serve.main(argv))
    assert get_config("mixtral-8x22b").moe_impl == "einsum"


def test_mla_stack_still_raises():
    cfg = get_config("deepseek-v2-236b").reduced()
    params = tlm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        tlm.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cfg)
