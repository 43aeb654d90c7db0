"""The port's configs and parameter schemas against the JAX package's."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.manager import _flatten
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.common import param as pm
from repro_torch.models import lm as tlm

ARCHS = jconfigs.ARCHS


def _assert_same(tcfg, jcfg):
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("padded_vocab", "resolved_head_dim", "resolved_v_head_dim",
                 "is_enc_dec"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    assert tcfg.pdtype == getattr(torch, jcfg.param_dtype)
    assert tcfg.cdtype == getattr(torch, jcfg.compute_dtype)


def test_registry_matches():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, s in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(s)
        assert tconfigs.SHAPES[name].tokens == s.tokens
    assert dataclasses.asdict(tconfigs.TrainConfig()) == \
        dataclasses.asdict(jconfigs.TrainConfig())
    assert tconfigs.canonical("yi-9b") == "yi_9b"
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch):
    _assert_same(tconfigs.get_config(arch), jconfigs.get_config(arch))
    _assert_same(tconfigs.get_config(arch).reduced(),
                 jconfigs.get_config(arch).reduced())
    _assert_same(tconfigs.get_config(arch).reduced(n_kv_heads=2, vocab_size=200),
                 jconfigs.get_config(arch).reduced(n_kv_heads=2, vocab_size=200))


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_and_schema_match(arch):
    """Counted from the schemas alone: nothing is allocated."""
    for reduce in (False, True):
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        if reduce:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        assert tlm.n_params(tcfg) == jlm.n_params(jcfg)
        jflat = _flatten(jlm.lm_schema(jcfg))
        tflat = pm.flat_keys(tlm.lm_schema(tcfg))
        assert list(tflat) == list(jflat)
        for key, p in tflat.items():
            assert dataclasses.astuple(p) == dataclasses.astuple(jflat[key]), key


def test_yi9b_full_width():
    cfg = tconfigs.get_config("yi-9b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab) == (48, 4096, 32, 4, 11008, 64000, 65536)
    assert cfg.pdtype == cfg.cdtype == torch.bfloat16
    assert 8.8e9 < tlm.n_params(cfg) < 8.9e9


@pytest.mark.parametrize("seed", [0, 1])
def test_init_params_rules(seed):
    """Init rules of repro.common.param._init_one: std 1/sqrt(fan_in),
    0.02 for embeddings, explicit scales, zeros and ones — drawn from the
    generator, in the target dtype."""
    schema = {"w": pm.P((256, 512), (None, None)),
              "stacked": pm.stack_schema({"w": pm.P((128, 64), (None, None))}, 3),
              "emb": pm.P((512, 64), (None, None), "embed"),
              "s": pm.P((4096,), (None,), scale=0.5),
              "z": pm.P((7,), (None,), "zeros"), "o": pm.P((7,), (None,), "ones"),
              "prefix": [{"b": pm.P((3,), (None,), "zeros")}]}
    gen = torch.Generator().manual_seed(seed)
    params = pm.init_params(schema, gen, torch.float32, "cpu")
    assert params["stacked"]["w"].shape == (3, 128, 64)
    for got, std in ((params["w"], 1 / math.sqrt(256)),
                     (params["stacked"]["w"], 1 / math.sqrt(3 * 128)),
                     (params["emb"], 0.02), (params["s"], 0.5)):
        assert abs(float(got.std()) / std - 1) < 0.05
    assert not params["z"].any() and bool((params["o"] == 1).all())
    assert params["prefix"][0]["b"].shape == (3,)
    again = pm.init_params(schema, torch.Generator().manual_seed(seed), torch.float32, "cpu")
    assert torch.equal(again["w"], params["w"])
    bf = pm.init_params(schema, torch.Generator().manual_seed(seed), torch.bfloat16, "cpu")
    assert bf["w"].dtype == torch.bfloat16
    assert pm.param_count(schema) == sum(
        int(np.prod(p.shape)) for p in pm.flat_keys(schema).values())


def _tiny_flat(param_dtype):
    jcfg = jconfigs.get_config("yi-9b").reduced(n_layers=2, d_model=32, head_dim=8,
                                                param_dtype=param_dtype)
    flat = {k: np.asarray(v) for k, v in _flatten(jlm.init(jcfg, jax.random.PRNGKey(0))).items()}
    return flat, tconfigs.get_config("yi-9b").reduced(n_layers=2, d_model=32, head_dim=8,
                                                       param_dtype=param_dtype)


def test_from_jax_flat_carries_bf16_bits():
    from repro_torch.weights import from_jax_flat
    flat, cfg = _tiny_flat("bfloat16")
    params = from_jax_flat(flat, cfg, device="cpu")
    for key, arr in flat.items():
        leaf = params
        for part in key.split("::"):
            leaf = leaf[part]
        assert leaf.dtype == torch.bfloat16, key
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      arr.view(np.int16), err_msg=key)


def test_from_jax_flat_rejects_missing_extra_and_misshaped():
    from repro_torch.weights import from_jax_flat
    flat, cfg = _tiny_flat("float32")
    missing = dict(flat)
    del missing["ln_f::scale"]
    with pytest.raises(KeyError, match="ln_f::scale"):
        from_jax_flat(missing, cfg, device="cpu")
    with pytest.raises(KeyError, match="extra"):
        from_jax_flat(dict(flat, bogus=np.zeros(1)), cfg, device="cpu")
    bad = dict(flat)
    bad["ln_f::scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="ln_f::scale"):
        from_jax_flat(bad, cfg, device="cpu")
