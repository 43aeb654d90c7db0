import os
import sys

# tests must see the single real CPU device (the dry-run sets its own flags
# in a separate process); keep any user XLA_FLAGS out of the picture.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# ---------------------------------------------------------------------------
# Optional-dependency shim: if `hypothesis` is absent, install a tiny
# deterministic stand-in covering the subset this suite uses
# (given/settings + integers/floats/sampled_from/booleans), so every test
# module collects and property tests still run over seeded random samples.
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def example_from(self, rng):
            return self._draw(rng)

    def _integers(min_value=-2**31, max_value=2**31):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def _floats(min_value=None, max_value=None, allow_nan=True):
        lo = -1e9 if min_value is None else min_value
        hi = 1e9 if max_value is None else max_value
        return _Strategy(lambda rng: rng.uniform(lo, hi))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def _booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def _none():
        return _Strategy(lambda rng: None)

    def _text(max_size=20, **_kw):
        alphabet = "abc XYZ09_é世"
        return _Strategy(lambda rng: "".join(
            rng.choice(alphabet) for _ in range(rng.randint(0, max_size))))

    def _one_of(*strategies):
        return _Strategy(
            lambda rng: rng.choice(strategies).example_from(rng))

    def _lists(elements, min_size=0, max_size=10, **_kw):
        return _Strategy(lambda rng: [
            elements.example_from(rng)
            for _ in range(rng.randint(min_size, max_size))])

    def _tuples(*strategies):
        return _Strategy(lambda rng: tuple(s.example_from(rng)
                                           for s in strategies))

    def _settings(**kwargs):
        def deco(fn):
            fn._shim_settings = dict(kwargs)
            return fn
        return deco

    def _given(*arg_strategies, **strategies):
        def deco(fn):
            max_examples = getattr(fn, "_shim_settings",
                                   {}).get("max_examples", 10)

            def wrapper(*args, **kwargs):
                rng = random.Random(0xF11A7)
                for _ in range(max_examples):
                    pos = tuple(s.example_from(rng) for s in arg_strategies)
                    drawn = {name: s.example_from(rng)
                             for name, s in strategies.items()}
                    fn(*args, *pos, **dict(kwargs, **drawn))
            # plain (*args, **kwargs) signature on purpose: pytest must not
            # mistake the strategy kwargs for fixtures
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    _mod = types.ModuleType("hypothesis")
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _st.booleans = _booleans
    _st.none = _none
    _st.text = _text
    _st.one_of = _one_of
    _st.lists = _lists
    _st.tuples = _tuples
    _mod.given = _given
    _mod.settings = _settings
    _mod.strategies = _st
    sys.modules["hypothesis"] = _mod
    sys.modules["hypothesis.strategies"] = _st
# ---------------------------------------------------------------------------

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

import pytest  # noqa: E402

from repro.configs import get_config  # noqa: E402

ALL_ARCHS = [
    "xlstm-350m", "pixtral-12b", "zamba2-7b", "codeqwen1.5-7b",
    "command-r-plus-104b", "qwen3-14b", "yi-9b", "seamless-m4t-large-v2",
    "deepseek-v2-236b", "mixtral-8x22b",
]


@pytest.fixture(scope="session")
def tiny_dense_cfg():
    return get_config("yi-9b").reduced(n_layers=2, d_model=32, n_heads=2,
                                       n_kv_heads=2, head_dim=16, d_ff=64,
                                       vocab_size=128)


def make_batch(cfg, key, batch=2, seq=16):
    import jax.numpy as jnp  # noqa: F401
    out = {"tokens": jax.random.randint(key, (batch, seq), 0,
                                        cfg.vocab_size)}
    if cfg.frontend == "vision":
        out["frontend"] = jax.random.normal(
            key, (batch, cfg.frontend_len, cfg.d_model))
    if cfg.is_enc_dec:
        out["enc_embeds"] = jax.random.normal(key, (batch, 8, cfg.d_model))
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
