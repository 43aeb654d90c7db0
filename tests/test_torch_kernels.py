"""The port's flash attention against the JAX package's, on the CPU.

On the CPU, ``repro_torch.kernels.ops.flash_attention`` runs its plain
version; ``repro.kernels.ops.flash_attention`` runs the Pallas kernel in
interpret mode, as tests/test_kernels.py runs it. The shapes and the
tolerances (2e-5 in f32, 2e-2 in bf16) are those of
tests/test_kernels.py::test_flash_attention_sweep. The CUDA kernel itself
runs only on the card, where chip_smoke.py holds it against the same plain
version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attention import flash_attention_bhsd

SWEEP = [
    (2, 4, 2, 128, 128, 64, True, 0),     # GQA causal prefill
    (1, 2, 2, 256, 256, 32, True, 64),    # sliding window
    (2, 4, 4, 128, 128, 16, False, 0),    # MHA bidirectional (encoder)
    (1, 8, 2, 128, 384, 64, True, 0),     # decode-style, Sq < Skv
    (1, 2, 1, 64, 64, 128, True, 0),      # MQA
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(b, h, kk, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, kk, d), dtype=np.float32),
            rng.standard_normal((b, skv, kk, d), dtype=np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kk,sq,skv,d,causal,window", SWEEP)
def test_flash_attention_matches_jax(b, h, kk, sq, skv, d, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(b, h, kk, sq, skv, d, seed=b * 7 + h)
    exp = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               causal=causal, window=window)
    out = tops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               causal=causal, window=window)
    assert out.dtype == tdt and out.shape == (b, sq, h, d)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 16, seed=0))
    before = flash_attention_bhsd.launches
    tops.flash_attention(q, k, v)
    assert flash_attention_bhsd.launches == before


def test_kernel_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in _qkv(1, 4, 2, 8, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bhsd(q, k, v)


def test_gradient_raises_until_training_slice():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 2, 1, 8, 8, 16, seed=0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.flash_attention(q, k, v)
