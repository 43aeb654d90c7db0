"""The port's flash attention and grouped matmul against the JAX
package's, on the CPU.

On the CPU, ``repro_torch.kernels.ops`` runs each kernel's plain version;
``repro.kernels.ops`` runs the Pallas kernels in interpret mode, as
tests/test_kernels.py runs them. The shapes and the tolerances are those
of tests/test_kernels.py::test_flash_attention_sweep (2e-5 in f32, 2e-2 in
bf16) and ::test_grouped_matmul_sweep (1e-4 * d in f32, 5e-2 * d in bf16).
The CUDA kernels themselves run only on the card (tests marked ``cuda``),
where chip_smoke.py holds them against the same plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels._build import KernelError
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


# ------------------------------------------------------------ grouped matmul

GMM_SWEEP = [(4, 64, 32, 48), (2, 128, 128, 128), (8, 16, 64, 8), (1, 256, 512, 128)]
# no dim a multiple of 8: the reference's wrapper sends these to its oracle
GMM_RAGGED = [(3, 100, 72, 40), (2, 37, 50, 13)]
GMM_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
              "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _gmm_inputs(e, t, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((e, t, d), dtype=np.float32),
            rng.standard_normal((e, d, f), dtype=np.float32))


@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
@pytest.mark.parametrize("e,t,d,f", GMM_SWEEP)
def test_grouped_matmul_matches_jax(e, t, d, f, dtype):
    """The port's CPU path against the reference's Pallas kernel
    (interpret mode) on its sweep."""
    jdt, tdt, tol = GMM_DTYPES[dtype]
    x, w = _gmm_inputs(e, t, d, f, seed=e * 13 + d)
    exp = jops.grouped_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    out = tops.grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert out.dtype == tdt and out.shape == (e, t, f)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               atol=tol * d, rtol=tol)


@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
@pytest.mark.parametrize("e,t,d,f", GMM_RAGGED)
def test_grouped_matmul_ragged_matches_reference_oracle(e, t, d, f, dtype):
    jdt, tdt, tol = GMM_DTYPES[dtype]
    x, w = _gmm_inputs(e, t, d, f, seed=t)
    exp = jref.grouped_matmul_ref(jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32))
    out = tops.grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                              sizes=torch.full((e,), t))
    assert out.dtype == tdt and out.shape == (e, t, f)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp), atol=tol * d, rtol=tol)


def test_grouped_matmul_plain_version_accumulates_in_f32_and_rounds_once():
    """bf16 inputs: the plain version sums the bf16 products in f32 and
    rounds once to bf16, as the TPU kernel's f32 scratch tile does, so it
    is within one rounding (2**-8 relative) of the exact sums; a bf16
    accumulator over 300 terms would be far off."""
    x, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _gmm_inputs(2, 24, 300, 16, 1))
    out = tref.grouped_matmul_ref(x, w)
    exp = np.einsum("etd,edf->etf", x.double().numpy(), w.double().numpy())
    assert out.dtype == torch.bfloat16
    err = np.abs(out.double().numpy() - exp)
    assert (err <= 2.0**-8 * np.abs(exp) + 1e-5).all(), err.max()


def test_grouped_matmul_cpu_tensors_take_the_plain_version():
    x, w = (torch.from_numpy(a) for a in _gmm_inputs(2, 8, 16, 8, 0))
    before = moe_gmm.grouped_matmul.launches
    tops.grouped_matmul(x, w)
    assert moe_gmm.grouped_matmul.launches == before


def test_grouped_matmul_kernel_refuses_cpu_tensors():
    x, w = (torch.from_numpy(a) for a in _gmm_inputs(2, 8, 16, 8, 0))
    before = moe_gmm.grouped_matmul.launches
    with pytest.raises(KernelError, match="CUDA"):
        moe_gmm.grouped_matmul(x, w)
    assert moe_gmm.grouped_matmul.launches == before


def test_grouped_matmul_gradient_raises_until_training_slice():
    x, w = (torch.from_numpy(a).requires_grad_() for a in _gmm_inputs(2, 8, 16, 8, 0))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.grouped_matmul(x, w)
    with torch.no_grad():
        assert tops.grouped_matmul(x, w).shape == (2, 8, 8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this kernel on the H100")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_cuda_tensors_always_launch_the_kernel(card, dtype, monkeypatch):
    """Every shape, ragged ones included, launches the kernel on the card;
    the plain version is never reached."""
    shapes = GMM_SWEEP + GMM_RAGGED
    exps = [tref.grouped_matmul_ref(*(torch.from_numpy(a).cuda().to(dtype)
                                      for a in _gmm_inputs(*s, seed=3))) for s in shapes]

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tref, "grouped_matmul_ref", refuse)
    before = moe_gmm.grouped_matmul.launches
    for (e, t, d, f), exp in zip(shapes, exps):
        x, w = (torch.from_numpy(a).cuda().to(dtype) for a in _gmm_inputs(e, t, d, f, seed=3))
        out = tops.grouped_matmul(x, w)
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        assert (out.float() - exp.float()).abs().max().item() <= tol * d
    assert moe_gmm.grouped_matmul.launches == before + len(shapes)
