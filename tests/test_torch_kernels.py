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
from repro_torch.kernels import flash_attention as tfa
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
    by_variant = dict(moe_gmm.grouped_matmul.launches_by_variant)
    expected = dict.fromkeys(by_variant, 0)
    for (e, t, d, f), exp in zip(shapes, exps):
        x, w = (torch.from_numpy(a).cuda().to(dtype) for a in _gmm_inputs(e, t, d, f, seed=3))
        out = tops.grouped_matmul(x, w)
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        assert (out.float() - exp.float()).abs().max().item() <= tol * d
        if dtype == torch.float32:
            expected[moe_gmm.F32] += 1
        else:  # contiguous inputs: TMA describes them when D and F are multiples of 8
            expected[moe_gmm.WGMMA if d % 8 == 0 and f % 8 == 0 else moe_gmm.MMA_SYNC] += 1
    assert moe_gmm.grouped_matmul.launches == before + len(shapes)
    assert {k: moe_gmm.grouped_matmul.launches_by_variant[k] - by_variant[k]
            for k in by_variant} == expected


@pytest.mark.cuda
def test_flash_attention_cuda_tensors_always_launch_the_kernel(card, monkeypatch):
    """Every swept shape launches a kernel on the card, the one the variant
    rule names (the wgmma kernel for bf16 with head dim 64 or 128); the
    plain version is never reached."""
    cases = [(c, dt) for c in SWEEP for dt in (torch.float32, torch.bfloat16)]
    inputs = [tuple(torch.from_numpy(a).cuda().to(dt) for a in _qkv(*c[:6], seed=3))
              for c, dt in cases]
    exps = [tref.flash_attention_ref(*qkv, causal=c[6], window=c[7])
            for (c, _), qkv in zip(cases, inputs)]

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tref, "flash_attention_ref", refuse)
    before = flash_attention_bhsd.launches
    by_variant = dict(flash_attention_bhsd.launches_by_variant)
    expected = dict.fromkeys(by_variant, 0)
    for ((b, h, kk, sq, skv, d, causal, window), dt), qkv, exp in zip(cases, inputs, exps):
        out = tops.flash_attention(*qkv, causal=causal, window=window)
        tol = DTYPES[str(dt).replace("torch.", "")][2]
        assert torch.allclose(out.float(), exp.float(), atol=tol, rtol=tol)
        wgmma = dt == torch.bfloat16 and d in tfa.WGMMA_HEAD_DIMS
        expected[tfa.WGMMA if wgmma else tfa.CUDA_CORES] += 1
    assert flash_attention_bhsd.launches == before + len(cases)
    assert {k: flash_attention_bhsd.launches_by_variant[k] - by_variant[k]
            for k in by_variant} == expected


# --------------------------------------------------- the choice of variant

def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("product,x_shape,w_shape", [
    ("gate", (8, 1312, 6144), (8, 6144, 16384)),
    ("up", (8, 1312, 6144), (8, 6144, 16384)),
    ("down", (8, 1312, 16384), (8, 16384, 6144)),
])
def test_gmm_variant_takes_wgmma_for_mixtrals_prefill_products(product, x_shape, w_shape):
    """mixtral-8x22b's three expert products at batch 8 x 512 (4 groups of
    1024 tokens at capacity 328), as models/moe.py passes them."""
    assert moe_gmm.variant(_meta(x_shape), _meta(w_shape)) == moe_gmm.WGMMA


@pytest.mark.parametrize("x,w,expected", [
    # the ragged sweep shape whose D and F are multiples of 8: TMA describes
    # it, and the wgmma kernel masks its ragged T, D and F tiles
    (lambda: _meta((3, 100, 72)), lambda: _meta((3, 72, 40)), moe_gmm.WGMMA),
    # rows of 100 and 26 bytes: no TMA
    (lambda: _meta((2, 37, 50)), lambda: _meta((2, 50, 13)), moe_gmm.MMA_SYNC),
    # F not a multiple of 8: the output's rows are not 16-byte aligned
    (lambda: _meta((2, 64, 64)), lambda: _meta((2, 64, 16))[:, :, :12], moe_gmm.MMA_SYNC),
    # a view whose base is one element past a 16-byte boundary
    (lambda: _meta((8, 1312, 6152))[:, :, 1:6145], lambda: _meta((8, 6144, 16384)),
     moe_gmm.MMA_SYNC),
    # D = 0: nothing for TMA to load; the earlier kernel writes the zeros
    (lambda: _meta((2, 16, 0)), lambda: _meta((2, 0, 16)), moe_gmm.MMA_SYNC),
    # f32 stays on the CUDA cores
    (lambda: _meta((8, 1312, 6144), torch.float32),
     lambda: _meta((8, 6144, 16384), torch.float32), moe_gmm.F32),
    (lambda: _meta((2, 37, 50), torch.float32), lambda: _meta((2, 50, 13), torch.float32),
     moe_gmm.F32),
])
def test_gmm_variant_by_type_and_layout(x, w, expected):
    assert moe_gmm.variant(x(), w()) == expected


@pytest.mark.parametrize("arch,b,h,kk,d", [
    ("yi-9b", 8, 32, 4, 128),
    ("mixtral-8x22b", 8, 48, 8, 128),
])
def test_fa_variant_takes_wgmma_at_the_serving_shapes(arch, b, h, kk, d):
    """The prefill shapes of both served models, as ops.flash_attention
    passes them: BSHD tensors read through BHSD views."""
    q = _meta((b, 512, h, d)).transpose(1, 2)
    k, v = (_meta((b, 512, kk, d)).transpose(1, 2) for _ in range(2))
    assert tfa.variant(q, k, v) == tfa.WGMMA


@pytest.mark.parametrize("dtype,d,misaligned,expected", [
    (torch.bfloat16, 64, False, tfa.WGMMA),
    (torch.float32, 128, False, tfa.CUDA_CORES),
    (torch.float32, 64, False, tfa.CUDA_CORES),
    (torch.bfloat16, 32, False, tfa.CUDA_CORES),
    (torch.bfloat16, 16, False, tfa.CUDA_CORES),
    (torch.bfloat16, 128, True, tfa.CUDA_CORES),
])
def test_fa_variant_by_type_head_dim_and_layout(dtype, d, misaligned, expected):
    q = _meta((2, 128, 4, d), dtype).transpose(1, 2)
    k = _meta((2, 128, 2, d), dtype).transpose(1, 2)
    v = _meta((2, 128, 2, d + 1), dtype)[..., 1:].transpose(1, 2) if misaligned else k
    assert tfa.variant(q, k, v) == expected


def test_fa_variant_needs_a_key():
    q = _meta((1, 16, 2, 128)).transpose(1, 2)
    k = _meta((1, 0, 2, 128)).transpose(1, 2)
    assert tfa.variant(q, k, k) == tfa.CUDA_CORES
