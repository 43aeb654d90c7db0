"""The port's bucket_reduce and grouped_reduce against the JAX package's, on
the CPU, and the shared build helper that binds the CUDA kernels.

On the CPU, ``repro_torch.kernels.ops.bucket_reduce`` runs its plain
version (``ref.bucket_reduce_ref``); ``repro.kernels.ops.bucket_reduce``
runs the Pallas kernel in interpret mode, as tests/test_kernels.py runs it.
Inputs are drawn with numpy from fixed seeds and handed to both. The sweep
and its tolerance (atol 1e-4 in f32, mass preserved) are those of
tests/test_kernels.py::test_bucket_reduce_property, with padding (-1) and
out-of-range ids added; ``grouped_reduce`` must give the same bits as the
reference's on every envelope of benchmarks/kernels_bench.py. The CUDA
kernel itself runs only on the card (marked ``cuda``), where
chip_smoke.py holds it against the same plain version.
"""

import pathlib
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import bucket_reduce as br
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SWEEP = [(1, 4, 8), (37, 16, 64), (255, 33, 8), (256, 4, 64), (513, 16, 8),
         (700, 33, 64), (699, 4, 8), (128, 33, 64)]


def _inputs(n, p, d, seed):
    """f32 values and int32 ids in [0, p), about a tenth of them -1
    (padding) or p + 3 (out of range)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d), dtype=np.float32)
    ids = rng.integers(0, p, n).astype(np.int32)
    u = rng.random(n)
    ids[u < 0.05] = -1
    ids[(u >= 0.05) & (u < 0.1)] = p + 3
    return vals, ids


@pytest.mark.parametrize("n,p,d", SWEEP)
def test_bucket_reduce_matches_jax(n, p, d):
    vals, ids = _inputs(n, p, d, seed=n * 7 + p)
    exp = np.asarray(jops.bucket_reduce(jnp.asarray(vals), jnp.asarray(ids), p,
                                        interpret=True))
    oracle = np.asarray(jref.bucket_reduce_ref(jnp.asarray(vals), jnp.asarray(ids), p))
    out = tops.bucket_reduce(torch.from_numpy(vals), torch.from_numpy(ids), p)
    assert out.dtype == torch.float32 and out.shape == (p, d)
    np.testing.assert_allclose(out.numpy(), exp, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), oracle, atol=1e-4)
    keep = (ids >= 0) & (ids < p)
    np.testing.assert_allclose(out.numpy().sum(0), vals[keep].sum(0), atol=1e-3)


@pytest.mark.parametrize("n,p,d", [(300, 16, 8), (700, 33, 64)])
def test_bucket_reduce_bf16_matches_jax(n, p, d):
    """bf16 values accumulate in f32 and round once, as the JAX oracle
    does."""
    vals, ids = _inputs(n, p, d, seed=3)
    vb = jnp.asarray(vals, jnp.bfloat16)
    exp = np.asarray(jref.bucket_reduce_ref(vb, jnp.asarray(ids), p), np.float32)
    tv = torch.from_numpy(vals).to(torch.bfloat16)
    out = tops.bucket_reduce(tv, torch.from_numpy(ids), p)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), exp, atol=1e-2, rtol=2.0**-6)


def _fold(vals, ids, p):
    acc = [0] * p
    for i, v in zip(ids.tolist(), vals.tolist()):
        if 0 <= i < p:
            acc[i] += v
    return acc


def _envelope_cases():
    """The four envelope cases of benchmarks/kernels_bench.py (kernel,
    int64, refused, empty), then int64 gids from the engine and a
    high-cardinality key (70,000 groups) in both envelopes."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 16, size=500)
    wide = rng.integers(0, 70_000, size=1500)
    return {
        "small": (rng.integers(-50, 50, size=500), ids, 16),
        "x64": (rng.integers(-2**40, 2**40, size=500), ids, 16),
        "over": (np.array([2**62, 2**62], dtype=np.int64), np.array([0, 0]), 1),
        "empty": (np.array([], dtype=np.int64), np.array([], dtype=np.int64), 4),
        "int64_gids": (rng.integers(0, 3000, size=800),
                       rng.integers(0, 24, size=800).astype(np.int64), 24),
        "p70000_small": (rng.integers(-9, 9, size=1500), wide, 70_000),
        "p70000_x64": (rng.integers(-2**45, 2**45, size=1500), wide, 70_000),
    }


def _jax_grouped_reduce(vals, ids, p):
    """The JAX package's grouped_reduce. Its int64 envelope
    (src/repro/kernels/ops.py:111) imports ``jax.experimental.enable_x64``,
    which the installed JAX no longer has, so for that envelope this runs
    the same x64 ``segment_sum`` through ``jax.enable_x64``."""
    abs_sum = float(np.abs(np.asarray(vals, np.int64)).astype(np.float64).sum())
    if len(vals) == 0 or abs_sum < float(2**24) or abs_sum > float(2**62):
        return jops.grouped_reduce(vals, ids, p, interpret=True)
    with jax.enable_x64(True):
        seg = jax.ops.segment_sum(jnp.asarray(vals, dtype=jnp.int64),
                                  jnp.asarray(ids, dtype=jnp.int32), num_segments=p)
        return np.asarray(seg, dtype=np.int64)


@pytest.mark.parametrize("case", list(_envelope_cases()))
def test_grouped_reduce_bit_identical_to_jax(case):
    vals, ids, p = _envelope_cases()[case]
    exp = _jax_grouped_reduce(vals, ids, p)
    before = tops.grouped_reduce.folds
    got = tops.grouped_reduce(vals, ids, p, device="cpu")
    if exp is None:
        assert got is None and tops.grouped_reduce.folds == before
        return
    assert got.dtype == np.int64 and got.shape == (p,)
    assert got.tobytes() == np.asarray(exp, np.int64).tobytes()
    assert got.tolist() == _fold(vals, ids, p)
    assert tops.grouped_reduce.folds == before + 1


@pytest.mark.parametrize("n,d,p,acc", [(8192, 1, 24, 4), (8192, 1, 24, 8), (1, 1, 1, 4),
                                       (700, 64, 33, 4), (4_194_304, 64, 4096, 4),
                                       (50_000, 1, 70_000, 8), (3, 200, 5, 4)])
def test_plan_covers_the_input_within_bounds(n, d, p, acc):
    """The tiling the wrapper hands the kernel: every row, bucket and
    column in some block; the lane partials inside the shared-memory
    budget; row chunks taken from the SM count, so the scratch stays
    bounded whatever N is."""
    pl = br.plan(n, d, p, acc, sms=132)
    assert pl.chunks * pl.rows_per_chunk >= n > (pl.chunks - 1) * pl.rows_per_chunk
    assert pl.p_tiles * pl.pt >= p and pl.d_tiles * pl.dt >= d
    assert br.NT % pl.dt == 0 and br.NT * pl.pt * acc <= br.SMEM_BUDGET
    assert pl.chunks <= max(1, -(-br.BLOCKS_PER_SM * 132 // (pl.p_tiles * pl.d_tiles)))
    assert pl.chunks <= br.MAX_GRID_Y


def test_kernel_refuses_cpu_tensors():
    vals, ids = _inputs(16, 4, 8, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        br.bucket_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 4)


def test_cpu_tensors_take_the_plain_version():
    vals, ids = _inputs(64, 4, 8, seed=1)
    before = br.bucket_reduce.launches
    tops.bucket_reduce(torch.from_numpy(vals), torch.from_numpy(ids), 4)
    tops.grouped_reduce(np.arange(64), ids, 4, device="cpu")
    assert br.bucket_reduce.launches == before


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_grouped_reduce_turns_every_device_fault_into_kernel_error(device, monkeypatch):
    """A fault while the kernel runs shows at the read-back, an
    out-of-memory error at a copy, as torch's RuntimeError; grouped_reduce
    raises each as KernelError, so the engine cannot rerun the fold on
    another path. Without a card the copy to "cuda" is what fails."""
    def fault(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tops, "bucket_reduce", fault)
    before = tops.grouped_reduce.folds
    with pytest.raises(_build.KernelError, match=f"grouped_reduce on {device} failed"):
        tops.grouped_reduce(np.arange(64), np.arange(64) % 4, 4, device=device)
    assert tops.grouped_reduce.folds == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this kernel on the H100")


@pytest.mark.cuda
def test_cuda_tensors_never_reach_the_plain_version(card, monkeypatch):
    vals, ids = _inputs(700, 33, 64, seed=5)
    tv, ti = torch.from_numpy(vals).cuda(), torch.from_numpy(ids).cuda()
    exp = tref.bucket_reduce_ref(tv, ti, 33)

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tref, "bucket_reduce_ref", refuse)
    before = br.bucket_reduce.launches
    out = tops.bucket_reduce(tv, ti, 33)
    again = tops.bucket_reduce(tv, ti, 33)
    got = tops.grouped_reduce(np.arange(700) % 50, ids, 33, device="cuda")
    assert br.bucket_reduce.launches == before + 3
    assert torch.equal(out, again)
    assert (out - exp).abs().max().item() <= 1e-4
    assert got.tolist() == _fold(np.arange(700) % 50, ids, 33)


# ------------------------------------------------------- the build helper


def test_launch_counts_are_not_lost_across_threads():
    """More threads than cores bump one count with a tiny switch interval:
    a read-modify-write without the lock would lose updates."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(wrapper)
                                                    for _ in range(2000)])
                   for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 32 * 2000


def test_library_is_built_and_loaded_once_across_threads(monkeypatch, tmp_path):
    builds, binds = [], []

    def fake_build(*names):
        builds.append(names)
        time.sleep(0.05)  # a slow compile: other threads arrive meanwhile
        return [tmp_path / f"{n}.so" for n in names]

    class FakeLib:
        def __init__(self, path):
            self.repro_cuda_error_string = type("Fn", (), {})()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(_build, "_LIBS", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        _build.load("fake", binds.append))) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert builds == [("fake",)] and len(binds) == 1
    assert len(got) == 16 and all(lib is got[0] for lib in got)


_FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
text = open(src).read()
if "FAIL" in text:
    print("error: bad source " + src)
    sys.exit(2)
open(out, "w").write("lib of " + src)
print("ptxas info    : Used 32 registers")
"""


def test_build_compiles_each_source_once_and_reports_failures(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a")
    (csrc / "b.cu").write_text("// b")
    (csrc / "bad.cu").write_text("// FAIL")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    a, b = _build.build("a", "b")
    assert a.read_text().endswith("a.cu") and b.read_text().endswith("b.cu")
    assert "registers" in a.with_suffix(".log").read_text()
    mtime = a.stat().st_mtime_ns
    assert _build.build("a") == [a] and a.stat().st_mtime_ns == mtime  # cached
    with pytest.raises(_build.KernelError, match="bad.cu"):
        _build.build("bad")
    left = sorted(pathlib.Path(tmp_path / "build").iterdir())
    assert [p.name for p in left if p.suffix == ".so"] == sorted([a.name, b.name])
