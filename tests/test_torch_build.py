"""The port's kernel build helper (``repro_torch.kernels._build``), on the
CPU: where a build lives, the launch counts and the TMA layout rule. Nothing
is compiled here; the kernels are built and run on the card by
chip_smoke.py."""

import threading

import pytest
import torch

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A kernel source ``k.cu`` that includes a shared header, in a
    temporary ``csrc/``; ``BUILD_DIR`` points into the same directory."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "hopper.cuh"\nextern "C" int f() { return 0; }\n')
    (src / "hopper.cuh").write_text("// helpers, first version\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_library_path_changes_when_only_a_header_changes(csrc, tmp_path):
    before = _build.library_path("k")
    assert _build.library_path("k") == before  # stable while nothing changes
    (csrc / "hopper.cuh").write_text("// helpers, second version\n")
    after = _build.library_path("k")
    assert after != before
    assert before.parent == after.parent == tmp_path / "build"
    assert after.name.startswith("k-") and after.suffix == ".so"


@pytest.mark.parametrize("change", ["source", "new header", "flags"])
def test_library_path_changes_with_source_headers_and_flags(csrc, monkeypatch, change):
    before = _build.library_path("k")
    if change == "source":
        (csrc / "k.cu").write_text('#include "hopper.cuh"\nextern "C" int f() { return 1; }\n')
    elif change == "new header":
        (csrc / "other.cuh").write_text("// a second shared header\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.library_path("k") != before


def test_every_kernel_source_has_a_library_path():
    for name in ("flash_attention", "bucket_reduce", "moe_gmm"):
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"{name}-")
    assert (_build.CSRC / "hopper.cuh").exists()


def _wrapper():
    def fn():
        pass
    fn.launches = 0
    fn.launches_by_variant = {"a": 0, "b": 0}
    return fn


def test_count_launch_counts_total_and_variant_across_threads():
    fn = _wrapper()

    def work(variant):
        for _ in range(500):
            _build.count_launch(fn, variant)

    threads = [threading.Thread(target=work, args=(v,)) for v in "abab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == 2000
    assert fn.launches_by_variant == {"a": 1000, "b": 1000}
    _build.reset_launches(fn)
    assert fn.launches == 0 and fn.launches_by_variant == {"a": 0, "b": 0}


def test_count_launch_without_variants():
    fn = _wrapper()
    del fn.launches_by_variant
    _build.count_launch(fn)
    assert fn.launches == 1
    _build.reset_launches(fn)
    assert fn.launches == 0


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("make,ok", [
    (lambda: _meta((8, 1312, 6144)), True),                       # contiguous, rows of 8k
    (lambda: _meta((8, 512, 32, 128)).transpose(1, 2), True),     # a BSHD tensor read as BHSD
    (lambda: _meta((1, 4, 8), torch.float32), True),              # f32 rows of 16 bytes
    (lambda: _meta((2, 37, 50)), False),                          # rows of 100 bytes
    (lambda: _meta((2, 64, 72))[:, :, 1:65], False),              # base off 16 bytes
    (lambda: _meta((2, 64, 64)).transpose(1, 2), False),          # last dim strided
    (lambda: _meta((2, 64, 64)).expand(3, 2, 64, 64), False),     # a zero stride
])
def test_tma_describable(make, ok):
    assert _build.tma_describable(make()) is ok
