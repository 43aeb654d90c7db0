"""Grouped (per-expert) matmul as CUDA kernels for Hopper (sm_90a).

The kernels (``csrc/moe_gmm.cu``) replace the Pallas TPU kernel
``repro.kernels.moe_gmm.grouped_matmul``: (E, T, D) @ (E, D, F) -> (E, T, F)
with an f32 accumulator over D, cast to the inputs' type. ``variant``
picks one of three by type and layout: bf16 on the tensor cores through
TMA and ``wgmma`` or, for layouts TMA cannot describe, ``mma.sync``; f32 on
the CUDA cores. The note at the top of the source says what bounds them and
how they are laid out. ``_build`` compiles them at first use, binds them
through ``ctypes`` and keeps the launch counts; nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import KernelError

_DTYPES = (torch.float32, torch.bfloat16)
WGMMA, MMA_SYNC, F32 = "gmm_wgmma_kernel", "gmm_bf16_kernel", "gmm_f32_kernel"
#: the C entry's code for each kernel, as in the source
_KERNEL_CODE = {F32: 0, MMA_SYNC: 1, WGMMA: 2}
#: output tile (T, F) of one block of the grid-per-tile kernels, as in the source
TILES = {F32: (64, 64), MMA_SYNC: (128, 128)}
MAX_GRID_YZ = 65535


def build() -> pathlib.Path:
    """Compile the kernel unless a build of this exact source exists;
    returns the library's path (see ``_build.build``)."""
    return _build.build("moe_gmm")[0]


def _bind(lib):
    fn = lib.repro_grouped_matmul
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _check(x, w):
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise KernelError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dim() != 3:
            raise KernelError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise KernelError(f"{name}'s last dim must be contiguous")
        if any(s < 0 for s in t.stride()):
            raise KernelError(f"{name} has a negative stride")
    if x.device != w.device:
        raise KernelError("x and w must be on one device")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise KernelError(f"x and w must share a dtype in {list(_DTYPES)}; "
                          f"got {x.dtype}, {w.dtype}")
    e, _, d = x.shape
    if w.shape[0] != e or w.shape[1] != d:
        raise KernelError(f"w shape {tuple(w.shape)} does not match x {tuple(x.shape)}")
    if max(x.shape) >= 2**31 or max(w.shape) >= 2**31:
        raise KernelError(f"shapes {tuple(x.shape)}, {tuple(w.shape)} out of range")


def _rows_aligned(t) -> bool:
    """Every row of ``t`` starts on a 16-byte boundary."""
    step = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(0) % step == 0
            and t.stride(1) % step == 0)


def variant(x, w) -> str:
    """The kernel that runs ``grouped_matmul(x, w)``, chosen from type and
    layout alone before any launch (no data is read, so meta tensors do):

    * ``gmm_f32_kernel`` for f32;
    * ``gmm_wgmma_kernel`` for bf16 when TMA can describe x, w and the
      contiguous output (``_build.tma_describable``, and F a multiple of 8)
      and D > 0;
    * ``gmm_bf16_kernel`` (``mma.sync``) for the other bf16 layouts.

    This is a selection, not a fallback: if the chosen kernel fails to
    build or launch, ``grouped_matmul`` raises and nothing retries it on
    another variant."""
    if x.dtype == torch.float32:
        return F32
    d, f = x.shape[2], w.shape[2]
    if d > 0 and f % 8 == 0 and _build.tma_describable(x) and _build.tma_describable(w):
        return WGMMA
    return MMA_SYNC


def grouped_matmul(x, w):
    """x: (E, T, D), w: (E, D, F), both f32 or both bf16 on one CUDA device,
    each with a contiguous last dim (other strides are free). Returns a new
    contiguous (E, T, F) tensor in x's dtype.

    Launches the kernel that ``variant`` names on the current stream, for
    every shape, ragged ones included, and adds one to
    ``grouped_matmul.launches`` and to
    ``grouped_matmul.launches_by_variant[variant]``. Raises ``KernelError``
    on a wrong device, dtype, rank or layout, and if the build or the
    launch fails. CPU tensors are refused: the plain version is
    ``repro_torch.kernels.ref.grouped_matmul_ref``."""
    _check(x, w)
    e, t, _ = x.shape
    f = w.shape[2]
    out = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    kernel = variant(x, w)
    if kernel in TILES and (e > MAX_GRID_YZ or -(-f // TILES[kernel][1]) > MAX_GRID_YZ):
        raise KernelError(f"{e} experts or {f} columns exceed the kernel's grid")
    _launch(kernel, x, w, out)
    _build.count_launch(grouped_matmul, kernel)
    return out


def _launch(kernel, x, w, out):
    """The one call of the C entry: runs ``kernel`` on checked inputs into
    ``out`` (E, T, F) on the current stream; raises ``KernelError`` if the
    build or the launch fails. Counts nothing."""
    e, t, d = x.shape
    f = w.shape[2]
    lib = _build.load("moe_gmm", _bind)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_grouped_matmul(
            _KERNEL_CODE[kernel], x.data_ptr(), w.data_ptr(), out.data_ptr(), e, t, d, f,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            out.stride(0), out.stride(1),
            int(_rows_aligned(x)), int(_rows_aligned(w)), stream)
    _build.check_launch(lib, err, kernel)


grouped_matmul.launches = 0
grouped_matmul.launches_by_variant = dict.fromkeys(_KERNEL_CODE, 0)
