"""Flash attention forward as CUDA kernels for Hopper (sm_90a).

The kernels (``csrc/flash_attention.cu``) replace the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_bhsd``. ``variant`` picks
one by type, head dim and layout: bf16 on the tensor cores through TMA and
``wgmma``, or f32 arithmetic on the CUDA cores. The note at the top of the
source says what bounds them and how they are laid out. ``_build`` compiles
them at first use, binds them through ``ctypes`` and keeps the launch
counts; nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WGMMA, CUDA_CORES = "fa_fwd_wgmma_kernel", "fa_fwd_kernel"


def build() -> pathlib.Path:
    """Compile the kernel unless a build of this exact source exists;
    returns the library's path (see ``_build.build``)."""
    return _build.build("flash_attention")[0]


def _bind(lib):
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, heads, S, D), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q, k, v must share a dtype in {list(_DTYPE_CODE)}; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[1]} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel has {HEAD_DIMS}")


def variant(q, k, v) -> str:
    """The kernel that runs ``flash_attention_bhsd(q, k, v)``, chosen from
    type, head dim and layout alone before any launch (no data is read, so
    meta tensors do): ``fa_fwd_wgmma_kernel`` for bf16 with head dim 64 or
    128, at least one key, and q, k, v that TMA can describe
    (``_build.tma_describable``); ``fa_fwd_kernel`` otherwise (f32, head dims
    16 and 32, other layouts). This is a selection, not a fallback: if the
    chosen kernel fails to build or launch, the wrapper raises and nothing
    retries it on another variant."""
    if (q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS and k.shape[2] > 0
            and all(_build.tma_describable(t) for t in (q, k, v))):
        return WGMMA
    return CUDA_CORES


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k/v: (B, K, Skv, D), any strides with a contiguous
    last dim. Returns (B, H, Sq, D) in q's dtype, as a view of a buffer laid
    out (B, Sq, H, D).

    Launches the kernel that ``variant`` names on the current stream and
    adds one to ``flash_attention_bhsd.launches`` and to
    ``flash_attention_bhsd.launches_by_variant[variant]``; raises if the
    build or the launch fails (``KernelError``). CPU tensors are refused:
    the plain version is ``repro_torch.kernels.ref.flash_attention_ref``."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    kernel = variant(q, k, v)
    _launch(kernel, q, k, v, out, causal, window)
    _build.count_launch(flash_attention_bhsd, kernel)
    return out


def _launch(kernel, q, k, v, out, causal, window):
    """The one call of the C entry: runs ``kernel`` on checked inputs into
    ``out`` (B, H, Sq, D) on the current stream; raises ``KernelError`` if
    the build or the launch fails. Counts nothing."""
    b, h, sq, d = q.shape
    kk, skv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention", _bind)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(2), t.stride(1))))
    code = 2 if kernel == WGMMA else _DTYPE_CODE[q.dtype]  # the C entry's kernel code
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            code, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kk, sq, skv, strides, 1.0 / math.sqrt(d), int(causal), int(window), stream)
    _build.check_launch(lib, err, kernel)


flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_variant = dict.fromkeys((WGMMA, CUDA_CORES), 0)
