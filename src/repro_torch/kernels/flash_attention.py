"""Flash attention forward as a CUDA kernel for Hopper (sm_90a).

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention_bhsd``; the note at the top
of the source says what bounds it and how it is laid out. ``_build``
compiles it at first use, binds it through ``ctypes`` and keeps its launch
count; nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import math
import pathlib

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, D); k/v: (B, K, Skv, D), any strides with a contiguous
    last dim. Returns (B, H, Sq, D) in q's dtype, as a view of a buffer laid
    out (B, Sq, H, D).

    Launches the CUDA kernel on the current stream and adds one to
    ``flash_attention_bhsd.launches``; raises if the build or the launch
    fails (``KernelError``). CPU tensors are refused: the plain version is
    ``repro_torch.kernels.ref.flash_attention_ref``."""
    _check(q, k, v)
    b, h, sq, d = q.shape
    kk, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    lib = _build.load("flash_attention", _bind)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in (t.stride(0), t.stride(2), t.stride(1))))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kk, sq, skv, strides, 1.0 / math.sqrt(d),
            int(causal), int(window), stream)
    _build.check_launch(lib, err, "flash-attention")
    _build.count_launch(flash_attention_bhsd)
    return out


flash_attention_bhsd.launches = 0
