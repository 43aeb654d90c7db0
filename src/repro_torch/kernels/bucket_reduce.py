"""bucket_reduce as a CUDA kernel for Hopper (sm_90a).

The kernel (``csrc/bucket_reduce.cu``) replaces the Pallas TPU kernel
``repro.kernels.bucket_reduce.bucket_reduce``: per-bucket sums of the rows
of ``values``, ids outside ``[0, n_buckets)`` adding nothing. The TPU
kernel's one-hot matmul becomes a deterministic two-pass segmented sum;
the note at the top of the source says what bounds it. ``_build`` compiles
it at first use, binds it through ``ctypes`` and keeps its launch count;
nothing is built when this module is imported.

The tiling is chosen here, in ``plan``, so that the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib

import torch

from repro_torch.kernels import _build

NT = 256  # threads per block, as in the source
#: shared memory of one block's private lane partials (256 * tile * 4 or 8
#: bytes); two such blocks fit on one SM
SMEM_BUDGET = 96 * 1024
#: blocks per SM that the row chunks aim for
BLOCKS_PER_SM = 4
MAX_GRID_Y = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int64: 2}


@dataclasses.dataclass(frozen=True)
class Plan:
    chunks: int          # row chunks (grid y); the scratch holds one partial each
    rows_per_chunk: int
    pt: int              # buckets per tile
    dt: int              # columns per tile; 256 / dt row lanes per block
    p_tiles: int
    d_tiles: int


def plan(n: int, d: int, p: int, acc_bytes: int, sms: int) -> Plan:
    """Tiling of one call: a column tile of the next power of two of D (at
    most 64), a bucket tile as large as the shared-memory budget allows,
    and enough row chunks for ``BLOCKS_PER_SM`` blocks on each SM (never
    fewer than 256 rows a chunk)."""
    dt = min(64, 1 << max(0, d - 1).bit_length())
    pt = max(1, min(p, SMEM_BUDGET // (NT * acc_bytes)))
    p_tiles = -(-p // pt)
    d_tiles = -(-d // dt)
    want = -(-BLOCKS_PER_SM * sms // (p_tiles * d_tiles))
    chunks = max(1, min(want, -(-n // NT), MAX_GRID_Y))
    rows_per_chunk = -(-n // chunks)
    chunks = -(-n // rows_per_chunk)
    return Plan(chunks, rows_per_chunk, pt, dt, p_tiles, d_tiles)


def build() -> pathlib.Path:
    """Compile the kernel unless a build of this exact source exists;
    returns the library's path (see ``_build.build``)."""
    return _build.build("bucket_reduce")[0]


def _bind(lib):
    fn = lib.repro_bucket_reduce
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


def _check(values, ids, n_buckets):
    for name, t in (("values", values), ("ids", ids)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.device != ids.device:
        raise ValueError("values and ids must be on one device")
    if values.dim() != 2 or values.dtype not in _DTYPE_CODE:
        raise ValueError(f"values must be 2-D (N, D) of {list(_DTYPE_CODE)}, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32 or ids.shape[0] != values.shape[0]:
        raise ValueError(f"ids must be int32 of shape ({values.shape[0]},), got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if not 0 <= n_buckets < 2**31 or max(values.shape) >= 2**31:
        raise ValueError(f"n_buckets {n_buckets} or shape {tuple(values.shape)} out of range")


def bucket_reduce(values, ids, n_buckets: int):
    """values: (N, D) f32, bf16 or int64; ids: (N,) int32. Returns the
    (n_buckets, D) per-bucket sums in values' dtype, accumulated in f32
    (int64 in int64), in an order fixed by the shapes and the card, so two
    calls give the same bits.

    Launches the kernel (both passes) on the current stream and adds one
    to ``bucket_reduce.launches``; raises ``KernelError`` if the build or
    the launch fails. CPU tensors are refused: the plain version is
    ``repro_torch.kernels.ref.bucket_reduce_ref``."""
    _check(values, ids, n_buckets)
    n, d = values.shape
    out = torch.empty((n_buckets, d), dtype=values.dtype, device=values.device)
    if out.numel() == 0:
        return out
    if n == 0:
        return out.zero_()
    acc = torch.int64 if values.dtype == torch.int64 else torch.float32
    sms = torch.cuda.get_device_properties(values.device).multi_processor_count
    pl = plan(n, d, n_buckets, acc.itemsize, sms)
    scratch = torch.empty((pl.chunks, n_buckets, d), dtype=acc, device=values.device)
    lib = _build.load("bucket_reduce", _bind)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.repro_bucket_reduce(
            _DTYPE_CODE[values.dtype], values.data_ptr(), ids.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, d, n_buckets, pl.chunks, pl.rows_per_chunk, pl.pt, pl.dt,
            pl.p_tiles, stream)
    _build.check_launch(lib, err, "bucket_reduce")
    _build.count_launch(bucket_reduce)
    return out


bucket_reduce.launches = 0
