"""Public wrappers for the port's kernels (counterpart of
``repro.kernels.ops``).

Device policy: a tensor on the CPU goes to the plain PyTorch version in
``ref.py`` (the counterpart of Pallas ``interpret=True``); a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.bucket_reduce import bucket_reduce as _bucket_reduce
from repro_torch.kernels.flash_attention import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, D) k/v: (B, S, K, D) — model layout; the kernel reads
    them through BHSD views, with no copy.

    Forward only: the backward (``repro.kernels.ops._fa_with_vjp``
    recomputes through the reference) comes with the training slice
    (ROADMAP queue 1: training step)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: it comes with the training "
            "slice (ROADMAP queue 1: training step)")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=int(window))
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal, window=int(window))
    return out.transpose(1, 2)


def bucket_reduce(values, bucket_ids, n_buckets: int):
    """values: (N, D) f32, bf16 or int64; bucket_ids: (N,) int32. Per-bucket
    sums (n_buckets, D) in values' dtype; ids outside [0, n_buckets) add
    nothing."""
    if values.device.type == "cpu":
        return ref.bucket_reduce_ref(values, bucket_ids, n_buckets)
    return _bucket_reduce(values.contiguous(), bucket_ids.contiguous(), n_buckets)


def grouped_reduce(values, bucket_ids, n_buckets: int, *, device="cuda"):
    """int64 grouped sum for the vectorized SQL engine
    (``vector_backend="torch"``). Integer addition is associative, so an
    order-free reduction is EXACT as long as nothing can overflow:

      * sum(|v|) < 2**24  — every value and every partial is an exact
        f32 integer, so the f32 bucket_reduce kernel gives bit-exact
        results;
      * sum(|v|) <= 2**62 — the int64 instantiation of the same kernel
        accumulates with no possible wrap;
      * otherwise returns None and the caller keeps its exact path
        (the numpy engine falls back to Python bigint folds).

    Takes and returns numpy, as the JAX package's ``grouped_reduce`` does:
    on a CUDA ``device`` one call copies values and ids to the card, runs
    the kernel and copies the sums back; on the CPU it runs the plain
    version. Any failure of the copies, the kernel or the read-back raises
    ``KernelError``, which the engine never reruns on another path.
    Returns a (n_buckets,) int64 array, or None. Each call that
    returns an array adds one to ``grouped_reduce.folds`` and its host
    wall time, copies included, to ``grouped_reduce.seconds``."""
    t0 = time.perf_counter()
    vals = np.asarray(values, dtype=np.int64)
    ids = np.asarray(bucket_ids)
    if vals.shape[0] == 0:
        out = np.zeros(n_buckets, dtype=np.int64)
    else:
        abs_sum = float(np.abs(vals).astype(np.float64).sum())
        if abs_sum > float(2**62):
            return None
        host = vals.astype(np.float32) if abs_sum < float(2**24) else vals
        try:
            v = torch.from_numpy(np.ascontiguousarray(host[:, None])).to(device)
            i = torch.from_numpy(ids.astype(np.int32)).to(device)
            out = bucket_reduce(v, i, n_buckets).cpu().numpy()[:, 0].astype(np.int64)
        except KernelError:
            raise
        except Exception as e:
            # a fault inside the kernel shows at the synchronising read-back,
            # an out-of-memory error at a copy: all are the fold's failure
            raise KernelError(f"grouped_reduce on {device} failed: "
                              f"{type(e).__name__}: {e}") from e
    with _TALLY:
        grouped_reduce.folds += 1
        grouped_reduce.seconds += time.perf_counter() - t0
    return out


_TALLY = threading.Lock()
grouped_reduce.folds = 0
grouped_reduce.seconds = 0.0
