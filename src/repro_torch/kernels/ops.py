"""Public wrappers for the port's kernels (counterpart of
``repro.kernels.ops``).

Device policy: a tensor on the CPU goes to the plain PyTorch version in
``ref.py`` (the counterpart of Pallas ``interpret=True``); a CUDA tensor
launches the hand-written kernel or raises. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
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
