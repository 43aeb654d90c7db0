"""Weight transfer from the JAX package's parameter pytrees.

``jax.random`` cannot be replayed in torch, so a test that compares the two
packages initialises the JAX model, flattens its params to numpy under the
``::``-joined keys of ``repro.checkpoint.manager._flatten``, and builds the
port's params from them here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import param as pm
from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # bits through a 16-bit integer view, never through f32
        return torch.from_numpy(np.array(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def from_jax_flat(flat: dict[str, np.ndarray], cfg: ModelConfig, device="cuda") -> dict:
    """The port's nested param dict for ``cfg``, on ``device``, from a
    flattened JAX param pytree. Raises on a missing or extra key and on a
    shape that differs from the schema."""
    device = resolve_device(device)
    schema = pm.flat_keys(lm.lm_schema(cfg))
    missing = sorted(set(schema) - set(flat))
    extra = sorted(set(flat) - set(schema))
    if missing or extra:
        raise KeyError(f"param keys differ from {cfg.name}'s schema: "
                       f"missing {missing}, extra {extra}")
    for key, p in schema.items():
        if tuple(flat[key].shape) != p.shape:
            raise ValueError(f"{key}: shape {tuple(flat[key].shape)}, schema {p.shape}")

    def build(path, node):
        if isinstance(node, dict):
            return {k: build(path + (k,), v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(path + (i,), v) for i, v in enumerate(node)]
        return _to_tensor(flat[pm.SEP.join(map(str, path))]).to(device)

    return build((), lm.lm_schema(cfg))
