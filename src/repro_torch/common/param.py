"""Declarative parameter schemas (torch counterpart of ``repro.common.param``).

Every model module declares its parameters once, as a nested dict (and, for
unrolled prefix layers, list) of :class:`P` entries: shape, logical axis
names and init rule. From that one schema come

* ``init_params``  — tensors drawn from a ``torch.Generator`` on the target
                     device, in the target dtype,
* ``param_count``  — the parameter count, with no allocation,
* ``flat_keys``    — the ``::``-joined leaf paths that the JAX package's
                     checkpoint flattening produces, for weight transfer.

The logical axis names are kept so the schemas stay comparable with the JAX
package's; the port does not shard yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

PyTree = Any
SEP = "::"


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter: shape, logical axes (same arity), init rule."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones | scaled | embed
    scale: float | None = None  # override init stddev

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} arity mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # convention: last axis is the output axis for 2D+; fan-in is the product
    # of the remaining axes.
    if len(shape) <= 1:
        return max(1, shape[0] if shape else 1)
    return max(1, math.prod(shape[:-1]))


def _init_one(p: P, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "embed":
        std = p.scale if p.scale is not None else 0.02
    elif p.init in ("normal", "scaled"):
        std = p.scale if p.scale is not None else 1.0 / math.sqrt(_fan_in(p.shape))
    else:
        raise ValueError(f"unknown init {p.init!r}")
    # drawn straight into the target dtype on the target device: a bf16
    # model never passes through an f32 or host copy of its weights
    out = torch.empty(p.shape, dtype=dtype, device=device)
    return out.normal_(0.0, std, generator=gen)


def tree_map(fn: Callable[[Any], Any], tree: PyTree) -> PyTree:
    """Map over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves_with_path(tree: PyTree, prefix: tuple = ()):
    """(path, leaf) pairs in the JAX package's flattening order: dict keys
    sorted, list entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def flat_keys(schema: PyTree) -> dict[str, P]:
    """``::``-joined leaf paths -> P, as ``repro.checkpoint.manager._flatten``
    names the leaves of a param pytree."""
    return {SEP.join(str(p) for p in path): leaf
            for path, leaf in tree_leaves_with_path(schema)}


def init_params(schema: PyTree, gen: torch.Generator, dtype: torch.dtype,
                device: torch.device | str) -> PyTree:
    device = torch.device(device)
    return tree_map(lambda p: _init_one(p, gen, dtype, device), schema)


def stack_schema(schema: PyTree, n: int, axis_name: str | None = "layers") -> PyTree:
    """Prefix every parameter with a stacked (layer) leading dim of size ``n``."""

    def stack_one(p: P) -> P:
        return P((n,) + p.shape, (axis_name,) + p.axes, p.init, p.scale)

    return tree_map(stack_one, schema)


def param_count(schema: PyTree) -> int:
    return sum(math.prod(p.shape) for _, p in tree_leaves_with_path(schema))
