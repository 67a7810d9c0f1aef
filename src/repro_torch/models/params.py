"""Parameter-definition DSL (port of ``repro.models.params``).

Every model declares its parameters once as a nested dict of ``PDef``
leaves (shape + logical axes + init); ``init_params`` materializes it as a
nested dict of tensors with the same keys. A subtree may also be a Python
list (the NAS supernet's per-block parameters). Leaves are visited in
sorted key order within a dict and in index order within a list, as JAX
flattens them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | scaled(fan_in)
    scale: float = 1.0
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree):
    """Leaves of nested dicts and lists: sorted key order in a dict, index
    order in a list."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the nesting of ``like``."""
    return _unflatten(like, iter(leaves))


def _unflatten(t, it):
    # a module-level walk: a nested one refers to itself through its
    # closure, a cycle that keeps ``leaves`` alive until the cyclic
    # collector runs (the sharded engine's gathered weights, every layer)
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, list):
        return [_unflatten(v, it) for v in t]
    return next(it)


def stacked(defs, n: int):
    """Prepend a stacked layer dimension to every PDef in a subtree."""
    return tree_map(lambda d: PDef((n,) + d.shape, ("layer",) + d.axes,
                                   d.init, d.scale, d.dtype), defs)


def _init_leaf(d: PDef, generator, device, dtype):
    dt = dtype or d.dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    else:
        std = d.scale * 0.02
    a = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return a.mul_(std).to(dt)


def init_params(defs, generator: torch.Generator, device, dtype=None):
    """Materialize ``defs`` on ``device`` from ``generator`` (a generator of
    that device). Leaves draw from the generator in ``tree_leaves``
    order."""
    leaves = [_init_leaf(d, generator, device, dtype)
              for d in tree_leaves(defs)]
    return tree_unflatten(defs, leaves)


def abstract_params(defs):
    """``defs`` as meta tensors of their shapes and dtypes."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def logical_specs(defs):
    return tree_map(lambda d: d.axes, defs)


def param_count(defs) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))


def param_bytes(defs) -> int:
    return int(sum(math.prod(d.shape) * d.dtype.itemsize
                   for d in tree_leaves(defs)))
