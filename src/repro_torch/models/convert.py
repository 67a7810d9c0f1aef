"""Bring the reference's parameters into the port.

``from_jax_params`` takes the reference's parameter pytree with its leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``,
done by the caller, so this module never touches JAX) and returns the
port's nested dict of tensors under the same keys: ``blocks/sub{j}/attn/wq``
keeps its ``(n_groups, d, H, hd)`` stacking. bf16 leaves (numpy dtype
``bfloat16`` from ml_dtypes) become bf16 tensors exactly. The same works
for a page pool, whose quantized slots hold int8 codes, and for a train
state (``from_jax_state``).
"""
from __future__ import annotations

import numpy as np
import torch

# the reference's leaf dtypes (numpy names) -> torch dtypes
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8, "int32": torch.int32}


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name not in DTYPES:
        raise TypeError(f"no torch dtype for parameter dtype {name!r}")
    if name == "bfloat16":       # exact: bf16 values are fp32 values
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax_params(tree, device="cpu"):
    """Nested dicts and lists of numpy arrays -> the same nesting of
    tensors on ``device``, same keys and shapes."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [from_jax_params(v, device) for v in tree]
    return to_tensor(tree, device)


def from_jax_state(state, device="cpu"):
    """The reference's train state ``{"params", "opt": {"master", "m", "v",
    "count"}}`` (leaves as numpy arrays; quantized moments as ``{"q",
    "scale"}``) -> the port's (training/steps.py), same keys, dtypes and
    shapes: the weights and optimizer state carried across for
    training."""
    if set(state) != {"params", "opt"} or \
            set(state["opt"]) != {"master", "m", "v", "count"}:
        raise ValueError("a train state is {'params', 'opt': {'master', "
                         "'m', 'v', 'count'}}")
    return from_jax_params(state, device)
