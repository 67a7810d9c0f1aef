"""Bring the reference's parameters into the port.

``from_jax_params`` takes the reference's parameter pytree with its leaves
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``,
done by the caller, so this module never touches JAX) and returns the
port's nested dict of tensors under the same keys: ``blocks/sub{j}/attn/wq``
keeps its ``(n_groups, d, H, hd)`` stacking. bf16 leaves (numpy dtype
``bfloat16`` from ml_dtypes) become bf16 tensors exactly. The same works
for a page pool, whose quantized slots hold int8 codes.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8}


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    name = a.dtype.name
    if name not in _DTYPES:
        raise TypeError(f"no torch dtype for parameter dtype {name!r}")
    if name == "bfloat16":       # exact: bf16 values are fp32 values
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def from_jax_params(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of tensors on
    ``device``, same keys and shapes."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)
