"""The global gradient norm of random-init whisper-large-v3 at reduced
depth, in the JAX reference and in the PyTorch port, on the CPU: full
width (d 1280, 20 heads of 64) with ``num_layers`` cut to each depth
given, one batch of ``--frames`` frames from ``batch_for_model`` (step 0,
B 1), the reference's parameters carried into the port. It shows how the
norm grows with depth in both packages at the reference's initialisation
(``ROADMAP.md`` Queue 3): at the full 32 layers the sum of squares
overflows fp32 and the optimizer's clip zeroes the step.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/encdec_grad_norm.py \
        --depths 4 8 --frames 256

Prints one line per depth and package: the loss and the global norm
(float64 sum of squares of the bf16 and fp32 gradient leaves).
"""
import argparse

import jax
import numpy as np
import torch

from repro.configs import get_config as j_config
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as jdp
from repro.models.api import build_model as j_build
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import pipeline as tdp
from repro_torch.models.api import build_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.params import tree_leaves

ARCH = "whisper-large-v3"


def global_norm(leaves) -> float:
    return float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in leaves)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--frames", type=int, default=256)
    args = ap.parse_args()
    for L in args.depths:
        jm = j_build(j_config(ARCH).replace(num_layers=L))
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))
        batch = jdp.batch_for_model(jm, JShape("t", args.frames, 1, "train"),
                                    None, 0)
        loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
        print(f"layers {L}: reference loss {float(loss):.4f}, grad norm "
              f"{global_norm(jax.tree.leaves(grads)):.4g}", flush=True)

        tm = build_model(get_config(ARCH).replace(num_layers=L))
        tp = from_jax_params(jax.tree.map(np.asarray, params))
        leaves = tree_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        tb = tdp.batch_for_model(tm, ShapeConfig("t", args.frames, 1,
                                                 "train"), None, 0)
        loss = tm.loss(tp, tb)
        grads = torch.autograd.grad(loss, leaves)
        print(f"layers {L}: port loss {float(loss.detach()):.4f}, grad norm "
              f"{global_norm([g.float().numpy() for g in grads]):.4g}",
              flush=True)


if __name__ == "__main__":
    main()
