"""Step builders (port of ``repro.training.steps``): the train step the
trainer loop (training/loop.py) runs, the prefill step and the
dense-cache serve step.

``dot`` is the HAQ quantized-matmul hook. Sequences of FLASH_MIN tokens
or more attend through the flash kernel on CUDA tensors and its plain
version on CPU ones (models/flash.py). The reference's ``abstract_train_state`` and ``train_state_logical_specs``
serve its dry-run and sharding, which wait for ROADMAP items 10-11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import adamw_init, adamw_update

F32 = torch.float32


def make_train_step(model, tcfg, *, dot=None) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``
    with ``state = {"params", "opt"}``. The loss and its gradients come
    from ``torch.autograd`` on the parameter leaves (each made to require
    grad for the call); with ``tcfg.microbatches = M > 1`` the batch is cut
    into M along its rows, the losses and the gradients (in fp32) summed
    and divided by M, as the reference's scan does. Then ``adamw_update``,
    which updates the optimizer state in place."""
    ocfg = tcfg.optim
    M = tcfg.microbatches

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, batch, remat=tcfg.remat, dot=dot)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), tree_unflatten(params, grads)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        if M > 1:
            loss = torch.zeros((), dtype=F32,
                               device=batch["tokens"].device)
            grads = None
            for mb in range(M):
                part = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])[mb]
                        for k, v in batch.items()}
                l, g = grad_fn(params, part)
                loss = loss + l
                if grads is None:
                    grads = tree_map(lambda a: a.to(F32), g)
                else:
                    for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                        a.add_(b.to(F32))
                del g
            loss = loss / M
            grads = tree_map(lambda g: g / M, grads)
        else:
            loss, grads = grad_fn(params, batch)
        new_params, new_opt, metrics = adamw_update(grads, state["opt"], ocfg)
        return {"params": new_params, "opt": new_opt}, {"loss": loss,
                                                        **metrics}

    return train_step


def init_train_state(model, tcfg, generator: torch.Generator, device):
    """Random parameters from ``generator`` on ``device`` and their AdamW
    state."""
    params = model.init(generator, device)
    return {"params": params, "opt": adamw_init(params, tcfg.optim)}


def make_prefill_step(model, *, dot=None) -> Callable:
    """``prefill_step(params, batch) -> (last-row logits, caches)`` in the
    dense decode's layout: the serving entry point of the families
    ``generate`` does not take (frames for the encoder-decoder, patches
    for the vision stub)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, dot=dot)

    return prefill_step


def make_serve_step(model, *, dot=None) -> Callable:
    """The reference's dense-cache decode step: ``serve_step(params,
    cache, token, pos) -> (logits, cache)`` over the caches of
    ``make_prefill_step`` (ring layout for local layers), updated in
    place."""
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos, dot=dot)

    return serve_step
