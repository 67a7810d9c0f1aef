"""Step builders (port of ``repro.training.steps``): the train step the
trainer loop (training/loop.py) runs, the prefill step and the
dense-cache serve step, and the train state's shapes
(``abstract_train_state``, meta tensors) and logical axes
(``train_state_logical_specs``), from which distributed/sharding.py's
rules place the state on a mesh.

``ac`` is the activation-layout hook (distributed/sharding.py::make_ac):
given one, the step is the sharded trainer's (training/sharded.py), or
the sharded prefill and serve steps' (training/sharded_serve.py), over
its mesh. ``dot`` is the HAQ quantized-matmul hook. Sequences of
FLASH_MIN tokens or more attend through the flash kernel on CUDA tensors
and its plain version on CPU ones (models/flash.py).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     moment_block_for,
                                     opt_state_logical_specs)

F32 = torch.float32


def make_train_step(model, tcfg, *, ac=None, dot=None) -> Callable:
    """``train_step(state, batch) -> (state, {"loss", "lr", "grad_norm"})``
    with ``state = {"params", "opt"}``. The loss and its gradients come
    from ``torch.autograd`` on the parameter leaves (each made to require
    grad for the call); with ``tcfg.microbatches = M > 1`` the batch is cut
    into M along its rows, the losses and the gradients (in fp32) summed
    and divided by M, as the reference's scan does. Then ``adamw_update``,
    which updates the optimizer state in place. With ``ac`` (a layout
    from ``make_ac(mesh)``) the state is this rank's shards and the batch
    the global one, of which the step takes this rank's rows
    (training/sharded.py)."""
    if ac is not None:
        from repro_torch.training.sharded import ShardedTrainer
        return ShardedTrainer(model, tcfg, ac, dot=dot).step

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, batch, remat=tcfg.remat, dot=dot)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return loss.detach(), tree_unflatten(params, grads)

    return run_train_step(tcfg, grad_fn, lambda grads, opt: adamw_update(
        grads, opt, tcfg.optim))


def run_train_step(tcfg, grad_fn, update) -> Callable:
    """The step around ``grad_fn(params, batch) -> (loss, grads)`` and
    ``update(grads, opt) -> (params, opt, metrics)``, microbatches
    included (``make_train_step``)."""
    M = tcfg.microbatches

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
        new_params, new_opt, metrics = update(grads, state["opt"])
        return {"params": new_params, "opt": new_opt}, {"loss": loss,
                                                        **metrics}

    return train_step


def init_train_state(model, tcfg, generator: torch.Generator, device):
    """Random parameters from ``generator`` on ``device`` and their AdamW
    state."""
    params = model.init(generator, device)
    return {"params": params, "opt": adamw_init(params, tcfg.optim)}


def abstract_train_state(model, tcfg):
    """``init_train_state``'s tree as meta tensors (shapes and dtypes, no
    storage): a quantized moment's codes int8 in the parameter's shape,
    its scales fp32 over ``moment_block_for``'s blocks of the last
    dimension."""
    params = model.abstract_params()

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def moment(p):
        shape = tuple(p.shape)
        if tcfg.optim.quantized_moments:
            b = moment_block_for(shape, tcfg.optim.moment_block)
            nb = shape[-1] // b if shape else 1
            return {"q": meta(shape, torch.int8),
                    "scale": meta(shape[:-1] + (nb,), F32)}
        return meta(shape, F32)

    return {"params": params,
            "opt": {"master": tree_map(lambda p: meta(p.shape, F32),
                                       params),
                    "m": tree_map(moment, params),
                    "v": tree_map(moment, params),
                    "count": meta((), torch.int32)}}


def train_state_logical_specs(model, tcfg):
    """Logical axes of the train state, leaf for leaf with
    ``abstract_train_state``."""
    pspecs = model.logical_specs()
    return {"params": pspecs,
            "opt": opt_state_logical_specs(pspecs, tcfg.optim)}


def make_prefill_step(model, *, ac=None, dot=None) -> Callable:
    """``prefill_step(params, batch) -> (last-row logits, caches)`` in the
    dense decode's layout: the serving entry point of the families
    ``generate`` does not take (frames for the encoder-decoder, patches
    for the vision stub). With ``ac`` (``make_ac(mesh)``) the step is the
    sharded one over its mesh (training/sharded_serve.py): parameters
    this rank's shards, the global batch in, its rows' logits and its
    cache blocks out."""
    if ac is not None:
        from repro_torch.training.sharded_serve import serve_steps
        return serve_steps(model, ac, dot=dot).prefill

    def prefill_step(params, batch):
        return model.prefill(params, batch, dot=dot)

    return prefill_step


def make_serve_step(model, *, ac=None, dot=None) -> Callable:
    """The reference's dense-cache decode step: ``serve_step(params,
    cache, token, pos) -> (logits, cache)`` over the caches of
    ``make_prefill_step`` (ring layout for local layers), updated in
    place. With ``ac`` the sharded step over its mesh, over this rank's
    cache blocks as the same ``ac``'s prefill step (or
    ``ShardedServeSteps.place_cache``) placed them, the global token in,
    its rows' logits out (training/sharded_serve.py)."""
    if ac is not None:
        from repro_torch.training.sharded_serve import serve_steps
        return serve_steps(model, ac, dot=dot).decode

    def serve_step(params, cache, token, pos):
        return model.decode_step(params, cache, token, pos, dot=dot)

    return serve_step
