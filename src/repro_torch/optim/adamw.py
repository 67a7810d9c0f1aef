"""AdamW over nested dicts of tensors (port of ``repro.optim.adamw``).

Layout, as in the reference: the model's parameters are bf16; the
optimizer holds an fp32 master copy and the first and second moments, and
after each step the parameters are the master cast to bf16 (norm scales
too, which start in fp32). Moments may be stored int8 with fp32 scales per
block of the last dimension (``OptimConfig.quantized_moments``), 6 bytes a
parameter instead of 12.

Functional in its interface, in place in its body: ``adamw_update``
updates the state's master, m and v tensors in place and returns the state
dict it was given, so the full-width step holds one copy of the 31 GB
optimizer state, not two. The arithmetic is the reference's, in fp32:
the count-based bias correction, weight decay on every leaf, moment codes
rounded half to even. The global norm comes first; then each leaf is
clipped, updated and cast on its own, so the fp32 copies of the gradients
that ``clip_by_global_norm`` returns as a whole are never all alive at
once.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


# ------------------------------------------------------- moment quantizer ----
def moment_block_for(shape, block: int) -> int:
    """Quantization block along the last dimension only, so the int8
    buffer keeps the parameter's shape; the whole dimension where ``block``
    does not divide it."""
    last = shape[-1] if len(shape) else 1
    return block if last % block == 0 else last


def moment_scale(amax: torch.Tensor) -> torch.Tensor:
    """A block's fp32 scale from its max |x|."""
    return amax / 127.0 + 1e-12


def quantize_moment(x: torch.Tensor, block: int, *,
                    amax=None) -> Dict[str, torch.Tensor]:
    """{"q": int8 codes of x's shape, "scale": one per block of the last
    dim}. ``amax`` (..., blocks): each block's max |x| where it is known
    to be larger than x's own (a sharded trainer's column slice of a
    block that straddles ranks)."""
    xf = x.to(F32)
    shape = tuple(x.shape)
    b = moment_block_for(shape, block)
    g = xf.reshape(shape[:-1] + (shape[-1] // b, b))
    if amax is None:
        amax = torch.amax(torch.abs(g), dim=-1)
    scale = moment_scale(amax)[..., None]
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return {"q": q.reshape(shape), "scale": scale[..., 0]}


def dequantize_moment(qs: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    shape = tuple(shape)
    q = qs["q"].to(F32)
    nb = qs["scale"].shape[-1]
    b = shape[-1] // nb
    g = q.reshape(shape[:-1] + (nb, b)) * qs["scale"][..., None]
    return g.reshape(shape)


# ----------------------------------------------------------------- state ----
def _moment_like(p: torch.Tensor, ocfg):
    z = torch.zeros(p.shape, dtype=F32, device=p.device)
    return quantize_moment(z, ocfg.moment_block) if ocfg.quantized_moments \
        else z


def adamw_init(params, ocfg) -> Dict[str, Any]:
    """{"master": fp32 copies, "m", "v": zero moments (or their codes),
    "count": int32 0}, on the parameters' device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return {
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "m": tree_map(lambda p: _moment_like(p, ocfg), params),
        "v": tree_map(lambda p: _moment_like(p, ocfg), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_logical_specs(param_specs, ocfg):
    """Logical axes of the optimizer state, mirroring the parameters'
    (``param_specs``, tuples of axis names): master and fp32 moments take
    the parameter's axes; a quantized moment's codes keep the parameter's
    exact shape and so its axes, and its per-block scale drops the last
    (blocked) axis to replicated."""
    def moment_spec(spec):
        if ocfg.quantized_moments:
            return {"q": spec, "scale": spec[:-1] + (None,) if spec else ()}
        return spec
    return {
        "master": param_specs,
        "m": tree_map(moment_spec, param_specs),
        "v": tree_map(moment_spec, param_specs),
        "count": (),
    }


# ---------------------------------------------------------------- update ----
def cosine_lr(step: torch.Tensor, ocfg) -> torch.Tensor:
    """Linear warmup then cosine decay to 0, in fp32, at ``step`` (an
    integer tensor)."""
    s = step.to(F32)
    warm = torch.clamp(s / max(ocfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - ocfg.warmup_steps)
                    / max(ocfg.total_steps - ocfg.warmup_steps, 1), 0.0, 1.0)
    return ocfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def global_norm(grads) -> torch.Tensor:
    """fp32 L2 norm over every leaf, the leaves' sums of squares added in
    the reference's leaf order."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(every gradient in fp32 scaled to a global norm of at most
    ``max_norm``, the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, grads), gn


def _is_leaf_dict(t) -> bool:
    return isinstance(t, dict) and "q" in t and "scale" in t


def _leaves(tree, quantized: bool):
    """Leaves of ``tree``, a quantized moment's {"q", "scale"} as one."""
    if isinstance(tree, dict) and not (quantized and _is_leaf_dict(tree)):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k],
                                                               quantized)]
    return [tree]


@torch.no_grad()
def adamw_update(grads, opt_state, ocfg, *, norm=global_norm,
                 requantize=None):
    """One AdamW step. Returns (new bf16 params, opt_state updated in
    place, {"lr", "grad_norm"}) with fp32 0-dim tensor metrics. ``norm``
    gives the global norm of ``grads``: a sharded trainer's spans every
    rank's shards (training/sharded.py); the update itself is elementwise,
    so it runs on shards as on whole tensors. ``requantize(moment, x)``:
    a quantized moment's new codes and scales from its fp32 value (a
    sharded trainer's, whose blocks may straddle ranks), in place of
    ``quantize_moment`` of x's own blocks."""
    count = opt_state["count"] + 1
    lr = cosine_lr(count, ocfg)
    b1, b2 = ocfg.b1, ocfg.b2
    cf = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=cf.device), cf)
    gn = norm(grads)
    scale = _clip_scale(gn, ocfg.grad_clip)
    qm = ocfg.quantized_moments

    flat_g = tree_leaves(grads)
    flat_ma = tree_leaves(opt_state["master"])
    flat_m = _leaves(opt_state["m"], qm)
    flat_v = _leaves(opt_state["v"], qm)
    for g, master, m, v in zip(flat_g, flat_ma, flat_m, flat_v):
        g = g.to(F32) * scale
        if qm:
            mf = b1 * dequantize_moment(m, g.shape) + (1 - b1) * g
            vf = b2 * dequantize_moment(v, g.shape) + (1 - b2) * g * g
        else:   # b1 * m + (1 - b1) * g, rounded as written, in place
            mf = m.mul_(b1).add_((1 - b1) * g)
            vf = v.mul_(b2).add_((1 - b2) * g * g)
        step = (mf / bc1) / (torch.sqrt(vf / bc2) + ocfg.eps)
        master.sub_(lr * (step + ocfg.weight_decay * master))
        if qm:
            for dst, src in ((m, mf), (v, vf)):
                codes = quantize_moment(src, ocfg.moment_block) \
                    if requantize is None else requantize(dst, src)
                dst["q"].copy_(codes["q"])
                dst["scale"].copy_(codes["scale"])
        del g, mf, vf, step
    opt_state["count"] = count
    new_params = tree_map(lambda ma: ma.to(torch.bfloat16),
                          opt_state["master"])
    return new_params, opt_state, {"lr": lr, "grad_norm": gn}
