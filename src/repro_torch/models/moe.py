"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
sort-based fixed-capacity dispatch, batched expert matmuls (GShard-style).

The dispatch avoids the (T, E, C) one-hot tensor: routed (token, expert)
pairs are sorted by expert id and scattered into an (E, C, D) buffer, the
experts run as one batched matmul per projection, and outputs come back
per token weighted by the gate. Capacity overflow drops pairs (GShard
semantics); the residual path keeps dropped tokens intact.

What the port keeps exactly:
  * the routing: fp32 router logits, softmax, the top k by probability
    with ties to the lower expert index (``lax.top_k``'s order, here a
    stable descending sort), the stable sort of the pairs by expert;
  * the capacity ``C`` from the static row count, never from the data,
    and the reference's extra row ``E*C`` that dropped pairs write and
    nobody reads;
  * the combine: each token's k weighted contributions added in
    ascending expert order in the activation dtype, rounding after each
    add, the order in which the reference's scatter-add meets them. The
    port builds that sum from a gather instead of a scatter-add, so the
    result does not depend on the order of atomics on the card: two calls
    on the same inputs give the same bits.
No step reads a value back to the host (counts by ``scatter_add_`` on an
integer tensor, segment starts by ``cumsum``), so a call never waits on
the device.

The batch split over ranks (``ranks``: distributed/sharding.py::
BatchRanks, the sharded trainer's and serving steps' hook). The
reference runs one program over the global batch, so the capacity, the
stable sort of the routed pairs, each pair's slot and the aux loss's
``me`` and ``ce`` are all functions of every rank's tokens. With the
hook a rank routes its own rows and computes exactly the reference's
plan: ``C = capacity(T_global)``; a pair's slot is its expert's count on
the ranks before this one (in the global batch's row order) plus its
place among the rank's own pairs, kept where that is below ``C``; and
``me`` and the top-1 counts are summed over the ranks before the
product, so ``aux`` is the reference's global scalar on every rank. The
buffer's shape stays static: ``min(C, T_local)`` rows an expert, which
is exact, as a token's k experts are distinct and so no expert takes
more than ``T_local`` pairs from one rank.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import PDef

F32 = torch.float32


def moe_defs(d_model: int, moe) -> dict:
    E, f = moe.num_experts, moe.d_ff_expert
    return {
        "router": PDef((d_model, E), ("embed", "experts"), "scaled",
                       dtype=torch.float32),
        "w_in": PDef((E, d_model, f), ("experts", "embed", "expert_ff"),
                     "scaled"),
        "w_gate": PDef((E, d_model, f), ("experts", "embed", "expert_ff"),
                       "scaled"),
        "w_out": PDef((E, f, d_model), ("experts", "expert_ff", "embed"),
                      "scaled"),
    }


def capacity(tokens: int, moe) -> int:
    c = math.ceil(tokens * moe.experts_per_token * moe.capacity_factor
                  / moe.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(p, xf: torch.Tensor, moe):
    """Router of ``xf`` (T, D): (probs (T, E) fp32, gates (T, k) fp32
    renormalized, idx (T, k) expert ids by descending probability). The
    router is fp32 at init and bf16 after a training step (the parameters
    are the masters cast to bf16): upcast, as the reference's einsum
    promotes it."""
    logits = xf.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: descending values, the lower index first on ties (exact
    # ties arise where pruned experts' probabilities underflow to 0)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = moe.experts_per_token
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def dispatch(idx: torch.Tensor, C: int, E: int, *, ranks=None,
             rows: int = 0):
    """The fixed-capacity plan of the routed pairs idx (T, k): (order
    (T*k,) the stable sort of the flat pairs by expert, keep (T*k,) whether
    each sorted pair found a slot, dest (T*k,) its buffer row, E*R where
    dropped). ``R`` is ``rows`` (``C`` where 0) rows an expert. With
    ``ranks`` (module docstring) a pair's slot counts the pairs of the
    ranks before this one: kept where that global slot is below ``C``, at
    row e*R + its place among this rank's pairs."""
    Tk = idx.numel()
    R = rows or C
    e_flat = idx.reshape(Tk)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=idx.device) \
        .scatter_add_(0, e_flat, torch.ones_like(e_flat))
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(Tk, device=idx.device) - seg_start[e_sorted]
    slot = pos if ranks is None else ranks.prefix(counts)[e_sorted] + pos
    keep = slot < C
    dest = torch.where(keep, e_sorted * R + pos, E * R)
    return order, keep, dest


def _bmm(a, w, name):
    return torch.bmm(a, w)


def moe_apply(p, x: torch.Tensor, moe, activation: str = "swiglu", *,
              dot=None, ranks=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux_loss fp32 scalar). ``dot``:
    optional (a, w, name) -> y override of the expert matmuls, sites
    moe_in, moe_gate, moe_out. ``ranks``: the ranks the batch is split
    over (module docstring); x is this rank's rows."""
    B, S, D = x.shape
    T = B * S
    E, k = moe.num_experts, moe.experts_per_token
    T_all = T if ranks is None else ranks.total(T)
    C = capacity(T_all, moe)
    R = C if ranks is None else min(C, T)
    xf = x.reshape(T, D)

    probs, gates, idx = route(p, xf, moe)
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    top1 = torch.zeros(E, dtype=F32, device=x.device).scatter_add_(
        0, idx[:, 0], torch.ones(T, dtype=F32, device=x.device))
    if ranks is None:
        me = torch.mean(probs, dim=0)
    else:
        me = ranks.sum(torch.sum(probs, dim=0)) / T_all
        top1 = ranks.sum(top1)
    aux = E * torch.sum(me * (top1 / T_all))

    order, keep, dest = dispatch(idx, C, E, ranks=ranks, rows=R)
    tok_sorted = order // k
    buf = torch.zeros((E * R + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = xf[tok_sorted]         # dropped pairs all land on row E*R
    buf = buf[:-1].reshape(E, R, D)

    dot = dot or _bmm
    h = dot(buf, p["w_in"], "moe_in")
    g = dot(buf, p["w_gate"], "moe_gate")
    if activation == "swiglu":
        h = F.silu(g) * h
    else:
        h = F.gelu(g, approximate="tanh") * h
    out_buf = dot(h, p["w_out"], "moe_out").reshape(E * R, D)

    safe_dest = torch.clamp(dest, max=E * R - 1)
    y_sorted = out_buf[safe_dest] * keep[:, None].to(x.dtype)
    g_flat = gates.reshape(T * k).to(x.dtype)
    contrib = y_sorted * g_flat[order][:, None]
    # back to (T, k) slot order, then each token's slots in ascending
    # expert order (a token's k experts are distinct)
    slots = torch.empty_like(contrib)
    slots[order] = contrib
    slots = slots.reshape(T, k, D)
    by_expert = torch.argsort(idx, dim=-1)
    slots = torch.gather(slots, 1, by_expert[:, :, None].expand(T, k, D))
    y = slots[:, 0]
    for j in range(1, k):
        y = y + slots[:, j]
    return y.reshape(B, S, D), aux
