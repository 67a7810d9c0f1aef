"""Structured pruning transforms for LM layers (port of
``repro.core.pruning``, AMC's compression backend).

Units are tensor-core-friendly structures: attention query-head GROUPS
(GQA groups prune together so grouped attention stays well-formed), FFN
hidden units, and MoE experts. Two modes:
  * mask_*  — zero out pruned units (policy evaluation in the RL env;
              shapes unchanged);
  * slice_* — physically shrink the tensors (the final exported model).

Importance criteria (magnitude-based, as AMC): L2 norm of the unit's
outgoing weights. Every function is plain tensor arithmetic on the device
of its input.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

F32 = torch.float32


# ----------------------------------------------------------- importance ----
# All functions accept optionally LAYER-STACKED params (leading stack dim):
# a stacked slot is one prunable layer in AMC, so importances reduce over
# every axis except the unit axis and the mask is shared across the stack.
def _sum_except(a: torch.Tensor, unit_axis: int) -> torch.Tensor:
    unit_axis %= a.dim()
    axes = tuple(i for i in range(a.dim()) if i != unit_axis)
    return torch.sum(a.to(F32) ** 2, dim=axes)


def head_group_importance(attn_p) -> torch.Tensor:
    """(n_kv,) importance of each GQA group = L2 of its wo rows + wq cols."""
    wo = attn_p["wo"]                          # (..., H, hd, D)
    wq = attn_p["wq"]                          # (..., D, H, hd)
    H = wo.shape[-3]
    K = attn_p["wk"].shape[-2]
    G = H // K
    per_head = torch.sqrt(_sum_except(wo, -3) + _sum_except(wq, -2))
    return per_head.reshape(K, G).sum(dim=1)


def ffn_importance(ffn_p) -> torch.Tensor:
    """(d_ff,) importance of each hidden unit."""
    imp = _sum_except(ffn_p["w_out"], -2) + _sum_except(ffn_p["w_in"], -1)
    if "w_gate" in ffn_p:
        imp = imp + _sum_except(ffn_p["w_gate"], -1)
    return torch.sqrt(imp)


def expert_importance(moe_p) -> torch.Tensor:
    """(E,) router-norm + weight-norm importance of each expert."""
    return torch.sqrt(_sum_except(moe_p["router"], -1)
                      + _sum_except(moe_p["w_out"], -3))


def keep_mask(importance: torch.Tensor, keep_ratio) -> torch.Tensor:
    """fp32 mask keeping the top keep_ratio fraction (at least 1 unit);
    ties keep the lower index (stable sorts, as the reference's argsort).

    The count is the reference's ``round(keep_ratio * n)``: a Python
    ratio multiplies in float64 and the product is rounded to float32
    before rounding half to even in float32 (a tensor ratio multiplies in
    float32), so a ratio on a .5 boundary keeps the same count."""
    n = importance.shape[0]
    if isinstance(keep_ratio, torch.Tensor):
        prod = keep_ratio.to(F32) * n
    else:
        prod = torch.tensor(keep_ratio * n, dtype=F32)
    k = int(torch.clamp(torch.round(prod), 1, n))
    order = torch.argsort(-importance, stable=True)
    ranks = torch.argsort(order, stable=True)
    return (ranks < k).to(F32)


# ---------------------------------------------------------------- mask ----
# masks broadcast against TRAILING axes, so layer-stacked leading dims pass
# through untouched.
def mask_attn(attn_p, group_mask: torch.Tensor):
    """Zero out pruned GQA groups. group_mask (n_kv,)."""
    K = group_mask.shape[0]
    H = attn_p["wo"].shape[-3]
    G = H // K
    head_mask = torch.repeat_interleave(group_mask, G)
    out = dict(attn_p)
    out["wq"] = attn_p["wq"] * head_mask[:, None].to(attn_p["wq"].dtype)
    out["wo"] = attn_p["wo"] * head_mask[:, None, None].to(
        attn_p["wo"].dtype)
    out["wk"] = attn_p["wk"] * group_mask[:, None].to(attn_p["wk"].dtype)
    out["wv"] = attn_p["wv"] * group_mask[:, None].to(attn_p["wv"].dtype)
    return out


def mask_ffn(ffn_p, unit_mask: torch.Tensor):
    out = dict(ffn_p)
    m = unit_mask.to(ffn_p["w_in"].dtype)
    out["w_in"] = ffn_p["w_in"] * m
    if "w_gate" in ffn_p:
        out["w_gate"] = ffn_p["w_gate"] * m
    out["w_out"] = ffn_p["w_out"] * m[:, None]
    return out


def mask_experts(moe_p, expert_mask: torch.Tensor):
    """Route around pruned experts (-1e9 on their router logits, in the
    router's fp32) and zero their output weights."""
    out = dict(moe_p)
    out["router"] = moe_p["router"] + torch.where(
        expert_mask > 0, 0.0, -1e9).to(moe_p["router"].dtype)
    m = expert_mask.to(moe_p["w_out"].dtype)
    out["w_out"] = moe_p["w_out"] * m[:, None, None]
    return out


# --------------------------------------------------------------- slice ----
def slice_ffn(ffn_p, keep_idx: np.ndarray):
    idx = torch.as_tensor(np.asarray(keep_idx), dtype=torch.long,
                          device=ffn_p["w_in"].device)
    out = {"w_in": ffn_p["w_in"][:, idx],
           "w_out": ffn_p["w_out"][idx, :]}
    if "w_gate" in ffn_p:
        out["w_gate"] = ffn_p["w_gate"][:, idx]
    return out


def slice_attn(attn_p, keep_groups: np.ndarray):
    K = attn_p["wk"].shape[1]
    H = attn_p["wq"].shape[1]
    G = H // K
    dev = attn_p["wq"].device
    head_idx = torch.as_tensor(np.concatenate(
        [np.arange(g * G, (g + 1) * G) for g in keep_groups]),
        dtype=torch.long, device=dev)
    groups = torch.as_tensor(np.asarray(keep_groups), dtype=torch.long,
                             device=dev)
    return {
        "wq": attn_p["wq"][:, head_idx],
        "wk": attn_p["wk"][:, groups],
        "wv": attn_p["wv"][:, groups],
        "wo": attn_p["wo"][head_idx],
    }


# ------------------------------------------------------------ flops ----
def block_flops(cfg, tokens: int) -> Dict[str, float]:
    """Per-block FLOPs split by prunable site (for AMC states/budget)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    gated = cfg.activation in ("swiglu", "geglu")
    attn = 2.0 * tokens * d * (H + 2 * K) * hd + 2.0 * tokens * H * hd * d
    ffn = 2.0 * tokens * d * cfg.d_ff * (3 if gated else 2)
    return {"attn": attn, "ffn": ffn}
