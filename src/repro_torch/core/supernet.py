"""Path-level binarized supernet (paper §2 / ProxylessNAS), LM-adapted
(port of ``repro.core.supernet``).

Each of the N blocks holds 7 candidate ops (configs/supernet_lm.py).
During search exactly ONE path per block is active (Eq. 1: x_l = sum_i
g_i o_i(x), g ~ Multinomial(softmax(alpha))): a Python branch on the
sampled gate, so only the sampled op runs — the paper's saving of
GPU-hours and memory ("path-level binarization"). The reference selects
with ``lax.switch`` for the same effect under jit.

Gradient estimator: the sampled path's output is scaled by
(p_i - p_i.detach() + 1), the straight-through estimator of the paper's
dL/dalpha_i ~ sum_j dL/dg_j dp_j/dalpha_i with the sampled g as the
evaluation point. The latency term (Eq. 2/3) uses the full softmax, so
every alpha receives a dense hardware-cost gradient each step even though
only one path computes.

The attention ops go through ``attention_fwd``: from FLASH_MIN tokens on
through flash attention (the kernel on the card, its plain-PyTorch
backward in the search's steps). The residual stream keeps the
parameters' dtype: the reference's straight-through product promotes a
bf16 stream to fp32 after the first block (JAX promotes a bf16 array
times an fp32 scalar array), which would keep every later attention op
off the bf16 flash kernel; with fp32 parameters both compute the same.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.supernet_lm import BACKBONE, CANDIDATE_OPS
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import ffn_apply, ffn_defs, norm_def, rms_norm
from repro_torch.models.params import PDef, init_params, param_count
from repro_torch.models.transformer import chunked_ce, embed_tokens

F32 = torch.float32

OP_SPECS = {
    "attn_full_e2": dict(kind="global", window=0, expand=2, arm="attn"),
    "attn_full_e4": dict(kind="global", window=0, expand=4, arm="attn"),
    "attn_local1k_e2": dict(kind="local", window=1024, expand=2, arm="attn"),
    "attn_local1k_e4": dict(kind="local", window=1024, expand=4, arm="attn"),
    "attn_local4k_e4": dict(kind="local", window=4096, expand=4, arm="attn"),
    "mamba2_e2": dict(arm="ssm"),
    "zero": dict(arm="zero"),
}


# ------------------------------------------------------------ parameters ----
def _op_defs(cfg, op: str) -> Dict[str, Any]:
    spec = OP_SPECS[op]
    d = cfg.d_model
    if spec["arm"] == "zero":
        return {"_": PDef((1,), ("null",), "zeros")}
    if spec["arm"] == "ssm":
        return {"ln": norm_def(d), "mamba": ssm_lib.mamba_defs(cfg)}
    return {
        "ln1": norm_def(d),
        "attn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim),
        "ln2": norm_def(d),
        "ffn": ffn_defs(d, spec["expand"] * d, cfg.activation),
    }


def supernet_defs(cfg=BACKBONE) -> Dict[str, Any]:
    return {
        "embed": PDef((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      "normal"),
        # a list: every block has parameters of its own
        "blocks": [{op: _op_defs(cfg, op) for op in CANDIDATE_OPS}
                   for _ in range(cfg.num_layers)],
        "final_norm": norm_def(cfg.d_model),
        "lm_head": PDef((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"),
                        "scaled"),
    }


def init_supernet(generator: torch.Generator, device, cfg=BACKBONE):
    """Random supernet parameters on ``device`` from ``generator`` and the
    architecture parameters alpha (n_blocks, n_ops), zero: the uniform
    mixture."""
    params = init_params(supernet_defs(cfg), generator, device)
    alpha = torch.zeros((cfg.num_layers, len(CANDIDATE_OPS)), dtype=F32,
                        device=device)
    return params, alpha


# ----------------------------------------------------------------- apply ----
def _apply_op(op: str, p, x, cfg, positions):
    spec = OP_SPECS[op]
    if spec["arm"] == "zero":
        return x * 1.0
    if spec["arm"] == "ssm":
        y, _ = ssm_lib.mamba_block_fwd(p["mamba"],
                                       rms_norm(x, p["ln"], cfg.norm_eps), cfg)
        return x + y
    sub_cfg = cfg.replace(window_size=spec["window"] or cfg.window_size)
    a, _ = attn.attention_fwd(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                              spec["kind"], sub_cfg, positions)
    x = x + a
    f = ffn_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps),
                  cfg.activation)
    return x + f


def supernet_forward(params, alpha, gates, batch, cfg=BACKBONE):
    """gates: (N,) sampled op index per block (path binarization), a
    tensor (read once to the host) or a sequence of ints.

    Returns the final hidden states; the caller computes the CE."""
    gates = gates.tolist() if isinstance(gates, torch.Tensor) else gates
    tokens = batch["tokens"]
    x = embed_tokens(params, tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    probs = torch.softmax(alpha, dim=-1)
    for i, block in enumerate(params["blocks"]):
        g = int(gates[i])
        op = CANDIDATE_OPS[g]
        y = _apply_op(op, block[op], x, cfg, positions)
        # straight-through: scale by (p - sg(p) + 1) so dL/dalpha_i flows
        p_i = probs[i, g]
        x = (y.to(F32) * (p_i - p_i.detach() + 1.0)).to(y.dtype)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def supernet_loss(params, alpha, gates, batch, cfg=BACKBONE):
    hidden = supernet_forward(params, alpha, gates, batch, cfg)
    return chunked_ce(params, hidden, batch["labels"], cfg)


def sample_gates(generator: torch.Generator, alpha) -> torch.Tensor:
    """Multinomial path sampling per block (Eq. 1's g) from
    softmax(alpha), on alpha's device (``generator`` a generator of that
    device)."""
    probs = torch.softmax(alpha.detach(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def derive_arch(alpha) -> List[str]:
    """argmax op per block — the specialized child architecture."""
    return [CANDIDATE_OPS[i] for i in torch.argmax(alpha, dim=-1).tolist()]


def child_param_count(arch: List[str], cfg=BACKBONE) -> int:
    total = param_count({"e": PDef((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"))})
    total *= 2  # embed + head
    for op in arch:
        if OP_SPECS[op]["arm"] != "zero":
            total += param_count(_op_defs(cfg, op))
    return total
