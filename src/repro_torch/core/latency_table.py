"""Per-op latency lookup table + differentiable expected latency (paper
Eq. 2; port of ``repro.core.latency_table``).

"To build the latency model we pre-compute the latency of each operator
with all possible inputs. During search we query the lookup table." The
table is precomputed from the roofline model (core/hardware_model.py) for
every candidate op of the LM search space at the target (batch, seq)
shape, per hardware target.

E[LAT] = sum_i sum_op p_{i,op} * F(op_i)          (Eq. 2)

p = softmax(alpha) makes E[LAT] differentiable in the architecture
parameters, which lets the search fold hardware latency into its loss
(Eq. 3).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.supernet_lm import CANDIDATE_OPS
from repro_torch.core import hardware_model as hwm

# (window, FFN expansion) of each attention op
ATTN_OPS = {
    "attn_full_e2": (0, 2), "attn_full_e4": (0, 4),
    "attn_local1k_e2": (1024, 2), "attn_local1k_e4": (1024, 4),
    "attn_local4k_e4": (4096, 4),
}


def op_latency(op: str, cfg, batch: int, seq: int, hw: hwm.Hardware,
               *, decode: bool = False) -> float:
    """Roofline latency of one candidate block-op at the given shape
    (seconds)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    tokens = batch * (1 if decode else seq)
    q_len = 1 if decode else seq
    tp = min(hw.chips, 16)
    if op == "zero":
        return 0.0
    if op == "mamba2_e2":
        s = cfg.ssm
        t = hwm.linear_cost(tokens, d, 2 * 2 * d, tp=tp).latency(hw)
        t += hwm.ssd_cost(batch, q_len, 2 * d, s.d_state if s else 64,
                          s.chunk if s else 128).latency(hw)
        t += hwm.linear_cost(tokens, 2 * d, d, tp=tp).latency(hw)
        return float(t)
    window, e = ATTN_OPS[op]
    H, K = cfg.num_heads, cfg.num_kv_heads
    t = hwm.linear_cost(tokens, d, (H + 2 * K) * hd, tp=tp).latency(hw)
    t += hwm.attention_cost(batch, q_len, seq, H, K, hd, window=window,
                            decode=decode).latency(hw)
    t += hwm.linear_cost(tokens, H * hd, d, tp=tp).latency(hw)
    # gated FFN at expansion e: 3 matmuls
    t += 3.0 * hwm.linear_cost(tokens, d, e * d, tp=tp).latency(hw)
    return float(t)


def build_lut(cfg, batch: int, seq: int, hw: hwm.Hardware,
              ops: Sequence[str] = CANDIDATE_OPS, *,
              decode: bool = False) -> torch.Tensor:
    """(n_blocks, n_ops) fp32 latency table F — Eq. 2's per-op terms, one
    row per block (every block's ops cost the same)."""
    row = np.array([op_latency(op, cfg, batch, seq, hw, decode=decode)
                    for op in ops], np.float32)
    return torch.from_numpy(np.tile(row, (cfg.num_layers, 1)))


def expected_latency(alpha: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Eq. 2: E[LAT] = sum_i <softmax(alpha_i), F_i>. Differentiable."""
    return torch.sum(torch.softmax(alpha, dim=-1) * lut)


def sampled_latency(gates: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Latency of one sampled architecture (gates one-hot per block)."""
    return torch.sum(gates * lut)
