"""Three-term roofline of one step on the H100 (port of
``repro.roofline.analysis``).

Terms (seconds), per chip of ``chips``:
  compute    = FLOPs_global      / (chips * PEAK_FLOPS)
  memory     = bytes_global      / (chips * HBM_BW)
  collective = coll_bytes_global / (chips * ICI_BW)

The constants are the port's hardware model's H100 SXM
(core/hardware_model.py::H100_SXM): 989 TFLOP/s dense bf16, 1,979 TOP/s
int8, 3.35 TB/s of device memory, 80 GiB, and NVLink at 450 GB/s each
way as the collective rate. The collective term prices every byte at
NVLink's rate, even where a model group spans more cards than one host
holds (16 > 8): it is a bound, not a model of the network.

The per-device FLOPs and collective bytes come from
roofline/step_costs.py, which runs the step on meta tensors and counts
them (``analyze_counted``, where the reference's ``analyze_hlo_aware``
parses the compiled HLO); the collective weighting is the reference's:
result-shape bytes, an all-reduce counted twice. The memory term is the
reference's analytic model (``analytic_memory_bytes``), line for line.
The reference's ``analyze`` reads XLA's ``cost_analysis`` (its own
docstring says it undercounts loop bodies) and ``collective_bytes``
parses HLO text; neither has a counterpart over torch.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware_model import H100_SXM

# ---- H100 SXM constants (per card) ----------------------------------------
PEAK_FLOPS = H100_SXM.peak_flops_bf16       # dense bf16
PEAK_FLOPS_INT8 = H100_SXM.peak_flops_int8
HBM_BW = H100_SXM.hbm_bw                    # bytes/s
ICI_BW = H100_SXM.ici_bw                    # NVLink, bytes/s each way
HBM_BYTES = H100_SXM.hbm_bytes              # per card

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "collective-broadcast",
               "ragged-all-to-all")


@dataclasses.dataclass
class Roofline:
    flops_global: float
    bytes_global: float
    coll_bytes_global: float
    chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_global / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_global / (self.chips * ICI_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops_global if self.flops_global else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization if the step ran exactly at the dominant
        roofline term."""
        if not self.t_bound:
            return 0.0
        return self.model_flops / (self.t_bound * self.chips * PEAK_FLOPS)

    def to_dict(self) -> dict:
        return {
            "flops_global": self.flops_global,
            "bytes_global": self.bytes_global,
            "coll_bytes_global": self.coll_bytes_global,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N_active·B (decode per step)."""
    n_active = active_params(cfg)
    if shape.kind == "train":
        toks = shape.tokens
        if cfg.is_encdec:
            toks = shape.global_batch * (shape.seq_len
                                         + shape.seq_len // cfg.dec_ratio)
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch


def active_params(cfg) -> int:
    """Per-token active parameter count (MoE counts top-k experts only)."""
    total = cfg.param_count()
    if not cfg.moe:
        return total
    m = cfg.moe
    gated = cfg.activation in ("swiglu", "geglu")
    per_expert = cfg.d_model * m.d_ff_expert * (3 if gated else 2)
    n_moe_layers = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    inactive = n_moe_layers * (m.num_experts - m.experts_per_token) * per_expert
    return total - inactive


# --------------------------------------------------- analytic memory model ----
def analytic_memory_bytes(cfg, shape, *, weight_bits: float = 16.0,
                          quantized_moments: bool = False) -> float:
    """Global HBM traffic per step (bytes), the reference's explicit model
    (coefficients inline).

    weight_bits: effective stored weight precision (HAQ policies lower it)."""
    P_act = float(active_params(cfg))
    P = float(cfg.param_count())
    d, L = cfg.d_model, cfg.num_layers
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    wb = weight_bits / 8.0                      # bytes per weight
    hd = cfg.resolved_head_dim
    H, K = max(cfg.num_heads, 1), max(cfg.num_kv_heads, 1)

    if shape.kind == "train":
        # weights: fwd read + bwd read + remat re-read (bf16)
        w_stream = 3 * 2 * P
        # grads fp32 write+read; master r/w; moments r/w (fp32 or int8)
        opt = 2 * 4 * P + 2 * 4 * P + (2 * 2 * P if quantized_moments
                                       else 2 * 8 * P) + 2 * P
        # residual stream: ~4 r/w per layer fwd, ~6 with remat bwd
        acts = tokens * d * 2 * L * 10
        # flash KV re-streaming: k/v re-read per q block, fwd + 2 bwd passes
        nq = max(S // 512, 1)
        attn = L * B * S * (2 * K) * hd * 2 * nq * 3 if H else 0
        # chunked CE: lm_head re-read per 256-token chunk, fwd + bwd recompute
        nchunk = max(S // 256, 1)
        ce = d * cfg.padded_vocab * 2 * nchunk * 3
        return w_stream + opt + acts + attn + ce
    if shape.kind == "prefill":
        w_stream = 2 * P_act if cfg.moe else wb * P
        acts = tokens * d * 2 * L * 4
        nq = max(S // 512, 1)
        attn = L * B * S * (2 * K) * hd * 2 * nq if H else 0
        cache = _cache_bytes(cfg, B, S)
        return w_stream + acts + attn + cache
    # decode: one token; weights + cache dominate
    w_stream = wb * P_act
    cache = _cache_bytes(cfg, B, S) * 1.02      # full read + tiny write
    return w_stream + cache + B * d * 2 * L * 6


def _cache_bytes(cfg, B: int, S: int) -> float:
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        s = cfg.ssm
        return cfg.num_layers * B * (cfg.ssm_heads * s.head_dim * s.d_state
                                     * 4 + 3 * (cfg.d_inner + 2 * s.n_groups
                                                * s.d_state) * 2)
    if cfg.family == "hybrid":
        s = cfg.ssm
        ssm = cfg.num_layers * B * (cfg.ssm_heads * s.head_dim * s.d_state * 4)
        n_apps = -(-cfg.num_layers // cfg.shared_attn_every)
        return ssm + n_apps * B * S * cfg.num_kv_heads * hd * 2 * 2
    total = 0.0
    from repro_torch.models.transformer import period_of, sublayer_kinds
    P = period_of(cfg)
    for j, kind in enumerate(sublayer_kinds(cfg)):
        T = min(cfg.window_size, S) if kind["attn"] == "local" else S
        total += (cfg.num_layers // P) * B * T * cfg.num_kv_heads * hd * 2 * 2
    if cfg.is_encdec:
        total += cfg.num_layers * B * S * cfg.num_kv_heads * hd * 2 * 2
    return total


def analyze_counted(costs, chips: int, cfg, shape, *,
                    weight_bits: float = 16.0,
                    quantized_moments: bool = False) -> Roofline:
    """Three-term roofline from one rank's counted costs
    (``step_costs.count_step``: its ``dot_flops`` and ``coll_bytes``,
    scaled by ``chips``) and the analytic memory model above."""
    return Roofline(
        flops_global=costs["dot_flops"] * chips,
        bytes_global=analytic_memory_bytes(
            cfg, shape, weight_bits=weight_bits,
            quantized_moments=quantized_moments),
        coll_bytes_global=costs["coll_bytes"] * chips,
        chips=chips,
        model_flops=model_flops_for(cfg, shape),
    )
