"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, MoE interleaved with
dense layers 1:1 (matches the ~400B total / ~17B active budget; an all-MoE
stack would be ~770B). Early fusion noted; text backbone only per spec.
[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    activation="swiglu",
    moe=MoEConfig(num_experts=128, experts_per_token=1, d_ff_expert=8192,
                  every=2, offset=1),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
