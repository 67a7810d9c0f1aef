"""granite-moe-3b-a800m [moe] — 40 experts top-8, tiny per-expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    moe=MoEConfig(num_experts=40, experts_per_token=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
