"""zamba2-1.2b [hybrid] — Mamba2 core stack + one SHARED attention+FFN block
applied every 6 mamba layers, input fused with the original embedding
(concat -> proj), per the Zamba2 design. [arXiv:2411.15242; hf]

Sub-quadratic (SSM core, shared-attn KV only) -> long_500k supported.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    activation="gelu",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1, chunk=256),
    shared_attn_every=6,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2411.15242",
)
