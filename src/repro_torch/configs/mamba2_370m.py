"""mamba2-370m [ssm] — attention-free SSD (state-space duality).
[arXiv:2405.21060]

long_500k supported (decode state is O(1) in sequence length).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    activation="swiglu",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, chunk=256),
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2405.21060",
)
