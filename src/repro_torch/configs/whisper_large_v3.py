"""whisper-large-v3 [audio] — enc-dec; conv frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model). [arXiv:2212.04356]

num_layers=32 applies to both the encoder and the decoder stacks.
Decoder length = seq_len // dec_ratio. MHA (kv == q heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    rope_theta=0.0,  # sinusoidal positions, no RoPE
    is_encdec=True,
    dec_ratio=8,
    frontend="audio_stub",
    source="arXiv:2212.04356",
)
