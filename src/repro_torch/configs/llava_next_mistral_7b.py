"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres vision tiling is
a STUB: input_specs() provides precomputed patch embeddings for the first
patch_frac of the sequence. [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    activation="swiglu",
    frontend="vision_stub",
    patch_frac=0.25,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
