"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
GeGLU, sandwich norms, head_dim 256. [arXiv:2408.00118; hf]

long_500k is supported: the interleaved local layers bound their KV window at
4096; global layers keep the full cache (hybrid-local, see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    activation="geglu",
    attn_pattern=("local", "global"),
    window_size=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sandwich_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2408.00118",
)
