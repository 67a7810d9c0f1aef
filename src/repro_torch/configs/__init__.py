"""Architecture registry: ``get_config(arch_id)`` / ``ARCHS``."""
from __future__ import annotations

from repro_torch.configs.base import (ModelConfig, MoEConfig, OptimConfig,
                                ShapeConfig, SSMConfig, TrainConfig, SHAPES)

__all__ = ["ModelConfig", "MoEConfig", "OptimConfig", "ShapeConfig",
           "SSMConfig", "TrainConfig", "SHAPES", "ARCHS", "ALIASES",
           "get_config", "get_shape", "assigned_cells", "tiny_config"]

from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.mistral_large_123b import CONFIG as _mistral
from repro_torch.configs.nemotron_4_15b import CONFIG as _nemotron
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.whisper_large_v3 import CONFIG as _whisper
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.granite_moe_3b import CONFIG as _granite_moe
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.supernet_lm import BACKBONE as _supernet

ARCHS = {
    c.name: c
    for c in [_granite, _mistral, _nemotron, _gemma2, _whisper, _llava,
              _llama4, _granite_moe, _zamba2, _mamba2, _supernet]
}

# Short aliases accepted by --arch.
ALIASES = {
    "granite-3-8b": "granite-3-8b",
    "mistral-large-123b": "mistral-large-123b",
    "nemotron-4-15b": "nemotron-4-15b",
    "gemma2-2b": "gemma2-2b",
    "whisper-large-v3": "whisper-large-v3",
    "llava-next-mistral-7b": "llava-next-mistral-7b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
    "llama4-maverick-400b": "llama4-maverick-400b-a17b",
    "granite-moe-3b-a800m": "granite-moe-3b-a800m",
    "granite-moe-3b": "granite-moe-3b-a800m",
    "zamba2-1.2b": "zamba2-1.2b",
    "mamba2-370m": "mamba2-370m",
    "supernet-lm": "supernet-lm",
}


def get_config(arch: str) -> ModelConfig:
    key = ALIASES.get(arch, arch)
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[key]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def assigned_cells():
    """The graded (arch x shape) cells: every supported shape per arch."""
    cells = []
    for name, cfg in ARCHS.items():
        if name == "supernet-lm":
            continue
        for shape in cfg.supported_shapes:
            cells.append((name, shape))
    return cells


def tiny_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(arch)
    kw = dict(
        num_layers=min(cfg.num_layers, 4 if not cfg.shared_attn_every else 6),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
    )
    if cfg.num_heads:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4
    if cfg.moe:
        kw["moe"] = cfg.moe.__class__(
            num_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=64,
            every=cfg.moe.every,
            offset=cfg.moe.offset,
            # effectively drop-free so prefill/decode equivalence is exact
            capacity_factor=4.0,
        )
    if cfg.ssm:
        kw["ssm"] = cfg.ssm.__class__(
            d_state=16, expand=2, head_dim=32, n_groups=1, conv_width=4,
            chunk=16)
    if cfg.shared_attn_every:
        kw["shared_attn_every"] = 3
    if cfg.window_size:
        kw["window_size"] = 32
    return cfg.replace(name=cfg.name + "-tiny", **kw)
