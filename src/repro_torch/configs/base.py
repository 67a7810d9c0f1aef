"""Config dataclasses shared by every architecture in the zoo.

A ``ModelConfig`` fully determines parameter shapes and the forward graph;
``ShapeConfig`` is one of the four assigned input-shape cells. Everything is
frozen/hashable so configs can be jit static arguments.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    # Which layers are MoE: every `every`-th layer starting at `offset`.
    every: int = 1
    offset: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    num_heads: int = 0          # mamba2 heads; 0 -> d_inner // head_dim
    head_dim: int = 64
    n_groups: int = 1           # B/C groups (GQA-analogue for SSM)
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    activation: str = "swiglu"  # swiglu | geglu | squared_relu | gelu
    # Attention pattern cycled over layers, e.g. ("local", "global") for gemma2.
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 4096
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    sandwich_norm: bool = False  # gemma2 post-sublayer norms
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma-style sqrt(d_model) embed scaling
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention block applied every k core layers
    shared_attn_every: int = 0
    # enc-dec (whisper): num_layers applies to BOTH encoder and decoder
    is_encdec: bool = False
    dec_ratio: int = 8          # decoder_len = seq_len // dec_ratio
    # modality frontends are stubs: input_specs() provides embeddings directly
    frontend: str = "none"      # none | audio_stub | vision_stub
    patch_frac: float = 0.25    # vlm: fraction of sequence that is patches
    dtype: str = "bfloat16"
    # Which shape cells this arch supports ("train_4k", ... ). long_500k is
    # only listed for sub-quadratic archs (see DESIGN.md §4).
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    # HAQ/AMC hooks
    quant_policy: Optional[Tuple[Tuple[str, int], ...]] = None  # (layer_kind, bits)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so embedding/lm_head/logits stay shardable
        on any mesh axis (Megatron-style vocab parallelism). Ids >= vocab_size
        are masked out of the softmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        if not self.ssm:
            return 0
        return self.ssm.num_heads or (self.d_inner // self.ssm.head_dim)

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.moe) and (i - self.moe.offset) % self.moe.every == 0 \
            and i >= self.moe.offset

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_attn = d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
        gated = self.activation in ("swiglu", "geglu")
        per_ffn = d * self.d_ff * (3 if gated else 2)
        blocks = 0
        n_stacks = 2 if self.is_encdec else 1
        for i in range(self.num_layers):
            if self.ssm and not self._is_attn_layer(i):
                di = self.d_inner
                g, n = self.ssm.n_groups, self.ssm.d_state
                nh = self.ssm_heads
                in_proj = d * (2 * di + 2 * g * n + nh)
                blocks += in_proj + di * d + di * self.ssm.conv_width + 3 * nh
            else:
                blocks += per_attn
                if self.is_moe_layer(i):
                    m = self.moe
                    e_ff = m.d_ff_expert
                    blocks += m.num_experts * d * e_ff * (3 if gated else 2)
                    blocks += d * m.num_experts  # router
                elif self.d_ff:
                    blocks += per_ffn
        blocks *= n_stacks
        if self.is_encdec:  # cross attention in decoder
            blocks += self.num_layers * per_attn
        if self.shared_attn_every:
            blocks += per_attn + per_ffn + 2 * d * d  # shared block + fuse proj
        return emb + head + blocks

    def _is_attn_layer(self, i: int) -> bool:
        """For hybrid/ssm families: which core layers are attention."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return False  # zamba2 core stack is all-mamba; attn is the shared block
        return True


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # int8 block-quantized Adam moments (beyond-paper, HAQ-themed; needed to
    # fit 400B-param optimizer state on a 16GiB/chip pod).
    quantized_moments: bool = False
    moment_block: int = 128


@dataclass(frozen=True)
class TrainConfig:
    optim: OptimConfig = field(default_factory=OptimConfig)
    remat: bool = True
    # gradient accumulation: global batch is split into `microbatches` chunks
    # scanned sequentially — bounds live activation memory for the 100B+
    # archs (grads accumulate in sharded fp32)
    microbatches: int = 1
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    log_every: int = 10
    seed: int = 0
