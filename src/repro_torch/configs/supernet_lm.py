"""The paper's own search space (§2), adapted to LM blocks (DESIGN.md §2).

ProxylessNAS CNN space: per block, MBConv {k3,k5,k7} x {e3,e6} + ZeroOp = 7
choices. LM adaptation keeps a 7-way mixed op per block:

  attention arm: {full_gqa, local_1k, local_4k}     (receptive-field analogue
                                                     of kernel size 3/5/7)
  ffn arm:       {swiglu_e2, swiglu_e4}             (expansion-ratio analogue
                                                     of e3/e6, applied to the
                                                     whole block's FFN)
  ssm arm:       {mamba2}                           (TPU-native linear-time op
                                                     the searcher may discover)
  zero arm:      {zero}                             (block skip)

Design-space size = 7^N, N = 21 blocks — identical to the paper.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

# Candidate op ids, in LUT/arch-param order.
CANDIDATE_OPS = (
    "attn_full_e2",
    "attn_full_e4",
    "attn_local1k_e2",
    "attn_local1k_e4",
    "attn_local4k_e4",
    "mamba2_e2",
    "zero",
)

# Backbone dims for the supernet (≈100M-scale so the end-to-end example can
# actually train a specialized child on CPU).
BACKBONE = ModelConfig(
    name="supernet-lm",
    family="dense",
    num_layers=21,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    activation="swiglu",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1, chunk=128),
    source="paper §2 (ProxylessNAS space, LM-adapted)",
)
