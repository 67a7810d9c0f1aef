"""Whole-prompt attention for long sequences (port of
``repro.models.flash``).

Every whole-sequence forward of ``FLASH_MIN`` tokens or more goes through
here instead of the dense ``(S, T)`` score matrix of ``attention._attend``:
on the card through the hand-written flash-attention kernel
(``kernels/flash_attention.py``), on the CPU through its plain version.
The reference's XLA twin computes the same forward blockwise; this module
keeps its shape contract (S and T multiples of their 512-row blocks, or
shorter than one) and its attention kinds.

The reference's custom-VJP backward waits for the training slice (ROADMAP
Queue 1, item 9): the forward is a ``torch.autograd.Function`` whose
backward raises, so a caller that needs a gradient is told so instead of
getting a wrong one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

FLASH_MIN = 2048          # use flash from this q-length on
BLOCK = 512               # the reference's q and kv blocks: they fix its
                          # shape contract
KINDS = ("global", "local", "bidir")


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, kernel):
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    cap=cap, mode=kernel)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash attention's backward (the reference's custom VJP in "
            "repro.models.flash) comes with the training slice (ROADMAP "
            "Queue 1, item 9); the port's flash attention is forward-only")


def flash_attention(q, k, v, kind: str = "global", window: int = 0,
                    cap: float = 0.0, *, kernel: str = "auto"):
    """q (B, S, H, hd), k/v (B, T, K, hd) -> (B, S, H, hd) in q's dtype.

    kind: "global" (causal), "local" (causal, keys within ``window`` of the
    query), "bidir" (full). ``kernel`` is the kernels/ops.py mode: "auto"
    (the CUDA kernel on CUDA tensors, the plain version on CPU ones),
    "cuda" or "ref". Raises ValueError on lengths the reference rejects."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}, not in {KINDS}")
    S, T = q.shape[1], k.shape[1]
    if S % min(BLOCK, S) or T % min(BLOCK, T):
        raise ValueError(
            f"flash attention takes S and T that are multiples of {BLOCK} "
            f"(or shorter than it), as the reference does; got S={S}, "
            f"T={T}")
    if kind == "local" and window <= 0:
        raise ValueError(f"local attention needs a window > 0, got {window}")
    return _FlashForward.apply(q, k, v, kind != "bidir",
                               int(window) if kind == "local" else 0,
                               float(cap), kernel)
