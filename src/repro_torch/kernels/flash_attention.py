"""Python wrapper of the hand-written Hopper flash-attention forward
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces the Pallas TPU kernel of the same name in
``repro.kernels.flash_attention``: dense attention of q (B, S, H, hd) over
k, v (B, T, K, hd) with GQA (query head h = k*G + g reads kv head k),
causal, local-window or full, with the softcap before the mask. It serves
whole-prompt prefill: every forward of ``models/flash.py::FLASH_MIN``
tokens or more (``chunked_prefill=False`` in the engine, and ``generate``).

What bounds it on the H100: the operations, 4*hd flops per valid (query
head, key) pair, over the tensor cores' rate. The kernel runs both
products on the tensor cores (mma.sync, fp32 accumulation), loads each
64-key K/V tile once for a 128-row tile of the fused (S*G) query rows of
one kv head, streams K/V through a two-stage cp.async ring and skips kv
tiles above the diagonal or below the window — see the source's header
note.

On a CPU tensor the wrapper returns its plain version
(``kernels/ref.py::flash_attention_ref``); on a CUDA tensor it launches
the kernel or raises. ``LAUNCHES`` counts kernel launches, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel; the wrapper adds one where it launches, and only
# there (chip_smoke.py zeroes it around the main path)
LAUNCHES = {"flash_attention_fwd": 0}

HEAD_DIMS = (32, 64, 128, 256)   # the head widths the kernel is built for


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, window) -> None:
    named = (("q", q), ("k", k), ("v", v))
    if not all(t.is_cuda and t.device == q.device for _, t in named):
        raise ValueError("flash attention kernel: q, k and v must be on one "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for _, t in named):
        raise TypeError(f"flash attention kernel takes bf16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"16-byte aligned (cp.async)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, T, K, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, T, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (need the same B and hd, H a "
                         f"multiple of K)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel is built for hd in {HEAD_DIMS}, got {hd}")
    if B == 0 or S == 0 or T == 0:
        raise ValueError(f"empty attention: B={B}, S={S}, T={T}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, cap=0.0):
    """q (B, S, H, hd) bf16; k, v (B, T, K, hd) bf16, H = K*G. ``causal``:
    key j <= query i; ``window`` > 0: key j > i - window (with or without
    ``causal``); ``cap`` > 0: scores softcapped before the mask. Returns
    (B, S, H, hd) bf16. A query with no valid key at all (only possible
    with ``causal=False``, a window, and the query past T + window - 2)
    is undefined: the kernel averages v over the kv tiles it visits, as the
    Pallas kernel does over its own, where the plain version averages all
    of v."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap)
    _check(q, k, v, int(window))
    B, S, H, hd = q.shape
    _, T, K, _ = k.shape
    lib = build.load("flash_attention")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), B, S, T, H, K, hd, int(causal),
                            int(window), float(cap), stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
