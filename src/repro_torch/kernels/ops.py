"""Dispatch between the hand-written CUDA kernels and their plain versions.

``mode`` works like ``repro.kernels.ops._paged_mode``:
  "auto" — the kernel's wrapper (kernels/paged_attention.py,
           kernels/flash_attention.py, kernels/quant_matmul.py), which
           launches the CUDA kernel for CUDA tensors and takes the plain
           version (kernels/ref.py) for CPU tensors;
  "cuda" — the CUDA kernel, or an error;
  "ref"  — the plain version, chosen explicitly (tests, and the plain side
           of chip_smoke.py's comparisons).
Nothing here catches a build or launch error to fall back on the plain
version.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import ref


def resolve_mode(mode: str, t, what: str) -> str:
    """Validate ``mode`` for a call on tensor ``t``: "cuda" needs a CUDA
    tensor, and only the three modes exist."""
    if mode == "cuda" and not t.is_cuda:
        raise ValueError(f"{what} mode 'cuda' needs CUDA tensors; use 'ref' "
                         f"or 'auto' on the CPU")
    if mode not in ("auto", "cuda", "ref"):
        raise ValueError(f"unknown {what} mode {mode!r}")
    return mode


def _quant_products(mode: str, x):
    """(w8a16, w4a16, w8a8) for ``mode``: the plain versions for "ref",
    the wrappers otherwise."""
    if resolve_mode(mode, x, "quant-matmul") == "ref":
        return (ref.quant_matmul_w8a16, ref.quant_matmul_w4a16,
                ref.quant_matmul_w8a8)
    return (qmm.quant_matmul_w8a16, qmm.quant_matmul_w4a16,
            qmm.quant_matmul_w8a8)


def quant_matmul(x, w, *, w_bits: int = 8, a_bits: int = 16,
                 mode: str = "auto"):
    """Drop-in ``einsum('...d,df->...f')`` with on-the-fly per-channel
    weight quantization — the HAQ ``dot`` hook's kernel path: W4A16 if
    w_bits <= 4, W8A8 (x quantized per tensor) if a_bits <= 8, else
    W8A16. Any number of rows; the reference's padding of M to its block
    is the kernel's own row guard here."""
    return quant_matmul_prepared(x, prepare_quantized(w, w_bits),
                                 a_bits=a_bits, mode=mode)


def prepare_quantized(w, w_bits: int):
    """One-time weight quantization for serving (stored int side
    tables)."""
    if w_bits <= 4:
        packed, scale = ref.quantize_w4_packed(w)
        return {"q": packed, "scale": scale, "bits": 4}
    q, scale = ref.quantize_w8(w)
    return {"q": q, "scale": scale, "bits": 8}


def quant_matmul_prepared(x, qw, *, a_bits: int = 16, mode: str = "auto"):
    """``quant_matmul`` over weights from ``prepare_quantized``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    w8a16, w4a16, w8a8 = _quant_products(mode, x)
    if int(qw["bits"]) <= 4:
        out = w4a16(x2, qw["q"], qw["scale"])
    elif a_bits <= 8:
        xq, xs = ref.quantize_a8(x2)
        out = w8a8(xq, xs, qw["q"], qw["scale"], out_dtype=x.dtype)
    else:
        out = w8a16(x2, qw["q"], qw["scale"])
    return out.reshape(*lead, out.shape[-1])


def paged_attention(q, pool_k, pool_v, page_table, positions, *,
                    window=0, cap=0.0, mode: str = "auto", kv_heads=None):
    """Paged-attention decode: q (B, H, hd) against the page pool.
    ``kv_heads``: the model's kv-head count when the pool holds a shard's
    slice of it (the split plan reads it; ``decode_splits``)."""
    if resolve_mode(mode, q, "paged-attention") == "ref":
        return ref.paged_attention_ref(q, pool_k, pool_v, page_table,
                                       positions, window=window, cap=cap)
    return pa.paged_attention_fwd(q, pool_k, pool_v, page_table, positions,
                                  window=window, cap=cap, kv_heads=kv_heads)


def paged_attention_prefill(q, pool_k, pool_v, page_table, positions, *,
                            window=0, cap=0.0, mode: str = "auto"):
    """Chunked-prefill attention: q (B, Sq, H, hd), one prompt chunk per
    sequence whose K/V are already in the pool; ``positions`` holds the
    chunk-start offsets."""
    if resolve_mode(mode, q, "paged-attention") == "ref":
        return ref.paged_prefill_ref(q, pool_k, pool_v, page_table,
                                     positions, window=window, cap=cap)
    return pa.paged_prefill_fwd(q, pool_k, pool_v, page_table, positions,
                                window=window, cap=cap)


def paged_attention_quant(q, pool_k, k_scale, pool_v, v_scale, page_table,
                          positions, *, window=0, cap=0.0,
                          mode: str = "auto", kv_heads=None):
    """Fused-dequant paged decode over a quantized pool: pool_k/v
    (P, page, K, hd_store) int8 (hd_store = hd for int8, hd//2 for int4),
    k/v_scale (P, page, K) fp32; ``kv_heads`` as paged_attention."""
    if resolve_mode(mode, q, "paged-attention") == "ref":
        return ref.paged_attention_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    return pa.paged_attention_quant_fwd(
        q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
        window=window, cap=cap, kv_heads=kv_heads)


def paged_attention_prefill_quant(q, pool_k, k_scale, pool_v, v_scale,
                                  page_table, positions, *, window=0,
                                  cap=0.0, mode: str = "auto"):
    """Fused-dequant chunked prefill over a quantized pool (the chunk's K/V
    already quantized into it); ``positions`` holds the chunk starts."""
    if resolve_mode(mode, q, "paged-attention") == "ref":
        return ref.paged_prefill_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    return pa.paged_prefill_quant_fwd(
        q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
        window=window, cap=cap)


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0,
                    mode: str = "auto", return_lse: bool = False):
    """Dense flash-attention forward (whole-prompt prefill, and training's
    forward): q (B, S, H, hd) over k, v (B, T, K, hd), causal and/or a
    local window, softcap; with ``return_lse`` also the rows' fp32
    log-sum-exp (B, H, S)."""
    if resolve_mode(mode, q, "flash-attention") == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap, return_lse=return_lse)
    return fa.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  cap=cap, return_lse=return_lse)
