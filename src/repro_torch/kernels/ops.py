"""Dispatch between the hand-written CUDA kernels and their plain versions.

``mode`` works like ``repro.kernels.ops._paged_mode``:
  "auto" — the kernel's wrapper (kernels/paged_attention.py), which
           launches the CUDA kernel for CUDA tensors and takes the plain
           version (kernels/ref.py) for CPU tensors;
  "cuda" — the CUDA kernel, or an error;
  "ref"  — the plain version, chosen explicitly (tests, and the plain side
           of chip_smoke.py's comparisons).
Nothing here catches a build or launch error to fall back on the plain
version.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref


def _paged_mode(mode: str, q) -> str:
    if mode == "cuda" and not q.is_cuda:
        raise ValueError("paged-attention mode 'cuda' needs CUDA tensors; "
                         "use 'ref' or 'auto' on the CPU")
    if mode not in ("auto", "cuda", "ref"):
        raise ValueError(f"unknown paged-attention mode {mode!r}")
    return mode


def paged_attention(q, pool_k, pool_v, page_table, positions, *,
                    window=0, cap=0.0, mode: str = "auto"):
    """Paged-attention decode: q (B, H, hd) against the page pool."""
    if _paged_mode(mode, q) == "ref":
        return ref.paged_attention_ref(q, pool_k, pool_v, page_table,
                                       positions, window=window, cap=cap)
    return pa.paged_attention_fwd(q, pool_k, pool_v, page_table, positions,
                                  window=window, cap=cap)


def paged_attention_prefill(q, pool_k, pool_v, page_table, positions, *,
                            window=0, cap=0.0, mode: str = "auto"):
    """Chunked-prefill attention: q (B, Sq, H, hd), one prompt chunk per
    sequence whose K/V are already in the pool; ``positions`` holds the
    chunk-start offsets."""
    if _paged_mode(mode, q) == "ref":
        return ref.paged_prefill_ref(q, pool_k, pool_v, page_table,
                                     positions, window=window, cap=cap)
    return pa.paged_prefill_fwd(q, pool_k, pool_v, page_table, positions,
                                window=window, cap=cap)


def paged_attention_quant(q, pool_k, k_scale, pool_v, v_scale, page_table,
                          positions, *, window=0, cap=0.0,
                          mode: str = "auto"):
    """Fused-dequant paged decode over a quantized pool: pool_k/v
    (P, page, K, hd_store) int8 (hd_store = hd for int8, hd//2 for int4),
    k/v_scale (P, page, K) fp32."""
    if _paged_mode(mode, q) == "ref":
        return ref.paged_attention_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    return pa.paged_attention_quant_fwd(
        q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
        window=window, cap=cap)


def paged_attention_prefill_quant(q, pool_k, k_scale, pool_v, v_scale,
                                  page_table, positions, *, window=0,
                                  cap=0.0, mode: str = "auto"):
    """Fused-dequant chunked prefill over a quantized pool (the chunk's K/V
    already quantized into it); ``positions`` holds the chunk starts."""
    if _paged_mode(mode, q) == "ref":
        return ref.paged_prefill_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    return pa.paged_prefill_quant_fwd(
        q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
        window=window, cap=cap)
