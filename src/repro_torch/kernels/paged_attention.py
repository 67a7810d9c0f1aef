"""Python wrappers of the hand-written Hopper paged-attention kernels
(``csrc/paged_attention.cu``).

Each replaces the Pallas TPU kernel of the same name in
``repro.kernels.paged_attention``: ``paged_attention_fwd`` (one-token
decode) and ``paged_prefill_fwd`` (chunked prefill) over a bf16 page pool,
``paged_attention_quant_fwd`` and ``paged_prefill_quant_fwd`` over a
quantized one (int8, or int4 packed two per byte along hd, with fp32
per-slot, per-head scales; the bitwidth is read from the stored shape).
All four walk ``page_table[b]`` page by page with an fp32 online softmax,
the softcap before the mask and the local window, dequantize each element
as it is read, and never build the dense chronological KV view.

What bounds them on the H100: the bytes of the live K/V pages (codes and
scales, for a quantized pool) each (sequence, kv head) walks, over
3.35 TB/s. The design loads each page once per kv head for all G query
heads (decode) or a BM-row tile of them (prefill), streams pages in their
stored width through a two-stage cp.async ring, and keeps the softmax
state in shared memory — see the source's header note.

On a CPU tensor each wrapper returns its plain version from
``kernels/ref.py``; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of each kernel; a wrapper adds one where it launches, and only
# there (chip_smoke.py zeroes these around the main path)
LAUNCHES = {"paged_attention_fwd": 0, "paged_prefill_fwd": 0,
            "paged_attention_quant_fwd": 0, "paged_prefill_quant_fwd": 0}

PREFILL_BM = 32       # query rows (of the flattened Sq*G) per prefill CTA
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, pool_k, pool_v, page_table, positions, rows, scales=()):
    """Validate a launch; ``scales`` (k_scale, v_scale) marks a quantized
    pool. Returns (library, bits of the pool)."""
    named = (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
             ("page_table", page_table), ("positions", positions))
    if scales:
        named += (("k_scale", scales[0]), ("v_scale", scales[1]))
    if not all(t.is_cuda for _, t in named):
        raise ValueError("paged attention kernel: every tensor must be on "
                         "the CUDA device")
    pool_dtype = torch.int8 if scales else torch.bfloat16
    if q.dtype != torch.bfloat16 or pool_k.dtype != pool_dtype \
            or pool_v.dtype != pool_dtype:
        raise TypeError(f"paged attention kernel takes bf16 q and "
                        f"{pool_dtype} pools, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError("paged attention kernel takes fp32 scales")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged attention kernel takes int32 page_table and "
                        "positions")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be "
                             f"contiguous")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4:
        raise ValueError(f"pools must both be (P, page, K, hd_store), got "
                         f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    _, page, K, _ = pool_k.shape
    H, hd = q.shape[-2], q.shape[-1]
    bits = ref.kv_bits_of(pool_k, hd) if scales else 16
    if (not scales and pool_k.shape[-1] != hd) or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool_k.shape)}")
    if any(s.shape != pool_k.shape[:3] for s in scales):
        raise ValueError(f"scales must be (P, page, K) = "
                         f"{tuple(pool_k.shape[:3])}, got "
                         f"{[tuple(s.shape) for s in scales]}")
    if hd % 32 or hd > 256:
        raise ValueError(f"kernel needs hd % 32 == 0 and hd <= 256, got {hd}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (cp.async)")
    if any(s.data_ptr() % 4 for s in scales):
        raise ValueError("scales must be 4-byte aligned (cp.async)")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError("page_table must be (B, n_blocks) and positions "
                         "(B,)")
    lib = build.load("paged_attention")
    smem = lib.paged_smem_bytes(rows, hd, page, bits)
    if smem > SMEM_LIMIT:
        raise ValueError(f"page={page}, hd={hd}, {rows} rows need {smem} B "
                         f"of shared memory, over {SMEM_LIMIT}")
    return lib, bits


def _raise_on(lib, rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.paged_error_string(rc).decode()}")


def paged_attention_fwd(q, pool_k, pool_v, page_table, positions, *,
                        window=0, cap=0.0):
    """q (B, H, hd) bf16; pool_k/v (P, page, K, hd) bf16; page_table
    (B, n_blocks) int32 (unused tails -> scratch page 0); positions (B,)
    int32. Returns (B, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool_k, pool_v, page_table,
                                       positions, window=window, cap=cap)
    B, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, _ = _check(q, pool_k, pool_v, page_table, positions, H // K)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, H, K, hd, page, page_table.shape[1], int(window), float(cap),
        stream)
    _raise_on(lib, rc, "paged_attention_fwd")
    LAUNCHES["paged_attention_fwd"] += 1
    return out


def paged_prefill_fwd(q, pool_k, pool_v, page_table, positions, *,
                      window=0, cap=0.0):
    """q (B, Sq, H, hd) bf16 — one prompt chunk per sequence whose K/V are
    already in the pool; positions (B,) int32 position of each chunk's
    first token. Returns (B, Sq, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, pool_k, pool_v, page_table,
                                     positions, window=window, cap=cap)
    B, Sq, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, _ = _check(q, pool_k, pool_v, page_table, positions, PREFILL_BM)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_prefill_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, Sq, H, K, hd, page, page_table.shape[1], int(window), float(cap),
        PREFILL_BM, stream)
    _raise_on(lib, rc, "paged_prefill_fwd")
    LAUNCHES["paged_prefill_fwd"] += 1
    return out


def paged_attention_quant_fwd(q, pool_k, k_scale, pool_v, v_scale,
                              page_table, positions, *, window=0, cap=0.0):
    """Fused-dequant paged decode. q (B, H, hd) bf16; pool_k/v
    (P, page, K, hd_store) int8 with hd_store = hd (int8) or hd//2 (int4
    packed along hd); k/v_scale (P, page, K) fp32; page_table and positions
    as paged_attention_fwd. Returns (B, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_attention_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    B, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, bits = _check(q, pool_k, pool_v, page_table, positions, H // K,
                       (k_scale, v_scale))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_quant(
        q.data_ptr(), pool_k.data_ptr(), k_scale.data_ptr(),
        pool_v.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, H, K, hd, page,
        page_table.shape[1], int(window), float(cap), bits, stream)
    _raise_on(lib, rc, "paged_attention_quant_fwd")
    LAUNCHES["paged_attention_quant_fwd"] += 1
    return out


def paged_prefill_quant_fwd(q, pool_k, k_scale, pool_v, v_scale,
                            page_table, positions, *, window=0, cap=0.0):
    """Fused-dequant chunked prefill. q (B, Sq, H, hd) bf16, the chunk's
    K/V already quantized into the pool; pools and scales as
    paged_attention_quant_fwd; positions (B,) chunk starts. Returns
    (B, Sq, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_prefill_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    B, Sq, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, bits = _check(q, pool_k, pool_v, page_table, positions, PREFILL_BM,
                       (k_scale, v_scale))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_prefill_quant(
        q.data_ptr(), pool_k.data_ptr(), k_scale.data_ptr(),
        pool_v.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, Sq, H, K, hd, page,
        page_table.shape[1], int(window), float(cap), PREFILL_BM, bits,
        stream)
    _raise_on(lib, rc, "paged_prefill_quant_fwd")
    LAUNCHES["paged_prefill_quant_fwd"] += 1
    return out
