"""Plain PyTorch versions of the port's kernels (the allclose targets).

These define the semantics on the port's side: the CPU path of every
kernel wrapper, and what ``chip_smoke.py`` holds each CUDA kernel against
on the card. They mirror ``repro.kernels.ref`` function for function:
the paged walks over bf16 and quantized (int8, or int4 packed along hd)
page pools, the KV-cache storage mapping the pool writers and the
fused-dequant kernels agree on bit for bit, and the weight-quantized
matmuls (W8A16, W4A16 with int4 packed along K, W8A8) with the quantizers
that feed them, and the dense attention oracle behind flash attention.
"""
from __future__ import annotations

import torch

F32 = torch.float32


# --------------------------------------------------------- quant matmul ----
def quantize_w8(w):
    """Per-output-channel symmetric int8. Returns (q int8 (K,N), scale (N,)
    fp32), q contiguous whatever the layout of ``w``."""
    wf = w.to(F32)
    scale = wf.abs().amax(dim=0) / 127.0 + 1e-12
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q.contiguous(), scale


def quantize_w4_packed(w):
    """Per-channel symmetric int4, two values packed per int8 along K (the
    rows): row 2i rides the low nibble, 2i+1 the high one. Returns
    (packed int8 (K//2, N), scale (N,) fp32)."""
    K = w.shape[0]
    assert K % 2 == 0, K
    wf = w.to(F32)
    scale = wf.abs().amax(dim=0) / 7.0 + 1e-12
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int8)
    return pack_w4(q).contiguous(), scale


def pack_w4(q):
    """Pack int4 codes two per byte along K, the second-to-last axis: row
    2i rides the low nibble, 2i+1 the high one. (..., K, N) int8 in
    [-7, 7] -> (..., K//2, N) int8. The one definition of this format on
    the port's side (serving/quant.py stores weights in it too)."""
    lo = q[..., 0::2, :] & 0x0F
    hi = (q[..., 1::2, :] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_w4(packed):
    """Inverse of ``pack_w4``: (..., K//2, N) int8 -> (..., K, N) int8 in
    [-7, 7] (arithmetic shifts on int8 sign-extend the nibbles)."""
    p = packed.to(torch.int8)
    lo = (p << 4) >> 4
    hi = p >> 4
    *lead, K2, N = p.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, K2 * 2, N)


def quantize_a8(x):
    """Per-tensor symmetric int8 activations. Returns (q int8, scale ()
    fp32)."""
    xf = x.to(F32)
    scale = (xf.abs().amax() + 1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quant_matmul_w8a16(x, w_q, scale):
    """x (M,K) bf16/f32, w_q (K,N) int8, scale (N,) -> (M,N) x.dtype: the
    product in fp32, times the per-column scale, cast once."""
    out = x.to(F32) @ w_q.to(F32)
    return (out * scale[None, :]).to(x.dtype)


def quant_matmul_w4a16(x, packed, scale):
    return quant_matmul_w8a16(x, unpack_w4(packed), scale)


def w8a8_accumulator(x_q, w_q):
    """The exact int32 product of int8 x (M,K) and int8 w (K,N). Taken in
    fp64, where every partial sum (|acc| <= 127**2 * K < 2**53) is exact,
    because an integer matmul has no CUDA path in PyTorch."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def quant_matmul_w8a8(x_q, x_scale, w_q, w_scale, out_dtype=torch.bfloat16):
    """int8 x int8 -> int32 accumulate -> rescale (acc * x_scale) * w_scale,
    in the reference's order, cast to ``out_dtype``."""
    acc = w8a8_accumulator(x_q, w_q)
    return (acc.to(F32) * x_scale * w_scale[None, :]).to(out_dtype)


# ----------------------------------------------------- KV-cache quant ------
def kv_qmax(bits: int) -> float:
    """Symmetric integer range for a KV bitwidth (int8 -> 127, int4 -> 7)."""
    if bits not in (4, 8):
        raise ValueError(f"KV cache bits must be 4 or 8, got {bits}")
    return 2.0 ** (bits - 1) - 1.0


def pack_int4_hd(q):
    """Pack int4 codes two per byte along head_dim (the minor axis):
    element 2i rides the low nibble, 2i+1 the high nibble.
    (..., hd) int8 in [-7, 7] -> (..., hd//2) int8."""
    assert q.shape[-1] % 2 == 0, q.shape
    lo = q[..., 0::2] & 0x0F
    hi = (q[..., 1::2] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4_hd(packed):
    """Inverse of pack_int4_hd: (..., hd//2) int8 -> (..., hd) int8 in
    [-7, 7] (arithmetic shifts on int8 sign-extend the nibbles)."""
    p = packed.to(torch.int8)
    lo = (p << 4) >> 4
    hi = p >> 4
    out = torch.stack([lo, hi], dim=-1)           # (..., hd//2, 2)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize_kv(x, bits: int, *, granularity: str = "token"):
    """Symmetric per-head KV quantization (the pool-write semantics).

    x (..., K, hd); for ``granularity="page"`` the third-from-last axis is
    the page-slot axis. "token": one scale per (leading..., K), amax over
    hd — what the paged pool stores, so decode never re-scales a page in
    place. "page": one scale per (page, K), amax over (slot, hd).

    Returns (stored, scale): stored int8, packed along hd when bits == 4;
    scale fp32 with the reduced axes dropped. Rounding is half to even, as
    ``jnp.round``."""
    qmax = kv_qmax(bits)
    xf = x.to(F32)
    if granularity == "token":
        scale = xf.abs().amax(dim=-1) / qmax + 1e-12            # (..., K)
        div = scale[..., None]
    elif granularity == "page":
        scale = xf.abs().amax(dim=(-3, -1)) / qmax + 1e-12      # (..., K)
        div = scale[..., None, :, None]
    else:
        raise ValueError(f"unknown scale granularity {granularity!r}")
    q = torch.clamp(torch.round(xf / div), -qmax, qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4_hd(q)
    return q, scale.to(F32)


def dequantize_kv(stored, scale, bits: int, *, granularity: str = "token"):
    """Inverse of quantize_kv -> fp32: each element is float(code) times
    its scale, one fp32 multiply."""
    q = unpack_int4_hd(stored) if bits == 4 else stored
    if granularity == "token":
        return q.to(F32) * scale[..., None]
    if granularity == "page":
        return q.to(F32) * scale[..., None, :, None]
    raise ValueError(f"unknown scale granularity {granularity!r}")


def kv_bits_of(stored, hd: int) -> int:
    """The stored KV bitwidth from the minor-axis size: int4 packs two
    codes per byte along hd, so the shape itself says which."""
    if stored.shape[-1] == hd:
        return 8
    if stored.shape[-1] * 2 == hd:
        return 4
    raise ValueError(
        f"stored KV minor dim {stored.shape[-1]} matches neither int8 ({hd}) "
        f"nor packed int4 ({hd // 2})")


# ------------------------------------------------------ paged attention ----
def _paged_block_walk(q, load_k, load_v, K, hd, page, n_blocks, positions, *,
                      window, cap):
    """Shared block-walk body for the bf16 and quantized paged attention
    refs. ``load_k``/``load_v`` map a block index to its fp32
    (B, page, K, hd) tile: a pool gather, or a gather and dequantization.

    q is (B, Sq, H, hd): Sq == 1 is the decode walk, Sq > 1 the
    chunked-prefill walk — query t of sequence b sits at absolute position
    ``positions[b] + t`` and attends causally to every pool slot at or
    before it (the resident prompt prefix plus the chunk's own already-
    written K/V).

    Walks the blocks ``[min(first qpos) - window + 1, max(last qpos)]``
    across the batch in a Python loop, so the dense chronological
    (B, n_blocks*page, K, hd) KV view is never built and local-window
    layers walk only their window. Scores are staged per block into a
    (B,K,G,Sq,T) fp32 buffer so the softmax is one full-row pass, as in the
    reference."""
    B, Sq, H, _ = q.shape
    G = H // K
    T = n_blocks * page
    scale = hd ** -0.5
    NEG = -2.0 ** 30
    dev = q.device
    # (B, Sq, K, G, hd) -> (B, K, G, Sq, hd): head h = k*G + g
    qf = q.to(F32).reshape(B, Sq, K, G, hd).permute(0, 2, 3, 1, 4)
    qpos = positions.long()[:, None] + torch.arange(Sq, device=dev)

    # blocks any query needs; a final chunk padded past the page-table
    # width must not walk past it (its overrun rows are garbage by
    # contract).
    hi = min((int(positions.max()) + Sq - 1) // page + 1, n_blocks)
    lo = max((int(positions.min()) - window + 1) // page, 0) if window else 0

    s_buf = torch.full((B, K, G, Sq, T), NEG, dtype=F32, device=dev)
    for i in range(lo, hi):
        s = torch.einsum("bkgsd,bpkd->bkgsp", qf, load_k(i)) * scale
        if cap:
            s = cap * torch.tanh(s / cap)
        kpos = i * page + torch.arange(page, device=dev)
        valid = kpos[None, None, :] <= qpos[:, :, None]          # (B, Sq, p)
        if window:
            valid &= kpos[None, None, :] > qpos[:, :, None] - window
        s_buf[..., i * page:(i + 1) * page] = torch.where(
            valid[:, None, None], s, NEG)
    w = torch.softmax(s_buf, dim=-1)

    o = torch.zeros((B, K, G, Sq, hd), dtype=F32, device=dev)
    for i in range(lo, hi):
        o += torch.einsum("bkgsp,bpkd->bkgsd",
                          w[..., i * page:(i + 1) * page], load_v(i))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def paged_attention_ref(q, pool_k, pool_v, page_table, positions, *,
                        window=0, cap=0.0):
    """Block-walking paged decode attention.

    q (B, H, hd) one query token per sequence; pool_k/v (P, page, K, hd);
    page_table (B, n_blocks) int32, unused tails pointing at scratch page 0;
    positions (B,) int32 absolute position of the query token. H = K*G."""
    return paged_prefill_ref(q[:, None], pool_k, pool_v, page_table,
                             positions, window=window, cap=cap)[:, 0]


def paged_prefill_ref(q, pool_k, pool_v, page_table, positions, *,
                      window=0, cap=0.0):
    """Block-walking chunked-prefill attention.

    q (B, Sq, H, hd) one prompt chunk per sequence, whose K/V are already
    in the pool; positions (B,) int32 absolute position of each chunk's
    FIRST token. Query t attends to pool slots at kpos <= positions[b] + t.
    """
    hd = q.shape[-1]
    _, page, K, _ = pool_k.shape
    pt = page_table.long()
    return _paged_block_walk(
        q, lambda i: pool_k[pt[:, i]].to(F32),
        lambda i: pool_v[pt[:, i]].to(F32),
        K, hd, page, page_table.shape[1], positions, window=window, cap=cap)


def paged_attention_quant_ref(q, pool_k, k_scale, pool_v, v_scale,
                              page_table, positions, *, window=0, cap=0.0):
    """Block-walking paged decode attention over a quantized page pool.

    q (B, H, hd); pool_k/v (P, page, K, hd_store) int8 — hd_store == hd for
    int8 KV, hd // 2 for int4 packed along hd (pack_int4_hd); k_scale/
    v_scale (P, page, K) fp32 per-slot, per-kv-head scales; page_table and
    positions as in paged_attention_ref. Each block is dequantized inside
    the walk: only a (B, page, K, hd) fp32 tile is ever built."""
    return paged_prefill_quant_ref(q[:, None], pool_k, k_scale, pool_v,
                                   v_scale, page_table, positions,
                                   window=window, cap=cap)[:, 0]


def paged_prefill_quant_ref(q, pool_k, k_scale, pool_v, v_scale,
                            page_table, positions, *, window=0, cap=0.0):
    """Chunked-prefill walk over a quantized page pool: the chunk's K/V are
    already quantized into the pool, and each block is dequantized inside
    the walk as in paged_attention_quant_ref. q (B, Sq, H, hd); positions
    (B,) chunk-start positions (see paged_prefill_ref)."""
    hd = q.shape[-1]
    _, page, K, _ = pool_k.shape
    bits = kv_bits_of(pool_k, hd)
    pt = page_table.long()

    def loader(pool, scales):
        def load(i):
            pids = pt[:, i]
            return dequantize_kv(pool[pids], scales[pids], bits)
        return load

    return _paged_block_walk(
        q, loader(pool_k, k_scale), loader(pool_v, v_scale),
        K, hd, page, page_table.shape[1], positions, window=window, cap=cap)


def _dense_kv(pool, page_table):
    B = page_table.shape[0]
    K, hd = pool.shape[2], pool.shape[3]
    return pool[page_table.long()].reshape(B, -1, K, hd)


def paged_attention_dense_ref(q, pool_k, pool_v, page_table, positions, *,
                              window=0, cap=0.0):
    """Dense decode oracle: gather pages chronologically, mask, softmax.
    Test-only — it builds exactly the (B, T, K, hd) view the walk avoids."""
    return paged_prefill_dense_ref(q[:, None], pool_k, pool_v, page_table,
                                   positions, window=window, cap=cap)[:, 0]


def paged_prefill_dense_ref(q, pool_k, pool_v, page_table, positions, *,
                            window=0, cap=0.0):
    """Dense chunked-prefill oracle. Test-only. q (B, Sq, H, hd); positions
    (B,) chunk-start positions."""
    B, Sq, H, hd = q.shape
    K = pool_k.shape[2]
    k = _dense_kv(pool_k, page_table)
    v = _dense_kv(pool_v, page_table)
    T = k.shape[1]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bkhd->bhsk", q.to(F32), k.to(F32)) * (hd ** -0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    dev = q.device
    qpos = positions.long()[:, None] + torch.arange(Sq, device=dev)
    j = torch.arange(T, device=dev)
    valid = j[None, None, :] <= qpos[:, :, None]                 # (B, Sq, T)
    if window:
        valid &= j[None, None, :] > qpos[:, :, None] - window
    s = torch.where(valid[:, None], s, -2.0 ** 30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhsk,bkhd->bshd", w, v.to(F32))
    return out.to(q.dtype)


# ------------------------------------------------------ flash attention ----
def flash_attention_ref(q, k, v, *, causal=True, window=0, cap=0.0,
                        return_lse=False):
    """Dense attention oracle, the plain version of flash_attention_fwd.

    q (B, S, H, hd), k/v (B, T, K, hd), H = K*G (GQA: kv head k serves
    query heads k*G .. k*G+G-1). fp32 scores scaled by hd**-0.5, then the
    softcap, then the mask (key j <= query i if ``causal``, and
    j > i - ``window`` if ``window``) to -1e30, softmax, and the output cast
    to q.dtype. With ``return_lse`` also the (B, H, S) fp32 log-sum-exp of
    each row's masked scores, ``m + log(max(l, 1e-30))`` with m the row max
    and l the sum of exp(s - m), as ``repro.models.flash._fwd_impl``
    defines it. Builds the (B, H, S, T) fp32 scores the kernel avoids."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32))
    s = s * (hd ** -0.5)
    if cap:
        s = cap * torch.tanh(s / cap)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(F32)).to(q.dtype)
    if not return_lse:
        return out
    del p
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    return out, m + torch.log(torch.clamp(l, min=1e-30))
