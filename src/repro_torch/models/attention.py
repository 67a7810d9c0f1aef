"""GQA attention (port of ``repro.models.attention``): whole-prompt
forwards — dense for short sequences, flash attention (models/flash.py)
from ``FLASH_MIN`` tokens on — the encoder-decoder's cross attention, the
dense-cache decode over full-length or ring-buffer (local) caches, and
the paged decode / chunked-prefill paths
over the serving engine's page pool — bf16, or quantized int8/int4 with
per-token scales (serving/kvquant).

Layout conventions, as in the reference:
  activations x          (B, S, D)
  q                      (B, S, H, hd)
  k, v                   (B, S, K, hd)     H = K * G (GQA groups)
  full KV cache          (B, S_max, K, hd)
  ring KV cache (local)  (B, W, K, hd)     slot = position % W
  page pool (one layer)  (P, page, K, hd) bf16, or
                         {"q": (P, page, K, hd_store) int8,
                          "scale": (P, page, K) fp32}
Attention logits are fp32; RoPE is applied at cache-write time (absolute
positions).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import flash as flash_lib
from repro_torch.models.layers import apply_rope, promoted, softcap
from repro_torch.models.params import PDef

F32 = torch.float32
NEG_INF = -2.0 ** 30  # large-but-finite; avoids NaNs for fully-masked rows


def attn_defs(d_model: int, n_heads: int, n_kv: int, head_dim: int):
    return {
        "wq": PDef((d_model, n_heads, head_dim),
                   ("embed", "heads", "head_dim"), "scaled"),
        "wk": PDef((d_model, n_kv, head_dim),
                   ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": PDef((d_model, n_kv, head_dim),
                   ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": PDef((n_heads, head_dim, d_model),
                   ("heads", "head_dim", "embed"), "scaled"),
    }


def _proj_in(x, w, name):
    return torch.einsum("bsd,dnh->bsnh", *promoted(x, w))


def _proj_out(o, w, name):
    return torch.einsum("bsnh,nhd->bsd", *promoted(o, w))


def qkv(p, x, theta: float, positions, *, dot=None):
    """Project and rope. positions: (B, S) absolute positions (or None).
    dot: optional (x, w, name) -> y override (sites attn_q/k/v)."""
    dot = dot or _proj_in
    q = dot(x, p["wq"], "attn_q")
    k = dot(x, p["wk"], "attn_k")
    v = dot(x, p["wv"], "attn_v")
    if theta > 0 and positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(o, p, dot=None):
    return (dot or _proj_out)(o, p["wo"], "attn_o")


def _attend(q, k, v, mask, cap: float):
    """Dense attention for short sequences. mask broadcastable to
    (B,H,S,T). Returns (B,S,H,hd)."""
    hd = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32))
    s = softcap(s * (hd ** -0.5), cap)
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.to(F32))
    return o.to(q.dtype)


def causal_mask(S: int, T: int, device=None):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= i)[None, None]


def local_mask(S: int, T: int, window: int, device=None):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return ((j <= i) & (j > i - window))[None, None]


def attention_fwd(p, x, kind: str, cfg, positions, *, dot=None,
                  kernel: str = "auto"):
    """Whole-sequence attention. Returns (out (B,S,D), cache_entry) with
    the roped k/v in chronological (full) layout, ready for the page pool.

    kind: "global" | "local" | "bidir" (the encoder's: every key).
    Sequences of ``flash.FLASH_MIN`` tokens or more go through flash
    attention (models/flash.py), whose ``kernel`` mode ("auto" | "cuda" |
    "ref", kernels/ops.py) picks the CUDA kernel or its plain version;
    shorter ones through the dense ``_attend``, as in the reference."""
    B, S, D = x.shape
    q, k, v = qkv(p, x, cfg.rope_theta, positions, dot=dot)
    if S >= flash_lib.FLASH_MIN:
        o = flash_lib.flash_attention(q, k, v, kind, cfg.window_size,
                                      cfg.attn_softcap, kernel=kernel)
    else:
        if kind == "local":
            mask = local_mask(S, S, cfg.window_size, device=x.device)
        elif kind == "bidir":
            mask = torch.ones((1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        else:
            mask = causal_mask(S, S, device=x.device)
        o = _attend(q, k, v, mask, cfg.attn_softcap)
    return _out_proj(o, p, dot), {"k": k, "v": v}


def _last_window_ring(k: torch.Tensor, W: int) -> torch.Tensor:
    """The last W cached positions of k (B, S, K, hd) in ring layout: slot
    s holds the position p of the last W with p % W == s."""
    S = k.shape[1]
    return torch.roll(k[:, S - W:S], shifts=S % W, dims=1)


def _cache_write(cache: torch.Tensor, new: torch.Tensor, idx) -> None:
    """Write ``new`` (B,1,K,hd) in place at sequence slot ``idx`` (a scalar
    tensor: no host read). A meta cache (the dry-run's) has no value to
    index by, so it takes the write as an ``index_copy_``."""
    if cache.is_meta:
        cache.index_copy_(1, torch.as_tensor(idx, device=cache.device)
                          .reshape(1).long(), new.to(cache.dtype))
        return
    cache[:, idx] = new[:, 0].to(cache.dtype)


def _block_write(cache: torch.Tensor, new: torch.Tensor, idx) -> None:
    """``_cache_write`` into a block of a cache's slots: ``idx`` (a scalar
    tensor) is the slot's index in the block, and a slot outside the block
    leaves it as it is (no host read)."""
    inside = (idx >= 0) & (idx < cache.shape[1])
    at = idx.clamp(0, cache.shape[1] - 1).reshape(1).long()
    cache.index_copy_(1, at, torch.where(inside, new.to(cache.dtype),
                                         cache.index_select(1, at)))


def _attend_partial(q, k, v, mask, cap: float):
    """``_attend``'s softmax left unnormalised, over one block of the
    keys: (m (B,H,1,1) the rows' max, l (B,H,1,1) the sum of exp(s - m),
    o (B,1,H,hd) the sum of exp(s - m) v), fp32, for a combine across
    blocks (distributed/sharding.py::softmax_combine)."""
    hd = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), k.to(F32))
    s = softcap(s * (hd ** -0.5), cap)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return m, e.sum(dim=-1, keepdim=True), \
        torch.einsum("bhqk,bkhd->bqhd", e, v.to(F32))


def attention_decode(p, x, cache_k, cache_v, pos, kind: str, cfg, *,
                     dot=None, place=None):
    """One-token decode over a dense cache. x (B,1,D); pos a scalar int
    tensor (the current position). A local layer whose cache holds
    exactly ``window_size`` slots is a ring (slot ``pos % W``); every
    other cache is chronological. The new k/v are written into the caches
    in place; attention runs through the plain ``_attend``, as in the
    reference, masked by each slot's absolute position.

    ``place`` (distributed/sharding.py::CacheBlock): the caches are this
    rank's block of a cache split over a mesh. q, k and v take the
    block's heads (``place.heads``), and the slots their global indices,
    ``place.offset`` on: only the rank whose block holds the written slot
    writes it, and the mask reads each slot's absolute position from its
    global index. Over a block of the sequence, each rank's softmax over
    its keys is combined across the ranks (``place.combine``).

    Returns (out (B,1,D), cache_k, cache_v)."""
    B = x.shape[0]
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k_new, v_new = qkv(p, x, cfg.rope_theta, positions, dot=dot)
    T = cache_k.shape[1]
    off, whole = 0, T
    if place is not None:
        q, k_new, v_new = place.heads(q, k_new, v_new)
        off, whole = place.offset, place.length
    s = off + torch.arange(T, device=x.device)
    if kind == "local" and whole == cfg.window_size:
        slot = pos % whole
        # absolute position held by each slot (after this write)
        abs_pos = pos - (pos - s) % whole
        mask = (abs_pos >= 0)[None, None, None, :]
    else:
        slot = pos
        valid = s <= pos
        if kind == "local":
            valid &= s > pos - cfg.window_size
        mask = valid[None, None, None, :]
    if whole == T:
        _cache_write(cache_k, k_new, slot)
        _cache_write(cache_v, v_new, slot)
        o = _attend(q, cache_k, cache_v, mask, cfg.attn_softcap)
    else:
        _block_write(cache_k, k_new, slot - off)
        _block_write(cache_v, v_new, slot - off)
        o = place.combine(*_attend_partial(q, cache_k, cache_v, mask,
                                           cfg.attn_softcap)).to(q.dtype)
    return _out_proj(o, p, dot), cache_k, cache_v


def cross_attention(p, x, mem_k, mem_v, cfg, *, dot=None,
                    kernel: str = "auto", place=None):
    """Decoder cross attention against the encoder's precomputed k/v
    (``cross_kv``), unmasked. x (B, S, D), mem_k/v (B, T, K, hd). Flash
    (kind "bidir", ``kernel`` as in attention_fwd) when S >= FLASH_MIN or
    T >= 4 * FLASH_MIN, which takes a decode step's single query row over
    a long encoder memory; the dense ``_attend`` otherwise. As in the
    reference, ``dot`` reaches the q projection only: the output
    projection (site ``xattn_o``) is a plain product whatever the hook,
    unless tensor parallelism left o with a rank's heads, which the
    ``tp_dot`` site gathers before the product, or the weight is stored
    (serving/quant.py), which has no plain product (the reference's
    einsum fails on it) and goes through the hook.

    ``place`` (distributed/sharding.py::CacheBlock): mem_k/v are this
    rank's block of a memory split over a mesh; q takes the block's heads
    (``place.query``). Over a block of the frames each rank attends over
    its own (flash's lse where the block still reaches flash) and the
    ranks' softmaxes are combined (``place.combine``)."""
    S, T = x.shape[1], mem_k.shape[1]
    q = (dot or _proj_in)(x, p["wq"], "xattn_q")
    flash = S >= flash_lib.FLASH_MIN or T >= 4 * flash_lib.FLASH_MIN
    if place is not None:
        q = place.query(q)
    if place is not None and place.split:
        if flash:
            part = flash_lib.flash_partial(q, mem_k, mem_v, cfg.attn_softcap,
                                           kernel=kernel)
        else:
            mask = torch.ones((1, 1, S, T), dtype=torch.bool,
                              device=x.device)
            part = _attend_partial(q, mem_k, mem_v, mask, cfg.attn_softcap)
        o = place.combine(*part).to(q.dtype)
    elif flash:
        o = flash_lib.flash_attention(q, mem_k, mem_v, "bidir", 0,
                                      cfg.attn_softcap, kernel=kernel)
    else:
        mask = torch.ones((1, 1, S, T), dtype=torch.bool, device=x.device)
        o = _attend(q, mem_k, mem_v, mask, cfg.attn_softcap)
    if isinstance(p["wo"], dict) or o.shape[2] != p["wo"].shape[0]:
        return dot(o, p["wo"], "xattn_o")        # stored, or a rank's heads
    return _proj_out(o, p["wo"], "xattn_o")


def cross_kv(p, mem, *, dot=None):
    """The encoder output's k and v for cross attention (no RoPE)."""
    dot = dot or _proj_in
    return dot(mem, p["wk"], "xattn_k"), dot(mem, p["wv"], "xattn_v")


def cache_len_for(kind: str, cfg, seq_len: int) -> int:
    if kind == "local":
        return min(cfg.window_size, seq_len)
    return seq_len


def write_kv(pool, index, new):
    """Store ``new`` (..., K, hd) k or v in place at ``pool[index]``: a
    bf16 pool takes it as it is, a quantized {"q", "scale"} pool its int
    codes and per-token scales (kernels/ref.py::quantize_kv). Every pool
    writer goes through here."""
    if isinstance(pool, dict):
        codes, scale = kref.quantize_kv(
            new, kref.kv_bits_of(pool["q"], new.shape[-1]))
        pool["q"][index] = codes
        pool["scale"][index] = scale
    else:
        pool[index] = new.to(pool.dtype)


def _page_size(pool) -> int:
    return (pool["q"] if isinstance(pool, dict) else pool).shape[1]


def _walk(q, pool_k, pool_v, page_table, positions, window, cap, kernel,
          *, prefill: bool, kv_heads: int):
    """The paged walk over this layer's pools through kernels/ops.py: the
    quantized pair for {"q", "scale"} pools, the bf16 pair otherwise.
    ``kv_heads`` is the model's kv-head count: a sharded engine's pool
    holds a slice of it, and the decode split plan reads the whole count,
    so a shard splits each (sequence, head) walk as one device does."""
    kw = {} if prefill else {"kv_heads": kv_heads}
    if isinstance(pool_k, dict):
        fn = kops.paged_attention_prefill_quant if prefill \
            else kops.paged_attention_quant
        return fn(q, pool_k["q"], pool_k["scale"], pool_v["q"],
                  pool_v["scale"], page_table, positions, window=window,
                  cap=cap, mode=kernel, **kw)
    fn = kops.paged_attention_prefill if prefill else kops.paged_attention
    return fn(q, pool_k, pool_v, page_table, positions, window=window,
              cap=cap, mode=kernel, **kw)


def attention_decode_paged(p, x, pool_k, pool_v, page_table, positions,
                           kind: str, cfg, *, kernel: str = "auto",
                           dot=None):
    """Slot-indexed one-token decode against a paged KV pool.

    x           (B, 1, D)   one new token's activations per sequence
    pool_k/v    this layer's page pool: (P, page, K, hd) bf16, or the
                quantized {"q", "scale"} dicts (int8, or int4 packed
                along hd — the bitwidth is read from the stored shape)
    page_table  (B, n_pages) int32; unused tails point at scratch page 0
    positions   (B,) int32  absolute position of the incoming token
    kernel      "auto" | "cuda" | "ref" — kernels/ops.py dispatch
    dot         optional (x, w, name) -> y override of the projections

    The new k/v are written in place into page
    ``page_table[b, pos // page]`` slot ``pos % page`` (the reference
    donates the pool to get the same in-place update), quantized on write
    for a quantized pool; attention then walks the sequence's pages,
    dequantizing inside the walk. Returns (out (B,1,D), pool_k, pool_v),
    the pools being the updated inputs.
    """
    page = _page_size(pool_k)
    q, k_new, v_new = qkv(p, x, cfg.rope_theta, positions[:, None],
                          dot=dot)
    pos = positions.long()
    pids = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    slots = pos % page
    # idle batch slots all write the scratch page: duplicates there are
    # harmless garbage, whichever write lands last
    write_kv(pool_k, (pids, slots), k_new[:, 0])
    write_kv(pool_v, (pids, slots), v_new[:, 0])
    window = cfg.window_size if kind == "local" else 0
    o = _walk(q[:, 0], pool_k, pool_v, page_table, positions, window,
              cfg.attn_softcap, kernel, prefill=False,
              kv_heads=cfg.num_kv_heads)[:, None]
    return _out_proj(o, p, dot), pool_k, pool_v


def attention_prefill_paged(p, x, pool_k, pool_v, page_table, positions,
                            kind: str, cfg, *, kernel: str = "auto",
                            dot=None):
    """Chunked prefill against a paged KV pool (prefill-with-cache).

    x           (B, Sq, D)  one prompt chunk's activations per sequence
    pool_k/v    as in attention_decode_paged
    positions   (B,) int32  absolute position of each chunk's FIRST token

    The chunk's roped k/v are written in place into their pages first —
    token t at page ``page_table[b, (pos+t) // page]`` slot
    ``(pos+t) % page``, quantized on write for a quantized pool — then
    attention walks the pages: query t attends to every pool slot at
    ``kpos <= positions[b] + t``. Returns (out (B, Sq, D), pool_k, pool_v).
    """
    page = _page_size(pool_k)
    B, Sq, _ = x.shape
    n_blocks = page_table.shape[1]
    abs_pos = positions.long()[:, None] + torch.arange(Sq, device=x.device)
    q, k_new, v_new = qkv(p, x, cfg.rope_theta, abs_pos, dot=dot)
    # A final chunk padded past the page-table width routes its overflow
    # rows to the scratch page; they may write it more than once, which is
    # harmless but order-dependent garbage.
    blocks = abs_pos // page                                    # (B, Sq)
    pids = page_table.long().gather(1, blocks.clamp(max=n_blocks - 1))
    pids = torch.where(blocks < n_blocks, pids, 0)
    slots = abs_pos % page
    write_kv(pool_k, (pids, slots), k_new)
    write_kv(pool_v, (pids, slots), v_new)
    window = cfg.window_size if kind == "local" else 0
    o = _walk(q, pool_k, pool_v, page_table, positions, window,
              cfg.attn_softcap, kernel, prefill=True,
              kv_heads=cfg.num_kv_heads)
    return _out_proj(o, p, dot), pool_k, pool_v
