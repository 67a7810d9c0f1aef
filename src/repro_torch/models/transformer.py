"""Decoder-only LM assembly for the dense family (port of
``repro.models.transformer``).

Parameters keep the reference's stacking: layers are grouped by
``period`` sub-layer slots and each slot's parameters are stacked over
``n_groups``, so ``blocks/sub{j}/attn/wq`` is ``(n_groups, d, H, hd)``.
Where the reference scans over groups with ``lax.scan``, this port runs a
Python loop over ``n_groups x period`` on per-group views.

The moe, ssm, hybrid, encdec and vlm families wait for their slices and
raise NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_defs, ffn_apply, ffn_defs,
                                       norm_def, rms_norm, softcap)
from repro_torch.models.params import PDef, stacked, tree_map

F32 = torch.float32


def _require_dense(cfg, what: str) -> None:
    if cfg.family != "dense" or cfg.is_encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{what}: the port serves the dense family only so far; "
            f"{cfg.name} (family={cfg.family!r}) waits for its slice "
            f"(ROADMAP)")


# ------------------------------------------------------------- structure ----
def period_of(cfg) -> int:
    p = len(cfg.attn_pattern)
    if cfg.moe:
        p = math.lcm(p, cfg.moe.every)
    return p


def sublayer_kinds(cfg):
    """Static description of each sub-layer slot within a period."""
    P = period_of(cfg)
    return [{"attn": cfg.attn_pattern[j % len(cfg.attn_pattern)],
             "moe": cfg.is_moe_layer(j)} for j in range(P)]


def _layers(cfg):
    """(group, slot, kind) for every layer, in execution order."""
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)
    return [(g, j, kinds[j]) for g in range(cfg.num_layers // P)
            for j in range(P)]


def _group(tree, g: int):
    """Group ``g``'s views of a stacked parameter (or pool) subtree."""
    return tree_map(lambda a: a[g], tree)


# ------------------------------------------------------------ param defs ----
def _dense_sublayer_defs(cfg) -> dict:
    d = cfg.d_model
    defs: Dict[str, Any] = {
        "ln1": norm_def(d),
        "attn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim),
        "ln2": norm_def(d),
        "ffn": ffn_defs(d, cfg.d_ff, cfg.activation),
    }
    if cfg.sandwich_norm:
        defs["ln1_post"] = norm_def(d)
        defs["ln2_post"] = norm_def(d)
    return defs


def param_defs(cfg) -> dict:
    _require_dense(cfg, "param_defs")
    d = cfg.d_model
    defs: Dict[str, Any] = {"embed": embed_defs(cfg.padded_vocab, d),
                            "final_norm": norm_def(d)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((d, cfg.padded_vocab), ("embed", "vocab"),
                               "scaled")
    P = period_of(cfg)
    assert cfg.num_layers % P == 0, (cfg.name, cfg.num_layers, P)
    defs["blocks"] = {f"sub{j}": stacked(_dense_sublayer_defs(cfg),
                                         cfg.num_layers // P)
                      for j in range(P)}
    return defs


# ----------------------------------------------------------------- blocks ----
def _ffn_half(p, x, cfg, dot):
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    f = ffn_apply(p["ffn"], h, cfg.activation, dot=dot)
    if cfg.sandwich_norm:
        f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
    return x + f


def _attn_residual(p, x, a, cfg):
    if cfg.sandwich_norm:
        a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
    return x + a


def _dense_block_fwd(p, x, kind, cfg, positions, dot, kernel):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn.attention_fwd(p["attn"], h, kind["attn"], cfg, positions,
                                  dot=dot, kernel=kernel)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), cfg, dot), cache


def _dense_block_decode_paged(p, x, pool_kv, page_table, positions, kind,
                              cfg, kernel, dot):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _, _ = attn.attention_decode_paged(
        p["attn"], h, pool_kv["k"], pool_kv["v"], page_table, positions,
        kind["attn"], cfg, kernel=kernel, dot=dot)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), cfg, dot)


def _dense_block_prefill_paged(p, x, pool_kv, page_table, positions, kind,
                               cfg, kernel, dot):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _, _ = attn.attention_prefill_paged(
        p["attn"], h, pool_kv["k"], pool_kv["v"], page_table, positions,
        kind["attn"], cfg, kernel=kernel, dot=dot)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), cfg, dot)


# ---------------------------------------------------------------- embed ----
def embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d) to the activation dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def unembed(params, x, cfg, *, dot=None):
    """Project hidden states (..., D) to fp32 logits.

    With a ``dot`` hook the logits are ``dot(x, w, "lm_head")`` cast to
    fp32 afterwards, as the reference does: a bf16 weight (the tied
    embedding under ``dequant_dot``, or a site the hook leaves alone)
    gives bf16-rounded logits there too.

    Without a hook the reference contracts the bf16 operands with an fp32
    result (``preferred_element_type=f32``); a bf16 ``torch.matmul`` would
    round the logits to bf16. Both operands are upcast to fp32 instead — every
    bf16 product is exact in fp32, so this is the same contraction — at
    the price of a transient fp32 copy of the weight per call (2.36 GB for
    the tied gemma2-2b table) rather than a resident one. Callers that
    need fp32 parity on the card keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if dot is None:
        logits = x.to(F32) @ w.to(F32)
    else:
        logits = dot(x, w, "lm_head").to(F32)
    logits = softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding columns
        pad_mask = torch.arange(cfg.padded_vocab,
                                device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e9)
    return logits


# ------------------------------------------------------------ chunked CE ----
def chunked_ce(params, hidden, labels, cfg, *, dot=None, chunk: int = 256,
               loss_mask=None):
    """Next-token cross-entropy without materializing (B, S, V) logits:
    the unembed and log-sum-exp run per ``chunk`` rows, so peak live
    memory is (B, chunk, V). Forward only: the reference's rematerialized
    scan serves its backward, which waits for the training slice. The
    mask and the padding of the last chunk are the reference's."""
    xs = hidden[:, :-1]
    ls = labels[:, 1:].long()
    B, n, D = xs.shape
    mask = torch.ones((B, n), dtype=F32, device=xs.device) \
        if loss_mask is None else loss_mask[:, 1:].to(F32)
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        ls = torch.nn.functional.pad(ls, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=F32, device=xs.device)
    cnt = torch.zeros((), dtype=F32, device=xs.device)
    for c in range(0, n + pad, chunk):
        logits = unembed(params, xs[:, c:c + chunk], cfg, dot=dot)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls[:, c:c + chunk, None])[..., 0]
        mc = mask[:, c:c + chunk]
        tot = tot + torch.sum((logz - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


# --------------------------------------------------------------- forward ----
def forward(params, batch, cfg, *, want_cache: bool,
            unembed_mode: str = "full", cache_layout: str = "full",
            dot=None, kernel: str = "auto"):
    """Full-sequence forward (prefill).

    unembed_mode: "full" -> logits (B,S,V); "last" -> logits (B,1,V);
    "none" -> final hidden states (B,S,D).
    cache_layout: "full" -> chronological caches of shape
    (n_groups, B, S, K, hd) per sub-layer slot (what the paged engine
    copies into its pool); the reference's ring layout for dense decode is
    not ported.
    dot: optional (x, w, name) -> y override of every matmul site.
    kernel: the flash-attention mode ("auto" | "cuda" | "ref") of the
    layers' whole-sequence attention from FLASH_MIN tokens on
    (models/flash.py); shorter sequences attend densely.
    Returns (logits_or_hidden, caches or None, aux 0.0, loss_mask None).
    """
    _require_dense(cfg, "forward")
    if cache_layout != "full":
        raise NotImplementedError(
            "the port keeps chronological ('full') caches only; the ring "
            "layout serves the reference's dense decode, not ported")
    tokens = batch["tokens"]
    x = embed_tokens(params, tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    caches: Dict[str, Dict[str, list]] = {
        f"sub{j}": {"k": [], "v": []} for j in range(period_of(cfg))}
    for g, j, kind in _layers(cfg):
        x, c = _dense_block_fwd(_group(params["blocks"][f"sub{j}"], g), x,
                                kind, cfg, positions, dot, kernel)
        if want_cache:
            caches[f"sub{j}"]["k"].append(c["k"])
            caches[f"sub{j}"]["v"].append(c["v"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out_cache = None
    if want_cache:
        out_cache = {s: {kv: torch.stack(lst) for kv, lst in c.items()}
                     for s, c in caches.items()}
    if unembed_mode == "none":
        return x, out_cache, 0.0, None
    if unembed_mode == "last":
        x = x[:, -1:]
    return unembed(params, x, cfg, dot=dot), out_cache, 0.0, None


# ----------------------------------------------------------- paged decode ----
def decode_step_paged(params, pool, page_table, token, positions, cfg, *,
                      kernel="auto", dot=None):
    """Batched slot-indexed decode against a paged KV pool.

    token (B,1) int32; positions (B,) int32 per-sequence absolute
    positions; pool is the dict from ``init_pool`` and page_table
    (B, n_pages) maps each sequence's logical blocks to physical pages
    (shared across layers). ``kernel`` selects the paged-attention path
    (see attention_decode_paged); ``dot`` overrides every matmul site.
    The pool is updated in place. Returns (logits (B,1,V), pool)."""
    _require_dense(cfg, "paged decode")
    x = embed_tokens(params, token, cfg)
    for g, j, kind in _layers(cfg):
        x = _dense_block_decode_paged(
            _group(params["blocks"][f"sub{j}"], g), x,
            _group(pool[f"sub{j}"], g), page_table, positions, kind, cfg,
            kernel, dot)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, x, cfg, dot=dot), pool


# --------------------------------------------------------- paged prefill ----
def prefill_chunk_paged(params, pool, page_table, tokens, positions, cfg, *,
                        kernel="auto", dot=None):
    """One chunked-prefill step: run ``tokens`` (B, Sq) — a contiguous
    prompt chunk whose first token sits at ``positions[b]`` — through every
    layer, writing each layer's chunk K/V into the pool in place and
    attending over the pool itself (resident prefix + the chunk);
    ``dot`` overrides every matmul site.

    Returns (hidden (B, Sq, D) final-norm hidden states, pool); the caller
    unembeds only the rows it needs."""
    _require_dense(cfg, "paged prefill")
    x = embed_tokens(params, tokens, cfg)
    for g, j, kind in _layers(cfg):
        x = _dense_block_prefill_paged(
            _group(params["blocks"][f"sub{j}"], g), x,
            _group(pool[f"sub{j}"], g), page_table, positions, kind, cfg,
            kernel, dot)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), pool


def normalize_kv_bits(cfg, kv_bits) -> Optional[Tuple[int, ...]]:
    """Canonicalize a KV bit spec to one entry per sub-layer slot.

    Accepts None (fp pool), an int (uniform), a dict keyed ``sub{j}`` or
    ``kv_sub{j}`` (missing slots default to 16, unknown keys are
    rejected), or a sequence cycled over the period like ``attn_pattern``.
    All-16 collapses to None, the bf16 pool."""
    if kv_bits is None:
        return None
    P = period_of(cfg)
    if isinstance(kv_bits, int):
        bits = (kv_bits,) * P
    elif isinstance(kv_bits, dict):
        by_slot = {}
        for key, v in kv_bits.items():
            slot = key[3:] if key.startswith("kv_sub") else key
            j = int(slot[3:]) if slot.startswith("sub") \
                and slot[3:].isdigit() else -1
            if not 0 <= j < P:
                raise ValueError(f"unknown KV policy key {key!r} "
                                 f"(period-{P} pool has sub0..sub{P - 1})")
            by_slot[j] = int(v)
        bits = tuple(by_slot.get(j, 16) for j in range(P))
    else:
        seq = tuple(int(b) for b in kv_bits)
        if not seq or P % len(seq):
            raise ValueError(f"kv_bits length {len(seq)} does not cycle "
                             f"into period {P}")
        bits = tuple(seq[j % len(seq)] for j in range(P))
    for b in bits:
        if b not in (4, 8, 16):
            raise ValueError(f"KV bits must be 4, 8 or 16, got {b}")
    if all(b == 16 for b in bits):
        return None
    if any(b == 4 for b in bits) and cfg.resolved_head_dim % 2:
        raise ValueError("int4 KV packs two codes per byte along head_dim; "
                         f"head_dim={cfg.resolved_head_dim} is odd")
    return bits


def pool_specs(cfg, num_pages: int, page_size: int, kv_bits=None):
    """Paged-KV-pool layout, as (shape, dtype) pairs: per sub-layer slot,
    k/v pools of shape (n_groups, num_pages, page_size, K, hd) bf16. Page
    ids are shared across layers.

    ``kv_bits`` (see normalize_kv_bits) selects the quantized layout per
    sub-layer slot: 16 keeps the bf16 pools; 8/4 store
    ``{"q": int8 (n_groups, num_pages, page_size, K, hd_store),
       "scale": fp32 (n_groups, num_pages, page_size, K)}``
    with hd_store = hd for int8 and hd//2 for int4 (two codes per byte
    along head_dim). Scales are per page slot (token) and per kv head, so
    quantize-on-write never re-scales resident tokens (serving/kvquant)."""
    _require_dense(cfg, "paged KV pool")
    hd = cfg.resolved_head_dim
    K = cfg.num_kv_heads
    P = period_of(cfg)
    n_groups = cfg.num_layers // P
    bits = normalize_kv_bits(cfg, kv_bits) or (16,) * P

    def kv_spec(b):
        if b == 16:
            return ((n_groups, num_pages, page_size, K, hd), torch.bfloat16)
        hd_store = hd if b == 8 else hd // 2
        return {"q": ((n_groups, num_pages, page_size, K, hd_store),
                      torch.int8),
                "scale": ((n_groups, num_pages, page_size, K), F32)}

    return {f"sub{j}": {"k": kv_spec(bits[j]), "v": kv_spec(bits[j])}
            for j in range(P)}


def init_pool(cfg, num_pages: int, page_size: int, *, device, kv_bits=None):
    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        shape, dtype = spec
        return torch.zeros(shape, dtype=dtype, device=device)

    return make(pool_specs(cfg, num_pages, page_size, kv_bits))
