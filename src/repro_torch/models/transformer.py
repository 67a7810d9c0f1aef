"""Decoder-only LM assembly for the dense, moe, vlm, ssm and hybrid
families (port of ``repro.models.transformer``; the encdec family is
models/encdec.py).

Parameters keep the reference's stacking: layers are grouped by
``period`` sub-layer slots and each slot's parameters are stacked over
``n_groups``, so ``blocks/sub{j}/attn/wq`` is ``(n_groups, d, H, hd)``;
the ssm and hybrid families stack their mamba layers (``mamba``,
``mamba_ln``) over ``num_layers``, and the hybrid's one ``shared``
attention block is applied before each group of ``hybrid_groups``
mamba layers. Where the reference scans with ``lax.scan``, this port runs
a Python loop on per-layer views.

A moe sub-layer slot (``cfg.is_moe_layer``) holds a ``moe`` subtree in
place of ``ffn`` and runs models/moe.py's routed experts; ``forward``
sums their load-balance losses into its ``aux``. The vlm family's vision
stub (``frontend_proj``) projects precomputed patch embeddings and puts
them before the token embeddings; ``forward`` then returns the 0/1 loss
mask of the text rows. Decoding runs over the paged pool
(``decode_step_paged``, the engine's; dense, moe and vlm, as in the
reference) or over dense caches (``decode_step``, the reference's
``generate`` for ssm and hybrid and ``make_serve_step``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (WHOLE_ROWS, embed_defs, ffn_apply,
                                       ffn_defs, norm_def, promoted,
                                       rms_norm, softcap)
from repro_torch.models.params import PDef, stacked, tree_map

F32 = torch.float32


def _require_paged(cfg, what: str) -> None:
    """The paged pool holds attention KV: the ssm, hybrid and encdec
    families decode over dense caches (``decode_step``), as in the
    reference."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{what} supports attention-cache families only, got "
            f"{cfg.family!r}")


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


def hybrid_groups(cfg):
    """zamba2: sizes of mamba-layer groups between shared-attn
    applications."""
    k = cfg.shared_attn_every
    L = cfg.num_layers
    sizes = []
    while L > 0:
        sizes.append(min(k, L))
        L -= k
    return sizes


def _group(tree, g: int):
    """Group ``g``'s views of a stacked parameter (or pool) subtree."""
    return tree_map(lambda a: a[g], tree)


# The sharded engine, trainer and serving steps (serving/engine/sharded.py,
# training/sharded.py, training/sharded_serve.py) keep parameters split
# over a mesh at rest and pass a ``gather(tree, path)`` hook down: it
# returns the subtree at key ``path`` of the parameter tree whole on this
# rank (a layer's view for a path into a stacked subtree, "blocks",
# "mamba", "mamba_ln", and encdec.py's "enc" and "dec"), so a rank holds
# one layer's gathered leaves at a time. Without the hook the parameters
# are whole.
def _whole(params, key: str, gather):
    return params[key] if gather is None else gather(params[key], (key,))


def _layer(params, j: int, g: int, gather):
    """Sub-layer slot ``j`` of group ``g``: its parameters' views."""
    p = _group(params["blocks"][f"sub{j}"], g)
    return p if gather is None else gather(p, ("blocks", f"sub{j}"))


# ------------------------------------------------------------ param defs ----
def _dense_sublayer_defs(cfg, kind) -> dict:
    d = cfg.d_model
    defs: Dict[str, Any] = {
        "ln1": norm_def(d),
        "attn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim),
        "ln2": norm_def(d),
    }
    if kind["moe"]:
        defs["moe"] = moe_lib.moe_defs(d, cfg.moe)
    else:
        defs["ffn"] = ffn_defs(d, cfg.d_ff, cfg.activation)
    if cfg.sandwich_norm:
        defs["ln1_post"] = norm_def(d)
        defs["ln2_post"] = norm_def(d)
    return defs


def param_defs(cfg) -> dict:
    d = cfg.d_model
    defs: Dict[str, Any] = {"embed": embed_defs(cfg.padded_vocab, d),
                            "final_norm": norm_def(d)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((d, cfg.padded_vocab), ("embed", "vocab"),
                               "scaled")
    if cfg.frontend == "vision_stub":
        defs["frontend_proj"] = PDef((d, d), ("embed", "embed2"), "scaled")
    if cfg.family in ("ssm", "hybrid"):
        defs["mamba"] = stacked(ssm_lib.mamba_defs(cfg), cfg.num_layers)
        defs["mamba_ln"] = stacked(norm_def(d), cfg.num_layers)
        if cfg.family == "hybrid":
            defs["shared"] = {
                "fuse_in": PDef((2 * d, d), ("embed2", "embed"), "scaled"),
                "fuse_out": PDef((d, d), ("embed2", "embed"), "scaled"),
                **_dense_sublayer_defs(cfg, SHARED_KIND)}
        return defs
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)
    assert cfg.num_layers % P == 0, (cfg.name, cfg.num_layers, P)
    defs["blocks"] = {f"sub{j}": stacked(_dense_sublayer_defs(cfg, kinds[j]),
                                         cfg.num_layers // P)
                      for j in range(P)}
    return defs


# ----------------------------------------------------------------- blocks ----
SHARED_KIND = {"attn": "global", "moe": False}   # the hybrid's shared block


def _ffn_half(p, x, kind, cfg, dot, ranks=None, rows=WHOLE_ROWS):
    """The feed-forward half of a block: (x + f, the moe aux loss or
    0.0). ``ranks``: the ranks the batch is split over, ``rows`` the
    residual's rows (``forward``): the FFN or the experts run on whole
    rows."""
    h = rows.whole(rows.norm(x, p["ln2"], cfg.norm_eps))
    if kind["moe"]:
        f, aux = moe_lib.moe_apply(p["moe"], h, cfg.moe, cfg.activation,
                                   dot=dot, ranks=ranks)
    else:
        f, aux = ffn_apply(p["ffn"], h, cfg.activation, dot=dot), 0.0
    f = rows.local(f)
    if cfg.sandwich_norm:
        f = rows.norm(f, p["ln2_post"], cfg.norm_eps)
    return x + f, aux


def _attn_residual(p, x, a, cfg, rows=WHOLE_ROWS):
    a = rows.local(a)
    if cfg.sandwich_norm:
        a = rows.norm(a, p["ln1_post"], cfg.norm_eps)
    return x + a


def _dense_block_fwd(p, x, kind, cfg, positions, dot, kernel, ring=False,
                     ranks=None, rows=WHOLE_ROWS):
    """``ring``: a local layer's cache in ring layout (dense decode)
    instead of chronological (the page pool's). ``rows``: x's rows
    (``forward``); the attention runs on whole rows."""
    h = rows.whole(rows.norm(x, p["ln1"], cfg.norm_eps))
    a, cache = attn.attention_fwd(p["attn"], h, kind["attn"], cfg, positions,
                                  dot=dot, kernel=kernel)
    x, aux = _ffn_half(p, _attn_residual(p, x, a, cfg, rows), kind, cfg,
                       dot, ranks, rows)
    if ring and kind["attn"] == "local":
        W = cfg.window_size
        cache = {"k": _to_ring(cache["k"], W), "v": _to_ring(cache["v"], W)}
    return x, cache, aux


def _to_ring(k: torch.Tensor, W: int) -> torch.Tensor:
    """A chronological cache (B, S, K, hd) as a W-slot ring: the last W
    positions rearranged, or (S < W) padded, position p in slot p."""
    S = k.shape[1]
    if S >= W:
        return attn._last_window_ring(k, W)
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, W - S))


def _dense_block_decode(p, x, cache, pos, kind, cfg, dot, place=None,
                        ranks=None):
    """One token through a block over its dense caches (written in
    place); ``place``: a rank's block of them, ``ranks`` the ranks the
    batch is split over (``decode_step``)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _, _ = attn.attention_decode(p["attn"], h, cache["k"], cache["v"],
                                    pos, kind["attn"], cfg, dot=dot,
                                    place=place)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), kind, cfg, dot,
                     ranks)[0]


def _fuse(u, w, dot):
    """The hybrid's fuse projections: a plain product, as the reference's,
    whatever the hook; a stored weight (serving/quant.py), which has no
    plain product (the reference's einsum fails on it), through the hook
    (site "fuse", HAQ's name for both)."""
    return dot(u, w, "fuse") if isinstance(w, dict) else u @ w


def _shared_block_fwd(p, x, emb, cfg, positions, dot, kernel,
                      rows=WHOLE_ROWS):
    """The hybrid's shared block: x concatenated with the original
    embedding, fused to d_model, one global dense block (through the
    dense sites of ``dot``), projected back and added to x. ``rows``: x's
    and emb's rows (``forward``); both fuse products run on whole
    rows."""
    u = _fuse(rows.whole(torch.cat([x, emb], dim=-1)), p["fuse_in"], dot)
    u, cache, _ = _dense_block_fwd(p, rows.local(u), SHARED_KIND, cfg,
                                   positions, dot, kernel, rows=rows)
    return x + rows.local(_fuse(rows.whole(u), p["fuse_out"], dot)), cache


def _shared_block_decode(p, x, emb, cache, pos, cfg, dot, place=None):
    u = _fuse(torch.cat([x, emb], dim=-1), p["fuse_in"], dot)
    u = _dense_block_decode(p, u, cache, pos, SHARED_KIND, cfg, dot, place)
    return x + _fuse(u, p["fuse_out"], dot)


def _mamba_layer(p, ln, gather):
    """A mamba layer's parameters and its pre-norm (views of layer l of
    the stacked ``mamba`` and ``mamba_ln``), whole on this rank."""
    if gather is None:
        return p, ln
    return gather(p, ("mamba",)), gather(ln, ("mamba_ln",))


def _mamba_fwd(p, ln, x, cfg, dot, gather=None, rows=WHOLE_ROWS):
    p, ln = _mamba_layer(p, ln, gather)
    y, cache = ssm_lib.mamba_block_fwd(
        p, rows.whole(rows.norm(x, ln, cfg.norm_eps)), cfg, dot=dot)
    return x + rows.local(y), cache


def _dense_block_decode_paged(p, x, pool_kv, page_table, positions, kind,
                              cfg, kernel, dot):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _, _ = attn.attention_decode_paged(
        p["attn"], h, pool_kv["k"], pool_kv["v"], page_table, positions,
        kind["attn"], cfg, kernel=kernel, dot=dot)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), kind, cfg, dot)[0]


def _dense_block_prefill_paged(p, x, pool_kv, page_table, positions, kind,
                               cfg, kernel, dot):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _, _ = attn.attention_prefill_paged(
        p["attn"], h, pool_kv["k"], pool_kv["v"], page_table, positions,
        kind["attn"], cfg, kernel=kernel, dot=dot)
    return _ffn_half(p, _attn_residual(p, x, a, cfg), kind, cfg, dot)[0]


# ---------------------------------------------------------------- embed ----
def embed_tokens(params, tokens, cfg, gather=None):
    x = _whole(params, "embed", gather)[tokens.long()]
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d) to the activation dtype first
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _assemble_input(params, batch, cfg, gather=None):
    """(x (B, S, D), loss mask (B, S) or None). The vision stub: patches
    (B, S_p, D), rounded to bf16, through ``frontend_proj``, before the
    token embeddings; the mask is 0 on the patch rows and 1 on the
    text."""
    te = embed_tokens(params, batch["tokens"], cfg, gather)
    if cfg.frontend != "vision_stub":
        return te, None
    w = _whole(params, "frontend_proj", gather)
    pe = torch.einsum("bsd,de->bse", *promoted(
        batch["patches"].to(torch.bfloat16), w))
    mask = torch.cat([torch.zeros(pe.shape[:2], dtype=F32, device=pe.device),
                      torch.ones(te.shape[:2], dtype=F32, device=te.device)],
                     dim=1)
    return torch.cat([pe, te], dim=1), mask


def unembed(params, x, cfg, *, dot=None, gather=None):
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
    (``torch.backends.cuda.matmul.allow_tf32 = False``). ``gather``: the
    sharded engine's and trainer's hook (``_whole``)."""
    return _logits(x, _unembed_weight(params, cfg, gather), cfg, dot)


def _unembed_weight(params, cfg, gather):
    """The (D, V) unembedding: the tied table's transpose or lm_head,
    whole on this rank."""
    return _whole(params, "embed", gather).T if cfg.tie_embeddings \
        else _whole(params, "lm_head", gather)


def _logits(x, w, cfg, dot):
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
def _chunk_ce(w, xc, lc, mc, cfg, dot):
    """Masked sum of one chunk's next-token losses."""
    logits = _logits(xc, w, cfg, dot)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((logz - gold) * mc)


def chunked_ce(params, hidden, labels, cfg, *, dot=None, chunk: int = 256,
               loss_mask=None, gather=None, data_sum=None,
               shifted: bool = False):
    """Next-token cross-entropy without materializing (B, S, V) logits:
    the unembed and log-sum-exp run per ``chunk`` rows, so peak live
    memory is (B, chunk, V). Where autograd records (training), each chunk
    runs under a checkpoint, as the reference's rematerialized scan does:
    its fp32 logits and the unembed's fp32 copy of the table are made
    again in the backward, one chunk at a time, instead of kept for all
    chunks (16 fp32 copies of the tied gemma2-2b table would be 38 GB).
    The mask and the padding of the last chunk are the reference's.

    ``gather``: the sharded trainer's hook (``_whole``); the unembedding
    is gathered once per loss, before the chunks, which all read it.
    ``data_sum``: the sum of a scalar over the ranks that split the batch
    (training/sharded.py): the loss sum and the token count are summed
    over them before the division, so the loss is the global batch's
    mean. ``shifted``: ``labels`` and ``loss_mask`` (given) are already
    each hidden row's next-token label and weight (a rank's rows of a
    sequence split over data, distributed/sharding.py::DataSeqRows), so
    no row is dropped."""
    w = _unembed_weight(params, cfg, gather)
    if shifted:
        xs, ls, mask = hidden, labels.long(), loss_mask.to(F32)
    else:
        xs, ls = hidden[:, :-1], labels[:, 1:].long()
    B, n, D = xs.shape
    if not shifted:
        mask = torch.ones((B, n), dtype=F32, device=xs.device) \
            if loss_mask is None else loss_mask[:, 1:].to(F32)
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        ls = torch.nn.functional.pad(ls, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    remat = torch.is_grad_enabled() and xs.requires_grad
    tot = torch.zeros((), dtype=F32, device=xs.device)
    for c in range(0, n + pad, chunk):
        args = (w, xs[:, c:c + chunk], ls[:, c:c + chunk],
                mask[:, c:c + chunk], cfg, dot)
        tot = tot + (checkpoint(_chunk_ce, *args, use_reentrant=False)
                     if remat else _chunk_ce(*args))
    cnt = torch.sum(mask)
    if data_sum is not None:
        tot, cnt = data_sum(tot), data_sum(cnt)
    return tot / torch.clamp(cnt, min=1.0)


# --------------------------------------------------------------- forward ----
def forward(params, batch, cfg, *, want_cache: bool,
            unembed_mode: str = "full", cache_layout: str = "ring",
            dot=None, kernel: str = "auto", remat: bool = False,
            gather=None, place=None, ranks=None, ac=None):
    """Full-sequence forward (training and prefill).

    unembed_mode: "full" -> logits (B,S,V); "last" -> logits (B,1,V);
    "none" -> final hidden states (B,S,D).
    cache_layout: "ring" -> local layers' caches in ring layout
    (``window_size`` slots, slot = position % W: the dense decode's);
    "full" -> chronological caches of shape (n_groups, B, S, K, hd) per
    sub-layer slot (what the paged engine copies into its pool). The ssm
    family's caches are ``{"mamba": {"conv", "state"}}`` stacked over
    layers; the hybrid's add ``"shared": {"k", "v"}`` stacked over the
    shared block's applications.
    dot: optional (x, w, name) -> y override of every matmul site.
    kernel: the flash-attention mode ("auto" | "cuda" | "ref") of the
    layers' whole-sequence attention from FLASH_MIN tokens on
    (models/flash.py, whose backward serves training); shorter sequences
    attend densely.
    remat: run each group of ``period_of(cfg)`` sub-layers (each mamba
    layer) under a checkpoint (the reference's ``jax.checkpoint``): the
    backward runs its forward again, flash kernel included, instead of
    keeping its activations.
    gather: the sharded trainer's and serving steps' hook (see
    ``_whole``): every family's layers gathered one at a time.
    place: the sharded serving steps' cache layout
    (training/sharded_serve.py): {slot: ``CacheBlock``}, and for the ssm
    and hybrid families {"mamba": ``MambaBlock``, "shared": ``CacheBlock``}
    (distributed/sharding.py); each layer's caches are cut to this rank's
    block as they are made.
    ranks: the ranks the batch's rows are split over
    (distributed/sharding.py::BatchRanks), for the moe layers' global
    capacity, slots and aux loss (models/moe.py); batch is this rank's
    rows.
    ac: the sharded steps' activation layout
    (distributed/sharding.py::make_ac): under seq_tp the residual
    stream's rows split over the model axis between sub-layers
    (``ac.rows``: the norms on the rank's rows, every sub-layer on whole
    rows, a remat checkpoint saving the rank's rows); the final norm and
    the unembedding run on whole rows. Where a training batch's sequence
    splits over data (``DataSeqRows``) the same, over the data axis, but
    the final norm and the unembedding run on the rank's rows (what the
    loss takes, models/api.py::Model.loss), the moe layers route the
    whole rows without ``ranks`` and ``aux`` is the whole batch's on every
    rank. None (or ``dp``): whole rows.
    batch: {tokens (B, S)}, and for the vision stub also patches
    (B, S_p, D), which come first: the sequence is S_p + S rows.
    Returns (logits_or_hidden, caches or None, aux, loss_mask): aux
    is the fp32 scalar tensor sum of the moe layers' load-balance losses
    (the float 0.0 for the other families); loss_mask (B, S_p + S) is 0
    on the patch rows and 1 on the text for the vision stub, else None.
    """
    if cache_layout not in ("ring", "full"):
        raise ValueError(f"cache_layout must be 'ring' or 'full', got "
                         f"{cache_layout!r}")
    ring = want_cache and cache_layout == "ring"
    x, loss_mask = _assemble_input(params, batch, cfg, gather)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    rows = WHOLE_ROWS if ac is None else ac.rows(x)
    x = rows.local(x)                 # the reference's ac(x, "resid")
    if cfg.family in ("ssm", "hybrid"):
        x, out_cache = _forward_mamba(params, x, cfg, positions, want_cache,
                                      dot, kernel, remat, gather, place,
                                      rows)
        aux_total = 0.0
    else:
        x, out_cache, aux_total = _forward_blocks(
            params, x, cfg, positions, want_cache, ring, dot, kernel, remat,
            gather, place, rows.route(ranks), rows)
    x = rows.final(x)
    x = rms_norm(x, _whole(params, "final_norm", gather), cfg.norm_eps)
    if unembed_mode == "none":
        return x, out_cache, aux_total, loss_mask
    if unembed_mode == "last":
        x = x[:, -1:]
    logits = unembed(params, x, cfg, dot=dot, gather=gather)
    return logits, out_cache, aux_total, loss_mask


def _forward_blocks(params, x, cfg, positions, want_cache, ring, dot,
                    kernel, remat, gather=None, place=None, ranks=None,
                    rows=WHOLE_ROWS):
    """The dense, moe and vlm families' layer groups: (x, caches, aux);
    ``place`` cuts each layer's caches to a rank's block, ``ranks`` and
    ``rows`` (x's rows) as in ``forward``."""
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)

    def group_body(h, aux, blocks):
        kv = []
        for j in range(P):
            p = blocks[f"sub{j}"]
            if gather is not None:
                p = gather(p, ("blocks", f"sub{j}"))
            h, c, a = _dense_block_fwd(p, h, kinds[j], cfg, positions, dot,
                                       kernel, ring, ranks, rows)
            aux = aux + a
            kv.append(c if want_cache else None)
        return h, aux, kv

    caches: Dict[str, Dict[str, list]] = {
        f"sub{j}": {"k": [], "v": []} for j in range(P)}
    aux_total = 0.0
    for g in range(cfg.num_layers // P):
        blocks = {f"sub{j}": _group(params["blocks"][f"sub{j}"], g)
                  for j in range(P)}
        if remat:
            x, aux_total, kv = checkpoint(group_body, x, aux_total, blocks,
                                          use_reentrant=False)
        else:
            x, aux_total, kv = group_body(x, aux_total, blocks)
        if want_cache:
            for j, c in enumerate(kv):
                for n in ("k", "v"):
                    caches[f"sub{j}"][n].append(
                        c[n] if place is None
                        else place[f"sub{j}"].block(c[n]))
    out_cache = None
    if want_cache:
        out_cache = {s: {kv: torch.stack(lst) for kv, lst in c.items()}
                     for s, c in caches.items()}
    return x, out_cache, aux_total


def _forward_mamba(params, x, cfg, positions, want_cache, dot, kernel,
                   remat, gather=None, place=None, rows=WHOLE_ROWS):
    """The ssm and hybrid families: every mamba layer in order, the
    hybrid's shared block (on x and the original embedding) before each
    of its ``hybrid_groups``. ``gather``, ``place`` and ``rows`` (x's
    rows) as in ``forward``. Returns (x, caches or None)."""
    emb0 = x
    groups = hybrid_groups(cfg) if cfg.family == "hybrid" \
        else [cfg.num_layers]
    convs, states, ks, vs = [], [], [], []
    layer = 0
    for size in groups:
        if cfg.family == "hybrid":
            x, sc = _shared_block_fwd(_whole(params, "shared", gather), x,
                                      emb0, cfg, positions, dot, kernel,
                                      rows)
            if place is not None:
                sc = {n: place["shared"].block(t) for n, t in sc.items()}
            ks.append(sc["k"])
            vs.append(sc["v"])
        for l in range(layer, layer + size):
            args = (_group(params["mamba"], l), params["mamba_ln"][l], x,
                    cfg, dot, gather, rows)
            x, mc = checkpoint(_mamba_fwd, *args, use_reentrant=False) \
                if remat else _mamba_fwd(*args)
            if place is not None:
                mc = {n: place["mamba"].block(n, t) for n, t in mc.items()}
            convs.append(mc["conv"])
            states.append(mc["state"])
        layer += size
    if not want_cache:
        return x, None
    caches = {"mamba": {"conv": torch.stack(convs),
                        "state": torch.stack(states)}}
    if cfg.family == "hybrid":
        caches["shared"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, caches


# ----------------------------------------------------------------- decode ----
def decode_step(params, cache, token, pos, cfg, *, dot=None, gather=None,
                place=None, ranks=None):
    """token (B,1) int32, pos a scalar int tensor (or int): the position of
    the token. One step over the dense caches of ``cache_specs``' layout
    (a prefill's, grown to the decode length), which it updates in place:
    KV slots written, mamba conv windows and states replaced. Returns
    (logits (B,1,V), cache).

    The sharded serving steps' hooks (training/sharded_serve.py):
    ``gather`` and ``ranks`` as in ``forward``, and ``place``
    (``forward``'s layout): ``cache`` is a rank's block of each slot's
    caches."""
    x = embed_tokens(params, token, cfg, gather)
    pos = torch.as_tensor(pos, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        emb0 = x
        groups = hybrid_groups(cfg) if cfg.family == "hybrid" \
            else [cfg.num_layers]
        mc = cache["mamba"]
        layer = 0
        for g, size in enumerate(groups):
            if cfg.family == "hybrid":
                x = _shared_block_decode(
                    _whole(params, "shared", gather), x, emb0,
                    _group(cache["shared"], g), pos, cfg, dot,
                    None if place is None else place["shared"])
            for l in range(layer, layer + size):
                p, ln = _mamba_layer(_group(params["mamba"], l),
                                     params["mamba_ln"][l], gather)
                y, new = ssm_lib.mamba_block_decode(
                    p, rms_norm(x, ln, cfg.norm_eps), _group(mc, l), cfg,
                    dot=dot, place=None if place is None
                    else place["mamba"])
                mc["conv"][l] = new["conv"]
                mc["state"][l] = new["state"]
                x = x + y
            layer += size
    else:
        for g, j, kind in _layers(cfg):
            x = _dense_block_decode(
                _layer(params, j, g, gather), x,
                _group(cache[f"sub{j}"], g), pos, kind, cfg, dot,
                None if place is None else place[f"sub{j}"], ranks)
    x = rms_norm(x, _whole(params, "final_norm", gather), cfg.norm_eps)
    return unembed(params, x, cfg, dot=dot, gather=gather), cache


# ----------------------------------------------------------- paged decode ----
def decode_step_paged(params, pool, page_table, token, positions, cfg, *,
                      kernel="auto", dot=None, gather=None):
    """Batched slot-indexed decode against a paged KV pool.

    token (B,1) int32; positions (B,) int32 per-sequence absolute
    positions; pool is the dict from ``init_pool`` and page_table
    (B, n_pages) maps each sequence's logical blocks to physical pages
    (shared across layers). ``kernel`` selects the paged-attention path
    (see attention_decode_paged); ``dot`` overrides every matmul site;
    ``gather`` is the sharded engine's hook (``_whole``). The pool is
    updated in place. Returns (logits (B,1,V), pool)."""
    _require_paged(cfg, "paged decode")
    x = embed_tokens(params, token, cfg, gather)
    for g, j, kind in _layers(cfg):
        x = _dense_block_decode_paged(
            _layer(params, j, g, gather), x, _group(pool[f"sub{j}"], g),
            page_table, positions, kind, cfg, kernel, dot)
    x = rms_norm(x, _whole(params, "final_norm", gather), cfg.norm_eps)
    return unembed(params, x, cfg, dot=dot, gather=gather), pool


# --------------------------------------------------------- paged prefill ----
def prefill_chunk_paged(params, pool, page_table, tokens, positions, cfg, *,
                        kernel="auto", dot=None, gather=None):
    """One chunked-prefill step: run ``tokens`` (B, Sq) — a contiguous
    prompt chunk whose first token sits at ``positions[b]`` — through every
    layer, writing each layer's chunk K/V into the pool in place and
    attending over the pool itself (resident prefix + the chunk);
    ``dot`` overrides every matmul site; ``gather`` is the sharded
    engine's hook (``_whole``).

    Returns (hidden (B, Sq, D) final-norm hidden states, pool); the caller
    unembeds only the rows it needs."""
    _require_paged(cfg, "paged prefill")
    x = embed_tokens(params, tokens, cfg, gather)
    for g, j, kind in _layers(cfg):
        x = _dense_block_prefill_paged(
            _layer(params, j, g, gather), x, _group(pool[f"sub{j}"], g),
            page_table, positions, kind, cfg, kernel, dot)
    return rms_norm(x, _whole(params, "final_norm", gather),
                    cfg.norm_eps), pool


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
    _require_paged(cfg, "paged KV pool")
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
    return zeros(pool_specs(cfg, num_pages, page_size, kv_bits), device)


def pool_axes(cfg, kv_bits=None):
    """Logical axes matching ``pool_specs`` (for the sharded engine).
    ``kv_heads`` is the only mesh-mapped axis: the page and page-slot dims
    stay whole because the paged walk's online softmax must keep its
    one-device reduction order (bit-exact serving), and pages are the host
    allocator's unit: one page id covers every shard's kv-head slice of
    that page. Quantized codes and their scale tiles split alike."""
    kv = ("layer", None, None, "kv_heads", "head_dim")
    scale = ("layer", None, None, "kv_heads")
    return tree_map(lambda spec: kv if len(spec[0]) == 5 else scale,
                    pool_specs(cfg, 2, 2, kv_bits=kv_bits))


# ------------------------------------------------------------ cache specs ----
def cache_specs(cfg, batch: int, seq_len: int):
    """The dense decode cache's layout as (shape, dtype) pairs: per
    sub-layer slot k/v of (n_groups, B, T, K, hd) bf16, T = seq_len, or
    the window for a local slot (its ring); the ssm family's mamba
    conv/state stacked over layers; the hybrid's also the shared block's
    k/v stacked over its applications."""
    hd = cfg.resolved_head_dim
    K = cfg.num_kv_heads

    def kv(T, lead):
        return {"k": (lead + (batch, T, K, hd), torch.bfloat16),
                "v": (lead + (batch, T, K, hd), torch.bfloat16)}

    if cfg.family in ("ssm", "hybrid"):
        one = ssm_lib.mamba_cache_spec(cfg, batch)
        out = {"mamba": {k: ((cfg.num_layers,) + shape, dtype)
                         for k, (shape, dtype) in one.items()}}
        if cfg.family == "hybrid":
            out["shared"] = kv(seq_len, (len(hybrid_groups(cfg)),))
        return out
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)
    n_groups = cfg.num_layers // P
    return {f"sub{j}": kv(attn.cache_len_for(kinds[j]["attn"], cfg, seq_len),
                          (n_groups,))
            for j in range(P)}


def cache_axes(cfg):
    """Logical axes matching ``cache_specs`` (for sharding)."""
    kv_ax = {"k": ("layer", "batch", "cache_seq", "kv_heads", "head_dim"),
             "v": ("layer", "batch", "cache_seq", "kv_heads", "head_dim")}
    mamba_ax = {"conv": ("layer", "batch", "conv", "ssm_inner"),
                "state": ("layer", "batch", "ssm_heads", "head_dim",
                          "ssm_state")}
    if cfg.family == "ssm":
        return {"mamba": mamba_ax}
    if cfg.family == "hybrid":
        return {"mamba": mamba_ax, "shared": dict(kv_ax)}
    return {f"sub{j}": dict(kv_ax) for j in range(period_of(cfg))}


def zeros(spec, device):
    """Zero tensors on ``device`` in the nesting of a (shape, dtype)
    spec tree."""
    if isinstance(spec, dict):
        return {k: zeros(v, device) for k, v in spec.items()}
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=device)

