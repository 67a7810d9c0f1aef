"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv/audio frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``frames (B, S_enc, d_model)``. Positions are
sinusoidal (no RoPE, cfg.rope_theta == 0). num_layers applies to both
stacks; the decoder's length is seq_len // cfg.dec_ratio.

The encoder attends bidirectionally (flash from FLASH_MIN frames on, the
kernel's full-attention mode); each decoder layer attends causally to the
tokens, then across to the encoder memory (``attention.cross_attention``).
Decode caches: per decoder layer a self-attention k/v cache ("k", "v",
grown to the decode length by the caller) and the cross-attention k/v of
the encoder memory ("mk", "mv"), computed once at prefill and never
grown. Where the reference scans its stacked layers, this port loops over
per-layer views.

Split over a mesh (training/sharded.py, training/sharded_serve.py), the
entry points take transformer.py's hooks: ``gather`` makes each layer
(``enc``, ``dec``) and the embedding, norms and lm_head whole at use, and
``place`` ({"self": ``CacheBlock``, "cross": ``CacheBlock``},
distributed/sharding.py) cuts the prefill's k/v and mk/mv to this rank's
blocks, per ``cache_axes``; a decode step attends over its blocks and
combines the ranks' softmaxes where a block holds part of the sequence
(of decoder slots or of encoder frames).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.layers import (WHOLE_ROWS, ffn_apply, ffn_defs,
                                       norm_def, rms_norm)
from repro_torch.models.params import PDef, stacked, tree_map
from repro_torch.models.transformer import _whole, embed_tokens, unembed

F32 = torch.float32
F64 = torch.float64


def _f32(c: float) -> float:
    return float(torch.tensor(c, dtype=F32))


# Cephes' expf, the polynomial XLA's CPU backend evaluates for exp
# (with fused multiply-adds): the reference's inverse frequencies bit for
# bit, so every angle pos * inv is its fp32 product too
_LOG2E, _C1, _C2 = (_f32(c) for c in (1.44269504088896341, 0.693359375,
                                      -2.12194440e-4))
_EXP_P = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))


def _fma(a, b, c):
    """a * b + c rounded once to fp32 (fp32 values held in fp64, where the
    product is exact)."""
    return (a * b + c).to(F32).to(F64)


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of fp32 ``x`` in [-88, 88] as the reference's CPU backend
    computes it (within an fp32 ulp of the true value)."""
    x = x.to(F64)
    fx = torch.floor(_fma(x, _LOG2E, 0.5))
    x = _fma(fx, -_C1, x)
    x = _fma(fx, -_C2, x)
    z = (x * x).to(F32).to(F64)
    y = torch.full_like(x, _EXP_P[0])
    for p in _EXP_P[1:]:
        y = _fma(y, x, p)
    y = (_fma(y, z, x) + 1.0).to(F32).to(F64)
    return (y * torch.exp2(fx)).to(F32)


def _inv_freq(d: int, device) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=F32, device=device)
    return _exp_f32(-math.log(10000.0) * dim / max(d // 2 - 1, 1))


def _sincos(ang: torch.Tensor) -> torch.Tensor:
    """[sin | cos] of fp32 angles, each rounded once from fp64: the
    reference's CPU backend calls the C library's sinf/cosf, which land
    within an fp32 ulp of that (equal in ~98.7% of the elements; the
    bf16-rounded tables the encoder adds differ in 5 of 21M at whisper's
    16384 x 1280, none at the tiny configs' widths)."""
    a = ang.to(F64)
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1).to(F32)


def sinusoidal(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) fp32 positional table: sin of pos * inv_freq in the first
    half, cos in the second."""
    pos = torch.arange(S, dtype=F32, device=device)[:, None]
    return _sincos(pos * _inv_freq(d, device)[None, :])


def sinusoidal_at(pos, d: int, device=None) -> torch.Tensor:
    """(d,) fp32 row of ``sinusoidal`` at ``pos`` (an int or a scalar
    tensor, read on its device)."""
    pos = torch.as_tensor(pos, device=device)
    return _sincos(pos.to(F32) * _inv_freq(d, pos.device))


# ------------------------------------------------------------ param defs ----
def _enc_layer_defs(cfg) -> dict:
    d = cfg.d_model
    return {
        "ln1": norm_def(d),
        "attn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim),
        "ln2": norm_def(d),
        "ffn": ffn_defs(d, cfg.d_ff, cfg.activation),
    }


def _dec_layer_defs(cfg) -> dict:
    d = cfg.d_model
    return {
        **_enc_layer_defs(cfg),
        "ln_x": norm_def(d),
        "xattn": attn.attn_defs(d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.resolved_head_dim),
    }


def param_defs(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": PDef((cfg.padded_vocab, d), ("vocab", "embed"), "normal"),
        "enc": stacked(_enc_layer_defs(cfg), cfg.num_layers),
        "dec": stacked(_dec_layer_defs(cfg), cfg.num_layers),
        "enc_norm": norm_def(d),
        "final_norm": norm_def(d),
        "lm_head": PDef((d, cfg.padded_vocab), ("embed", "vocab"), "scaled"),
    }


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _gathered(p, key: str, gather):
    """Layer views of the stacked ``key`` ("enc" or "dec"), whole."""
    return p if gather is None else gather(p, (key,))


# ---------------------------------------------------------------- encoder ----
def _enc_layer(p, h, cfg, dot, kernel, gather=None, rows=WHOLE_ROWS):
    p = _gathered(p, "enc", gather)
    a, _ = attn.attention_fwd(
        p["attn"], rows.whole(rows.norm(h, p["ln1"], cfg.norm_eps)),
        "bidir", cfg, None, dot=dot, kernel=kernel)
    h = h + rows.local(a)
    f = ffn_apply(p["ffn"], rows.whole(rows.norm(h, p["ln2"], cfg.norm_eps)),
                  cfg.activation, dot=dot)
    return h + rows.local(f)


def encode(params, frames, cfg, *, remat=False, dot=None, kernel="auto",
           gather=None, ac=None):
    """frames (B, S, D) -> the encoder memory (B, S, D). The frames and
    the sinusoid are each rounded to bf16 before the add, as in the
    reference; ``remat`` runs each layer under a checkpoint. ``ac``: the
    sharded steps' activation layout (transformer.forward's): under
    seq_tp, or where the frames' sequence splits over data, the layers
    hold the rank's rows between sub-layers, and the memory is gathered
    whole before ``enc_norm`` (over data, its gradient reduce-scattered
    back to the frames' owners)."""
    S, D = frames.shape[1:]
    x = frames.to(torch.bfloat16) + \
        sinusoidal(S, D, frames.device).to(torch.bfloat16)
    rows = WHOLE_ROWS if ac is None else ac.rows(x)
    x = rows.local(x)
    for i in range(cfg.num_layers):
        args = (_layer(params["enc"], i), x, cfg, dot, kernel, gather, rows)
        x = checkpoint(_enc_layer, *args, use_reentrant=False) if remat \
            else _enc_layer(*args)
    return rms_norm(rows.whole(x), _whole(params, "enc_norm", gather),
                    cfg.norm_eps)


# ---------------------------------------------------------------- decoder ----
def _dec_layer(p, h, mem, cfg, dot, kernel, want_cache, gather=None,
               rows=WHOLE_ROWS):
    p = _gathered(p, "dec", gather)
    a, sc = attn.attention_fwd(
        p["attn"], rows.whole(rows.norm(h, p["ln1"], cfg.norm_eps)),
        "global", cfg, None, dot=dot, kernel=kernel)
    h = h + rows.local(a)
    mk, mv = attn.cross_kv(p["xattn"], mem, dot=dot)
    c = attn.cross_attention(
        p["xattn"], rows.whole(rows.norm(h, p["ln_x"], cfg.norm_eps)), mk,
        mv, cfg, dot=dot, kernel=kernel)
    h = h + rows.local(c)
    f = ffn_apply(p["ffn"], rows.whole(rows.norm(h, p["ln2"], cfg.norm_eps)),
                  cfg.activation, dot=dot)
    cache = {"k": sc["k"], "v": sc["v"], "mk": mk, "mv": mv} \
        if want_cache else None
    return h + rows.local(f), cache


def decode_fwd(params, mem, tokens, cfg, *, want_cache: bool, remat=False,
               dot=None, unembed_mode: str = "full", kernel="auto",
               gather=None, place=None, ac=None):
    """Teacher-forced decoder pass over tokens (B, S) against the encoder
    memory (whole). Returns (logits, or hidden states for unembed_mode
    "none"; caches stacked over layers, or None). ``ac`` as in
    ``encode``: the decoder's rows split on their own, and gathered whole
    before the final norm, except where they split over data: the final
    norm and the unembedding then run on the rank's rows (the loss's,
    models/api.py::Model.loss)."""
    x = embed_tokens(params, tokens, cfg, gather)
    x = x + sinusoidal(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)
    rows = WHOLE_ROWS if ac is None else ac.rows(x)
    x = rows.local(x)
    caches = []
    for i in range(cfg.num_layers):
        args = (_layer(params["dec"], i), x, mem, cfg, dot, kernel,
                want_cache, gather, rows)
        x, c = checkpoint(_dec_layer, *args, use_reentrant=False) if remat \
            else _dec_layer(*args)
        if want_cache and place is not None:
            c = {k: place[_SLOT[k]].block(t) for k, t in c.items()}
        caches.append(c)
    out = {k: torch.stack([c[k] for c in caches]) for k in caches[0]} \
        if want_cache else None
    x = rms_norm(rows.final(x), _whole(params, "final_norm", gather),
                 cfg.norm_eps)
    if unembed_mode == "none":
        return x, out
    if unembed_mode == "last":
        x = x[:, -1:]
    return unembed(params, x, cfg, dot=dot, gather=gather), out


def forward(params, batch, cfg, *, want_cache: bool, remat=False, dot=None,
            unembed_mode: str = "full", kernel="auto", gather=None,
            place=None, ac=None):
    """batch: {frames (B, S, D), tokens (B, S_dec)}. Returns (logits,
    caches, aux 0, None), transformer.forward's signature: no moe loss,
    no loss mask."""
    mem = encode(params, batch["frames"], cfg, remat=remat, dot=dot,
                 kernel=kernel, gather=gather, ac=ac)
    logits, caches = decode_fwd(params, mem, batch["tokens"], cfg,
                                want_cache=want_cache, remat=remat, dot=dot,
                                unembed_mode=unembed_mode, kernel=kernel,
                                gather=gather, place=place, ac=ac)
    return logits, caches, torch.zeros((), dtype=F32, device=mem.device), \
        None


def decode_step(params, cache, token, pos, cfg, *, dot=None, gather=None,
                place=None):
    """One decoder token (B, 1) at position ``pos`` (a scalar int tensor or
    int). cache: {k, v (L, B, S_dec, K, hd), mk, mv (L, B, S_enc, K, hd)};
    the self-attention slot ``pos`` is written in place. The cross
    attention runs through flash (the kernel on CUDA tensors) when S_enc
    >= 4 * FLASH_MIN. ``gather`` and ``place``: the sharded serving
    steps' hooks (the module docstring); ``cache`` is then this rank's
    blocks. Returns (logits (B, 1, V), cache)."""
    x = embed_tokens(params, token, cfg, gather)
    pos = torch.as_tensor(pos, device=x.device)
    x = x + sinusoidal_at(pos, cfg.d_model).to(x.dtype)[None, None, :]
    own, cross = (None, None) if place is None \
        else (place["self"], place["cross"])
    for i in range(cfg.num_layers):
        p = _gathered(_layer(params["dec"], i), "dec", gather)
        c = _layer(cache, i)
        a, _, _ = attn.attention_decode(
            p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), c["k"], c["v"],
            pos, "global", cfg, dot=dot, place=own)
        x = x + a
        x = x + attn.cross_attention(
            p["xattn"], rms_norm(x, p["ln_x"], cfg.norm_eps), c["mk"],
            c["mv"], cfg, dot=dot, place=cross)
        x = x + ffn_apply(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps),
                          cfg.activation, dot=dot)
    x = rms_norm(x, _whole(params, "final_norm", gather), cfg.norm_eps)
    return unembed(params, x, cfg, dot=dot, gather=gather), cache


def cache_specs(cfg, batch: int, seq_len: int):
    """The decode caches as (shape, dtype) pairs: self-attention k/v over
    max(seq_len // dec_ratio, 1) decoder positions, cross k/v over the
    seq_len encoder frames."""
    hd = cfg.resolved_head_dim
    K = cfg.num_kv_heads
    L = cfg.num_layers
    S_dec = max(seq_len // cfg.dec_ratio, 1)

    def sd(*shape):
        return (shape, torch.bfloat16)

    return {"k": sd(L, batch, S_dec, K, hd), "v": sd(L, batch, S_dec, K, hd),
            "mk": sd(L, batch, seq_len, K, hd),
            "mv": sd(L, batch, seq_len, K, hd)}


def cache_axes(cfg):
    """Logical axes matching ``cache_specs`` (for sharding)."""
    ax = ("layer", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax, "mk": ax, "mv": ax}


# each cache leaf's placement in a sharded serving step's ``place``: the
# self attention's slots and the encoder memory's frames
_SLOT = {"k": "self", "v": "self", "mk": "cross", "mv": "cross"}


def grow_cache(cache, max_len: int):
    """The self-attention k/v padded with zeros to ``max_len`` decoder
    positions; the encoder memory's mk/mv stay as they are, whatever
    their length (the reference's ``_grow_cache`` would pad them too
    whenever S_enc equals the decoder prompt's length)."""
    def grow(a):
        return torch.nn.functional.pad(
            a, (0, 0, 0, 0, 0, max_len - a.shape[2]))
    return {k: grow(a) if k in ("k", "v") else a for k, a in cache.items()}
