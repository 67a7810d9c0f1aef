"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) in chunked form
(port of ``repro.models.ssm``).

The forward uses the SSD chunked algorithm: quadratic attention-like
compute inside length-Q chunks, a linear state recurrence across chunks
(a Python loop where the reference scans). Decode is the O(1) recurrent
update. All state math is fp32. The reference runs the SSD as plain XLA,
with no Pallas kernel, so it is plain PyTorch here.

Block structure (mamba_block_*):
  in_proj -> [z | xs | B | C | dt] -> causal depthwise conv(xs,B,C) -> SiLU
  -> SSD -> gated RMSNorm (y * silu(z)) -> out_proj
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.params import PDef

F32 = torch.float32


def mamba_defs(cfg) -> dict:
    d, s = cfg.d_model, cfg.ssm
    di = cfg.d_inner
    H = cfg.ssm_heads
    G, N = s.n_groups, s.d_state
    d_conv = di + 2 * G * N
    return {
        "in_proj": PDef((d, 2 * di + 2 * G * N + H), ("embed", "ssm_inner"),
                        "scaled"),
        "conv_w": PDef((s.conv_width, d_conv), ("conv", "ssm_inner"),
                       "scaled", scale=0.5),
        "conv_b": PDef((d_conv,), ("ssm_inner",), "zeros"),
        "a_log": PDef((H,), ("null",), "zeros", dtype=F32),
        "dt_bias": PDef((H,), ("null",), "zeros", dtype=F32),
        "d_skip": PDef((H,), ("null",), "ones", dtype=F32),
        "norm": PDef((di,), ("ssm_inner",), "zeros", dtype=F32),
        "out_proj": PDef((di, d), ("ssm_inner", "embed"), "scaled"),
    }


def _matmul(a, w, name):
    return a @ w


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as the reference computes it (``logaddexp(x, 0)``) at
    every x: ``F.softplus`` returns x itself above its threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _split_proj(cfg, zxbcdt):
    """[z | xs | B | C | dt] along the last axis (sizes, where the
    reference's ``jnp.split`` takes split points)."""
    di = cfg.d_inner
    GN = cfg.ssm.n_groups * cfg.ssm.d_state
    return torch.split(zxbcdt, [di, di, GN, GN, cfg.ssm_heads], dim=-1)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C), w (W,C). The taps add in fp32 in
    tap order, then the sum is cast to x's dtype, as in the reference."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].to(F32) * w[i].to(F32)
    return (out + b.to(F32)).to(x.dtype)


def ssd_chunked(xh, dt, a_log, Bm, Cm, chunk: int):
    """SSD scan. xh (B,S,H,P), dt (B,S,H) fp32 post-softplus, Bm/Cm
    (B,S,G,N).

    Returns (y (B,S,H,P) fp32, final_state (B,H,P,N) fp32).
    """
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:  # pad with dt=0/x=0 tokens: state-neutral (decay 1, contrib 0)
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    hg = H // G
    A = -torch.exp(a_log.to(F32))                         # (H,) negative

    xc = xh.reshape(B, nc, Q, H, P).to(F32)
    dtc = dt.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, G, N).to(F32)
    Cc = Cm.reshape(B, nc, Q, G, N).to(F32)

    dA = dtc * A                                          # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)                         # within-chunk
    # intra-chunk (masked "attention"): L[i,j] = exp(cum_i - cum_j), i >= j
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    # the masked (i < j) differences are zeroed before the exp: there they
    # are positive, and past ~88 their exp overflows, which the reference's
    # where(mask, exp(diff), 0) keeps out of L but not out of its gradient
    # (0 * inf = NaN in d/d dt). L and every finite gradient are the
    # reference's.
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    del diff
    # scores_gij = C_i . B_j per group -> expanded to heads
    CB = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)       # (B,nc,Q,Q,G)
    CB = CB.repeat_interleave(hg, dim=-1)                 # (B,nc,Q,Q,H)
    Wt = CB * L * dtc[:, :, None, :, :]                   # weight on x_j
    del CB, L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", Wt, xc)
    del Wt

    # chunk summary states: sum_j exp(cum_Q - cum_j) dt_j B_j x_j
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(hg, dim=3)                  # (B,nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          (decay_tail * dtc)[..., None] * Bh, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B,nc,H)

    # the recurrence emits each chunk's state BEFORE the chunk
    state = torch.zeros((B, H, P, N), dtype=F32, device=xh.device)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)               # (B,nc,H,P,N)

    # inter-chunk: y_i += C_i . (exp(cum_i) * prev_state)
    Ch = Cc.repeat_interleave(hg, dim=3)                  # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    if S != S_orig:
        y = y[:, :S_orig]
    return y, state


def mamba_block_fwd(p, x, cfg, *, dot=None) -> Tuple[torch.Tensor, dict]:
    """x (B,S,D) -> (y (B,S,D), cache {conv, state}). ``dot``: optional
    (x, w, name) -> y override of the projections (sites ssm_in,
    ssm_out)."""
    B, S, D = x.shape
    s = cfg.ssm
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    G, N = s.n_groups, s.d_state
    dot = dot or _matmul
    zxbcdt = dot(x, p["in_proj"], "ssm_in")
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    dtf = softplus(dt.to(F32) + p["dt_bias"])
    xh = xs.reshape(B, S, H, P)
    y, final = ssd_chunked(xh, dtf, p["a_log"], Bm.reshape(B, S, G, N),
                           Cm.reshape(B, S, G, N), s.chunk)
    y = y + xh.to(F32) * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = dot(y, p["out_proj"], "ssm_out")
    # the last W-1 conv inputs; a prompt shorter than that leaves a short
    # tail, which mamba_block_decode cannot take (as in the reference)
    tail = conv_in[:, max(S - (s.conv_width - 1), 0):S]
    return out, {"conv": tail, "state": final}


def mamba_block_decode(p, x, cache, cfg, *, dot=None, place=None):
    """One-token decode. x (B,1,D); cache {conv (B,W-1,C), state
    (B,H,P,N)}. Returns (out (B,1,D), new cache); the inputs are not
    changed. ``place`` (distributed/sharding.py::MambaBlock): the cache
    is this rank's block of one split over a mesh; the window is made
    whole, the recurrence runs on the block's heads, y is made whole over
    the heads, and the new cache is the rank's block."""
    B = x.shape[0]
    s = cfg.ssm
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    G, N = s.n_groups, s.d_state
    dot = dot or _matmul
    zxbcdt = dot(x, p["in_proj"], "ssm_in")
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)             # (B,1,C)
    prev = cache["conv"] if place is None else place.whole_conv(cache["conv"])
    window = torch.cat([prev, conv_in], dim=1)            # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", window.to(F32),
                            p["conv_w"].to(F32)) + p["conv_b"].to(F32)
    conv_out = F.silu(conv_out)[:, None, :].to(x.dtype)
    xs, Bm, Cm = torch.split(conv_out, [di, G * N, G * N], dim=-1)
    h = slice(None) if place is None else slice(*place.head_range)
    dtf = softplus(dt.to(F32) + p["dt_bias"])[:, :, h]    # (B,1,h)
    A = -torch.exp(p["a_log"][h].to(F32))
    dA = torch.exp(dtf[:, 0, :] * A)                      # (B,h)
    xh = xs.reshape(B, H, P)[:, h].to(F32)
    Bh = Bm.reshape(B, G, N).repeat_interleave(H // G, dim=1)[:, h]
    Ch = Cm.reshape(B, G, N).repeat_interleave(H // G, dim=1)[:, h]
    state = cache["state"] * dA[:, :, None, None] + \
        (dtf[:, 0, :, None] * xh)[..., None] * Bh.to(F32)[:, :, None, :]
    y = torch.einsum("bhn,bhpn->bhp", Ch.to(F32), state)
    y = y + xh * p["d_skip"][None, h, None]
    if place is not None:
        y = place.whole_heads(y)
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = dot(y, p["out_proj"], "ssm_out")
    conv = window[:, 1:] if place is None else place.block("conv",
                                                           window[:, 1:])
    return out, {"conv": conv, "state": state}


def mamba_cache_spec(cfg, batch: int):
    """One layer's decode cache as (shape, dtype) pairs."""
    s = cfg.ssm
    d_conv = cfg.d_inner + 2 * s.n_groups * s.d_state
    return {
        "conv": ((batch, s.conv_width - 1, d_conv), torch.bfloat16),
        "state": ((batch, cfg.ssm_heads, s.head_dim, s.d_state), F32),
    }
