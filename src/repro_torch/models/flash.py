"""Whole-sequence attention for long sequences (port of
``repro.models.flash``).

Every whole-sequence forward of ``FLASH_MIN`` tokens or more goes through
here instead of the dense ``(S, T)`` score matrix of ``attention._attend``:
on the card through the hand-written flash-attention kernel
(``kernels/flash_attention.py``), on the CPU through its plain version.
The reference's XLA twin computes the same forward blockwise; this module
keeps its shape contract (S and T multiples of their 512-row blocks, or
shorter than one) and its attention kinds.

The backward is the reference's custom VJP (``_bwd_impl``), a plain
blockwise computation there too, in PyTorch here (``flash_backward``):
P and dS recomputed per (512-row q block, 512-key kv block) pair from the
forward's log-sum-exp, fp32 inside. When q, k or v needs a gradient the
forward asks the kernel (or the plain version) for that lse and saves q,
k, v, out and lse; the serving and search paths, whose tensors need none,
launch the kernel without it.

The dry-run (launch/dryrun.py) counts a step on meta tensors, which no
kernel takes, and the plain version builds the (B, H, S, T) fp32 scores
the kernel avoids. Its ``kernel="blockwise"`` runs the forward as the
reference's XLA twin walks it instead (``blockwise_forward``): the same
products, every block pair computed, one 512-row q block's scores alive
at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

F32 = torch.float32
NEG = -1e30
FLASH_MIN = 2048          # use flash from this q-length on
BLOCK = 512               # the reference's q and kv blocks: they fix its
                          # shape contract and the backward's blocking
KINDS = ("global", "local", "bidir")
BLOCKWISE = "blockwise"   # the dry-run's forward (the module docstring)


def _pair_mask(i: int, j: int, Qc: int, Kc: int, causal: bool, window: int,
               device):
    """q block i against kv block j: None where every pair is valid,
    False where none is (the pair is skipped: its P and dS are exactly 0),
    else the (Qc, Kc) bool mask of the reference's ``_block_mask``."""
    q_lo, q_hi = i * Qc, i * Qc + Qc - 1
    k_lo, k_hi = j * Kc, j * Kc + Kc - 1
    if causal and k_lo > q_hi:
        return False
    if window and k_hi <= q_lo - window:
        return False
    if (not causal or k_hi <= q_lo) and (not window or k_lo > q_hi - window):
        return None
    qpos = torch.arange(q_lo, q_hi + 1, device=device)[:, None]
    kpos = torch.arange(k_lo, k_hi + 1, device=device)[None, :]
    m = torch.ones((Qc, Kc), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def flash_backward(q, k, v, out, lse, dout, *, causal: bool, window: int,
                   cap: float):
    """dq, dk, dv of flash attention, the reference's ``_bwd_impl``.

    q (B, S, H, hd), k/v (B, T, K, hd), out and dout (B, S, H, hd), lse
    (B, H, S) fp32 from the forward. fp32 inside; each gradient is cast to
    its input's dtype. Per block pair the scores are recomputed, softcapped
    and masked, P = exp(s - lse) and dS = P (dP - delta) with delta the
    rows' dout . out, times the softcap's chain (1 - tanh^2(raw / cap));
    dq gains dS K, dv P^T dout and dk dS^T q (with the scale), on the
    kv heads repeated G times and folded back to K at the end. The
    reference makes two passes, one for dq and one for dk and dv, each
    recomputing P and dS; here one pass over the pairs (q blocks outer,
    kv blocks inner) updates all three from one P and dS, and each
    accumulator still meets its terms in the reference's order. Pairs the
    mask wholly excludes are skipped."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = hd ** -0.5
    Qc, Kc = min(BLOCK, S), min(BLOCK, T)
    nq, nk = S // Qc, T // Kc

    def heads_first(t):                        # (B, L, H, hd) fp32
        return t.to(F32).transpose(1, 2)       # -> (B, H, L, hd)

    qf, dof = heads_first(q), heads_first(dout)
    kf = heads_first(k.repeat_interleave(G, dim=2) if G > 1 else k)
    vf = heads_first(v.repeat_interleave(G, dim=2) if G > 1 else v)
    delta = (dof * heads_first(out)).sum(-1)                  # (B, H, S)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i in range(nq):
        rows = slice(i * Qc, (i + 1) * Qc)
        qi, do_i = qf[:, :, rows], dof[:, :, rows]
        lse_i, delta_i = lse[:, :, rows, None], delta[:, :, rows, None]
        for j in range(nk):
            mask = _pair_mask(i, j, Qc, Kc, causal, window, q.device)
            if mask is False:
                continue
            keys = slice(j * Kc, (j + 1) * Kc)
            kj, vj = kf[:, :, keys], vf[:, :, keys]
            raw = (qi @ kj.transpose(-1, -2)) * scale
            if cap:
                t = torch.tanh(raw / cap)
                s = cap * t
            else:
                s = raw
            if mask is not None:
                s = torch.where(mask, s, NEG)
            p = torch.exp(s - lse_i)
            ds = p * ((do_i @ vj.transpose(-1, -2)) - delta_i)
            if cap:
                ds = ds * (1.0 - t * t)
            dq[:, :, rows] += (ds @ kj) * scale
            dv[:, :, keys] += p.transpose(-1, -2) @ do_i
            dk[:, :, keys] += (ds.transpose(-1, -2) @ qi) * scale

    def back(t, like, heads):                  # (B, H, L, hd) -> like's
        t = t.transpose(1, 2)
        if heads != t.shape[2]:                # fold the G repeats to K
            t = t.reshape(t.shape[0], t.shape[1], heads, -1, hd).sum(3)
        return t.to(like.dtype)

    return back(dq, q, H), back(dk, k, K), back(dv, v, K)


def blockwise_forward(q, k, v, *, causal: bool, window: int, cap: float):
    """(out, lse) of ``flash_attention_ref`` one ``BLOCK``-row q block at
    a time, each block's scores over every key: the products of the dense
    plain version (every pair, masked ones included, as the reference's
    ``_fwd_impl`` computes them) with one block's (B, H, BLOCK, T) fp32
    scores alive instead of (B, H, S, T). The rows' softmax is whole per
    block, so out and lse are the plain version's up to the order of its
    sums."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    Qc = min(BLOCK, S)
    kf = (k.repeat_interleave(G, dim=2) if G > 1 else k).to(F32) \
        .transpose(1, 2)                                   # (B, H, T, hd)
    vf = (v.repeat_interleave(G, dim=2) if G > 1 else v).to(F32) \
        .transpose(1, 2)
    kpos = torch.arange(T, device=q.device)[None, :]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=F32, device=q.device)
    for i in range(S // Qc):
        rows = slice(i * Qc, (i + 1) * Qc)
        # in place: one block's scores alive, then its weights
        s = (q[:, rows].to(F32).transpose(1, 2) @ kf.transpose(-1, -2)) \
            .mul_(hd ** -0.5)
        if cap:
            s.div_(cap).tanh_().mul_(cap)
        qpos = torch.arange(i * Qc, (i + 1) * Qc, device=q.device)[:, None]
        mask = torch.ones((Qc, T), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        s.masked_fill_(~mask, NEG)
        m = s.amax(dim=-1, keepdim=True)
        p = s.sub_(m).exp_()
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[:, rows] = ((p @ vf) / l).transpose(1, 2).to(q.dtype)
        lse[:, :, rows] = (m + torch.log(l))[..., 0]
    return out, lse


def flash_partial(q, k, v, cap: float = 0.0, *, kernel: str = "auto"):
    """A full ("bidir") flash attention over one block of the keys, for a
    combine across blocks (distributed/sharding.py::softmax_combine):
    (m (B, H, S, 1) the rows' log-sum-exp, l ones, o (B, S, H, hd) the
    normalised output in fp32). Serving only: no backward."""
    if kernel == BLOCKWISE:
        out, lse = blockwise_forward(q, k, v, causal=False, window=0,
                                     cap=cap)
    else:
        out, lse = kops.flash_attention(q, k, v, causal=False, window=0,
                                        cap=cap, mode=kernel,
                                        return_lse=True)
    m = lse[..., None]
    return m, torch.ones_like(m), out.to(F32)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, kernel, with_grad):
        ctx.cfg = (causal, window, cap)
        if kernel == BLOCKWISE:
            out, lse = blockwise_forward(q, k, v, causal=causal,
                                         window=window, cap=cap)
            if with_grad:
                ctx.save_for_backward(q, k, v, out, lse)
            return out
        if not with_grad:
            return kops.flash_attention(q, k, v, causal=causal,
                                        window=window, cap=cap, mode=kernel)
        out, lse = kops.flash_attention(q, k, v, causal=causal,
                                        window=window, cap=cap, mode=kernel,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, cap = ctx.cfg
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, causal=causal,
                                    window=window, cap=cap)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kind: str = "global", window: int = 0,
                    cap: float = 0.0, *, kernel: str = "auto"):
    """q (B, S, H, hd), k/v (B, T, K, hd) -> (B, S, H, hd) in q's dtype.

    kind: "global" (causal), "local" (causal, keys within ``window`` of the
    query), "bidir" (full). ``kernel`` is the kernels/ops.py mode: "auto"
    (the CUDA kernel on CUDA tensors, the plain version on CPU ones),
    "cuda", "ref", or the dry-run's "blockwise" (``blockwise_forward``);
    it picks the forward, and the backward is ``flash_backward`` either
    way. Raises ValueError on lengths the
    reference rejects."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention kind {kind!r}, not in {KINDS}")
    S, T = q.shape[1], k.shape[1]
    if S % min(BLOCK, S) or T % min(BLOCK, T):
        raise ValueError(
            f"flash attention takes S and T that are multiples of {BLOCK} "
            f"(or shorter than it), as the reference does; got S={S}, "
            f"T={T}")
    if kind == "local" and window <= 0:
        raise ValueError(f"local attention needs a window > 0, got {window}")
    with_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    return _Flash.apply(q, k, v, kind != "bidir",
                        int(window) if kind == "local" else 0, float(cap),
                        kernel, with_grad)
