"""Shared layer library: norms, RoPE, FFN, softcap (port of
``repro.models.layers``).

Everything is a function of (params, x); computation runs in bf16 with
fp32 where the reference keeps fp32 (norm statistics, RoPE angles).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import PDef

F32 = torch.float32


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Scales by ``(1 + scale)``, with fp32 statistics."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


class WholeRows:
    """The rows of a forward's (B, S, D) residual stream, as the model's
    blocks hold them between sub-layers: here whole on every rank, so
    ``local`` (a sub-layer's output -> the rows the residual keeps) and
    ``whole`` (a norm's output -> the rows a sub-layer reads) are
    identities and ``norm`` is ``rms_norm``. ``make_ac``'s seq_tp splits
    them over the model axis (distributed/sharding.py::SplitRows), and a
    batch whose sequence the rules split over data splits them over that
    axis (``DataSeqRows``).

    ``split_loss``: whether each rank takes the loss on its own rows (a
    share of the global loss, ``DataSeqRows``); ``final`` gives the rows
    the final norm and the unembedding run on (whole here) and ``route``
    the ranks the moe layers route over (models/moe.py's ``ranks``, as
    given here)."""

    split_loss = False

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def norm(self, x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
        return rms_norm(x, scale, eps)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self.whole(x)

    def route(self, ranks):
        return ranks


WHOLE_ROWS = WholeRows()


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to
    (..., seq). Rotates split halves (not interleaved pairs)."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)      # (hd/2,)
    angles = positions.to(F32)[..., None] * freqs      # (..., seq, hd/2)
    angles = angles[..., None, :]                      # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- FFN ----
def ffn_defs(d_model: int, d_ff: int, activation: str):
    gated = activation in ("swiglu", "geglu")
    defs = {
        "w_in": PDef((d_model, d_ff), ("embed", "d_ff"), "scaled"),
        "w_out": PDef((d_ff, d_model), ("d_ff", "embed"), "scaled"),
    }
    if gated:
        defs["w_gate"] = PDef((d_model, d_ff), ("embed", "d_ff"), "scaled")
    return defs


def _act(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        return F.silu(h)
    if kind in ("geglu", "gelu"):
        return F.gelu(h, approximate="tanh")
    if kind == "squared_relu":
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def promoted(x, w):
    """x and w in their common dtype, as ``jnp.einsum`` promotes mixed
    operands (the encoder's bf16 input against fp32 weights: the exact
    fp32 product); torch's products take one dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)


def _matmul(x, w, name):
    x, w = promoted(x, w)
    return x @ w


def ffn_apply(p, x: torch.Tensor, activation: str, *,
              dot=None) -> torch.Tensor:
    """dot: optional (x, w, name) -> y override (the HAQ quantized path,
    sites ffn_in, ffn_gate, ffn_out)."""
    dot = dot or _matmul
    h = dot(x, p["w_in"], "ffn_in")
    if "w_gate" in p:
        h = _act(dot(x, p["w_gate"], "ffn_gate"), activation) * h
    else:
        h = _act(h, activation)
    return dot(h, p["w_out"], "ffn_out")


def embed_defs(vocab: int, d_model: int):
    return PDef((vocab, d_model), ("vocab", "embed"), "normal")


def norm_def(d_model: int):
    return PDef((d_model,), ("embed",), "zeros", dtype=torch.float32)
