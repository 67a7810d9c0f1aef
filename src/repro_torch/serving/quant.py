"""Quantized serving: HAQ weight policies as serve-time parameters (port of
``repro.serving.quant``).

Matmul weights are STORED int8 (``{"q", "scale"}``), or int4 packed two
per byte along the contracting dim (``{"q4", "scale"}``: row 2i in the low
nibble, 2i+1 in the high one), with fp32 scales per tensor, or per layer
for the stacked ``['blocks']`` subtrees. 3-D attention projections clamp
to int8 (their contracting dim is not the second-to-last). Device memory
for the weights drops 2x/4x against bf16, and so does the decode roofline
term the admission policy prices them at.

The ``dot`` hook ``dequant_dot`` serves every matmul from the stored
codes. On CPU tensors it is the reference's function: dequantize to the
activation dtype, then the einsum. On CUDA tensors it runs the W8A16
(``q``) or W4A16 (``q4``) kernel on the stored codes, the per-tensor scale
read with a stride of 0; 3-D projections go in as 2-D views — wq/wk/wv as
(d, H*hd), wo as (H*hd, d) against x viewed as (B*S, H*hd); a moe
site's expert batch runs one launch per expert. The kernel
scales the fp32 product where the plain version rounds the dequantized
weight to bf16 first, so the two agree to rounding, not bit for bit.
Non-dict weights (the tied embedding at ``lm_head``) run as a plain
einsum. ``make_dequant_dot(mode)`` picks the path explicitly ("ref" is
the plain version on the card too).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.quantization import (_einsum_for, default_site_of,
                                           keystr, map_with_path)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import ref as kref
from repro_torch.models.params import PDef

F32 = torch.float32

_QUANT_KEYS = ("'wq'", "'wk'", "'wv'", "'wo'", "'w_in'", "'w_gate'",
               "'w_out'", "'in_proj'", "'out_proj'", "'lm_head'",
               "'fuse_in'", "'fuse_out'")
# 3D attention projections: contracting dim is not -2 -> int8 only
_NO_PACK = ("'wq'", "'wk'", "'wv'", "'wo'")
# stacked (layer-leading) parameter subtrees get per-layer scales
_STACKED = ("['blocks']", "['mamba']", "['enc']", "['dec']")


def _bits_for(keystr_: str, policy: Optional[Dict[str, int]],
              default_bits: int) -> Optional[int]:
    if not any(k in keystr_ for k in _QUANT_KEYS):
        return None
    if policy is None:
        bits = default_bits
    else:
        site = default_site_of(keystr_, None)
        if site is None:
            return None
        bits = policy.get(site, default_bits)
    if bits <= 4 and any(k in keystr_ for k in _NO_PACK):
        bits = 8
    return bits


def quantize_defs(defs, *, policy: Optional[Dict[str, int]] = None,
                  default_bits: int = 8):
    """PDef tree -> tree where eligible weights become int-stored dicts.
    Layer-stacked weights (leading 'layer' axis) carry per-layer
    scales."""
    def leaf(path, d):
        bits = _bits_for(keystr(path), policy, default_bits)
        if bits is None or len(d.shape) < 2:
            return d
        return _stored_def(d, bits)
    return map_with_path(leaf, defs)


def _stored_def(d: PDef, bits: int) -> dict:
    """A weight's def stored at ``bits`` (``quantize_defs``' leaf)."""
    if d.axes and d.axes[0] == "layer":
        scale = PDef((d.shape[0], 1), ("layer", "null"), "ones", dtype=F32)
    else:
        scale = PDef((1,), ("null",), "ones", dtype=F32)
    if bits <= 4:
        shape = d.shape[:-2] + (d.shape[-2] // 2, d.shape[-1])
        return {"q4": PDef(shape, d.axes, "zeros", dtype=torch.int8),
                "scale": scale}
    return {"q": PDef(d.shape, d.axes, "zeros", dtype=torch.int8),
            "scale": scale}


def stored_defs(defs, params):
    """The defs of ``params``, a tree of the model's ``defs`` in which
    ``quantize_params`` stored some weights: each such leaf
    (``{"q" | "q4", "scale"}``) as ``quantize_defs`` makes it, at 8 or 4
    bits; ``defs`` itself where nothing is stored."""
    def walk(d, p):
        if isinstance(d, PDef):
            return _stored_def(d, 4 if "q4" in p else 8) \
                if isinstance(p, dict) else d
        return {k: walk(v, p[k]) for k, v in d.items()}
    return walk(defs, params)


def quantize_params(params, *, policy: Optional[Dict[str, int]] = None,
                    default_bits: int = 8):
    """Materialize quantized leaves from real bf16 params (on their
    device). Rounding is half to even, as the reference's."""
    def leaf(path, w):
        ks = keystr(path)
        bits = _bits_for(ks, policy, default_bits)
        if bits is None or w.dim() < 2:
            return w
        wf = w.to(F32)
        qmax = 2.0 ** (min(bits, 8) - 1) - 1.0
        if any(s in ks for s in _STACKED) and w.dim() >= 3:
            amax = wf.abs().amax(dim=tuple(range(1, w.dim())))    # (L,)
            scale = (amax / qmax + 1e-12)[:, None]                # (L, 1)
            div = scale.reshape((w.shape[0],) + (1,) * (w.dim() - 1))
        else:
            scale = (wf.abs().amax() / qmax + 1e-12)[None]
            div = scale[0]
        q = torch.round(wf / div).clamp(-qmax, qmax).to(torch.int8)
        if bits <= 4:
            return {"q4": kref.pack_w4(q), "scale": scale}
        return {"q": q, "scale": scale}
    return map_with_path(leaf, params)


def _dequant_plain(x, w):
    """The reference's dequant_dot: dequantize to x's dtype, then the
    einsum."""
    q = kref.unpack_w4(w["q4"]) if "q4" in w else w["q"]
    wde = (q.to(F32) * w["scale"]).to(x.dtype)
    return torch.einsum(_einsum_for(x, wde), x, wde)


def _dequant_kernel(x, w, name):
    """W8A16 (``q``) or W4A16 (``q4``) on the stored codes, 3-D
    projections as 2-D views; the moe sites' expert batches (x (E, C, d)
    against codes (E, d, f), one scale) one expert at a time."""
    packed = "q4" in w
    codes = w["q4"] if packed else w["q"]
    fn = qmm.quant_matmul_w4a16 if packed else qmm.quant_matmul_w8a16
    if name.startswith("moe_"):
        return torch.stack([fn(x[e].contiguous(), codes[e], w["scale"])
                            for e in range(codes.shape[0])])
    if codes.dim() == 2:
        K = codes.shape[0] * (2 if packed else 1)
        lead, w2 = x.shape[:-1], codes
    elif x.dim() == 4:                 # wo (H, hd, d) against (B, S, H, hd)
        K = codes.shape[0] * codes.shape[1]
        lead, w2 = x.shape[:-2], codes.reshape(K, codes.shape[2])
    else:                              # wq/wk/wv (d, H, hd) against (B, S, d)
        K = codes.shape[0]
        lead, w2 = x.shape[:-1], codes.reshape(K, -1)
    out = fn(x.reshape(-1, K).contiguous(), w2, w["scale"])
    if codes.dim() == 3 and x.dim() == 3:
        return out.reshape(*lead, *codes.shape[1:])
    return out.reshape(*lead, out.shape[-1])


def make_dequant_dot(mode: str = "auto"):
    """The serving ``dot`` hook over stored weights. ``mode``: "auto" runs
    the kernels on CUDA tensors and the plain version on CPU ones; "cuda"
    the kernels or an error; "ref" the plain version on any device."""
    def dot(x, w, name):
        if not isinstance(w, dict):
            return torch.einsum(_einsum_for(x, w), x, w)
        if kops.resolve_mode(mode, x, "dequant_dot") == "ref" \
                or not x.is_cuda:
            return _dequant_plain(x, w)
        return _dequant_kernel(x, w, name)
    return dot


dequant_dot = make_dequant_dot("auto")


def avg_weight_bits(defs_q) -> float:
    """Average stored bits per weight element (analytic memory model)."""
    elems, bits = 0.0, 0.0

    def walk(d):
        nonlocal elems, bits
        if isinstance(d, dict) and ("q" in d or "q4" in d):
            key = "q4" if "q4" in d else "q"
            n = float(math.prod(d[key].shape))
            elems += n * (2 if key == "q4" else 1)
            bits += n * 8
        elif isinstance(d, dict):
            for v in d.values():
                walk(v)
        elif isinstance(d, PDef):
            n = float(math.prod(d.shape))
            elems += n
            bits += n * d.dtype.itemsize * 8
    walk(defs_q)
    return bits / max(elems, 1.0)
