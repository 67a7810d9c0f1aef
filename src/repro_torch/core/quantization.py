"""Quantizers shared by HAQ, the PACT baseline and the serving path (port
of ``repro.core.quantization``).

Weights: symmetric per-output-channel int quantization (the paper's
linear quantization). Activations: PACT-style clipped range [Choi et al.
2018], the paper's §4 comparison baseline.

``fake_quant_*`` return dequantized fp values (HAQ policy evaluation);
``quantize_weight`` returns the int-valued tensor and scale.
``make_quant_dot`` builds the ``dot`` hook the models thread through
every matmul site; with ``use_kernel`` its 2-D int8/int4 sites run the
weight-quantized matmul kernels (kernels/ops.py::quant_matmul).

Policy sites are matched on the reference's parameter path strings
(``jax.tree_util.keystr``), e.g. ``"['blocks']['sub0']['ffn']['w_in']"``;
``keystr`` below builds the same string from a nested-dict path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops as kops

F32 = torch.float32


def keystr(path) -> str:
    """The reference's path string for a tuple of dict keys."""
    return "".join(f"[{k!r}]" for k in path)


def map_with_path(fn, tree, path=()):
    """Map ``fn(path, leaf)`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def qmax(bits) -> torch.Tensor:
    return 2.0 ** (torch.as_tensor(bits, dtype=F32) - 1.0) - 1.0


def quantize_weight(w, bits, *, axis: int = -1, amax=None):
    """Symmetric per-channel (along ``axis``'s complement) int
    quantization. Returns (q int-valued fp32, scale) with w ~= q * scale.
    ``amax``: a function of the fp32 ``w`` giving the per-channel max
    |w| (kept dims) in place of ``w``'s own, where ``w`` is a rank's
    slice of a weight split off its channels
    (distributed/sharding.py::tp_dot)."""
    wf = w.to(F32)
    red = tuple(i for i in range(w.dim()) if i != (axis % w.dim()))
    amax = wf.abs().amax(dim=red, keepdim=True) if amax is None \
        else amax(wf)
    qm = qmax(bits).to(w.device)
    scale = amax / torch.clamp(qm, min=1.0) + 1e-12
    q = torch.clamp(torch.round(wf / scale), -qm, qm)
    return q, scale


def fake_quant_weight(w, bits, *, axis: int = -1, amax=None):
    q, scale = quantize_weight(w, bits, axis=axis, amax=amax)
    return (q * scale).to(w.dtype)


def fake_quant_act(x, bits, clip: float = 6.0):
    """PACT: clip to [-c, c] (signed), then uniform-quantize."""
    xf = x.to(F32)
    c = torch.tensor(clip, dtype=F32, device=x.device)
    xf = torch.clamp(xf, -c, c)
    scale = c / torch.clamp(qmax(bits).to(x.device), min=1.0)
    return (torch.round(xf / scale) * scale).to(x.dtype)


def quant_error(w, bits, *, axis: int = -1):
    """Relative L2 reconstruction error (HAQ state feature)."""
    wq = fake_quant_weight(w, bits, axis=axis)
    num = torch.sum(torch.square((w - wq).to(F32)))
    den = torch.sum(torch.square(w.to(F32))) + 1e-12
    return torch.sqrt(num / den)


# ------------------------------------------------------- policy -> params ----
def apply_weight_policy(params, policy: Dict[str, int], site_of) -> dict:
    """Fake-quantize every weight leaf whose site (via site_of(keystr,
    leaf)) appears in ``policy`` (site -> bits). Non-matmul leaves (norms,
    biases) stay fp."""
    def leaf(path, w):
        site = site_of(keystr(path), w)
        if site is not None and site in policy and w.dim() >= 2:
            return fake_quant_weight(w, policy[site])
        return w
    return map_with_path(leaf, params)


def default_site_of(keystr_: str, leaf) -> str | None:
    """Map a parameter path to a HAQ policy site (layer-kind
    granularity)."""
    for token, site in [
        ("'wq'", "attn_q"), ("'wk'", "attn_k"), ("'wv'", "attn_v"),
        ("'wo'", "attn_o"), ("'w_in'", "ffn_in"), ("'w_gate'", "ffn_gate"),
        ("'w_out'", "ffn_out"), ("'in_proj'", "ssm_in"),
        ("'out_proj'", "ssm_out"), ("'lm_head'", "lm_head"),
        ("'embed'", "embed"), ("'fuse_in'", "fuse"), ("'fuse_out'", "fuse"),
    ]:
        if token in keystr_:
            return site
    return None


def make_quant_dot(policy: Dict[str, Tuple[int, int]], *, use_kernel=False):
    """Build the ``dot`` hook threaded through the models: per-site
    (w_bits, a_bits) fake-quant, or the weight-quantized matmul kernels
    when ``use_kernel`` and the site's weight is 2-D with w_bits <= 8
    (W4A16 if w_bits <= 4, W8A8 if a_bits <= 8, else W8A16). Sites not in
    the policy run in the operands' precision. ``amax``: the per-channel
    scale's max |w| over the whole weight, where the site holds a slice
    of it split off its channels (``quantize_weight``)."""

    def dot(x, w, name, amax=None):
        eq = _einsum_for(x, w)
        if name not in policy:
            return torch.einsum(eq, x, w)
        w_bits, a_bits = policy[name]
        if w_bits >= 16 and a_bits >= 16:   # full precision: exact no-op
            return torch.einsum(eq, x, w)
        if use_kernel and w.dim() == 2 and w_bits <= 8:
            return kops.quant_matmul(x, w, w_bits=int(w_bits),
                                     a_bits=int(a_bits))
        wq = fake_quant_weight(w, w_bits, amax=amax)
        xq = fake_quant_act(x, a_bits) if a_bits and a_bits < 16 else x
        return torch.einsum(eq, xq, wq)

    return dot


def _einsum_for(x, w) -> str:
    """The einsum a model site uses, from the operands' ranks."""
    if w.dim() == 2:
        return "...d,df->...f"
    if x.dim() == 4 and w.dim() == 3:
        return "bsnh,nhd->bsd"     # attention output projection
    if w.dim() == 3 and x.dim() == 3 and w.shape[0] == x.shape[0] \
            and x.shape[-1] == w.shape[1]:
        return "ecd,edf->ecf"      # moe expert batch
    if w.dim() == 3:
        return "bsd,dnh->bsnh"     # qkv projection
    raise ValueError((tuple(x.shape), tuple(w.shape)))
