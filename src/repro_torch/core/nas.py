"""Differentiable hardware-aware architecture search (paper §2; port of
``repro.core.nas``).

The search loop alternates:
  * weight step — sample a path per block (Eq. 1), SGD on the active
    path's weights against training data;
  * arch step   — sample a path on *validation* data, backprop the
    combined loss (Eq. 3) into the architecture parameters alpha; the
    latency term uses the differentiable expected latency (Eq. 2) from the
    LUT.

Eq. 3 as printed (L = L_CE x alpha log(E[LAT]/ref)^beta) vanishes at
LAT == ref; as in the reference, the MnasNet-style multiplicative form the
text describes and ProxylessNAS's additive form are implemented — select
with ``latency_loss``:
  mul:  L = CE * (E[LAT]/ref)^beta
  add:  L = CE + lam * E[LAT]/ref

Paths are sampled from a ``torch.Generator`` seeded with ``ncfg.seed``:
the same distribution as the reference's ``jax.random`` keys, other
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.supernet_lm import BACKBONE, CANDIDATE_OPS
from repro_torch.core import latency_table as lt
from repro_torch.core import supernet as sn
from repro_torch.core.hardware_model import V5E_POD, Hardware
from repro_torch.models.params import tree_leaves

F32 = torch.float32


@dataclasses.dataclass
class NASConfig:
    steps: int = 200
    warmup_steps: int = 100       # weight-only phase (uniform path sampling):
                                  # untrained paths lose to ZeroOp otherwise
    weight_lr: float = 5e-2
    alpha_lr: float = 3e-2
    lat_ref: float = 0.0          # 0 -> set to 0.6x uniform-mixture latency
    beta: float = 0.6             # latency exponent (mul) / weight (add)
    latency_loss: str = "mul"     # mul | add
    batch: int = 8
    seq: int = 128
    seed: int = 0
    log_every: int = 25


def combined_loss(ce, e_lat, ref, ncfg: NASConfig):
    """Latency pressure only ABOVE the target: the raw multiplicative form
    rewards shrinking below LAT_ref (loss -> 0 as arch -> all-ZeroOp),
    which collapses the search; clamping at the target keeps Eq. 3's
    trade-off semantics ('meet the budget, then maximize quality')."""
    rel = torch.clamp(torch.as_tensor(e_lat / ref, dtype=F32), min=1.0)
    if ncfg.latency_loss == "mul":
        return ce * torch.pow(rel, ncfg.beta)
    return ce + ncfg.beta * (rel - 1.0)


def weight_step(params, alpha, batch, gates, ncfg: NASConfig,
                cfg=BACKBONE) -> torch.Tensor:
    """SGD on the sampled paths' weights, in place: the global gradient
    norm clipped at 1. Ops not sampled get no gradient (the reference's
    zeros) and stay as they are. Returns the loss."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = sn.supernet_loss(params, alpha.detach(), gates, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    used = [(p, g) for p, g in zip(leaves, grads) if g is not None]
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(F32))) for _, g in used))
    scale = torch.clamp(1.0 / (gn + 1e-9), max=1.0)  # clip at norm 1
    with torch.no_grad():
        for p, g in used:
            p.sub_((ncfg.weight_lr * scale * g.to(F32)).to(p.dtype))
    return loss.detach()


def alpha_step(params, alpha, batch, gates, lut, ref: float,
               ncfg: NASConfig, cfg=BACKBONE):
    """One gradient step of alpha on CE x latency (``combined_loss``).
    Returns (new alpha, loss, ce, e_lat)."""
    a = alpha.detach().requires_grad_(True)
    ce = sn.supernet_loss(params, a, gates, batch, cfg)
    e_lat = lt.expected_latency(a, lut)
    loss = combined_loss(ce, e_lat, ref, ncfg)
    (ga,) = torch.autograd.grad(loss, [a])
    return ((alpha - ncfg.alpha_lr * ga).detach(), loss.detach(),
            ce.detach(), e_lat.detach())


def search(data_iter: Callable[[int], Dict[str, torch.Tensor]],
           hw: Hardware = V5E_POD, ncfg: NASConfig = NASConfig(),
           cfg=BACKBONE, lut: Optional[torch.Tensor] = None,
           progress: Optional[Callable[[dict], None]] = None, *,
           device="cuda") -> dict:
    """Run the search on ``device``. data_iter(step) -> {tokens, labels}
    on that device. Returns a dict with the final alpha, the derived arch
    and the latency/CE history, as the reference's."""
    gen = torch.Generator(device=device).manual_seed(ncfg.seed)
    params, alpha = sn.init_supernet(gen, device, cfg)
    if lut is None:
        lut = lt.build_lut(cfg, ncfg.batch, ncfg.seq, hw)
    lut = lut.to(device)
    # default target: 60% of the uniform-mixture latency (a real budget --
    # ProxylessNAS's LAT_ref is the measured target-device budget)
    ref = ncfg.lat_ref or 0.6 * float(lt.expected_latency(alpha, lut))

    hist: List[dict] = []
    uniform_alpha = torch.zeros_like(alpha)
    for w in range(ncfg.warmup_steps):
        weight_step(params, uniform_alpha, data_iter(2 * ncfg.steps + w),
                    sn.sample_gates(gen, uniform_alpha), ncfg, cfg)

    for step in range(ncfg.steps):
        wl = weight_step(params, alpha, data_iter(2 * step),
                         sn.sample_gates(gen, alpha), ncfg, cfg)
        alpha, al, ce, e_lat = alpha_step(
            params, alpha, data_iter(2 * step + 1),
            sn.sample_gates(gen, alpha), lut, ref, ncfg, cfg)
        if step % ncfg.log_every == 0 or step == ncfg.steps - 1:
            rec = {"step": step, "weight_loss": float(wl),
                   "arch_loss": float(al), "val_ce": float(ce),
                   "e_lat_us": float(e_lat) * 1e6,
                   "arch": sn.derive_arch(alpha)}
            hist.append(rec)
            if progress:
                progress(rec)
    one_hot = torch.nn.functional.one_hot(torch.argmax(alpha, -1),
                                          len(CANDIDATE_OPS)).to(F32)
    return {
        "alpha": alpha.cpu().numpy(),
        "arch": sn.derive_arch(alpha),
        "e_lat_us": float(lt.expected_latency(alpha, lut)) * 1e6,
        "sampled_lat_us": float(lt.sampled_latency(one_hot, lut)) * 1e6,
        "history": hist,
        "params": params,
        "lat_ref_us": ref * 1e6,
    }


def synthetic_lm_data(cfg=BACKBONE, batch: int = 8, seq: int = 128,
                      seed: int = 0, *, device="cpu"):
    """Deterministic synthetic next-token task with learnable structure
    (Zipf unigram + copy pattern) so the search signal is non-trivial:
    the reference's numbers, as int32 tensors on ``device``."""
    def it(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(seed + step)
        zipf = np.clip(rng.zipf(1.5, size=(batch, seq + 1)), 0,
                       cfg.vocab_size - 1)
        # inject copy structure: second half repeats first half
        half = (seq + 1) // 2
        zipf[:, half:2 * half] = zipf[:, :half]
        toks = torch.from_numpy(zipf[:, :seq].astype(np.int32)).to(device)
        # chunked_ce shifts internally: labels are the same token stream
        return {"tokens": toks, "labels": toks}
    return it
