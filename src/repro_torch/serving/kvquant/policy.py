"""HAQ search over KV-cache bits (port of
``repro.serving.kvquant.policy``): the paper's hardware-in-the-loop
quantization loop (core/haq.py), pointed at the paged pool instead of the
weights.

Sites are the pool's sub-layer slots (core/haq.py::enumerate_kv_sites).
Direct hardware feedback — never a FLOPs proxy — comes from the same
roofline admission queries at serve time: per-site KV read traffic from
``hardware_model.attention_cost(kv_bits=...)`` and the whole decode tick
from ``admission.step_latency``. Budget enforcement is the paper's exact
mechanism (sequentially decrease bits until the constraint holds), stepped
along KV_BITS.

Quality feedback is an *attention sensitivity proxy* rather than a trained
subject: uniform symmetric quantization at b bits carries noise variance
proportional to 2^-2(b-1), and a layer integrates that noise over its
effective context — full ``ctx`` for global attention, ``window`` for
sliding-window layers. The proxy both scores policies (reward) and hard-
gates the search space: sites whose effective context exceeds the local
window may not drop to int4 at all (``allowed_kv_bits``) — local-window
layers go first, exactly the asymmetry the roofline already exploits for
compute (window-trimmed walks).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.haq import (KV_BITS, KVCacheSite, enumerate_kv_sites,
                                  resource)
from repro_torch.core.hardware_model import Hardware, V5E_EDGE
from repro_torch.core.rl.ddpg import DDPG, DDPGConfig
from repro_torch.serving.engine.admission import (kv_bytes_per_token,
                                                  step_latency)

STATE_DIM = 8


def allowed_kv_bits(site: KVCacheSite) -> Tuple[int, ...]:
    """Sensitivity gate: local-window sites may drop to int4; global sites
    floor at int8 (their quantization noise integrates over the full
    context, so int4 error there dominates the drift budget)."""
    return KV_BITS if site.local else tuple(b for b in KV_BITS if b >= 8)


def kv_sensitivity(site: KVCacheSite) -> float:
    """Noise-accumulation weight of one site: log-effective-context per
    layer sharing it (softmax averaging washes out per-token noise roughly
    with the log of the number of summands, not linearly)."""
    return site.count * math.log2(site.eff_ctx + 1)


def proxy_loss(sites: Sequence[KVCacheSite],
               bits: Sequence[int]) -> float:
    """Σ sensitivity × quantizer noise variance (2^-2(b-1); 0 at bf16)."""
    total = 0.0
    for s, b in zip(sites, bits):
        if b >= 16:
            continue
        total += kv_sensitivity(s) * 2.0 ** (-2 * (b - 1))
    return total


def enforce_kv_budget(sites: Sequence[KVCacheSite], bits: List[int],
                      hw: Hardware, budget: float, mode: str) -> List[int]:
    """Paper's back-off along KV_BITS: while over budget, decrement the
    site with the largest resource share that can still go lower within
    its gate."""
    bits = list(bits)
    wa = lambda: [(b, 16) for b in bits]
    while (cur := resource(sites, wa(), hw, mode)) > budget:
        best, gain = None, 0.0
        for i, s in enumerate(sites):
            lower = [b for b in allowed_kv_bits(s) if b < bits[i]]
            if not lower:
                continue
            trial = list(bits)
            trial[i] = max(lower)
            g = cur - resource(sites, [(b, 16) for b in trial], hw, mode)
            # ">= on ties/zero gain": keep decrementing toward the gated
            # floor even when a step buys nothing in this mode (e.g. a
            # compute-bound site in latency mode), so the contract stays
            # the paper's — over budget only if even the floor is
            if g > gain or best is None:
                best, gain = (i, max(lower)), g
        if best is None:
            break                        # every site at its gated floor
        bits[best[0]] = best[1]
    return bits


def _state(sites, t: int, prev_bits: int, budget_frac: float) -> np.ndarray:
    s = sites[t]
    return np.array([
        t / max(len(sites) - 1, 1),
        np.log2(max(s.eff_ctx, 1)) / 20.0,
        float(s.local),
        s.d_in / 4096.0,
        s.count / 100.0,
        kv_sensitivity(s) / 1000.0,
        prev_bits / 16.0,
        budget_frac,
    ], np.float32)


def search_kv_policy(cfg, hw: Hardware = V5E_EDGE, *, max_model_len: int,
                     batch: int = 1, budget_frac: float = 0.55,
                     mode: str = "size", episodes: int = 16,
                     quality_coef: float = 1.0, seed: int = 0) -> Dict:
    """Search per-sub-layer KV bits under a resource budget.

    budget = ``budget_frac`` × the bf16 pool's resource in ``mode``
    ("size": resident KV HBM bytes; "latency"/"energy": the roofline
    attention terms at the quantized width). Returns a dict with the
    per-site policy, its ``sub{j}`` tuple (ready for
    ``derive_policy(kv_bits=...)``), and the serve-time feedback the
    policy was scored with (est. decode tick latency via
    admission.step_latency, bytes/token via admission.kv_bytes_per_token).

    ``episodes=0`` skips the RL loop and returns the deterministic
    sensitivity-gated back-off from all-int8 — the budget-feasible
    fallback (and a fine default for P <= 2 pools, where the search space
    is tiny)."""
    sites = enumerate_kv_sites(cfg, batch, max_model_len)
    base_bits = [16] * len(sites)
    base_res = resource(sites, [(b, 16) for b in base_bits], hw, mode)
    budget = budget_frac * base_res

    def finish(bits, extra):
        bits = enforce_kv_budget(sites, list(bits), hw, budget, mode)
        pol = {s.name: b for s, b in zip(sites, bits)}
        tup = tuple(pol[f"kv_sub{j}"] for j in range(len(sites)))
        return {
            "policy": pol,
            "bits": tup,
            "loss": proxy_loss(sites, bits),
            "resource": resource(sites, [(b, 16) for b in bits], hw, mode),
            "budget": budget,
            "base_resource": base_res,
            "kv_bytes_per_token": kv_bytes_per_token(cfg, tup),
            "kv_bytes_per_token_fp": kv_bytes_per_token(cfg),
            "est_decode_s": step_latency(cfg, batch, 1, max_model_len, hw,
                                         kv_bits=tup),
            "est_decode_s_fp": step_latency(cfg, batch, 1, max_model_len,
                                            hw),
            **extra,
        }

    if episodes <= 0:
        start = [min(8, max(allowed_kv_bits(s))) for s in sites]
        return finish(start, {"episodes": 0})

    agent = DDPG(DDPGConfig(state_dim=STATE_DIM), seed=seed)
    best: Optional[Tuple[float, List[int]]] = None
    hist = []
    for ep in range(episodes):
        bits, traj = [], []
        prev = 16
        for t in range(len(sites)):
            st = _state(sites, t, prev, budget_frac)
            a = agent.act(st, explore=True)
            arr = allowed_kv_bits(sites[t])
            b = arr[max(0, min(int(round(a * (len(arr) - 1))),
                               len(arr) - 1))]
            bits.append(b)
            traj.append((st, a))
            prev = b
        bits = enforce_kv_budget(sites, bits, hw, budget, mode)
        loss = proxy_loss(sites, bits)
        reward = -quality_coef * loss
        for t, (st, a) in enumerate(traj):
            done = t == len(traj) - 1
            s2 = _state(sites, min(t + 1, len(sites) - 1), bits[t],
                        budget_frac) if not done \
                else np.zeros(STATE_DIM, np.float32)
            agent.observe(st, a, reward if done else 0.0, s2, done)
        agent.end_episode()
        hist.append({"episode": ep, "loss": loss,
                     "bits": tuple(bits)})
        if best is None or loss < best[0]:
            best = (loss, bits)
    return finish(best[1], {"episodes": episodes, "history": hist})
