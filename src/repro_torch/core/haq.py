"""HAQ — Hardware-Aware Automated Quantization (paper §4), port of
``repro.core.haq``.

A DDPG agent assigns per-site (w_bits, a_bits); the roofline model
(core/hardware_model.py) provides DIRECT latency/energy/size feedback —
never FLOPs proxies. Budget enforcement is the paper's exact mechanism:
"if the current policy exceeds our resource budget, we sequentially
decrease the bitwidth of each layer until the constraint is finally
satisfied".

Weight bits in {2..8}, activation bits in {4..8, 16}. The default target
stays the reference's ``V5E_EDGE`` so the two packages search the same
problem; the port's callers pass ``h100-sxm``, where weights of 8 bits
or fewer price on the int8 tensor-core peak.

Beyond weights, ``KVCacheSite``/``enumerate_kv_sites`` expose the serving
engine's paged KV-cache pool to the same machinery (KV bits in
{4, 8, 16}); the search loop for those sites lives in
serving/kvquant/policy.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hardware_model import (Hardware, V5E_EDGE, OpCost,
                                             attention_cost, linear_cost)
from repro_torch.core.rl.ddpg import DDPG, DDPGConfig

STATE_DIM = 10
W_BITS = (2, 3, 4, 5, 6, 7, 8)
A_BITS = (4, 5, 6, 7, 8, 16)
# Storable KV-cache bitwidths: the page pool is bf16, int8, or int4 packed
# along head_dim (serving/kvquant) — no other layouts exist at serve time.
KV_BITS = (4, 8, 16)


@dataclasses.dataclass
class HAQConfig:
    latency_budget: float = 0.0     # seconds; 0 -> derived as frac of 8-bit
    budget_frac: float = 0.7        # budget = frac * latency(W8A8)
    episodes: int = 60
    quality_coef: float = 1.0       # reward = -coef * ΔCE
    seed: int = 0
    mode: str = "latency"           # latency | energy | size


class QuantSite:
    """One quantizable matmul site (layer-kind granularity, both stacks)."""

    def __init__(self, name: str, tokens: int, d_in: int, d_out: int,
                 count: int):
        self.name = name
        self.tokens = tokens
        self.d_in = d_in
        self.d_out = d_out
        self.count = count          # layers sharing this site
        self.cost: OpCost = linear_cost(tokens, d_in, d_out)

    def latency(self, hw, w_bits, a_bits) -> float:
        return float(self.cost.latency(hw, w_bits, a_bits)) * self.count

    def energy(self, hw, w_bits, a_bits) -> float:
        return float(self.cost.energy(hw, w_bits, a_bits)) * self.count

    def size_bytes(self, w_bits) -> float:
        return float(self.cost.weight_bytes) * w_bits / 16.0 * self.count


def enumerate_sites(cfg, batch: int, seq: int, *, decode=False
                    ) -> List[QuantSite]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    L = cfg.num_layers
    tokens = batch * (1 if decode else seq)
    sites = [
        QuantSite("attn_q", tokens, d, H * hd, L),
        QuantSite("attn_k", tokens, d, K * hd, L),
        QuantSite("attn_v", tokens, d, K * hd, L),
        QuantSite("attn_o", tokens, H * hd, d, L),
    ]
    gated = cfg.activation in ("swiglu", "geglu")
    if cfg.moe:
        n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
        ff = cfg.moe.d_ff_expert
        k = cfg.moe.experts_per_token
        sites += [
            QuantSite("moe_in", tokens * k, d, ff, n_moe),
            QuantSite("moe_gate", tokens * k, d, ff, n_moe),
            QuantSite("moe_out", tokens * k, ff, d, n_moe),
        ]
        n_dense = L - n_moe
    else:
        n_dense = L
    if cfg.d_ff and n_dense:
        sites += [QuantSite("ffn_in", tokens, d, cfg.d_ff, n_dense),
                  QuantSite("ffn_out", tokens, cfg.d_ff, d, n_dense)]
        if gated:
            sites.append(QuantSite("ffn_gate", tokens, d, cfg.d_ff, n_dense))
    if cfg.ssm:
        di = cfg.d_inner
        s = cfg.ssm
        proj = 2 * di + 2 * s.n_groups * s.d_state + cfg.ssm_heads
        sites += [QuantSite("ssm_in", tokens, d, proj, L),
                  QuantSite("ssm_out", tokens, di, d, L)]
    return sites


class KVCacheSite:
    """One KV-cache quantization site: the k/v pages of one sub-layer slot
    (all ``count`` layers sharing it) in the serving engine's paged pool.

    Duck-types QuantSite so the HAQ machinery (state features, resource
    accounting, budget back-off) applies unchanged — here "w_bits" are the
    *stored KV bits* (KV_BITS: 4/8/16) and a_bits are ignored: the query is
    always fp and dequant rides the attention block walk. Latency/energy
    feedback comes from the same roofline (hardware_model.attention_cost
    with ``kv_bits``) that admission.step_latency queries at serve time;
    size is the resident KV footprint at a given batch/context.

    ``local`` records the attention kind: sliding-window layers see a
    bounded effective context, which is the sensitivity proxy
    serving/kvquant/policy.py uses to gate which sites may drop to int4.
    """

    def __init__(self, name: str, batch: int, ctx: int, n_heads: int,
                 n_kv: int, head_dim: int, count: int, *, window: int = 0,
                 resident_ctx: int = 0):
        self.name = name
        self.batch = batch
        self.ctx = ctx
        self.n_heads = n_heads
        self.n_kv = n_kv
        self.head_dim = head_dim
        self.count = count          # layers sharing this site
        self.window = window
        self.local = window > 0
        self.eff_ctx = min(window, ctx) if window else ctx
        # Tokens actually RESIDENT in the pool for this site. Pages are
        # shared across layers, so a local layer's dead blocks are only
        # freed when every layer is local (Scheduler.trim_window); next to
        # any global layer they stay resident and must be priced at full
        # context even though the walk (latency) only reads the window.
        self.resident_ctx = resident_ctx or self.eff_ctx
        # QuantSite-compatible state features for the DDPG agent
        self.d_in = n_kv * head_dim
        self.d_out = self.eff_ctx
        self.cost: OpCost = self._cost(16)

    def _cost(self, kv_bits: int) -> OpCost:
        return attention_cost(self.batch, 1, self.ctx, self.n_heads,
                              self.n_kv, self.head_dim, window=self.window,
                              decode=True, kv_bits=kv_bits)

    def latency(self, hw, w_bits, a_bits=16) -> float:
        return float(self._cost(int(w_bits)).latency(hw)) * self.count

    def energy(self, hw, w_bits, a_bits=16) -> float:
        return float(self._cost(int(w_bits)).energy(hw)) * self.count

    def size_bytes(self, w_bits) -> float:
        """Resident KV bytes at this batch/context (codes + scale tiles)."""
        toks = self.batch * self.resident_ctx
        bytes_tok = 2.0 * self.n_kv * self.head_dim * int(w_bits) / 8.0
        if int(w_bits) < 16:
            bytes_tok += 2.0 * self.n_kv * 4.0
        return toks * bytes_tok * self.count


def enumerate_kv_sites(cfg, batch: int, ctx: int) -> List[KVCacheSite]:
    """One KVCacheSite per sub-layer slot of the serving pool — the KV
    analogue of enumerate_sites, matching the pool's ``sub{j}`` keys
    (models/transformer.py::pool_specs) so a searched policy maps directly
    onto the quantized page-pool layout."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"KV sites describe attention page pools; {cfg.family!r} "
            f"families have no paged KV cache")
    # the pool's own period/kind rules — deferred import keeps core free
    # of a hard models dependency (models never imports core)
    from repro_torch.models.transformer import period_of, sublayer_kinds
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)
    n_groups = cfg.num_layers // P
    all_local = all(k["attn"] == "local" for k in kinds)
    sites = []
    for j in range(P):
        window = cfg.window_size if kinds[j]["attn"] == "local" else 0
        sites.append(KVCacheSite(
            f"kv_sub{j}", batch, ctx, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, n_groups, window=window,
            # window-trimmed residency only exists on all-local models
            resident_ctx=0 if all_local else ctx))
    return sites


def resource(sites, wa: List[Tuple[int, int]], hw: Hardware,
             mode: str) -> float:
    if mode == "latency":
        return sum(s.latency(hw, w, a) for s, (w, a) in zip(sites, wa))
    if mode == "energy":
        return sum(s.energy(hw, w, a) for s, (w, a) in zip(sites, wa))
    return sum(s.size_bytes(w) for s, (w, _) in zip(sites, wa))


def enforce_budget(sites, wa: List[Tuple[int, int]], hw: Hardware,
                   budget: float, mode: str) -> List[Tuple[int, int]]:
    """Paper's back-off: sequentially decrement bitwidths until it fits."""
    wa = list(wa)
    guard = 0
    while resource(sites, wa, hw, mode) > budget and guard < 10_000:
        # decrement the site with the largest resource contribution that can
        # still go lower (sequential sweep, as in the paper)
        changed = False
        for i in range(len(wa)):
            w, a = wa[i]
            if a > min(A_BITS):
                wa[i] = (w, A_BITS[A_BITS.index(a) - 1])
                changed = True
            elif w > min(W_BITS):
                wa[i] = (w - 1, a)
                changed = True
            if changed and resource(sites, wa, hw, mode) <= budget:
                return wa
        if not changed:
            break
        guard += 1
    return wa


class HAQEnv:
    def __init__(self, cfg, sites: List[QuantSite],
                 eval_policy: Callable[[Dict[str, Tuple[int, int]]], float],
                 hcfg: HAQConfig, hw: Hardware = V5E_EDGE):
        self.cfg = cfg
        self.sites = sites
        self.eval_policy = eval_policy
        self.hcfg = hcfg
        self.hw = hw
        base = [(8, 8)] * len(sites)
        self.base_resource = resource(sites, base, hw, hcfg.mode)
        self.budget = hcfg.latency_budget or hcfg.budget_frac * \
            self.base_resource
        self.base_loss = float(eval_policy({s.name: (16, 16)
                                            for s in sites}))

    def state(self, t: int, prev_w: int, prev_a: int) -> np.ndarray:
        s = self.sites[t]
        return np.array([
            t / max(len(self.sites) - 1, 1),
            np.log10(max(float(s.cost.flops), 1.0)) / 15.0,
            np.log10(max(float(s.cost.weight_bytes), 1.0)) / 12.0,
            float(s.cost.intensity()) / 1000.0,
            s.d_in / 16384.0,
            s.d_out / 16384.0,
            s.count / 100.0,
            prev_w / 8.0,
            prev_a / 16.0,
            self.budget / max(self.base_resource, 1e-12),
        ], np.float32)

    def decode_action(self, a: float, arr) -> int:
        idx = int(round(a * (len(arr) - 1)))
        return arr[max(0, min(idx, len(arr) - 1))]

    def rollout(self, agent_w: DDPG, agent_a: DDPG, explore=True) -> dict:
        wa: List[Tuple[int, int]] = []
        traj = []
        pw, pa = 8, 8
        for t in range(len(self.sites)):
            s = self.state(t, pw, pa)
            aw = agent_w.act(s, explore=explore)
            aa = agent_a.act(s, explore=explore)
            w_bits = self.decode_action(aw, W_BITS)
            a_bits = self.decode_action(aa, A_BITS)
            wa.append((w_bits, a_bits))
            traj.append((s, aw, aa))
            pw, pa = w_bits, a_bits
        wa = enforce_budget(self.sites, wa, self.hw, self.budget,
                            self.hcfg.mode)
        policy = {s.name: b for s, b in zip(self.sites, wa)}
        loss = float(self.eval_policy(policy))
        reward = -self.hcfg.quality_coef * (loss - self.base_loss)
        for t, (s, aw, aa) in enumerate(traj):
            done = t == len(traj) - 1
            s2 = self.state(min(t + 1, len(self.sites) - 1), *wa[t]) \
                if not done else np.zeros(STATE_DIM, np.float32)
            r = reward if done else 0.0
            agent_w.observe(s, aw, r, s2, done)
            agent_a.observe(s, aa, r, s2, done)
        used = resource(self.sites, wa, self.hw, self.hcfg.mode)
        return {"policy": policy, "loss": loss, "reward": reward,
                "resource": used, "budget": self.budget,
                "base_resource": self.base_resource}


def search(cfg, sites, eval_policy, hcfg: HAQConfig = HAQConfig(),
           hw: Hardware = V5E_EDGE,
           agents: Optional[Tuple[DDPG, DDPG]] = None,
           progress: Optional[Callable[[dict], None]] = None) -> dict:
    """Returns best policy + history (+ the trained agents for Table 7's
    transfer experiment)."""
    env = HAQEnv(cfg, sites, eval_policy, hcfg, hw)
    if agents is None:
        agent_w = DDPG(DDPGConfig(state_dim=STATE_DIM), seed=hcfg.seed)
        agent_a = DDPG(DDPGConfig(state_dim=STATE_DIM), seed=hcfg.seed + 1)
    else:
        agent_w, agent_a = agents
    best, hist = None, []
    for ep in range(hcfg.episodes):
        rec = env.rollout(agent_w, agent_a, explore=True)
        agent_w.end_episode()
        agent_a.end_episode()
        hist.append({"episode": ep, "loss": rec["loss"],
                     "reward": rec["reward"], "resource": rec["resource"]})
        if best is None or rec["reward"] > best["reward"]:
            best = rec
        if progress and ep % 10 == 0:
            progress(rec)
    final = env.rollout(agent_w, agent_a, explore=False)
    if final["reward"] > best["reward"]:
        best = final
    return {"best": best, "history": hist, "base_loss": env.base_loss,
            "agents": (agent_w, agent_a),
            "sites": [s.name for s in env.sites]}
