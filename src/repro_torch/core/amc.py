"""AMC — AutoML for Model Compression (paper §3), LM-adapted (port of
``repro.core.amc``).

A DDPG agent walks the prunable layers of a trained model. Per layer it
observes an 11-dim embedding (AMC's state: layer index, type, dims, FLOPs
fractions, reduced-so-far, rest, previous action) and emits a KEEP ratio
a_t in [a_min, 1]. Budget enforcement follows AMC's resource-constrained
protocol: before each action, the env computes the minimum keep ratio that
still allows the REMAINING layers (at max prune) to hit the FLOPs target,
and clips the action into the feasible interval.

Reward (AMC's FLOPs-constrained form): R = -ΔCE measured on a held-out
batch with the masked model — the budget is met by construction, so reward
is pure quality.

The budget is FLOPs only, as in the reference: ``AMCConfig.mode`` and
``AMCEnv.hw`` are stored and never read (kept so both packages take the
same arguments), so no search here is a latency search. The agent is host
numerics (core/rl/ddpg.py); the masked parameters and ``eval_loss`` stay
on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import pruning
from repro_torch.core.hardware_model import Hardware, V5E_POD
from repro_torch.core.rl.ddpg import DDPG, DDPGConfig
from repro_torch.models.transformer import period_of, sublayer_kinds

STATE_DIM = 11


@dataclasses.dataclass
class AMCConfig:
    target: float = 0.5           # FLOPs budget, fraction
    a_min: float = 0.2            # min keep ratio per layer
    episodes: int = 60
    mode: str = "flops"           # stored, never read (as the reference)
    seed: int = 0


class PrunableLayer:
    def __init__(self, name: str, kind: str, path: Tuple, n_units: int,
                 flops: float):
        self.name = name
        self.kind = kind          # attn | ffn | moe
        self.path = path          # keys into the params tree
        self.n_units = n_units
        self.flops = flops


def enumerate_layers(model, tokens: int) -> List[PrunableLayer]:
    """Prunable layers of a (dense/moe family) model: per sub-layer slot,
    attention groups + FFN units or experts (stacked layers prune jointly
    — the structured analogue of AMC treating a conv layer as one unit)."""
    cfg = model.cfg
    layers: List[PrunableLayer] = []
    if cfg.family in ("ssm",):
        return layers
    P = period_of(cfg)
    kinds = sublayer_kinds(cfg)
    fl = pruning.block_flops(cfg, tokens)
    n_groups = cfg.num_layers // P
    for j in range(P):
        layers.append(PrunableLayer(
            f"sub{j}/attn", "attn", ("blocks", f"sub{j}", "attn"),
            cfg.num_kv_heads, fl["attn"] * n_groups))
        if kinds[j]["moe"]:
            layers.append(PrunableLayer(
                f"sub{j}/moe", "moe", ("blocks", f"sub{j}", "moe"),
                cfg.moe.num_experts, fl["ffn"] * n_groups))
        else:
            layers.append(PrunableLayer(
                f"sub{j}/ffn", "ffn", ("blocks", f"sub{j}", "ffn"),
                cfg.d_ff, fl["ffn"] * n_groups))
    return layers


def _get(params, path):
    node = params
    for k in path:
        node = node[k]
    return node


def _set(params, path, value):
    if not path:
        return value
    out = dict(params)
    out[path[0]] = _set(params[path[0]], path[1:], value)
    return out


def apply_ratios(params, layers: List[PrunableLayer],
                 ratios: List[float]) -> Dict:
    """Mask-prune every layer at its keep ratio (shapes unchanged). The
    masked subtrees are new tensors; everything else is shared with
    ``params``."""
    out = params
    for layer, r in zip(layers, ratios):
        p = _get(out, layer.path)
        if layer.kind == "attn":
            imp = pruning.head_group_importance(p)
            masked = pruning.mask_attn(p, pruning.keep_mask(imp, r))
        elif layer.kind == "moe":
            imp = pruning.expert_importance(p)
            masked = pruning.mask_experts(p, pruning.keep_mask(imp, r))
        else:
            imp = pruning.ffn_importance(p)
            masked = pruning.mask_ffn(p, pruning.keep_mask(imp, r))
        out = _set(out, layer.path, masked)
    return out


class AMCEnv:
    """Episode = one pass over prunable layers; terminal reward = -ΔCE."""

    def __init__(self, model, params, eval_loss: Callable[[Dict], float],
                 acfg: AMCConfig, tokens: int = 4096,
                 hw: Hardware = V5E_POD):
        self.model = model
        self.params = params
        self.eval_loss = eval_loss
        self.acfg = acfg
        self.layers = enumerate_layers(model, tokens)
        assert self.layers, f"no prunable layers for {model.cfg.name}"
        self.total_flops = sum(l.flops for l in self.layers)
        self.base_loss = float(eval_loss(params))
        self.hw = hw

    # -------------------------------------------------------------- state --
    def state(self, t: int, reduced: float, prev_a: float) -> np.ndarray:
        L = self.layers[t]
        rest = sum(l.flops for l in self.layers[t + 1:]) / self.total_flops
        return np.array([
            t / max(len(self.layers) - 1, 1),
            1.0 if L.kind == "attn" else 0.0,
            1.0 if L.kind == "ffn" else 0.0,
            1.0 if L.kind == "moe" else 0.0,
            L.n_units / 1024.0,
            np.log10(max(L.flops, 1.0)) / 15.0,
            L.flops / self.total_flops,
            reduced,
            rest,
            prev_a,
            self.acfg.target,
        ], np.float32)

    # ----------------------------------------------------------- feasible --
    def feasible_interval(self, t: int,
                          flops_used: float) -> Tuple[float, float]:
        """Keep-ratio bounds so the target stays achievable (AMC's budget
        enforcement: later layers can always be pruned to a_min)."""
        target_flops = self.acfg.target * self.total_flops
        rest_min = sum(l.flops for l in self.layers[t + 1:]) \
            * self.acfg.a_min
        L = self.layers[t]
        a_max = (target_flops - flops_used - rest_min) / L.flops
        return self.acfg.a_min, float(np.clip(a_max, self.acfg.a_min, 1.0))

    # ------------------------------------------------------------ episode --
    def rollout(self, agent: DDPG, explore: bool = True) -> dict:
        ratios: List[float] = []
        transitions = []
        reduced, prev_a, flops_used = 0.0, 1.0, 0.0
        for t in range(len(self.layers)):
            s = self.state(t, reduced, prev_a)
            a = agent.act(s, explore=explore)
            lo, hi = self.feasible_interval(t, flops_used)
            a = float(np.clip(self.acfg.a_min + a * (1 - self.acfg.a_min),
                              lo, hi))
            ratios.append(a)
            flops_used += self.layers[t].flops * a
            reduced = flops_used / self.total_flops
            prev_a = a
            transitions.append((s, (a - self.acfg.a_min)
                                / (1 - self.acfg.a_min)))
        masked = apply_ratios(self.params, self.layers, ratios)
        loss = float(self.eval_loss(masked))
        del masked                # one episode's masked copy at a time
        reward = -(loss - self.base_loss)
        for t, (s, a) in enumerate(transitions):
            s2 = self.state(min(t + 1, len(self.layers) - 1),
                            reduced, ratios[t]) \
                if t + 1 < len(self.layers) \
                else np.zeros(STATE_DIM, np.float32)
            agent.observe(s, a, reward if t == len(transitions) - 1 else 0.0,
                          s2, t == len(transitions) - 1)
        return {"ratios": ratios, "loss": loss, "reward": reward,
                "flops_frac": flops_used / self.total_flops}


def search(model, params, eval_loss, acfg: AMCConfig = AMCConfig(),
           progress: Optional[Callable[[dict], None]] = None) -> dict:
    env = AMCEnv(model, params, eval_loss, acfg)
    agent = DDPG(DDPGConfig(state_dim=STATE_DIM), seed=acfg.seed)
    best = None
    hist = []
    for ep in range(acfg.episodes):
        rec = env.rollout(agent, explore=True)
        agent.end_episode()
        rec["episode"] = ep
        hist.append({k: rec[k] for k in ("episode", "loss", "reward",
                                         "flops_frac")})
        if best is None or rec["reward"] > best["reward"]:
            best = rec
        if progress and ep % 10 == 0:
            progress(rec)
    final = env.rollout(agent, explore=False)
    if final["reward"] > best["reward"]:
        best = final
    return {"best": best, "history": hist, "base_loss": env.base_loss,
            "layers": [l.name for l in env.layers]}


def uniform_baseline(model, params, eval_loss, keep: float) -> dict:
    """The paper's rule-based comparison: uniform width multiplier."""
    env_layers = enumerate_layers(model, 4096)
    masked = apply_ratios(params, env_layers, [keep] * len(env_layers))
    return {"loss": float(eval_loss(masked)), "keep": keep}
