"""DDPG actor-critic (port of ``repro.core.rl.ddpg``) — the agent behind
HAQ (§4), the KV-bit search and the serving autotuner.

Continuous action in [0, 1] per step (normalized bitwidth or knob
index), truncated-normal exploration noise with decay, soft target
updates, plain SGD, and a numpy ring-buffer replay. Small MLPs (width
128) so a full search runs in seconds.

Device: the agent is host-side numerics, as in the reference — a few
128-wide matmuls per action, next to the host scheduler that consumes
them. It takes an explicit ``device`` and runs on the CPU by default; it
does not follow the model onto the card, whose time goes to the model,
the engine and the kernels the searches score. This is a placement, not
a fallback: ``device="cuda"`` runs it on the card.

Initial weights: the reference draws them from ``jax.random``, which
torch cannot reproduce. The port draws N(0, 1)/sqrt(fan_in) weights and
zero biases, the reference's scaling, from ``torch.Generator(seed)``;
``DDPG.set_weights`` carries any other weights in (the reference's own
``[{"w", "b"}, ...]`` layout), as ``models/convert.py`` does for a
model. Exploration and replay draw from ``np.random.default_rng(seed)``
in the reference's order, so with the same weights the two agents take
the same actions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

F32 = torch.float32


@dataclasses.dataclass
class DDPGConfig:
    state_dim: int
    hidden: int = 128
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 1.0  # episodic, finite-horizon (AMC uses 1)
    tau: float = 0.01
    noise0: float = 0.5
    noise_decay: float = 0.99
    batch: int = 64
    buffer: int = 4096
    warmup_episodes: int = 8


def _mlp_init(generator, sizes, device):
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator, dtype=F32) / np.sqrt(a)
        params.append({"w": w.to(device),
                       "b": torch.zeros((b,), dtype=F32, device=device)})
    return params


def _mlp(params, x, final_act=None):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return final_act(x) if final_act else x


def actor_fwd(params, s):
    return _mlp(params, s, torch.sigmoid)[..., 0]  # action in (0,1)


def critic_fwd(params, s, a):
    x = torch.cat([s, a[..., None]], dim=-1)
    return _mlp(params, x)[..., 0]


def _copy(params):
    return [{k: v.detach().clone() for k, v in layer.items()}
            for layer in params]


class ReplayBuffer:
    def __init__(self, cap: int, state_dim: int):
        self.cap = cap
        self.s = np.zeros((cap, state_dim), np.float32)
        self.a = np.zeros((cap,), np.float32)
        self.r = np.zeros((cap,), np.float32)
        self.s2 = np.zeros((cap, state_dim), np.float32)
        self.done = np.zeros((cap,), np.float32)
        self.n = 0
        self.ptr = 0

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, done
        self.ptr = (i + 1) % self.cap
        self.n = min(self.n + 1, self.cap)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.n, size=batch)
        return (
            self.s[idx],
            self.a[idx],
            self.r[idx],
            self.s2[idx],
            self.done[idx],
        )


class DDPG:
    def __init__(self, cfg: DDPGConfig, seed: int = 0, *, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        g = torch.Generator().manual_seed(seed)
        self.actor = _mlp_init(g, [cfg.state_dim, cfg.hidden, cfg.hidden, 1],
                               self.device)
        self.critic = _mlp_init(
            g, [cfg.state_dim + 1, cfg.hidden, cfg.hidden, 1], self.device)
        self.t_actor = _copy(self.actor)
        self.t_critic = _copy(self.critic)
        self.buffer = ReplayBuffer(cfg.buffer, cfg.state_dim)
        self.rng = np.random.default_rng(seed)
        self.noise = cfg.noise0
        self.episode = 0

    def set_weights(self, actor, critic) -> None:
        """Set the actor and critic from lists of ``{"w": (in, out), "b":
        (out,)}`` arrays (the reference's layout) and reset both targets
        to copies of them."""
        def load(layers):
            return [{k: torch.tensor(np.asarray(v), dtype=F32,
                                     device=self.device)
                     for k, v in layer.items()}
                    for layer in layers]
        self.actor = load(actor)
        self.critic = load(critic)
        self.t_actor = _copy(self.actor)
        self.t_critic = _copy(self.critic)

    # ---------------------------------------------------------------- api --
    def act(self, state: np.ndarray, explore: bool = True) -> float:
        s = torch.as_tensor(np.asarray(state, np.float32), device=self.device)
        with torch.no_grad():
            a = float(actor_fwd(self.actor, s))
        if explore:
            # truncated-normal exploration (AMC's choice)
            a = float(np.clip(self.rng.normal(a, self.noise), 0.0, 1.0))
        return a

    def observe(self, s, a, r, s2, done):
        self.buffer.add(s, a, r, s2, float(done))

    def end_episode(self, updates: int = 32):
        self.episode += 1
        self.noise *= self.cfg.noise_decay
        if (
            self.episode < self.cfg.warmup_episodes
            or self.buffer.n < self.cfg.batch
        ):
            return {}
        losses = {}
        for _ in range(updates):
            batch = self.buffer.sample(self.rng, self.cfg.batch)
            out = self._train_step(
                self.actor,
                self.critic,
                self.t_actor,
                self.t_critic,
                *[torch.as_tensor(b, device=self.device) for b in batch],
            )
            self.actor, self.critic, self.t_actor, self.t_critic, losses = out
        return {k: float(v) for k, v in losses.items()}

    # ------------------------------------------------------------- update --
    def _train_step(self, actor, critic, t_actor, t_critic, s, a, r, s2,
                    done):
        """One update, in the reference's order: the TD target from the
        old target nets; both gradients before either net moves (the
        actor's through the pre-update critic); SGD; soft target updates
        toward the new nets. Returns the new nets and the pre-update
        losses."""
        cfg = self.cfg
        with torch.no_grad():
            q_next = critic_fwd(t_critic, s2, actor_fwd(t_actor, s2))
            target = r + cfg.gamma * (1.0 - done) * q_next

        def leaves(params):
            return [p.detach().requires_grad_() for layer in params
                    for p in (layer["w"], layer["b"])]

        def tree(flat):
            return [{"w": flat[2 * i], "b": flat[2 * i + 1]}
                    for i in range(len(flat) // 2)]

        c_leaves = leaves(critic)
        cl = torch.mean(torch.square(critic_fwd(tree(c_leaves), s, a)
                                     - target))
        gc = torch.autograd.grad(cl, c_leaves)
        a_leaves = leaves(actor)
        al = -torch.mean(critic_fwd(critic, s, actor_fwd(tree(a_leaves), s)))
        ga = torch.autograd.grad(al, a_leaves)
        with torch.no_grad():
            critic = tree([p - cfg.critic_lr * g
                           for p, g in zip(c_leaves, gc)])
            actor = tree([p - cfg.actor_lr * g
                          for p, g in zip(a_leaves, ga)])
            t_critic = [{k: (1 - cfg.tau) * t[k] + cfg.tau * p[k] for k in t}
                        for t, p in zip(t_critic, critic)]
            t_actor = [{k: (1 - cfg.tau) * t[k] + cfg.tau * p[k] for k in t}
                       for t, p in zip(t_actor, actor)]
        return (actor, critic, t_actor, t_critic,
                {"critic_loss": cl.detach(), "actor_loss": al.detach()})
