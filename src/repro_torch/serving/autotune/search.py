"""Search over the serving config space (port of
``repro.serving.autotune.search``): DDPG (the paper's AMC/HAQ agent,
`core/rl/ddpg.py`) plus a seeded evolutionary baseline.

Both searchers consume the calibrated-roofline `Objective` — thousands
of evaluations per second — and are deterministic under a fixed seed
(numpy Generators throughout; the DDPG actor's torch init and CPU train
steps are seed-deterministic too). ``budget`` counts objective
evaluations of *distinct* candidates; revisits hit the objective's memo
and cost nothing. `search_serving_config` is the entry point: it splits
the budget across both methods, merges, and ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.rl.ddpg import DDPG, DDPGConfig
from repro_torch.serving.autotune.objective import Objective, \
    ScoredCandidate
from repro_torch.serving.autotune.space import ConfigSpace, ServingConfig

STATE_DIM = 4


@dataclasses.dataclass
class SearchResult:
    ranked: List[ScoredCandidate]  # admissible only, best score first
    evaluated: int  # distinct candidates scored
    admissible: int
    method: str
    seed: int
    budget: int

    @property
    def best(self) -> Optional[ScoredCandidate]:
        return self.ranked[0] if self.ranked else None


def _rank(scored: List[ScoredCandidate]) -> List[ScoredCandidate]:
    """Admissible candidates, best calibrated score first; ties broken
    on the config's total order so rankings are reproducible."""
    return sorted(
        (s for s in scored if s.admissible),
        key=lambda s: (-s.score, s.config.sort_key()),
    )


def evolutionary_search(
    space: ConfigSpace,
    objective: Objective,
    *,
    budget: int = 32,
    seed: int = 0,
    pop_size: int = 8,
    mutate_p: float = 0.35,
) -> List[ScoredCandidate]:
    """Seeded (mu + lambda)-style search: population of encoded configs,
    uniform crossover of two tournament-selected parents, per-dimension
    mutation onto a random other choice. The hand-picked default is in
    the initial population, so the best result never scores below it."""
    rng = np.random.default_rng(seed)
    seen: Dict[ServingConfig, ScoredCandidate] = {}
    limit = min(budget, space.size())

    def evaluate(c: ServingConfig) -> Optional[ScoredCandidate]:
        if c not in seen:
            if len(seen) >= limit:
                return None
            seen[c] = objective(c)
        return seen[c]

    pop = [space.default()]
    while len(pop) < pop_size and len(seen) + len(pop) <= limit:
        pop.append(space.sample(rng))
    for c in pop:
        evaluate(c)

    attempts = 0
    while len(seen) < limit and attempts < budget * 20:
        attempts += 1
        ranked = _rank(list(seen.values()))
        parents = ranked[: max(pop_size, 2)] or list(seen.values())

        def pick() -> ServingConfig:
            i = int(min(rng.integers(len(parents)),
                        rng.integers(len(parents))))
            return parents[i].config

        a, b = space.indices(pick()), space.indices(pick())
        child = [
            (a if rng.random() < 0.5 else b)[t]
            for t in range(space.num_dims)
        ]
        for t, (_, choices) in enumerate(space.dims):
            if len(choices) > 1 and rng.random() < mutate_p:
                others = [i for i in range(len(choices)) if i != child[t]]
                child[t] = int(others[int(rng.integers(len(others)))])
        evaluate(space.from_indices(child))
    return list(seen.values())


def _ddpg_state(space: ConfigSpace, t: int, prev: float) -> np.ndarray:
    return np.array(
        [
            t / max(space.num_dims - 1, 1),
            prev,
            len(space.dims[t][1]) / 8.0,
            1.0,
        ],
        np.float32,
    )


def ddpg_search(
    space: ConfigSpace,
    objective: Objective,
    *,
    budget: int = 32,
    seed: int = 0,
) -> List[ScoredCandidate]:
    """AMC/HAQ-style episodic search: one episode walks the knob
    dimensions in order, the continuous action in [0, 1] picks each
    knob's choice index, and the terminal reward is the candidate's
    score relative to the best seen so far (inadmissible = -1)."""
    agent = DDPG(DDPGConfig(state_dim=STATE_DIM), seed=seed)
    seen: Dict[ServingConfig, ScoredCandidate] = {}
    best_score = objective(space.default()).score
    if not np.isfinite(best_score) or best_score <= 0.0:
        best_score = None
    for _ in range(budget):
        idxs: List[int] = []
        traj = []
        prev = 0.0
        for t, (_, choices) in enumerate(space.dims):
            st = _ddpg_state(space, t, prev)
            a = agent.act(st, explore=True)
            i = int(round(a * (len(choices) - 1)))
            i = max(0, min(i, len(choices) - 1))
            idxs.append(i)
            traj.append((st, a))
            prev = i / max(len(choices) - 1, 1)
        cand = space.from_indices(idxs)
        sc = seen.get(cand)
        if sc is None:
            sc = objective(cand)
            seen[cand] = sc
        if not sc.admissible:
            reward = -1.0
        elif best_score is None:
            best_score = sc.score
            reward = 1.0
        else:
            reward = float(
                np.clip(sc.score / best_score - 1.0, -1.0, 1.0)
            )
            best_score = max(best_score, sc.score)
        for t, (st, a) in enumerate(traj):
            done = t == len(traj) - 1
            s2 = (
                _ddpg_state(
                    space,
                    t + 1,
                    idxs[t] / max(len(space.dims[t][1]) - 1, 1),
                )
                if not done
                else np.zeros(STATE_DIM, np.float32)
            )
            agent.observe(st, a, reward if done else 0.0, s2, done)
        agent.end_episode()
    return list(seen.values())


def search_serving_config(
    space: ConfigSpace,
    objective: Objective,
    *,
    budget: int = 64,
    seed: int = 0,
    method: str = "both",
) -> SearchResult:
    """Run the configured searcher(s) and merge into one ranked result.

    ``method``: "evolution", "ddpg", or "both" (the default — half the
    budget each, evolution first; candidates both find are scored once
    thanks to the objective memo and deduped here)."""
    if method not in ("evolution", "ddpg", "both"):
        raise ValueError(f"unknown search method {method!r}")
    scored: Dict[ServingConfig, ScoredCandidate] = {}

    def merge(results: List[ScoredCandidate]) -> None:
        for s in results:
            scored.setdefault(s.config, s)

    if method in ("evolution", "both"):
        ev_budget = budget // 2 if method == "both" else budget
        merge(
            evolutionary_search(
                space, objective, budget=ev_budget, seed=seed
            )
        )
    if method in ("ddpg", "both"):
        dd_budget = budget - budget // 2 if method == "both" else budget
        merge(ddpg_search(space, objective, budget=dd_budget, seed=seed))

    all_scored = list(scored.values())
    ranked = _rank(all_scored)
    return SearchResult(
        ranked=ranked,
        evaluated=len(all_scored),
        admissible=len(ranked),
        method=method,
        seed=seed,
        budget=budget,
    )
