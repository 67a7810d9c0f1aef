"""End-to-end autotune loop: calibrate -> search -> validate -> emit
(port of ``repro.serving.autotune.tune``).

`autotune_serving_config` is the whole HAQ-shaped loop over the serving
stack, shared by ``launch/serve.py --autotune`` and the bench's
``autotune`` section:

  1. **calibrate** — serve a short warmup trace with the hand-picked
     default config; `telemetry.calibrate` fits the per-(kind, batch,
     q_len) measured/predicted scale factors for THIS host (every engine
     runs on the parameters' device: on the card, through the kernels).
     The warmup's timed re-run doubles as the default's measured score.
  2. **search** — DDPG + evolutionary search over the `ConfigSpace`,
     scored by the scale-corrected roofline (`Objective`). Budget is
     objective evaluations; all of this is analytic and fast.
  3. **validate** — the top-k searched configs are *measured* on the
     real engine alongside the default; the winner is the best measured
     candidate (the default wins ties, so a noisy search can never ship
     a config that measured worse).
  4. **emit** — `result.record(space)` is the per-hardware JSON artifact
     (`save_serving_config`) that ``--serving-config`` loads back.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serving.autotune.objective import Objective, \
    ScoredCandidate
from repro_torch.serving.autotune.search import SearchResult, \
    search_serving_config
from repro_torch.serving.autotune.space import ConfigSpace, config_record
from repro_torch.serving.autotune.validate import (
    MeasuredCandidate,
    measure_candidate,
    spearman,
    validate_candidates,
)
from repro_torch.serving.engine import Engine
from repro_torch.serving.telemetry import ScaleLookup, calibrate


@dataclasses.dataclass
class TuneResult:
    default: MeasuredCandidate
    winner: MeasuredCandidate
    search: SearchResult
    validated: List[MeasuredCandidate]  # default first, then top-k
    scales: ScaleLookup
    rank_correlation: Optional[float]

    @property
    def searched_vs_default(self) -> float:
        base = self.default.decode_tok_s
        return self.winner.decode_tok_s / base if base > 0 else 0.0

    def record(self, space: ConfigSpace) -> Dict:
        """The winner as a per-hardware serving-config JSON record."""
        return config_record(
            space,
            self.winner.scored.config,
            budget=self.search.budget,
            seed=self.search.seed,
            method=self.search.method,
            candidates=self.search.evaluated,
            admissible=self.search.admissible,
            predicted_decode_tok_s=self.winner.scored.pred_decode_tok_s,
            measured_decode_tok_s=self.winner.decode_tok_s,
            default_decode_tok_s=self.default.decode_tok_s,
            searched_vs_default=self.searched_vs_default,
            rank_correlation=self.rank_correlation,
            calibration=self.scales.as_dict(),
        )


def autotune_serving_config(
    model,
    params,
    space: ConfigSpace,
    warmup_reqs,
    *,
    budget: int = 64,
    top_k: int = 3,
    seed: int = 0,
    method: str = "both",
    ttft_slo_s: Optional[float] = None,
    validate_reqs=None,
) -> TuneResult:
    """Run the full loop on ``warmup_reqs`` (calibration + measurement
    trace; pass ``validate_reqs`` to measure candidates on a different
    trace than the calibration warmup)."""
    validate_reqs = (
        validate_reqs if validate_reqs is not None else warmup_reqs
    )
    default_cfg = space.default()
    default_policy = space.to_policy(default_cfg)
    engine = Engine(model, params, default_policy)
    # score the default AFTER calibration so predicted/measured pairs are
    # consistent; measure it first so its ticks fit the scales
    default_measured_raw = measure_candidate(
        model,
        params,
        space,
        ScoredCandidate(
            config=default_cfg, score=0.0, admissible=True
        ),
        warmup_reqs,
        engine=engine,
    )
    scales = calibrate(engine.telemetry.ticks).scale_lookup()

    prompt_len = max(
        int(sum(len(r.prompt) for r in warmup_reqs) / len(warmup_reqs)), 1
    )
    objective = Objective(
        space,
        scales=scales,
        prompt_len=prompt_len,
        ttft_slo_s=ttft_slo_s,
    )
    result = search_serving_config(
        space, objective, budget=budget, seed=seed, method=method
    )

    default_scored = objective(default_cfg)
    default_measured = dataclasses.replace(
        default_measured_raw, scored=default_scored
    )
    top = [
        s
        for s in result.ranked
        if s.config != default_cfg
    ][: max(top_k, 1)]
    validated = [default_measured] + validate_candidates(
        model,
        params,
        space,
        top,
        validate_reqs,
        roofline_scales=scales,
    )
    # winner = best measured; max() keeps the FIRST maximum, and the
    # default is first, so ties ship the hand-picked config
    winner = max(validated, key=lambda m: m.decode_tok_s)
    corr = spearman(
        [m.scored.score for m in validated],
        [m.decode_tok_s for m in validated],
    )
    return TuneResult(
        default=default_measured,
        winner=winner,
        search=result,
        validated=validated,
        scales=scales,
        rank_correlation=corr,
    )
