"""Validate searched configs against the real engine (port of
``repro.serving.autotune.validate``).

The calibrated roofline ranks thousands of candidates; the top few are
then *measured* — a real `Engine` built from each candidate's policy on
the parameters' device (on the card: the paged kernels), warmed on the
exact trace and re-timed, the clock read after
``torch.cuda.synchronize()`` when the engine runs on the card. The winner is
the best MEASURED candidate, and `spearman` reports how well the
calibrated objective predicted the measured ranking — the paper's
predicted-vs-measured fidelity number, recorded in the bench's
``autotune`` section.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.autotune.objective import ScoredCandidate
from repro_torch.serving.autotune.space import ConfigSpace
from repro_torch.serving.engine import Engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class MeasuredCandidate:
    scored: ScoredCandidate
    decode_tok_s: float
    ttft_p50_s: float
    wall_s: float
    decode_ticks: int
    preemptions: int

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["scored"] = self.scored.as_dict()
        return d


def measure_candidate(
    model,
    params,
    space: ConfigSpace,
    scored: ScoredCandidate,
    reqs,
    *,
    roofline_scales=None,
    engine: Optional[Engine] = None,
) -> Optional[MeasuredCandidate]:
    """Serve ``reqs`` through an engine built from the candidate; warm
    on the exact trace, then re-time the same instance. Returns None for
    candidates this port cannot run: a mesh split (``mesh_model > 1``)
    waits for the sharded engine. Pass ``engine`` to reuse an
    already-built engine (the default config's calibration engine)."""
    c = scored.config
    if engine is None:
        if c.mesh_model > 1:
            return None
        engine = Engine(model, params, space.to_policy(c),
                        roofline_scales=roofline_scales)
    engine.run(reqs, realtime=False)  # warm: first calls off the clock
    engine.reset_stats()
    _sync(engine.device)
    t0 = time.monotonic()
    engine.run(reqs, realtime=False)
    _sync(engine.device)
    dt = time.monotonic() - t0
    stats = engine.stats
    ttft = sorted(engine.first_token_s.values())
    return MeasuredCandidate(
        scored=scored,
        decode_tok_s=stats["decode_tokens"] / dt if dt > 0 else 0.0,
        ttft_p50_s=float(np.median(ttft)) if ttft else 0.0,
        wall_s=dt,
        decode_ticks=stats["decode_ticks"],
        preemptions=stats["preemptions"],
    )


def validate_candidates(
    model,
    params,
    space: ConfigSpace,
    scored: List[ScoredCandidate],
    reqs,
    *,
    roofline_scales=None,
) -> List[MeasuredCandidate]:
    """Measure each candidate (preserving order, skipping unmeasurable
    ones); duplicate configs are measured once."""
    out: List[MeasuredCandidate] = []
    seen = set()
    for s in scored:
        if s.config in seen:
            continue
        seen.add(s.config)
        m = measure_candidate(
            model,
            params,
            space,
            s,
            reqs,
            roofline_scales=roofline_scales,
        )
        if m is not None:
            out.append(m)
    return out


def spearman(xs, ys) -> Optional[float]:
    """Spearman rank correlation (average ranks on ties); None when
    fewer than 3 points or either side is constant — a correlation from
    2 points is a coin flip, and NaN must never reach the bench JSON."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if xs.size != ys.size or xs.size < 3:
        return None
    if np.ptp(xs) == 0.0 or np.ptp(ys) == 0.0:
        return None

    def ranks(v):
        order = np.argsort(v, kind="stable")
        r = np.empty_like(v)
        r[order] = np.arange(v.size, dtype=np.float64)
        # average tied ranks
        for val in np.unique(v):
            m = v == val
            r[m] = r[m].mean()
        return r

    rx, ry = ranks(xs), ranks(ys)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = float(np.sqrt((rx * rx).sum() * (ry * ry).sum()))
    if denom == 0.0:
        return None
    return float((rx * ry).sum() / denom)
