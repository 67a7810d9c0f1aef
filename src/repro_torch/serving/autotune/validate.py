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

In a world of ranks (torchrun, or ``launch.mesh.spawn``) every rank runs
the same search; a ``mesh_model = m`` candidate is served on a sub-mesh
of the first m ranks (``launch.mesh.make_sub_mesh``), the sharded engine
over it, while the other ranks wait, and rank 0's numbers reach every
rank (``distributed/sharding.py::broadcast_floats``), so that all rank
and pick alike. A candidate wider than the world is skipped, as the
reference skips one wider than its devices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shlib
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


def world() -> tuple:
    """(this rank, ranks) of the initialized process group; (0, 1)
    without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def first_rank(values):
    """Rank 0's ``values`` (floats; every rank passes as many) on every
    rank; the values themselves in a world of one."""
    return shlib.broadcast_floats(values) if world()[1] > 1 \
        else [float(v) for v in values]


def same_on_every_rank(value: float) -> bool:
    """Whether every rank passed the same ``value``. One all-gather, so
    every rank sees every rank's value and reaches the same verdict;
    True in a world of one."""
    if world()[1] == 1:
        return True
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    got = shlib.all_gather_dim(torch.tensor(
        [float(value)], dtype=torch.float64, device=device), 0, None)
    return bool((got == got[0]).all())


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
    candidates this world cannot run (a mesh split wider than its ranks).
    A ``mesh_model > 1`` candidate runs on the first ``mesh_model`` ranks
    (every rank of the world calls this); rank 0's numbers are every
    rank's. Pass ``engine`` to reuse an already-built engine (the default
    config's calibration engine, which every rank runs)."""
    c = scored.config
    rank, ranks = world()
    if engine is None:
        if c.mesh_model > ranks:
            return None
        mesh = None
        if c.mesh_model > 1:
            from repro_torch.launch.mesh import make_sub_mesh
            mesh = make_sub_mesh(1, c.mesh_model,
                                 device_type=params["embed"].device.type)
        if rank < c.mesh_model:
            engine = Engine(model, params, space.to_policy(c), mesh=mesh,
                            roofline_scales=roofline_scales)
    numbers = [0.0] * 5
    if engine is not None:
        numbers = _timed(engine, reqs)
    tok_s, ttft, wall, ticks, preempted = first_rank(numbers)
    return MeasuredCandidate(
        scored=scored,
        decode_tok_s=tok_s,
        ttft_p50_s=ttft,
        wall_s=wall,
        decode_ticks=int(ticks),
        preemptions=int(preempted),
    )


def _timed(engine: Engine, reqs) -> list:
    """[decode tok/s, TTFT p50 s, wall s, decode ticks, preemptions] of
    ``engine`` serving ``reqs`` once warm."""
    engine.run(reqs, realtime=False)  # warm: first calls off the clock
    engine.reset_stats()
    _sync(engine.device)
    t0 = time.monotonic()
    engine.run(reqs, realtime=False)
    _sync(engine.device)
    dt = time.monotonic() - t0
    stats = engine.stats
    ttft = sorted(engine.first_token_s.values())
    return [stats["decode_tokens"] / dt if dt > 0 else 0.0,
            float(np.median(ttft)) if ttft else 0.0, dt,
            stats["decode_ticks"], stats["preemptions"]]


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
