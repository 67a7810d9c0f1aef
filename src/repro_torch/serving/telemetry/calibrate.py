"""Roofline calibration: fit predicted vs measured tick latency.

The paper's loop (HAQ/ProxylessNAS) only works because its fast feedback
signal — a latency table or roofline — is validated against the real
device. This module is that validation for the serving engine:
`calibrate()` takes the recorded tick events (each carrying
``predicted_s`` from `admission.step_latency` next to fenced wall-clock
``measured_s``) and fits, per (tick kind, padded batch, q_len) group,
the least-squares scale ``measured ≈ scale * predicted`` through the
origin, plus the median relative error.

The per-kind scale factors are exactly the correction
`core/hardware_model` would need for its roofline to predict this host
— the direct input for the ROADMAP's serving-stack autotuner, which
wants to search on the (cheap) roofline and trust it only as far as
this report says it deserves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.telemetry.events import TickEvent


@dataclasses.dataclass
class CalibrationGroup:
    """Predicted-vs-measured fit for one (kind, batch, q_len) shape."""
    kind: str
    batch: int                 # padded jit batch (what actually runs)
    q_len: int
    n: int
    predicted_s: float         # the group's (constant) roofline prediction
    measured_p50_s: float
    measured_p99_s: float
    measured_mean_s: float
    scale: Optional[float]     # measured ~= scale * predicted (None: no pred)
    rel_err: Optional[float]   # median |measured - predicted| / predicted

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScaleLookup:
    """Calibration scales as a queryable lookup — the report's export for
    consumers that price rooflines at arbitrary shapes (the serving-stack
    autotuner, `admission.RooflinePredictor(scales=...)`).

    Resolution order for ``scale(kind, batch, q_len)``:

      1. the exact (kind, batch, q_len) group the warmup trace measured;
      2. the kind's sample-weighted aggregate scale (the shape searched
         by the autotuner rarely matches a warmup shape exactly — the
         per-kind factor is the transferable signal);
      3. ``None`` — no calibration for this kind (e.g. the warmup engine
         ran an unknown ``hw_name``, so every prediction was 0.0 and
         `calibrate` fitted nothing). Callers must fall back to the raw
         roofline explicitly rather than multiplying by a made-up 1.0
         silently — see autotune/objective.py for the logged fallback.

    Only finite, positive fits are stored; ``from_dict`` round-trips the
    JSON shape written into serving-config files.
    """
    by_shape: Dict[Tuple[str, int, int], float] = \
        dataclasses.field(default_factory=dict)
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)

    def scale(self, kind: str, batch: Optional[int] = None,
              q_len: Optional[int] = None) -> Optional[float]:
        if batch is not None and q_len is not None:
            got = self.by_shape.get((kind, int(batch), int(q_len)))
            if got is not None:
                return got
        return self.by_kind.get(kind)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted(self.by_kind))

    def as_dict(self) -> Dict:
        return {
            "by_kind": dict(self.by_kind),
            "by_shape": {f"{k}/{b}/{q}": s
                         for (k, b, q), s in sorted(self.by_shape.items())},
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ScaleLookup":
        by_shape = {}
        for key, s in (d.get("by_shape") or {}).items():
            kind, b, q = key.rsplit("/", 2)
            by_shape[(kind, int(b), int(q))] = float(s)
        return cls(by_shape=by_shape,
                   by_kind={k: float(v)
                            for k, v in (d.get("by_kind") or {}).items()})


@dataclasses.dataclass
class CalibrationReport:
    groups: List[CalibrationGroup]

    def scale_factors(self) -> Dict[str, Optional[float]]:
        """Per tick kind, the sample-weighted least-squares scale the
        roofline is off by on this host (measured = scale * predicted)."""
        out: Dict[str, Optional[float]] = {}
        for kind in sorted({g.kind for g in self.groups}):
            num = den = 0.0
            for g in self.groups:
                if g.kind != kind or g.scale is None:
                    continue
                # un-normalize the per-group fit back to sums of m*p, p*p
                den_g = g.n * g.predicted_s * g.predicted_s
                num += g.scale * den_g
                den += den_g
            out[kind] = (num / den) if den > 0.0 else None
        return out

    def rel_err_by_kind(self) -> Dict[str, Optional[float]]:
        """Per tick kind, the sample-weighted mean of group median
        relative errors — the single "how wrong is the roofline" number
        the bench records."""
        out: Dict[str, Optional[float]] = {}
        for kind in sorted({g.kind for g in self.groups}):
            num = den = 0
            for g in self.groups:
                if g.kind != kind or g.rel_err is None:
                    continue
                num += g.rel_err * g.n
                den += g.n
            out[kind] = (num / den) if den else None
        return out

    def scale_lookup(self) -> ScaleLookup:
        """Export the fits as a `ScaleLookup` (exact-shape scales plus the
        per-kind aggregates). Groups with no prediction (scale None) are
        dropped — the lookup answers None for them and the caller decides
        how to fall back."""
        by_shape = {
            (g.kind, g.batch, g.q_len): float(g.scale)
            for g in self.groups
            if g.scale is not None and g.scale > 0.0
        }
        by_kind = {k: float(s) for k, s in self.scale_factors().items()
                   if s is not None and s > 0.0}
        return ScaleLookup(by_shape=by_shape, by_kind=by_kind)

    def as_dict(self) -> Dict:
        return {
            "groups": [g.as_dict() for g in self.groups],
            "scale": self.scale_factors(),
            "rel_err": self.rel_err_by_kind(),
        }

    def format(self) -> str:
        """Human-readable table for launch/serve.py and bench logs."""
        lines = ["roofline calibration (measured = scale * predicted):",
                 f"{'kind':8} {'batch':>5} {'q_len':>5} {'n':>5} "
                 f"{'pred_ms':>9} {'p50_ms':>9} {'scale':>7} {'relerr':>7}"]
        for g in sorted(self.groups, key=lambda g: (g.kind, g.batch,
                                                    g.q_len)):
            scale = "-" if g.scale is None else f"{g.scale:.2f}"
            rel = "-" if g.rel_err is None else f"{g.rel_err:.2f}"
            lines.append(
                f"{g.kind:8} {g.batch:>5} {g.q_len:>5} {g.n:>5} "
                f"{g.predicted_s * 1e3:>9.3f} "
                f"{g.measured_p50_s * 1e3:>9.3f} {scale:>7} {rel:>7}")
        for kind, scale in self.scale_factors().items():
            if scale is not None:
                lines.append(f"  -> hardware_model scale[{kind}] = "
                             f"{scale:.3f}")
        return "\n".join(lines)


def calibrate(ticks: Iterable[TickEvent]) -> CalibrationReport:
    """Group tick events by (kind, padded_batch, q_len) and fit each
    group's predicted-vs-measured latency. Groups whose prediction is
    absent (unknown hardware target => predicted_s == 0) still report
    measured percentiles with ``scale``/``rel_err`` of None."""
    by_key: Dict[Tuple[str, int, int], List[TickEvent]] = {}
    for ev in ticks:
        by_key.setdefault((ev.kind, ev.padded_batch, ev.q_len),
                          []).append(ev)
    groups = []
    for (kind, batch, q_len), evs in sorted(by_key.items()):
        m = np.asarray([e.measured_s for e in evs], np.float64)
        p = np.asarray([e.predicted_s for e in evs], np.float64)
        pred = float(p.mean())
        if pred > 0.0:
            scale = float((m * p).sum() / (p * p).sum())
            rel_err = float(np.median(np.abs(m - p) / p))
        else:
            scale = rel_err = None
        groups.append(CalibrationGroup(
            kind=kind, batch=batch, q_len=q_len, n=len(evs),
            predicted_s=pred,
            measured_p50_s=float(np.percentile(m, 50)),
            measured_p99_s=float(np.percentile(m, 99)),
            measured_mean_s=float(m.mean()),
            scale=scale, rel_err=rel_err))
    return CalibrationReport(groups=groups)
