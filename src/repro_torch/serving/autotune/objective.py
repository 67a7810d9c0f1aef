"""Calibrated-roofline objective: the autotuner's fast feedback signal
(port of ``repro.serving.autotune.objective``).

The paper's loop (AMC/HAQ) searches on a cheap signal and trusts it only
as far as its validation against the device says it deserves. Here the
cheap signal is `admission.step_latency` — the same roofline that sizes
the engine — and the validation is `telemetry.calibrate`: a short warmup
trace on the target host fits per-(kind, batch, q_len) scale factors
between the roofline's prediction and the fenced measured tick latency,
exported as a `ScaleLookup`. Scoring a candidate costs two analytic
latency queries, so thousands of configs are searched per second; the
top candidates are then re-measured for real (autotune/validate.py).

Fallback contract (the unknown-``hw_name`` fix): when no calibration
scale exists for a tick kind — the warmup engine ran a hardware target
not in ``HARDWARES`` so every ``predicted_s`` was 0.0 and `calibrate`
fitted nothing, or no warmup ran at all — the objective falls back to
the RAW roofline with a logged warning, once per kind. It never scores
zeros (the pre-fix behaviour: `RooflinePredictor` answers 0.0 for an
unknown target, and an objective built on it would rank every candidate
equal at -inf throughput) and never invents a silent 1.0.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Optional, Tuple

from repro_torch.serving.autotune.space import ConfigSpace, ServingConfig
from repro_torch.serving.engine.admission import step_latency

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ScoredCandidate:
    """One candidate with its calibrated-roofline score. Inadmissible
    candidates carry ``score=-inf`` and their constraint violations."""

    config: ServingConfig
    score: float
    admissible: bool
    violations: Tuple[str, ...] = ()
    pred_decode_tok_s: float = 0.0
    pred_ttft_s: float = 0.0
    pred_decode_tick_s: float = 0.0
    pred_chunk_tick_s: float = 0.0
    calibrated: bool = False
    max_batch: int = 0
    num_pages: int = 0

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["config"] = self.config.as_dict()
        d["violations"] = list(self.violations)
        return d


class Objective:
    """Score = calibrated predicted aggregate decode tok/s, softly
    discounted when predicted TTFT overshoots ``ttft_slo_s`` (None
    disables the discount — pure decode throughput).

    * decode: the policy's (capped) max_batch tokens per tick over the
      scale-corrected decode-tick roofline at worst-case context;
    * TTFT: ``ceil(prompt_len / chunk)`` chunk ticks, each at the
      scale-corrected prefill-with-cache roofline (matching the chunked
      engine: one chunk per tick, decode interleaving ignored).

    ``scales`` is a `telemetry.ScaleLookup` (or None). Results are
    memoized per candidate — searchers revisit configs freely.
    """

    def __init__(
        self,
        space: ConfigSpace,
        *,
        scales=None,
        prompt_len: int = 32,
        ttft_slo_s: Optional[float] = None,
    ):
        self.space = space
        self.scales = scales
        self.prompt_len = max(int(prompt_len), 1)
        self.ttft_slo_s = ttft_slo_s
        self._warned: set = set()
        self._memo: Dict[ServingConfig, ScoredCandidate] = {}

    def _scale(self, kind: str, batch: int, q_len: int):
        """(scale, calibrated?) — raw-roofline fallback logs once."""
        s = (
            self.scales.scale(kind, batch, q_len)
            if self.scales is not None
            else None
        )
        if s is not None:
            return float(s), True
        if kind not in self._warned:
            self._warned.add(kind)
            log.warning(
                "autotune: no calibration scale for kind=%r on %s — "
                "scoring on the RAW roofline (fit scales on this host "
                "with telemetry.calibrate over a warmup trace)",
                kind,
                self.space.hw.name,
            )
        return 1.0, False

    def __call__(self, c: ServingConfig) -> ScoredCandidate:
        got = self._memo.get(c)
        if got is not None:
            return got
        sc = self._score(c)
        self._memo[c] = sc
        return sc

    def _score(self, c: ServingConfig) -> ScoredCandidate:
        viols = self.space.violations(c)
        if viols:
            return ScoredCandidate(
                config=c,
                score=float("-inf"),
                admissible=False,
                violations=viols,
            )
        space = self.space
        policy = space.to_policy(c)
        B = policy.max_batch
        raw_decode = step_latency(
            space.cfg,
            B,
            1,
            space.max_model_len,
            space.hw,
            w_bits=policy.quant_bits,
            kv_bits=policy.kv_bits,
            mesh_model=policy.mesh_model,
        )
        s_decode, cal_d = self._scale("decode", B, 1)
        decode_tick = s_decode * raw_decode
        tok_s = B / decode_tick if decode_tick > 0.0 else 0.0

        chunk = policy.prefill_chunk
        raw_chunk = step_latency(
            space.cfg,
            1,
            chunk,
            space.max_model_len,
            space.hw,
            w_bits=policy.quant_bits,
            mesh_model=policy.mesh_model,
        )
        s_chunk, cal_c = self._scale("chunk", 1, chunk)
        chunk_tick = s_chunk * raw_chunk
        ttft = math.ceil(self.prompt_len / chunk) * chunk_tick

        score = tok_s
        if self.ttft_slo_s:
            score /= 1.0 + max(0.0, ttft / self.ttft_slo_s - 1.0)
        return ScoredCandidate(
            config=c,
            score=score,
            admissible=True,
            pred_decode_tok_s=tok_s,
            pred_ttft_s=ttft,
            pred_decode_tick_s=decode_tick,
            pred_chunk_tick_s=chunk_tick,
            calibrated=cal_d and cal_c,
            max_batch=B,
            num_pages=policy.num_pages,
        )
