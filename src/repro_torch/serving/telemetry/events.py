"""Typed telemetry events: per-tick traces and per-sequence lifecycle
spans.

A **tick event** is one jitted engine dispatch — a whole-prompt prefill,
one prompt chunk, or one batched decode step — carrying the measured
wall-clock duration (fenced: the engine blocks on the dispatch's outputs
before stopping the timer, so async jit dispatch is never mistaken for
compute) *next to* the roofline-predicted duration for the same shape.
That pairing is the point of the layer: `telemetry.calibrate` fits the
two against each other per (kind, batch, q_len) and reports how far the
`core/hardware_model` roofline — the fast feedback signal of every
search loop in this repo — is from the machine it runs on.

A **sequence span** is the lifecycle of one request: enqueue -> admit ->
chunk* -> first_token -> (preempt -> requeue -> admit -> ...)* ->
finish/release. Spans yield the real time-to-first-token, queue wait,
and preemption history that `Engine.first_token_s` / the stall log used
to approximate with bare lists (both survive as thin views).

Everything here is host-side plain Python (dataclasses + floats): no
jax, so the scheduler and tests stay importable without a device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

TICK_KINDS = ("prefill", "chunk", "decode")

# sequence-span edge kinds, in lifecycle order (preempt/requeue may cycle)
SEQ_EVENTS = ("enqueue", "admit", "chunk", "first_token", "preempt",
              "requeue", "finish", "release")


@dataclasses.dataclass
class TickEvent:
    """One jitted engine dispatch, measured and predicted side by side.

    ``measured_s`` is wall clock around the dispatch *including* the
    fence (``block_until_ready`` / the host transfer of its outputs);
    ``predicted_s`` is ``admission.step_latency`` for the same (kind,
    padded_batch, q_len) — 0.0 when the policy's hardware target is
    unknown (hand-built test policies). ``batch`` is the live sequence
    count; ``padded_batch`` is the fixed jit batch that actually runs
    (idle slots ride along), which is why predictions use it.

    Page deltas are since the *previous* tick event, so admission-time
    allocations land on the step's first event and growth/trim/preempt
    frees land on the decode event that caused them.
    """
    kind: str                 # "prefill" | "chunk" | "decode"
    step: int                 # engine step() index
    t_start: float            # absolute monotonic seconds
    measured_s: float
    predicted_s: float
    batch: int                # live sequences in this dispatch
    padded_batch: int         # fixed jit batch (idle slots ride along)
    q_len: int                # query rows per sequence (1 for decode)
    tokens: int               # tokens produced / prompt tokens advanced
    rids: Tuple[int, ...] = ()
    admitted: int = 0         # admissions so far this step
    preempted: int = 0        # preemptions caused by this dispatch
    pages_allocated: int = 0  # page deltas since the previous tick event
    pages_freed: int = 0
    pages_trimmed: int = 0
    queue_depth: int = 0      # scheduler queue at emit time
    pool_free: int = 0        # free pages at emit time
    pool_allocated: int = 0   # allocated pages at emit time
    tags: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def rel_err(self) -> float:
        """|measured - predicted| / predicted (0.0 when unpredicted)."""
        if self.predicted_s <= 0.0:
            return 0.0
        return abs(self.measured_s - self.predicted_s) / self.predicted_s


@dataclasses.dataclass
class SeqEvent:
    """One edge of a sequence's lifecycle span."""
    kind: str                 # one of SEQ_EVENTS
    t: float                  # absolute monotonic seconds
    attrs: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SeqSpan:
    """All lifecycle edges of one request id, in emission order.

    A preempted request cycles admit -> preempt -> requeue -> admit; its
    derived timestamps always take the FIRST matching edge (a request's
    TTFT is when its first token was *served*, not re-computed)."""
    rid: int
    events: List[SeqEvent] = dataclasses.field(default_factory=list)

    def first(self, kind: str):
        for ev in self.events:
            if ev.kind == kind:
                return ev
        return None

    def count(self, kind: str) -> int:
        return sum(1 for ev in self.events if ev.kind == kind)

    @property
    def enqueue_t(self):
        ev = self.first("enqueue")
        return None if ev is None else ev.t

    @property
    def admit_t(self):
        ev = self.first("admit")
        return None if ev is None else ev.t

    @property
    def first_token_t(self):
        ev = self.first("first_token")
        return None if ev is None else ev.t

    @property
    def finish_t(self):
        ev = self.first("finish")
        return None if ev is None else ev.t

    def queue_wait_s(self):
        """Seconds from enqueue to first admission (None if unadmitted)."""
        if self.enqueue_t is None or self.admit_t is None:
            return None
        return self.admit_t - self.enqueue_t


@dataclasses.dataclass
class StallRecord:
    """Per-decode-tick prefill stall: the seconds this tick's already-
    ready sequences *measurably* waited on prefill work that step, next
    to the roofline's prediction for the same chunks — the quantity
    ``prefill_stall_factor`` budgets, now with both sides recorded
    (``Engine.stall_log`` is the measured-only back-compat view)."""
    measured_s: float
    predicted_s: float
