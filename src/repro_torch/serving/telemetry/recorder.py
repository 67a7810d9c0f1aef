"""The telemetry recorder the engine (and scheduler) write into.

One `Telemetry` instance per engine: tick events, sequence spans, stall
records, and the metrics registry live here; a `Sink` (NULL_SINK by
default) additionally sees every event as it happens. The recorder is
jax-free and clock-injectable, so scheduler tests and synthetic
calibration fixtures run without a device or real time.

The monotonic trace clock (`t0`) starts at the engine's first step (or
first recorded event) and resets with `reset()`, matching the engine's
pre-telemetry behaviour where benchmarks re-time a warmed instance:
warm run -> `Engine.reset_stats()` -> timed run re-stamps everything
relative to the timed run's start.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.serving.telemetry.events import (SeqEvent, SeqSpan, StallRecord,
                                            TickEvent)
from repro_torch.serving.telemetry.metrics import MetricsRegistry
from repro_torch.serving.telemetry.sinks import NULL_SINK, Sink


class Telemetry:
    def __init__(self, sink: Optional[Sink] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.sink = sink if sink is not None else NULL_SINK
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.clock = clock
        self.ticks: List[TickEvent] = []
        self.spans: Dict[int, SeqSpan] = {}
        self.stalls: List[StallRecord] = []
        self.t0: Optional[float] = None

    # -------------------------------------------------------------- clock --
    def start_clock(self) -> float:
        """Start (idempotently) the trace clock; returns t0."""
        if self.t0 is None:
            self.t0 = self.clock()
        return self.t0

    def now(self) -> float:
        return self.clock()

    def rel(self, t: Optional[float]) -> Optional[float]:
        """Absolute monotonic -> seconds since the trace clock started."""
        if t is None:
            return None
        return t - (self.t0 if self.t0 is not None else t)

    # ------------------------------------------------------------- emitters --
    def tick(self, ev: TickEvent) -> None:
        """Record one tick event and roll it into the metrics registry."""
        self.ticks.append(ev)
        m = self.metrics
        m.counter(f"ticks.{ev.kind}").inc()
        m.counter(f"tokens.{ev.kind}").inc(ev.tokens)
        if ev.preempted:
            m.counter("preemptions").inc(ev.preempted)
        m.gauge("pool.free").set(ev.pool_free)        # .min = low-water mark
        m.gauge("pool.allocated").set(ev.pool_allocated)
        m.gauge("queue.depth").set(ev.queue_depth)
        m.histogram(f"tick.{ev.kind}.measured_s").observe(ev.measured_s)
        if ev.predicted_s > 0.0:
            m.histogram(f"tick.{ev.kind}.rel_err").observe(ev.rel_err)
        self.sink.tick(ev)

    def seq_event(self, rid: int, kind: str, **attrs) -> SeqEvent:
        """Append one lifecycle edge to ``rid``'s span."""
        span = self.spans.get(rid)
        if span is None:
            span = self.spans[rid] = SeqSpan(rid)
        ev = SeqEvent(kind=kind, t=self.clock(), attrs=attrs)
        span.events.append(ev)
        self.sink.seq(rid, ev)
        return ev

    def stall(self, measured_s: float, predicted_s: float) -> None:
        """Record one decode tick's prefill stall (measured + predicted)."""
        self.stalls.append(StallRecord(measured_s, predicted_s))
        self.metrics.histogram("stall.measured_s").observe(measured_s)

    # ---------------------------------------------------------------- views --
    def stall_log_view(self) -> List[float]:
        """Measured per-decode-tick stall seconds — the exact list
        ``Engine.stall_log`` exposed before telemetry existed."""
        return [r.measured_s for r in self.stalls]

    def first_token_view(self) -> Dict[int, float]:
        """rid -> time-to-first-token seconds relative to the trace clock
        (first ``first_token`` edge only: a preempted request's re-served
        extension never moves its TTFT) — the ``Engine.first_token_s``
        back-compat view."""
        out = {}
        for rid, span in self.spans.items():
            t = span.first_token_t
            if t is not None:
                out[rid] = self.rel(t)
        return out

    def ttft_seconds(self) -> List[float]:
        return sorted(self.first_token_view().values())

    def queue_wait_seconds(self) -> List[float]:
        out = []
        for span in self.spans.values():
            w = span.queue_wait_s()
            if w is not None:
                out.append(w)
        return sorted(out)

    # ---------------------------------------------------------------- admin --
    def reset(self) -> None:
        """Drop all recorded state and restart the trace clock on the
        next event (Engine.reset_stats delegates here)."""
        self.ticks.clear()
        self.spans.clear()
        self.stalls.clear()
        self.metrics.reset()
        self.t0 = None

    def close(self) -> None:
        self.sink.close()
