"""Telemetry sinks: where events go *beyond* the recorder's own ring.

The recorder (`recorder.Telemetry`) always keeps its in-memory record —
that is what the back-compat views, `calibrate()`, and the exporters
read. A sink is the streaming extension point on top: every tick event
and sequence edge is offered to it as it happens, so a live dashboard,
a log shipper, or a test can observe the engine without polling.

`NULL_SINK` is the default and the reason telemetry is free to leave
enabled: its methods are empty, so the disabled path costs one no-op
call per event and zero serialization.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.serving.telemetry.events import SeqEvent, TickEvent


class Sink:
    """Streaming consumer interface. Subclass and override what you need;
    the base class is deliberately a no-op so partial sinks stay cheap."""

    def tick(self, ev: TickEvent) -> None:
        pass

    def seq(self, rid: int, ev: SeqEvent) -> None:
        pass

    def close(self) -> None:
        pass


class NullSink(Sink):
    """The default: drop everything (inherits the no-op methods)."""


class RecordingSink(Sink):
    """Keep every offered event in order — for tests and ad-hoc scripts
    that want the stream itself rather than the recorder's structured
    ticks/spans."""

    def __init__(self):
        self.ticks: List[TickEvent] = []
        self.seq_events: List[Tuple[int, SeqEvent]] = []

    def tick(self, ev: TickEvent) -> None:
        self.ticks.append(ev)

    def seq(self, rid: int, ev: SeqEvent) -> None:
        self.seq_events.append((rid, ev))


NULL_SINK = NullSink()
