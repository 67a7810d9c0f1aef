"""Engine telemetry: per-tick tracing, a metrics registry, and roofline
predicted-vs-measured calibration.

Why this layer exists
---------------------
Every search loop in this repo (NAS, AMC, HAQ, the admission policy)
leans on `core/hardware_model`'s roofline as its fast feedback signal —
and the paper's method only holds if that signal is validated against
the real device. Before this package the engine had the inversion of
that: `admission.step_latency` *predicted* every tick, the engine
*measured* nothing but two bare lists, and no code path ever compared
the two. Telemetry closes the loop:

* **Tick trace** — every jitted dispatch (whole-prompt prefill, prompt
  chunk, batched decode) emits a typed `TickEvent` with fenced
  wall-clock duration (the engine blocks on the dispatch's outputs
  before stopping the timer, so async jit dispatch is never billed as
  compute) next to the roofline prediction for the same shape, plus
  batch composition, admissions, preemptions, page alloc/free/trim
  deltas, queue depth, pool watermarks, and per-shard mesh tags.
* **Sequence spans** — per request: enqueue -> admit -> chunk* ->
  first_token -> (preempt -> requeue -> ...)* -> finish/release,
  yielding real TTFT, queue-wait, and preemption history.
  ``Engine.stall_log`` / ``Engine.first_token_s`` survive as thin views
  over this record, so pre-telemetry tests and benches run unchanged.
* **Metrics registry** — counters/gauges/histograms (pool occupancy,
  fragmentation, free-page low-water mark, queue depth, preemptions,
  JitLRU hit/miss, per-kind tick latency). The default sink is a no-op
  (`sinks.NULL_SINK`), so the always-on path costs dataclass appends
  and integer bumps — no serialization, no export.
* **Exports + calibration** — Chrome trace-event JSON
  (`write_chrome_trace`, ``--trace-out`` in launch/serve.py, loadable
  in Perfetto), a text `summarize`, and `calibrate()`: per
  (tick kind, batch, q_len) least-squares scale factors and relative
  error of predicted vs measured — the correction `hardware_model`
  would need on this host, and the designated feedback input for the
  ROADMAP's serving-stack autotuner.

Reading a trace in Perfetto: open https://ui.perfetto.dev, drag the
``--trace-out`` JSON in. The "engine ticks" process shows one slice per
dispatch (click for measured vs predicted ms and page deltas), with
pool-free / queue-depth counter tracks above; the "requests" process
shows one span per request with instant marks at admit / chunk /
first_token / preempt.

Modules: `events` (typed event/span dataclasses), `metrics` (registry),
`sinks` (streaming extension point, NULL_SINK default), `recorder`
(the per-engine `Telemetry` object), `trace` (Chrome export + text
summary), `calibrate` (predicted-vs-measured fits).
"""
from repro_torch.serving.telemetry.calibrate import (CalibrationGroup,
                                               CalibrationReport,
                                               ScaleLookup, calibrate)
from repro_torch.serving.telemetry.events import (SEQ_EVENTS, TICK_KINDS, SeqEvent,
                                            SeqSpan, StallRecord, TickEvent)
from repro_torch.serving.telemetry.metrics import (Counter, Gauge, Histogram,
                                             MetricsRegistry)
from repro_torch.serving.telemetry.recorder import Telemetry
from repro_torch.serving.telemetry.sinks import (NULL_SINK, NullSink,
                                           RecordingSink, Sink)
from repro_torch.serving.telemetry.trace import (chrome_trace, summarize,
                                           write_chrome_trace)

__all__ = [
    "CalibrationGroup", "CalibrationReport", "ScaleLookup",
    "calibrate",
    "SEQ_EVENTS", "TICK_KINDS", "SeqEvent", "SeqSpan", "StallRecord",
    "TickEvent", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Telemetry", "NULL_SINK", "NullSink", "RecordingSink", "Sink",
    "chrome_trace", "summarize", "write_chrome_trace",
]
