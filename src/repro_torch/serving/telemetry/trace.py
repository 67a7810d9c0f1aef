"""Chrome trace-event export + text summary.

`chrome_trace` renders a recorder's ticks and spans into the Trace Event
JSON format (the ``{"traceEvents": [...]}`` dict chrome://tracing and
https://ui.perfetto.dev load directly — see launch/serve.py
``--trace-out``). Layout:

* pid 1 ("engine ticks"): one complete ("ph":"X") slice per jitted
  dispatch on a thread per tick kind (prefill / chunk / decode), with
  measured vs predicted ms, batch composition, page deltas, and mesh
  tags in ``args`` — click a slice in Perfetto to read them;
* pid 1, counter tracks ("ph":"C"): pool free pages and queue depth
  sampled at every tick, drawn as area charts above the slices;
* pid 2 ("requests"): one async span ("ph":"b"/"e", id=rid) per request
  from enqueue to release, with instant marks ("ph":"n") for admit /
  chunk / first_token / preempt / requeue — the sequence lifecycle at a
  glance, stacked by request id.

Timestamps are microseconds since the trace clock (`Telemetry.t0`).
All values are finite by construction (`json.dumps(..., allow_nan=
False)` is asserted in tests), so the artifact always loads.
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.serving.telemetry.calibrate import calibrate
from repro_torch.serving.telemetry.recorder import Telemetry

_TICK_TID = {"prefill": 1, "chunk": 2, "decode": 3}


def _base_time(tel: Telemetry) -> float:
    if tel.t0 is not None:
        return tel.t0
    times = [ev.t_start for ev in tel.ticks]
    times += [e.t for s in tel.spans.values() for e in s.events]
    return min(times) if times else 0.0


def chrome_trace(tel: Telemetry) -> Dict:
    """Render the recorder into a Trace Event Format dict."""
    t0 = _base_time(tel)
    us = lambda t: (t - t0) * 1e6
    evs: List[Dict] = [
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "engine ticks"}},
        {"name": "process_name", "ph": "M", "pid": 2,
         "args": {"name": "requests"}},
    ]
    for kind, tid in _TICK_TID.items():
        evs.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": kind}})
    for ev in tel.ticks:
        args = {"measured_ms": ev.measured_s * 1e3,
                "predicted_ms": ev.predicted_s * 1e3,
                "batch": ev.batch, "padded_batch": ev.padded_batch,
                "q_len": ev.q_len, "tokens": ev.tokens,
                "rids": list(ev.rids), "step": ev.step,
                "admitted": ev.admitted, "preempted": ev.preempted,
                "pages_allocated": ev.pages_allocated,
                "pages_freed": ev.pages_freed,
                "pages_trimmed": ev.pages_trimmed}
        args.update(ev.tags)
        evs.append({"name": ev.kind, "cat": "tick", "ph": "X", "pid": 1,
                    "tid": _TICK_TID.get(ev.kind, 9), "ts": us(ev.t_start),
                    "dur": ev.measured_s * 1e6, "args": args})
        evs.append({"name": "pool free pages", "ph": "C", "pid": 1,
                    "ts": us(ev.t_start),
                    "args": {"free": ev.pool_free}})
        evs.append({"name": "queue depth", "ph": "C", "pid": 1,
                    "ts": us(ev.t_start),
                    "args": {"queued": ev.queue_depth}})
    for rid in sorted(tel.spans):
        span = tel.spans[rid]
        if not span.events:
            continue
        name = f"req {rid}"
        start = span.events[0].t
        end = span.events[-1].t
        evs.append({"name": name, "cat": "request", "ph": "b", "id": rid,
                    "pid": 2, "tid": 1, "ts": us(start)})
        for e in span.events:
            if e.kind in ("enqueue", "release"):
                continue
            evs.append({"name": name, "cat": "request", "ph": "n",
                        "id": rid, "pid": 2, "tid": 1, "ts": us(e.t),
                        "args": {"event": e.kind, **e.attrs}})
        evs.append({"name": name, "cat": "request", "ph": "e", "id": rid,
                    "pid": 2, "tid": 1, "ts": us(end)})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome_trace(tel: Telemetry, path: str) -> None:
    """Write the Perfetto-loadable trace JSON (finite values enforced)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f, allow_nan=False)


def summarize(tel: Telemetry) -> str:
    """Plain-text rollup: tick counts, decode tok/s, stall / TTFT / queue
    percentiles, pool watermarks, jit cache hit rates, and the roofline
    calibration table."""
    m = tel.metrics

    def pct(h, q):
        return m.histogram(h).percentile(q) * 1e3

    lines = ["telemetry summary:"]
    for kind in ("prefill", "chunk", "decode"):
        n = m.counter(f"ticks.{kind}").value
        if not n:
            continue
        h = m.histogram(f"tick.{kind}.measured_s")
        lines.append(f"  {kind:8} ticks={n:<6} measured p50="
                     f"{h.percentile(50) * 1e3:.2f}ms "
                     f"p99={h.percentile(99) * 1e3:.2f}ms")
    decode_s = m.histogram("tick.decode.measured_s").total
    decode_toks = m.counter("tokens.decode").value
    if decode_s > 0.0:
        lines.append(f"  decode tok/s (in-tick) = "
                     f"{decode_toks / decode_s:.1f}")
    if tel.stalls:
        lines.append(f"  stall p50={pct('stall.measured_s', 50):.2f}ms "
                     f"p99={pct('stall.measured_s', 99):.2f}ms "
                     f"(n={len(tel.stalls)})")
    ttft = tel.ttft_seconds()
    if ttft:
        mid = ttft[len(ttft) // 2]
        lines.append(f"  ttft p50={mid * 1e3:.1f}ms max={ttft[-1] * 1e3:.1f}"
                     f"ms (n={len(ttft)})")
    waits = tel.queue_wait_seconds()
    if waits:
        lines.append(f"  queue wait p50={waits[len(waits) // 2] * 1e3:.1f}ms "
                     f"max={waits[-1] * 1e3:.1f}ms")
    free = m.gauge("pool.free")
    if free.value is not None:
        lines.append(f"  pool free={free.value:.0f} low-water={free.min:.0f} "
                     f"preemptions={m.counter('preemptions').value}")
    occ = m.gauge("pool.occupancy")
    if occ.value is not None:
        frag = m.gauge("pool.fragmentation").value
        lines.append(f"  pool occupancy={occ.value:.2f} "
                     f"fragmentation={frag:.2f}")
    jit_bits = []
    for name in ("prefill", "pool_writer"):
        hits = m.gauge(f"jit.{name}.hits")
        if hits.value is not None:
            jit_bits.append(f"{name} {hits.value:.0f}h/"
                            f"{m.gauge(f'jit.{name}.misses').value:.0f}m")
    cache = m.gauge("jit.decode.cache_size")
    if cache.value is not None and cache.value >= 0:
        jit_bits.append(f"decode cache={cache.value:.0f}")
    if jit_bits:
        lines.append("  jit: " + "  ".join(jit_bits))
    if tel.ticks:
        lines.append(calibrate(tel.ticks).format())
    return "\n".join(lines)
