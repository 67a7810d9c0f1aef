"""Straggler detection and host heartbeats for the trainer (port of
``repro.distributed.fault_tolerance``).

Checkpoint/restart lives in the trainer loop (training/loop.py) and the
data pipeline is a pure function of the step, so a resume is exact. A
step whose time exceeds ``multiplier`` x the trailing median is a
straggler; after ``strikes`` consecutive ones the callback asks the
cluster runner to evict and replace the host. ``shrink_mesh`` sizes the
elastic re-mesh from the surviving devices; the reference's
``reshard_state`` needs the train state's logical specs and waits for
sharded training (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    window: int = 16  # trailing steps for the median
    multiplier: float = 2.0  # deadline = multiplier x median
    strikes: int = 3  # consecutive violations before eviction


class StragglerMonitor:
    """Flags slow steps; ``on_straggler`` gets the event after ``strikes``
    consecutive breaches (in a deployment: evict and replace the host)."""

    def __init__(
        self,
        cfg: StragglerConfig = StragglerConfig(),
        on_straggler: Optional[Callable[[dict], None]] = None,
    ):
        self.cfg = cfg
        self.times: Deque[float] = deque(maxlen=cfg.window)
        self.strikes = 0
        self.events: List[dict] = []
        self.on_straggler = on_straggler

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step breached the deadline."""
        breached = False
        if len(self.times) >= 4:
            med = float(np.median(self.times))
            if dt > self.cfg.multiplier * med:
                self.strikes += 1
                breached = True
                ev = {
                    "step": step,
                    "dt": dt,
                    "median": med,
                    "strikes": self.strikes,
                }
                self.events.append(ev)
                if self.strikes >= self.cfg.strikes and self.on_straggler:
                    self.on_straggler(ev)
                    self.strikes = 0
            else:
                self.strikes = 0
        self.times.append(dt)
        return breached


def shrink_mesh(n_devices: int, model_axis: int):
    """Largest (data, model) mesh from ``n_devices`` surviving devices
    (elastic re-mesh): the model axis stays whole (tensor-parallel groups
    must), devices past the largest multiple of it are dropped. Returns
    ((data, model), the ranks kept: the first data * model of a world
    renumbered over the survivors), for ``launch.mesh.make_serving_mesh``
    in a world of that size."""
    data = n_devices // model_axis
    if data < 1:
        raise ValueError(f"{n_devices} devices cannot hold a model axis of "
                         f"{model_axis}")
    return (data, model_axis), list(range(data * model_axis))


class Heartbeat:
    """Host-liveness file heartbeat: each host touches its file every
    step; a coordinator declares a host dead after ``timeout_s`` of
    silence."""

    def __init__(self, path: str, timeout_s: float = 60.0):
        self.path = path
        self.timeout_s = timeout_s

    def beat(self):
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def alive(self) -> bool:
        try:
            with open(self.path) as f:
                return time.time() - float(f.read()) < self.timeout_s
        except (FileNotFoundError, ValueError):
            return False
