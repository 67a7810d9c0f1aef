"""Straggler detection and host heartbeats for the trainer (port of
``repro.distributed.fault_tolerance``).

Checkpoint/restart lives in the trainer loop (training/loop.py) and the
data pipeline is a pure function of the step, so a resume is exact. A
step whose time exceeds ``multiplier`` x the trailing median is a
straggler; after ``strikes`` consecutive ones the callback asks the
cluster runner to evict and replace the host. ``shrink_mesh`` sizes the
elastic re-mesh from the surviving devices (``launch.mesh.make_sub_mesh``
builds it), and ``reshard_state`` moves a sharded train state onto it.
"""
from __future__ import annotations

import dataclasses
import itertools
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


def reshard_state(state, model, tcfg, new_mesh, *, old_mesh,
                  donate: bool = False):
    """The train state split at rest over ``old_mesh``
    (training/sharded.py), split over ``new_mesh`` instead: the specs
    re-derived on the new mesh by the divisibility-aware rules, each leaf
    gathered whole over the old mesh (one at a time) and each new rank's
    block kept. Every rank of the old mesh calls it; ``new_mesh`` is this
    rank's mesh after the re-mesh (a ``DeviceMesh`` over ranks of the old
    world, such as ``make_sub_mesh``'s; a mesh of one rank holds the whole
    state), None on a rank outside it, which gets None back: it drops
    out. All-gathers move bits, so every leaf is the same bits as the old
    layout's. ``donate``: each leaf of ``state`` is set to None once it
    has moved, so a rank never holds both whole states (a full-width
    state resharded onto one card).

    ``old_mesh`` is an argument beside the reference's signature
    ``(state, model, tcfg, new_mesh)``: a rank's shards are plain tensors,
    which keep no record of the mesh they were cut on, while the
    reference's arrays carry their sharding."""
    from repro_torch.distributed.sharding import leaf_paths
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.sharded import StateLayout
    old = StateLayout(model, tcfg, old_mesh)
    new = None if new_mesh is None else StateLayout(model, tcfg, new_mesh)
    leaves = tree_leaves(state)
    out = []
    for path, a, b in zip(leaf_paths(state), old.leaf_specs(),
                          new.leaf_specs() if new else itertools.repeat(None)):
        whole = old.whole(leaves.pop(0), a)
        if donate:
            parent = state
            for key in path[:-1]:
                parent = parent[key]
            parent[path[-1]] = None
        out.append(None if new is None else new.local(whole, b))
        del whole
    return None if new is None else tree_unflatten(state, out)


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
