"""The trainer loop (port of ``repro.training.loop``): checkpoint and
restart, straggler monitoring, logging — what ``launch/train.py`` drives.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         restore, save)
from repro_torch.data import pipeline as dp
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.distributed.sharding import make_ac, specs_for
from repro_torch.training import steps as steps_lib
from repro_torch.training.sharded import ShardedTrainer


def train(model, shape, tcfg, *, mesh=None, ac=None, dot=None,
          num_steps: int = 100, dcfg: Optional[dp.DataConfig] = None,
          log: Callable[[dict], None] = lambda r: print(r, flush=True),
          in_shardings=None, device=None) -> Dict:
    """Returns {state, history, straggler_events}. Resumes from
    ``tcfg.checkpoint_dir`` when it holds a checkpoint (exact: the data is
    a pure function of the step). History records ``{step, loss,
    grad_norm, dt_s}`` every ``tcfg.log_every`` steps and at the last;
    ``float(loss)`` is the step's sync point, so ``dt_s`` is the step's
    time on the host's clock, device work included. Each step trains on
    the whole global batch of ``shape``.

    ``mesh`` (a named ("data", "model") or ("pod", "data", "model")
    ``DeviceMesh``, every rank of it
    calling ``train``): the state split at rest over the mesh
    (training/sharded.py), each rank computing its rows of each
    (micro)batch (``ac``, by default ``make_ac(mesh)``), or its block of
    their sequence where no batch axis divides them and the rules split
    the sequence over ``data``; an FSDP axis that takes neither holds the
    (micro)batch whole, and the step counts it once, as the reference's
    rules place every batch. ``in_shardings`` (state
    specs, batch specs), as the reference's jit takes them, can only be
    the rules' own: ``specs_for`` of ``train_state_logical_specs`` and of
    ``batch_logical_specs``, which is also the default. Logs and ``dt_s``
    are rank 0's; checkpoints are written whole by rank 0 and restore on
    any mesh. ``device`` defaults to the card (the mesh's device type
    under a mesh); the returned state is this rank's shards."""
    if mesh is None and ac is not None:
        mesh = ac.mesh
    trainer = None
    if mesh is not None:
        ac = ac or make_ac(mesh)
        _check_layout(model, tcfg, shape, ac, in_shardings)
        trainer = ShardedTrainer(model, tcfg, ac, dot=dot)
        device = trainer.device
        step_fn = trainer.step
    else:
        if in_shardings is not None:
            raise ValueError("in_shardings needs a mesh")
        device = torch.device(device or "cuda")
        step_fn = steps_lib.make_train_step(model, tcfg, dot=dot)
    start = latest_step(tcfg.checkpoint_dir)
    if trainer is not None and start is not None:
        state, start = trainer.restore(tcfg.checkpoint_dir, start)
    else:
        gen = torch.Generator(device=device).manual_seed(tcfg.seed)
        state = trainer.init_state(gen) if trainer is not None else \
            steps_lib.init_train_state(model, tcfg, gen, device)
        if start is not None:
            state, start = restore(tcfg.checkpoint_dir, state, start)
    if start is not None:
        log({"event": "restored", "step": start})
        start += 1
    else:
        start = 0

    def host(state):        # the whole state, where it is to be written
        return state if trainer is None else trainer.host_state(state)

    ckpt = AsyncCheckpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    monitor = StragglerMonitor()
    history = []
    for step in range(start, num_steps):
        batch = dp.batch_for_model(model, shape, dcfg, step, device,
                                   full=True)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # blocks: the device sync point
        dt = time.time() - t0
        if trainer is not None:
            dt = trainer.first_rank_float(dt)
        monitor.record(step, dt)
        if step % tcfg.log_every == 0 or step == num_steps - 1:
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]), "dt_s": dt}
            history.append(rec)
            log(rec)
        if tcfg.checkpoint_every and step and \
                step % tcfg.checkpoint_every == 0:
            whole = host(state)
            if whole is not None:
                ckpt.save(step, whole)
    ckpt.wait()
    if tcfg.checkpoint_every:
        whole = host(state)
        if whole is not None:
            save(tcfg.checkpoint_dir, num_steps - 1, whole,
                 keep=tcfg.keep_checkpoints)
        if trainer is not None:     # every rank returns with it written
            trainer.barrier()
    return {"state": state, "history": history,
            "straggler_events": monitor.events}


def _check_layout(model, tcfg, shape, ac, in_shardings):
    """The layout the sharded step takes: the state as the rules place
    it, and the batch's rows split as ``ac`` splits them and no other
    dim, or, where they split over no batch axis, the sequence over
    ``data`` as the rules' batch spec splits it (each rank then takes the
    whole batch and the model cuts the sequence: ``DataSeqRows``), or
    nothing split (each rank takes the whole batch), each input as the
    rules split its own sequence (whisper's frames over data beside
    decoder tokens data does not divide); an FSDP axis neither takes
    holds the batch whole. ``in_shardings``, if given, must be that
    layout: the reference's dry-run, its one caller, passes the rules'
    own."""
    state = specs_for(steps_lib.abstract_train_state(model, tcfg),
                      steps_lib.train_state_logical_specs(model, tcfg),
                      ac.mesh)
    inputs = model.input_specs(shape)
    batch = specs_for(inputs, model.batch_logical_specs(shape), ac.mesh)
    if in_shardings is not None and tuple(in_shardings) != (state, batch):
        raise NotImplementedError(
            "in_shardings other than the rules' own (specs_for of "
            "train_state_logical_specs and batch_logical_specs)")
    rows = ac.batch_axes(shape.global_batch)
    for key, spec in batch.items():
        spec = tuple(spec)
        if rows is None:      # the sequence (dim 1) over data, or nothing
            ok = spec[:1] in ((), (None,)) and all(a is None
                                                    for a in spec[2:])
        else:
            ok = spec[:1] == (() if rows is None else (rows,)) and all(
                a is None for a in spec[1:])
        if not ok:
            raise NotImplementedError(
                f"batch {key!r} split as {spec}: the sharded trainer splits "
                f"the rows of the global batch as make_ac does ({rows}), or, "
                f"where no batch axis divides them, the sequence over data "
                f"or nothing")
