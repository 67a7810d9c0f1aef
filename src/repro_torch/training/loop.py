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
from repro_torch.training import steps as steps_lib


def train(model, shape, tcfg, *, device="cuda", dot=None,
          num_steps: int = 100,
          dcfg: Optional[dp.DataConfig] = None,
          log: Callable[[dict], None] = lambda r: print(r, flush=True)
          ) -> Dict:
    """Returns {state, history, straggler_events}. Resumes from
    ``tcfg.checkpoint_dir`` when it holds a checkpoint (exact: the data is
    a pure function of the step). History records ``{step, loss,
    grad_norm, dt_s}`` every ``tcfg.log_every`` steps and at the last;
    ``float(loss)`` is the step's sync point, so ``dt_s`` is the step's
    time on the host's clock, device work included."""
    device = torch.device(device)
    step_fn = steps_lib.make_train_step(model, tcfg, dot=dot)
    start = latest_step(tcfg.checkpoint_dir)
    state = steps_lib.init_train_state(
        model, tcfg, torch.Generator(device=device).manual_seed(tcfg.seed),
        device)
    if start is not None:
        state, start = restore(tcfg.checkpoint_dir, state)
        log({"event": "restored", "step": start})
        start += 1
    else:
        start = 0

    ckpt = AsyncCheckpointer(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
    monitor = StragglerMonitor()
    history = []
    for step in range(start, num_steps):
        batch = dp.batch_for_model(model, shape, dcfg, step, device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])  # blocks: the device sync point
        dt = time.time() - t0
        monitor.record(step, dt)
        if step % tcfg.log_every == 0 or step == num_steps - 1:
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]), "dt_s": dt}
            history.append(rec)
            log(rec)
        if tcfg.checkpoint_every and step and \
                step % tcfg.checkpoint_every == 0:
            ckpt.save(step, state)
    ckpt.wait()
    if tcfg.checkpoint_every:
        save(tcfg.checkpoint_dir, num_steps - 1, state,
             keep=tcfg.keep_checkpoints)
    return {"state": state, "history": history,
            "straggler_events": monitor.events}
