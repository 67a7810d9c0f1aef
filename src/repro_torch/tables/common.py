"""Shared helpers for the per-table modules (port of
``benchmarks/common.py``).

Output contract (tables/run.py): every table prints CSV rows
``name,us_per_call,derived``, where us_per_call is the table's
representative call timed on this host (or, in the tables that price
architectures and policies, a roofline prediction: each module's
``US_PER_CALL`` says which) and ``derived`` carries the table-specific
metric (loss delta, priced latency, speedup, ...).

Every table's ``main`` takes its subject, its hardware targets and its
sizes as keyword arguments, with the reference's constants as defaults,
runs on ``device`` (the card unless the caller asks for the CPU) and
returns ``{"rows": [(name, us, derived), ...], "haq": [...], "amc":
[...]}``: the rows it printed, each HAQ search's best record and each AMC
search's best record with its FLOPs target.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from repro_torch.configs import tiny_config
from repro_torch.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro_torch.core import quantization as q
from repro_torch.data.pipeline import DataConfig, batch_for_model
from repro_torch.models.api import build_model
from repro_torch.training import steps as steps_lib


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn, *args, iters: int = 3) -> float:
    """Mean host microseconds of ``fn(*args)`` over ``iters`` calls after
    one warm-up call, the device synchronized before and after."""
    fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters * 1e6


def row(name: str, us: float, derived: str) -> Tuple[str, float, str]:
    print(f"{name},{us:.4g},{derived}", flush=True)
    return name, float(us), derived


_SUBJECTS: Dict[tuple, tuple] = {}


def trained_tiny_model(arch: str = "granite-3-8b", steps: int = 120,
                       B: int = 8, S: int = 64, seed: int = 0, *,
                       device="cuda", init_state=None):
    """A briefly trained tiny model and an eval batch (the AMC/HAQ
    subject): ``steps`` of training/steps.py's train step on
    data/pipeline.py's family-aware batches (vlm patches, encdec frames),
    from random parameters drawn with ``seed`` or from ``init_state`` (a
    train state, e.g. the reference's carried across by
    models/convert.py::from_jax_state). Returns (model, params, val).
    Memoized per argument tuple within a process (without
    ``init_state``): the tables train the same subject again and again."""
    key = (arch, steps, B, S, seed, str(torch.device(device)))
    if init_state is None and key in _SUBJECTS:
        return _SUBJECTS[key]
    cfg = tiny_config(arch)
    model = build_model(cfg)
    tcfg = TrainConfig(optim=OptimConfig(lr=5e-3, warmup_steps=4,
                                         total_steps=steps))
    state = init_state if init_state is not None else \
        steps_lib.init_train_state(
            model, tcfg, torch.Generator(device=device).manual_seed(seed),
            device)
    step = steps_lib.make_train_step(model, tcfg)
    shape = ShapeConfig("bench", S, B, "train")
    dcfg = DataConfig(cfg.vocab_size, S, B, seed=seed)
    for s in range(steps):
        state, _ = step(state, batch_for_model(model, shape, dcfg, s,
                                               device))
    val = batch_for_model(model, shape, dcfg, 10_000, device)
    out = (model, state["params"], val)
    if init_state is None:
        _SUBJECTS[key] = out
    return out


def loss_fn(model, batch):
    """``params -> float`` of ``Model.loss`` on ``batch`` (AMC's and
    the tables' quality feedback)."""
    def eval_loss(params):
        with torch.no_grad():
            return float(model.loss(params, batch))
    return eval_loss


def make_traced_policy_loss(model, params, batch, site_names):
    """``eval_policy(policy) -> float``: ``Model.loss`` with every site of
    ``policy`` in ``site_names`` fake-quantized at its (w_bits, a_bits),
    a bit width of 16 or more leaving its operand as it is (the
    reference's select). The reference jits this closure with the bits
    traced so its episodes never recompile; eager PyTorch has nothing to
    recompile, so this is a plain closure."""
    def eval_policy(policy: Dict[str, Tuple[int, int]]) -> float:
        bits = {k: v for k, v in policy.items() if k in site_names}

        def dot(x, w, name, amax=None):
            eq = q._einsum_for(x, w)
            if name not in bits:
                return torch.einsum(eq, x, w)
            w_bits, a_bits = bits[name]
            wq = w if w_bits >= 16 else q.fake_quant_weight(w, w_bits,
                                                            amax=amax)
            xq = x if a_bits >= 16 else q.fake_quant_act(x, a_bits)
            return torch.einsum(eq, xq, wq)

        with torch.no_grad():
            return float(model.loss(params, batch, dot=dot))

    return eval_policy
