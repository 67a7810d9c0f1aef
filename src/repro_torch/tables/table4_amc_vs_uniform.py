"""Table 4 — learning-based AMC vs the rule-based uniform shrink at equal
FLOPs (the paper's MobileNet-V1/V2 uniform-multiplier comparison). Port of
``benchmarks/table4_amc_vs_uniform.py``: tiny granite-3-8b and tiny
granite-moe-3b-a800m, each trained as the AMC subject."""
from __future__ import annotations

from repro_torch.core import amc
from repro_torch.tables.common import (loss_fn, row, time_call,
                                       trained_tiny_model)

US_PER_CALL = "measured: one Model.loss on the eval batch"
ARCHS = ("granite-3-8b", "granite-moe-3b-a800m")
FLOPS_TARGETS = (0.5, 0.7)


def main(*, subjects=None, episodes: int = 24, steps: int = 120,
         device="cuda") -> dict:
    """``subjects``: {arch: (model, params, val)} for ARCHS (trained here
    where absent)."""
    subjects = subjects or {}
    rows, bests = [], []
    for arch in ARCHS:
        model, params, val = subjects.get(arch) or trained_tiny_model(
            arch, steps=steps, device=device)
        eval_loss = loss_fn(model, val)
        base = eval_loss(params)
        for target in FLOPS_TARGETS:
            uni = amc.uniform_baseline(model, params, eval_loss, keep=target)
            res = amc.search(model, params, eval_loss,
                             amc.AMCConfig(target=target, episodes=episodes))
            us = time_call(eval_loss, params)
            d_uni = uni["loss"] - base
            d_amc = res["best"]["loss"] - base
            rows.append(row(
                f"table4/{arch}-flops{int(target * 100)}", us,
                f"base={base:.3f};d_uniform={d_uni:+.4f};d_amc={d_amc:+.4f};"
                f"amc_wins={d_amc <= d_uni + 1e-4}"))
            bests.append((res["best"], target))
    return {"rows": rows, "haq": [], "amc": bests}


if __name__ == "__main__":
    main()
