"""Table 3 — AMC speeds up the model: prune a trained tiny LM to 50% FLOPs
(and the "50%-latency" variant), report the priced decode latency, the
weight memory and quality before and after (the paper's MobileNet
1.81x/1.95x rows). Port of ``benchmarks/table3_amc_speedup.py``, priced on
one H100 (``h100-sxm``) where the reference prices its one TPU chip.

AMC's budget is FLOPs only, in the reference as here (``AMCConfig.mode``
is stored and never read), so "amc-50pct-latency" is a FLOPs search at a
target of 0.4.
"""
from __future__ import annotations

from repro_torch.core import amc
from repro_torch.core.hardware_model import H100_SXM, linear_cost
from repro_torch.tables.common import (loss_fn, row, time_call,
                                       trained_tiny_model)

US_PER_CALL = "measured: one Model.loss on the eval batch"
TARGETS = ((0.5, "amc-50pct-flops"), (0.4, "amc-50pct-latency"))


def model_latency_bytes(model, ratios, layers, hw=H100_SXM):
    """Priced per-token decode latency (us) and weight MiB at the given
    keep ratios on ``hw`` (attention heads scale qkv/o; FFN units scale
    both matmuls)."""
    cfg = model.cfg
    d, hd = cfg.d_model, cfg.resolved_head_dim
    lat, mem = 0.0, 0.0
    for layer, r in zip(layers, ratios):
        if layer.kind == "attn":
            c = linear_cost(1, d, int((cfg.num_heads + 2 * cfg.num_kv_heads)
                                      * hd * r))
            c2 = linear_cost(1, int(cfg.num_heads * hd * r), d)
        else:
            c = linear_cost(1, d, int(cfg.d_ff * r) * 3)
            c2 = linear_cost(1, int(cfg.d_ff * r), d)
        n = cfg.num_layers
        lat += float(c.latency(hw) + c2.latency(hw)) * n
        mem += float(c.weight_bytes + c2.weight_bytes) * n
    return lat * 1e6, mem / 2**20


def main(*, subject=None, hw=H100_SXM, episodes: int = 24, steps: int = 120,
         device="cuda") -> dict:
    model, params, val = subject or trained_tiny_model(steps=steps,
                                                       device=device)
    eval_loss = loss_fn(model, val)
    base_loss = eval_loss(params)
    layers = amc.enumerate_layers(model, tokens=4096)

    lat0, mem0 = model_latency_bytes(model, [1.0] * len(layers), layers, hw)
    rows = [row("table3/dense-100pct", time_call(eval_loss, params),
                f"loss={base_loss:.3f};sim_lat_us={lat0:.2f};"
                f"weights_MiB={mem0:.2f}")]
    bests = []
    for target, tag in TARGETS:
        res = amc.search(model, params, eval_loss,
                         amc.AMCConfig(target=target, episodes=episodes))
        ratios = res["best"]["ratios"]
        masked = amc.apply_ratios(params, layers, ratios)
        us = time_call(eval_loss, masked)
        lat, mem = model_latency_bytes(model, ratios, layers, hw)
        rows.append(row(
            f"table3/{tag}", us,
            f"loss={res['best']['loss']:.3f};sim_lat_us={lat:.2f};"
            f"weights_MiB={mem:.2f};speedup={lat0 / lat:.2f}x;"
            f"flops={res['best']['flops_frac']:.2f}"))
        bests.append((res["best"], target))
    return {"rows": rows, "haq": [], "amc": bests}


if __name__ == "__main__":
    main()
