"""Table 1 / Fig. 2 — a specialized model against fixed baselines on the
target hardware (priced latency; quality = val CE on the synthetic task).
Port of ``benchmarks/table1_specialization.py``, the search's latency
table priced on an 8-card H100 NVLink node where the reference prices its
TPU pod.

Baselines mirror the paper's: a uniform full-attention stack (the
"human-designed" reference), a uniform local stack ("small model"), and
the NAS-specialized architecture at a latency budget between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.supernet_lm import BACKBONE, CANDIDATE_OPS
from repro_torch.core import latency_table as lt
from repro_torch.core import nas
from repro_torch.core import supernet as sn
from repro_torch.core.hardware_model import H100_NODE8
from repro_torch.models.params import tree_map
from repro_torch.tables.common import row

US_PER_CALL = "roofline prediction of the architecture on the LUT (us)"


def tiny_backbone():
    cfg = BACKBONE.replace(num_layers=6, d_model=96, num_heads=4,
                           num_kv_heads=2, head_dim=24, d_ff=192,
                           vocab_size=512)
    return cfg.replace(ssm=cfg.ssm.__class__(
        d_state=16, expand=2, head_dim=48, n_groups=1, chunk=32))


def arch_latency(arch, lut) -> float:
    """The LUT's latency (us) of a fixed architecture."""
    one_hot = torch.from_numpy(np.eye(len(CANDIDATE_OPS), dtype=np.float32)[
        [CANDIDATE_OPS.index(op) for op in arch]])
    return float(lt.sampled_latency(one_hot, lut.cpu())) * 1e6


def eval_arch(arch, cfg, data, steps: int = 60, *, params=None,
              device="cuda") -> float:
    """Train a fixed (one-hot) architecture briefly (SGD at 3e-2, the
    gradient norm clipped at 1), return its val CE. ``params``: the
    supernet's initial parameters (a copy is trained), by default drawn
    with seed 1 on ``device``."""
    if params is None:
        params, alpha = sn.init_supernet(
            torch.Generator(device=device).manual_seed(1), device, cfg)
    else:
        params = tree_map(torch.clone, params)
        alpha = torch.zeros((cfg.num_layers, len(CANDIDATE_OPS)),
                            dtype=torch.float32, device=device)
    gates = [CANDIDATE_OPS.index(op) for op in arch]
    ncfg = nas.NASConfig(weight_lr=3e-2)
    for s in range(steps):
        nas.weight_step(params, alpha, data(s), gates, ncfg, cfg)
    with torch.no_grad():
        return float(sn.supernet_loss(params, alpha, gates, data(9999), cfg))


def main(*, hw=H100_NODE8, steps: int = 80, warmup_steps: int = 30,
         eval_steps: int = 60, device="cuda") -> dict:
    cfg = tiny_backbone()
    data = nas.synthetic_lm_data(cfg, batch=4, seq=64, device=device)
    lut = lt.build_lut(cfg, 4, 64, hw)

    baselines = {
        "uniform-full-e4": ["attn_full_e4"] * cfg.num_layers,
        "uniform-full-e2": ["attn_full_e2"] * cfg.num_layers,
        "uniform-local1k-e2": ["attn_local1k_e2"] * cfg.num_layers,
    }
    # budget: between the cheap and expensive uniform baselines
    ref = 0.75 * arch_latency(baselines["uniform-full-e4"], lut) / 1e6
    res = nas.search(data, hw=hw,
                     ncfg=nas.NASConfig(steps=steps,
                                        warmup_steps=warmup_steps, batch=4,
                                        seq=64, alpha_lr=0.08, lat_ref=ref,
                                        log_every=40),
                     cfg=cfg, lut=lut, device=device)
    candidates = dict(baselines, **{"nas-specialized": res["arch"]})

    rows = []
    for name, arch in candidates.items():
        ce = eval_arch(arch, cfg, data, eval_steps, device=device)
        rows.append(row(f"table1/{name}", arch_latency(arch, lut),
                        f"val_ce={ce:.3f}"))
    rows.append(row("table1/nas-arch", res["e_lat_us"],
                    "arch=" + "|".join(res["arch"])))
    return {"rows": rows, "haq": [], "amc": [], "search": res, "lut": lut}


if __name__ == "__main__":
    main()
