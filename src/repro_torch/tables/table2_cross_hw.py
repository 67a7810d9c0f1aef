"""Table 2 — hardware prefers specialized models: search one architecture
per hardware target, then price every architecture on every target (the
diagonal should win, as in the paper's GPU/CPU/mobile matrix). Port of
``benchmarks/table2_cross_hw.py`` on the H100 targets:
  decode-edge  — one H100,           batch 1 decode   (memory-bound)
  prefill-node — 8 cards over NVLink, batch 8 x 2048   (compute-bound)
  train-2node  — 16 cards, two nodes over InfiniBand   (collective-
                 sensitive)
"""
from __future__ import annotations

import torch

from repro_torch.core import latency_table as lt
from repro_torch.core import nas
from repro_torch.core.hardware_model import H100_2NODE16, H100_NODE8, \
    H100_SXM
from repro_torch.tables.common import row
from repro_torch.tables.table1_specialization import (arch_latency,
                                                      tiny_backbone)

US_PER_CALL = "roofline prediction on the architecture's own target (ns)"
TARGETS = {
    "decode-edge": (H100_SXM, dict(batch=1, seq=2048, decode=True)),
    "prefill-node": (H100_NODE8, dict(batch=8, seq=2048, decode=False)),
    "train-2node": (H100_2NODE16, dict(batch=8, seq=2048, decode=False)),
}


def main(*, targets=TARGETS, steps: int = 60, warmup_steps: int = 20,
         device="cuda") -> dict:
    cfg = tiny_backbone()
    data = nas.synthetic_lm_data(cfg, batch=4, seq=64, device=device)
    luts = {name: lt.build_lut(cfg, hw=hw, **kw)
            for name, (hw, kw) in targets.items()}

    archs = {}
    for name, lut in luts.items():
        ref = 0.6 * float(lt.expected_latency(
            torch.zeros((cfg.num_layers, lut.shape[1])), lut))
        res = nas.search(data, hw=targets[name][0],
                         ncfg=nas.NASConfig(steps=steps,
                                            warmup_steps=warmup_steps,
                                            batch=4, seq=64, alpha_lr=0.08,
                                            lat_ref=ref, log_every=60),
                         cfg=cfg, lut=lut, device=device)
        archs[name] = res["arch"]

    # cross matrix, normalized per column: cell = slowdown against the best
    # arch on that target (regimes have different absolute scales; the
    # paper's Table 2 point is that the DIAGONAL wins its column)
    lats = {a: {t: arch_latency(arch, luts[t]) for t in targets}
            for a, arch in archs.items()}
    col_best = {t: min(lats[a][t] for a in archs) for t in targets}
    rows = []
    for a_name in archs:
        rel = {t: lats[a_name][t] / max(col_best[t], 1e-12) for t in targets}
        derived = ";".join(f"{t}={rel[t]:.3f}x" for t in targets)
        diag_wins = rel[a_name] <= min(rel.values()) + 1e-9
        rows.append(row(f"table2/specialized-for-{a_name}",
                        lats[a_name][a_name] * 1e3,  # ns
                        derived + f";diagonal_best={diag_wins};"
                        f"arch={'|'.join(archs[a_name][:6])}"))
    return {"rows": rows, "haq": [], "amc": [], "archs": archs,
            "luts": luts, "lats": lats}


if __name__ == "__main__":
    main()
