"""The roofline report and the Fig. 4 analogue (port of
``benchmarks/roofline_report.py``): (a) the port's dry-run records
(launch/dryrun.py, ``artifacts/dryrun_torch/*__single.json``), one row a
cell with its three-term roofline on the H100; (b) the HAQ move of
granite-3-8b's first six decode sites on one H100's roofline: operation
intensity and priced latency at bf16 and at 4-bit weights with 8-bit
activations."""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.core import haq
from repro_torch.core.hardware_model import H100_SXM
from repro_torch.launch.dryrun import ART
from repro_torch.tables.common import row

US_PER_CALL = ("roofline prediction: the dry-run's t_compute, and Fig. 4's "
               "bf16 site latency on h100-sxm")
FIG4_ARCH = "granite-3-8b"
FIG4_SITES = 6


def fig4_sites(arch: str = FIG4_ARCH):
    """The sites Fig. 4 reports: ``arch``'s first six at batch-1 decode
    over a 4096-token context."""
    return haq.enumerate_sites(get_config(arch), batch=1, seq=4096,
                               decode=True)[:FIG4_SITES]


def main(*, art=ART, hw=H100_SXM, device=None) -> dict:
    """``device`` is accepted for tables/run.py and unused: the report
    prices, it runs nothing."""
    rows = []
    recs = sorted(Path(art).glob("*__single.json"))
    if not recs:
        print(f"# roofline: no dry-run records in {art} (python -m "
              f"repro_torch.launch.dryrun --all --mesh single writes them)",
              flush=True)
    for p in recs:
        r = json.loads(p.read_text())
        rf = r["roofline"]
        derived = (f"bottleneck={rf['bottleneck']};"
                   f"t_comp={rf['t_compute_s']:.4f}s;"
                   f"t_mem={rf['t_memory_s']:.4f}s;"
                   f"t_coll={rf['t_collective_s']:.4f}s;"
                   f"useful={rf['useful_flops_ratio']:.3f};"
                   f"mfu_bound={rf['mfu_bound']:.3f}")
        rows.append(row(f"roofline/{r['arch']}__{r['shape']}",
                        rf["t_compute_s"] * 1e6, derived))

    # Fig. 4: operation intensity before (bf16) and after HAQ (mixed bits)
    for s in fig4_sites():
        i16 = float(s.cost.intensity(16, 16))
        i4 = float(s.cost.intensity(4, 8))
        t16 = s.latency(hw, 16, 16) * 1e6
        t4 = s.latency(hw, 4, 8) * 1e6
        rows.append(row(f"fig4/{s.name}", t16,
                        f"intensity_bf16={i16:.1f};intensity_haq={i4:.1f};"
                        f"lat_bf16_us={t16:.2f};lat_haq_us={t4:.2f};"
                        f"gain={t16 / max(t4, 1e-12):.2f}x"))
    return {"rows": rows, "haq": [], "amc": []}


if __name__ == "__main__":
    main()
