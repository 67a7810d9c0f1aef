"""Table 6 — latency-constrained HAQ vs fixed-bitwidth PACT on edge and
cloud: at the latency of uniform k-bit PACT, HAQ's mixed policy should
lose less quality (the paper: +2-5 points top-1 at matched latency). Port
of ``benchmarks/table6_haq_latency.py``: edge is one H100 decoding, cloud
an 8-card NVLink node prefilling, each priced on its roofline."""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import haq
from repro_torch.core.hardware_model import H100_NODE8, H100_SXM
from repro_torch.tables.common import (make_traced_policy_loss, row,
                                       trained_tiny_model)

US_PER_CALL = "roofline prediction on the target (us)"
ARCH = "granite-3-8b"
REGIMES = ((H100_SXM, dict(batch=1, seq=4096, decode=True), "edge"),
           (H100_NODE8, dict(batch=8, seq=4096, decode=False), "cloud"))
PACT_BITS = (4, 6, 8)


def main(*, subject=None, regimes=REGIMES, episodes: int = 20,
         steps: int = 120, device="cuda") -> dict:
    model, params, val = subject or trained_tiny_model(ARCH, steps=steps,
                                                       device=device)
    cfg = get_config(ARCH)
    rows, bests = [], []
    for hw, kw, tag in regimes:
        sites = haq.enumerate_sites(cfg, **kw)
        names = {s.name for s in sites}
        eval_policy = make_traced_policy_loss(model, params, val, names)
        loss_fp = eval_policy({n: (16, 16) for n in names})
        for bits in PACT_BITS:
            pact = {s.name: (bits, max(bits, 4)) for s in sites}
            lat_pact = haq.resource(sites, [pact[s.name] for s in sites],
                                    hw, "latency")
            loss_pact = eval_policy(pact)
            res = haq.search(cfg, sites, eval_policy,
                             haq.HAQConfig(episodes=episodes,
                                           latency_budget=lat_pact, seed=2),
                             hw=hw)
            loss_haq = res["best"]["loss"]
            lat_haq = res["best"]["resource"]
            rows.append(row(f"table6/{tag}-pact{bits}b", lat_pact * 1e6,
                            f"loss={loss_pact:.4f};fp_loss={loss_fp:.4f}"))
            rows.append(row(
                f"table6/{tag}-haq@{bits}b-budget", lat_haq * 1e6,
                f"loss={loss_haq:.4f};"
                f"haq_wins={loss_haq <= loss_pact + 1e-4}"))
            bests.append(res["best"])
    return {"rows": rows, "haq": bests, "amc": []}


if __name__ == "__main__":
    main()
