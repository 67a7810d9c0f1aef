"""Table 5 — the best quantization policy for one hardware is not optimal
on another (the paper's HW1/HW2/HW3 matrix). Port of
``benchmarks/table5_cross_hw_quant.py``.

Each target constrains its own binding resource, as in the reference:
  HW1 edge-decode   : LATENCY budget on one H100 (decode is memory-bound,
                      so fewer bits read fewer bytes)
  HW2 node-prefill  : ENERGY budget on an 8-card NVLink node
                      (compute-bound; energy tracks bits)
  HW3 2node-capacity: SIZE budget on two nodes over InfiniBand (weight
                      bytes)
The H100 prices weights of 8 bits or fewer on its int8 tensor-core peak,
so below 8 bits only bytes move a latency, as on the reference's TPU. The
energy constants are the reference's literature values, not the card's
(core/hardware_model.py). The cross matrix reports each policy's resource
under every target's constraint, over that target's budget (<= 1 is
feasible); the diagonal is the paper's claim, printed, not asserted.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import haq
from repro_torch.core.hardware_model import H100_2NODE16, H100_NODE8, \
    H100_SXM
from repro_torch.tables.common import (make_traced_policy_loss, row,
                                       trained_tiny_model)

US_PER_CALL = "the policy's resource on its own target, % of its budget"
TARGETS = {
    "HW1-edge-lat": (H100_SXM, dict(batch=1, seq=4096, decode=True),
                     "latency", 0.6),
    "HW2-node-energy": (H100_NODE8, dict(batch=8, seq=4096, decode=False),
                        "energy", 0.55),
    "HW3-2node-size": (H100_2NODE16, dict(batch=32, seq=4096, decode=False),
                       "size", 0.45),
}
FULL_ARCH = "granite-3-8b"


def main(*, subject=None, targets=TARGETS, episodes: int = 20,
         steps: int = 120, device="cuda") -> dict:
    model, params, val = subject or trained_tiny_model(FULL_ARCH,
                                                       steps=steps,
                                                       device=device)
    cfg_full = get_config(FULL_ARCH)
    site_sets = {n: haq.enumerate_sites(cfg_full, **kw)
                 for n, (hw, kw, mode, frac) in targets.items()}
    names = [s.name for s in next(iter(site_sets.values()))]
    eval_policy = make_traced_policy_loss(model, params, val, set(names))

    budgets, policies, losses, bests = {}, {}, {}, []
    for n, (hw, kw, mode, frac) in targets.items():
        sites = site_sets[n]
        base = haq.resource(sites, [(8, 8)] * len(sites), hw, mode)
        budgets[n] = frac * base
        res = haq.search(cfg_full, sites, eval_policy,
                         haq.HAQConfig(episodes=episodes, budget_frac=frac,
                                       mode=mode, seed=1), hw=hw)
        policies[n] = res["best"]["policy"]
        losses[n] = res["best"]["loss"]
        bests.append(res["best"])

    rows = []
    for pn, pol in policies.items():
        cells = {}
        for tn, (hw, kw, mode, frac) in targets.items():
            wa = [pol.get(s.name, (8, 8)) for s in site_sets[tn]]
            used = haq.resource(site_sets[tn], wa, hw, mode)
            cells[tn] = used / budgets[tn]
        derived = ";".join(f"{t}={cells[t]:.2f}xbudget" for t in targets)
        rows.append(row(f"table5/policy-for-{pn}", cells[pn] * 100,
                        derived + f";loss={losses[pn]:.4f};"
                        f"feasible_on_own_hw={cells[pn] <= 1.001}"))
    return {"rows": rows, "haq": bests, "amc": []}


if __name__ == "__main__":
    main()
