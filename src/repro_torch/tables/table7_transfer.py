"""Table 7 — agent transfer: HAQ agents trained on arch A, applied with no
further training to arch B, against a direct search on B and fixed PACT.
Port of ``benchmarks/table7_transfer.py``: granite-3-8b to
llava-next-mistral-7b (its subject's batches carry patches), decode on one
H100."""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.core import haq
from repro_torch.core.hardware_model import H100_SXM
from repro_torch.tables.common import (make_traced_policy_loss, row,
                                       trained_tiny_model)

US_PER_CALL = "none (0.0): the rows are losses"
ARCH_A, ARCH_B = "granite-3-8b", "llava-next-mistral-7b"
KW = dict(batch=1, seq=4096, decode=True)


def setup(arch, subject):
    model, params, val = subject
    cfg = get_config(arch)
    sites = haq.enumerate_sites(cfg, **KW)
    names = {s.name for s in sites}
    return cfg, sites, make_traced_policy_loss(model, params, val, names)


def main(*, subjects=None, hw=H100_SXM, episodes: int = 20,
         steps: int = 120, device="cuda") -> dict:
    """``subjects``: {arch: (model, params, val)} for ARCH_A and ARCH_B
    (trained here where absent)."""
    subjects = subjects or {}
    cfg_a, sites_a, eval_a = setup(ARCH_A, subjects.get(ARCH_A) or
                                   trained_tiny_model(ARCH_A, steps=steps,
                                                      device=device))
    cfg_b, sites_b, eval_b = setup(ARCH_B, subjects.get(ARCH_B) or
                                   trained_tiny_model(ARCH_B, steps=steps,
                                                      device=device))

    res_a = haq.search(cfg_a, sites_a, eval_a,
                       haq.HAQConfig(episodes=episodes, budget_frac=0.6,
                                     seed=3), hw=hw)
    res_b = haq.search(cfg_b, sites_b, eval_b,
                       haq.HAQConfig(episodes=episodes, budget_frac=0.6,
                                     seed=3), hw=hw)
    # transfer: A's agents on B's env with ZERO episodes of training
    env_b = haq.HAQEnv(cfg_b, sites_b, eval_b,
                       haq.HAQConfig(budget_frac=0.6), hw=hw)
    transfer = env_b.rollout(*res_a["agents"], explore=False)

    pact = {s.name: (4, 4) for s in sites_b}
    loss_pact = eval_b(pact)
    rows = [
        row("table7/pact-4bit", 0.0, f"loss={loss_pact:.4f}"),
        row("table7/direct-search-B", 0.0,
            f"loss={res_b['best']['loss']:.4f}"),
        row("table7/transfer-A-to-B", 0.0,
            f"loss={transfer['loss']:.4f};"
            f"close_to_direct={transfer['loss'] <= res_b['best']['loss'] + 0.1};"
            f"beats_pact={transfer['loss'] <= loss_pact + 1e-4}")]
    return {"rows": rows, "haq": [res_a["best"], res_b["best"], transfer],
            "amc": [], "transfer": transfer}


if __name__ == "__main__":
    main()
