"""Paper §3+§4 push-the-button pipeline on the PyTorch port: train a tiny
LM, AMC-prune it to a FLOPs target, HAQ-quantize the pruned model under a
decode latency budget on one H100, and serve it through the weight-
quantized matmul kernels and the paged decode kernel.

    python examples/torch_compress_pipeline.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import amc, haq  # noqa: E402
from repro_torch.core.hardware_model import H100_SXM  # noqa: E402
from repro_torch.core.quantization import make_quant_dot  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.tables.common import (loss_fn,  # noqa: E402
                                       make_traced_policy_loss,
                                       trained_tiny_model)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("=== stage 0: train subject model (tiny granite) ===")
    model, params, val = trained_tiny_model("granite-3-8b", steps=80,
                                            device=args.device)
    eval_loss = loss_fn(model, val)
    base = eval_loss(params)
    print(f"base val loss: {base:.4f}")

    print("=== stage 1: AMC auto-pruning to 60% FLOPs ===")
    res_amc = amc.search(model, params, eval_loss,
                         amc.AMCConfig(target=0.6, episodes=16))
    layers = amc.enumerate_layers(model, tokens=4096)
    pruned = amc.apply_ratios(params, layers, res_amc["best"]["ratios"])
    print(f"AMC: loss {base:.4f} -> {res_amc['best']['loss']:.4f} at "
          f"{res_amc['best']['flops_frac']:.2f}x FLOPs "
          f"(ratios={['%.2f' % r for r in res_amc['best']['ratios']]})")

    print("=== stage 2: HAQ mixed-precision quantization (edge budget) ===")
    cfg_full = get_config("granite-3-8b")
    sites = haq.enumerate_sites(cfg_full, batch=1, seq=4096, decode=True)
    names = {s.name for s in sites}
    eval_policy = make_traced_policy_loss(model, pruned, val, names)
    res_haq = haq.search(cfg_full, sites, eval_policy,
                         haq.HAQConfig(episodes=12, budget_frac=0.55),
                         hw=H100_SXM)
    pol = res_haq["best"]["policy"]
    print(f"HAQ policy: { {k: v for k, v in pol.items()} }")
    print(f"HAQ: loss {res_haq['best']['loss']:.4f} at "
          f"{res_haq['best']['resource'] * 1e6:.1f}us "
          f"(budget {res_haq['best']['budget'] * 1e6:.1f}us)")

    print("=== stage 3: serve the compressed model (int kernels) ===")
    dot = make_quant_dot(dict(pol), use_kernel=True)
    prompt = torch.ones((1, 16), dtype=torch.int32, device=args.device)
    toks = generate(model, pruned, prompt, gen_len=8, dot=dot)
    print("served tokens:", toks[0, 16:].tolist())
    print("pipeline complete: prune -> quantize -> serve")
    return {"model": model, "pruned": pruned, "policy": pol,
            "prompt": prompt, "tokens": toks, "amc": res_amc["best"],
            "haq": res_haq["best"]}


if __name__ == "__main__":
    main()
