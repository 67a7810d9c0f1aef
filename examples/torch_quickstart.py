"""Quickstart on the PyTorch port: build an assigned architecture, train it
briefly on the synthetic pipeline, checkpoint, restore, and serve a few
tokens (the paged decode kernel on the card).

    python examples/torch_quickstart.py [--arch gemma2-2b] [--device cpu]
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.checkpoint.ckpt import restore  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.configs.base import (OptimConfig, ShapeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.training.loop import train  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_config(args.arch)          # reduced same-family config
    model = build_model(cfg)
    print(f"{cfg.name}: {model.param_count():,} params "
          f"(full config: {get_config(args.arch).param_count():,})")

    shape = ShapeConfig("quick", seq_len=64, global_batch=4, kind="train")
    ckpt_dir = tempfile.mkdtemp(prefix="repro_quickstart_")
    try:
        tcfg = TrainConfig(optim=OptimConfig(lr=3e-3, total_steps=args.steps,
                                             warmup_steps=3),
                           checkpoint_dir=ckpt_dir, checkpoint_every=10,
                           log_every=5)
        out = train(model, shape, tcfg, num_steps=args.steps,
                    device=args.device)
        print(f"trained: loss {out['history'][0]['loss']} -> "
              f"{out['history'][-1]['loss']}")

        state, step = restore(ckpt_dir, out["state"])
        params = state["params"]
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params), tree_leaves(out["state"]["params"])))
        print(f"restored step {step} from {ckpt_dir}: parameters "
              f"{'equal' if same else 'DIFFER'}")
        if not same:
            raise SystemExit("the restored parameters differ from the "
                             "trained ones")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    prompt = torch.ones((2, 16), dtype=torch.int32, device=args.device)
    toks = generate(model, params, prompt, gen_len=8)
    print("generated:", toks[0, 16:].tolist())
    return {"model": model, "params": params, "history": out["history"],
            "tokens": toks}


if __name__ == "__main__":
    main()
