"""End-to-end example on the PyTorch port: train a ~100M-parameter LM for a
few hundred steps on the deterministic synthetic pipeline, with
checkpoint/restart and straggler monitoring — the full production loop on
one device.

    python examples/torch_train_lm.py [--steps 200] [--device cpu]

~100M config: 12L x d512 (GQA 8/4) x ff2048, vocab 32k -> 103M params.
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.base import (ModelConfig, OptimConfig,  # noqa: E402
                                      ShapeConfig, TrainConfig)
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.training.loop import train  # noqa: E402

CFG_100M = ModelConfig(
    name="repro-lm-100m",
    family="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    activation="swiglu",
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = build_model(CFG_100M)
    n_dev = torch.cuda.device_count() if args.device.startswith("cuda") \
        else 1
    print(f"{CFG_100M.name}: {model.param_count():,} params on "
          f"{n_dev} device(s)")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    tcfg = TrainConfig(
        optim=OptimConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir, checkpoint_every=50, log_every=10)
    t0 = time.time()
    out = train(model, shape, tcfg, num_steps=args.steps, device=args.device)
    dt = time.time() - t0
    h = out["history"]
    toks = args.steps * args.batch * args.seq
    print(f"loss {h[0]['loss']} -> {h[-1]['loss']} in {dt:.0f}s "
          f"({toks / dt:.0f} tok/s); straggler events: "
          f"{len(out['straggler_events'])}")
    assert h[-1]["loss"] < h[0]["loss"], "training must reduce loss"
    return {"history": h, "seconds": dt, "tokens": toks}


if __name__ == "__main__":
    main()
