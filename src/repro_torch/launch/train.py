"""Training launcher (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch gemma2-2b [--tiny] ...

Trains on the card unless ``--device cpu`` is given (``--tiny`` for a
CPU-sized model of the same family), on the reference's synthetic data
from a seed, with random initial weights from ``TrainConfig.seed``.
Checkpoints go under ``--ckpt-dir``/<arch> every ``--ckpt-every`` steps
(0: none), and a run resumes from the newest one there.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import (OptimConfig, TrainConfig, get_config,
                                 get_shape, tiny_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.serve import resolve_device
from repro_torch.models.api import build_model
from repro_torch.training.loop import train


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Train as the flags say; returns the loop's {state, history,
    straggler_events}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    shape = get_shape(args.shape)
    if args.batch or args.seq:
        shape = ShapeConfig(shape.name, args.seq or shape.seq_len,
                            args.batch or shape.global_batch, shape.kind)
    model = build_model(cfg)
    tcfg = TrainConfig(
        optim=OptimConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1)),
        checkpoint_dir=os.path.join(args.ckpt_dir, cfg.name),
        checkpoint_every=args.ckpt_every,
        microbatches=args.microbatches,
        log_every=args.log_every,
    )
    print(f"training {cfg.name}: {model.param_count():,} params, "
          f"shape=({shape.global_batch}x{shape.seq_len}), device={device}",
          flush=True)
    out = train(model, shape, tcfg, device=device, num_steps=args.steps,
                dcfg=DataConfig(cfg.vocab_size, shape.seq_len,
                                shape.global_batch))
    first, last = out["history"][0], out["history"][-1]
    print(f"loss {first['loss']:.4f} -> {last['loss']:.4f} over "
          f"{args.steps} steps; straggler events: "
          f"{len(out['straggler_events'])}", flush=True)
    return out


if __name__ == "__main__":
    main()
