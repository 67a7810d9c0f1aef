"""Time the dense-cache decode step (``training/steps.py::make_serve_step``)
at full width, on caches of ``init_cache`` at position ``--pos``.

    python scripts/time_dense_decode.py [--src DIR] [--arch A ...] \\
        [--batch 2] [--pos 4096] [--steps 32] [--device cuda] [--tiny]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so that two checkouts can be timed in turns in
one call on one card. Random weights from seed 0; one token a row a
step, fed the step's greedy token; 3 warm-up steps. Prints one JSON line
per arch: the median, min and max ms of a step on the host's clock after
``torch.cuda.synchronize()``, and the source timed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--arch", nargs="+",
                    default=["mamba2-370m", "zamba2-1.2b", "gemma2-2b"])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--pos", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny configs (a check on the CPU)")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.configs import get_config, tiny_config
    from repro_torch.models.api import build_model
    from repro_torch.training.steps import make_serve_step

    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for arch in args.arch:
        model = build_model((tiny_config if args.tiny else get_config)(arch))
        params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        cache = model.init_cache(args.batch, args.pos + args.steps + 3,
                                 device=dev)
        step = make_serve_step(model)
        tok = torch.full((args.batch, 1), 2, dtype=torch.int32, device=dev)
        ms = []
        for i in range(args.steps + 3):
            pos = torch.tensor(args.pos + i, device=dev)
            sync()
            t0 = time.perf_counter()
            logits, cache = step(params, cache, tok, pos)
            sync()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        ms.sort()
        print(json.dumps({"arch": arch, "src": args.src,
                          "median_ms": ms[len(ms) // 2], "min_ms": ms[0],
                          "max_ms": ms[-1], "steps": len(ms)}), flush=True)
        del params, cache
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
