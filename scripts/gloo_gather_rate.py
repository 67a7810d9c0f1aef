"""Rate of the sharded engine's gloo all-gather between two ranks on one
host (``distributed/sharding.py::all_gather_dim``: on a gloo group a CUDA
tensor goes through host memory, as bytes).

    PYTHONPATH=src python scripts/gloo_gather_rate.py [--mb 150] \\
        [--device cpu|cuda]

Each rank holds ``--mb`` MB of bf16 and gathers both ranks' halves, as a
rank of a model=2 mesh gathers a vocab-split embedding; prints the mean
seconds of 3 gathers after one warm-up and the gathered bytes a second.
On ``cuda`` both ranks share card 0 (chip_smoke.py phase 17's world).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.launch.mesh import spawn  # noqa: E402


def rank(r, world, device, mb):
    from repro_torch.distributed.sharding import all_gather_dim
    x = torch.zeros(mb * 10 ** 6 // 2, dtype=torch.bfloat16, device=device)
    all_gather_dim(x, 0, None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        all_gather_dim(x, 0, None)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=150)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    device = "cuda:0" if args.device == "cuda" else "cpu"
    secs = max(spawn(rank, 2, backend="gloo", device=device,
                     args=(args.mb,)))
    print(f"gloo all-gather, 2 ranks on {device}, {args.mb} MB a rank: "
          f"{secs:.3f} s, {2 * args.mb / 1e3 / secs:.3f} GB/s gathered")


if __name__ == "__main__":
    main()
