"""Serve chip_smoke.py's main trace (8 prompts of 300-1200 tokens and
one of 4200, 32 new tokens each; ``--max-batch 8``, page 16, chunked
prefill, bf16 pool, random weights from seed 0) with the port's engine on
the card, and print served tok/s and the mean decode and chunk tick of
the second of two runs (the first builds and warms). ``--arch`` picks the
model (gemma2-2b by default). With ``--other DIR`` (a checkout of another
commit, such as the parent, unpacked under a git-ignored directory) that
checkout's package is served too, in turns: other, this, this, other, each
in its own process, so both are compared on one card in one call. Needs
a CUDA card.

    python scripts/bench_torch_engine_ab.py [--arch A] [--other DIR]
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve(root: Path, arch: str) -> str:
    """One process's measurement with the package under ``root/src``."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import Request
    if not Path(launch.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {launch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_config(arch))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(300, 1201, 8).tolist() + [4200]
    reqs = [Request(rid=i, prompt=rng.integers(2, model.cfg.vocab_size, S)
                    .astype(np.int32), max_new=32)
            for i, S in enumerate(lens)]
    args = launch.build_parser().parse_args(
        ["--arch", arch, "--max-batch", "8", "--page-size", "16"])
    policy = launch.make_policy(model.cfg, model, args,
                                max(len(r.prompt) + r.max_new for r in reqs))
    for _ in range(2):
        engine = launch.make_engine(model, params, policy, args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    ticks = engine.telemetry.ticks
    dec = [t.measured_s for t in ticks if t.kind == "decode"]
    chunk = [t.measured_s for t in ticks if t.kind == "chunk"]
    st = engine.stats
    return (f"{root}: {arch} {(st['decode_tokens'] + st['prefills']) / dt:.2f}"
            f" tok/s, decode {1e3 * sum(dec) / len(dec):.3f} ms, chunk "
            f"{1e3 * sum(chunk) / len(chunk):.3f} ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--other", default="")
    ap.add_argument("--root", default=str(ROOT), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not args.other:
        print(serve(Path(args.root), args.arch), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for root in (args.other, ROOT, ROOT, args.other):
        subprocess.run([sys.executable, __file__, "--arch", args.arch,
                        "--root", str(Path(root).resolve())], check=True,
                       timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
