"""Paper §2 end to end on the PyTorch port: search a specialized LM
architecture for a chosen H100 target with the path-binarized supernet and
the latency LUT.

    python examples/torch_nas_specialize.py --target decode-edge \\
        [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.supernet_lm import BACKBONE  # noqa: E402
from repro_torch.core import latency_table as lt  # noqa: E402
from repro_torch.core import nas  # noqa: E402
from repro_torch.core.hardware_model import (H100_2NODE16,  # noqa: E402
                                             H100_NODE8, H100_SXM)

TARGETS = {
    "decode-edge": (H100_SXM, dict(batch=1, seq=2048, decode=True)),
    "prefill-node": (H100_NODE8, dict(batch=8, seq=2048, decode=False)),
    "train-2node": (H100_2NODE16, dict(batch=8, seq=2048, decode=False)),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", default="decode-edge", choices=TARGETS)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = BACKBONE.replace(num_layers=args.layers, d_model=96, num_heads=4,
                           num_kv_heads=2, head_dim=24, d_ff=192,
                           vocab_size=512)
    cfg = cfg.replace(ssm=cfg.ssm.__class__(d_state=16, expand=2, head_dim=48,
                                            n_groups=1, chunk=32))
    hw, kw = TARGETS[args.target]
    lut = lt.build_lut(cfg, hw=hw, **kw)
    print(f"searching {7 ** cfg.num_layers:,}-arch space for {args.target} "
          f"({hw.name})")
    res = nas.search(
        nas.synthetic_lm_data(cfg, batch=4, seq=64, device=args.device),
        hw=hw,
        ncfg=nas.NASConfig(steps=args.steps, warmup_steps=args.steps // 3,
                           batch=4, seq=64, alpha_lr=0.08,
                           log_every=max(args.steps // 4, 1)),
        cfg=cfg, lut=lut, device=args.device,
        progress=lambda r: print(f"  step {r['step']:4d} "
                                 f"ce={r['val_ce']:.3f} "
                                 f"E[lat]={r['e_lat_us']:.2f}us"))
    print(f"\nspecialized arch for {args.target}:")
    for i, op in enumerate(res["arch"]):
        print(f"  block {i:2d}: {op}")
    print(f"E[LAT] {res['e_lat_us']:.2f}us vs budget "
          f"{res['lat_ref_us']:.2f}us")
    return {"search": res, "lut": lut, "cfg": cfg}


if __name__ == "__main__":
    main()
