"""Bytes a rank's int8-moment update reads its scales through, on the
production meshes (training/sharded.py::ShardedTrainer._scale_view): for
each leaf whose last dim splits over ranks, the runs of gcd(block,
columns) columns that view takes (a view of the scales at rest where the
runs are whole blocks, one fp32 scale a run copied where blocks straddle
ranks), against one fp32 scale a column, and the moments' int8 codes.
Counted for m and v together, on rank 0, under a ``fake`` world (no
device, nothing allocated).

    PYTHONPATH=src python scripts/moment_view_bytes.py \\
        [--arch mistral-large-123b,llama4-maverick-400b-a17b]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.dryrun import QUANT_MOMENT_ARCHS, \
    train_cfg_for  # noqa: E402
from repro_torch.launch.mesh import dry_world, \
    make_production_mesh  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.flash import BLOCKWISE  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.training.sharded import ShardedTrainer  # noqa: E402

GIB = 2 ** 30


def view_bytes(arch: str, multi: bool) -> dict:
    """{"split_leaves", "straddling", "codes", "per_column", "runs"}: the
    leaves split along their last dim, those whose blocks straddle ranks,
    and bytes of m and v's codes, of a scale a column, of the runs'
    copied scales."""
    model = build_model(get_config(arch))
    out = dict.fromkeys(("split_leaves", "straddling", "codes",
                         "per_column", "runs"), 0)
    with dry_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        tr = ShardedTrainer(model, train_cfg_for(arch), shlib.make_ac(mesh),
                            kernel=BLOCKWISE)
        shapes = [tuple(a.shape)
                  for a in tree_leaves(tr.abstract["params"])]
        for i, spec in enumerate(tr.param_specs):
            if tr._split[i] is None:
                continue
            b, r, _, local = tr._runs(i)
            lead = math.prod(shlib.local_shape(shapes[i], spec,
                                               tr.sizes)[:-1])
            out["split_leaves"] += 1
            out["codes"] += 2 * lead * local
            out["per_column"] += 2 * 4 * lead * local
            if r != b:
                out["straddling"] += 1
                out["runs"] += 2 * 4 * lead * (local // r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=",".join(sorted(QUANT_MOMENT_ARCHS)))
    args = ap.parse_args(argv)
    for arch in args.arch.split(","):
        for mesh, multi in (("single", False), ("multi", True)):
            n = view_bytes(arch, multi)
            print(f"{arch} {mesh}: {n['split_leaves']} leaves split on "
                  f"their last dim, {n['straddling']} straddling; codes "
                  f"{n['codes'] / GIB:.4f} GiB, a scale a column "
                  f"{n['per_column'] / GIB:.4f} GiB, the runs' copied "
                  f"scales {n['runs'] / GIB:.4f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
