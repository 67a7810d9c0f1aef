"""Count one train step of a batch whose sequence splits over ``data``
(distributed/sharding.py::DataSeqRows) beside the same batch on one
device, in chip_smoke.py phase 18(e)'s cell: full-width gemma2-2b cut to
2 layers, B 1 x S 4096, data=2, on meta tensors through the dry-run's
``cell_record`` (launch/dryrun.py; a ``fake``-backend world, no card).
Prints each rank's dot FLOPs, live peak, collective bytes by kind and
state at rest, and the residual a remat checkpoint saves a layer group.

    PYTHONPATH=src python scripts/seq_split_costs.py
"""
from __future__ import annotations

import json

ARCH, LAYERS, SEQ, BATCH, DATA = "gemma2-2b", 2, 4096, 1, 2


def main() -> None:
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.launch.dryrun import cell_record
    from repro_torch.launch.mesh import _mesh, dry_world
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import period_of
    cfg = get_config(ARCH).replace(num_layers=LAYERS)
    model = build_model(cfg)
    shape = ShapeConfig("train", SEQ, BATCH, "train")
    out = {}
    for data in (1, DATA):
        with dry_world(data):
            rec = cell_record(model, shape, _mesh(data, 1, "cpu", 60.0),
                              TrainConfig(), chips=data)
        rows = SEQ // data if BATCH % data else SEQ
        out[f"data={data}"] = {
            "dot_flops_per_rank": rec["dot_flops_per_device"],
            "live_bytes_per_rank": rec["live_bytes_per_device"],
            "state_bytes_per_rank": rec["state_bytes_per_device"],
            "collectives_per_rank": rec["collectives_per_device"],
            "residual_saved_per_group": BATCH * rows * cfg.d_model * 2,
            "groups": cfg.num_layers // period_of(cfg)}
    one, split = out["data=1"], out[f"data={DATA}"]
    out["flops_all_ranks_over_one_device"] = \
        DATA * split["dot_flops_per_rank"] / one["dot_flops_per_rank"]
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
