"""Dry-run on the production meshes (port of ``repro.launch.dryrun``):
trace one step of every (arch x shape) cell as rank 0 of the mesh, on
meta tensors, count its costs (roofline/step_costs.py) and derive the
three-term roofline on the H100 (roofline/analysis.py). Runs on the CPU
with no card and no process group of its own: each cell makes a world of
256 (``single``: data 16 x model 16) or 512 ranks (``multi``: pod 2 x
data 16 x model 16) under torch's ``fake`` backend
(launch/mesh.py::dry_world).

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --cells mamba2-370m:decode_32k,...
Records go to artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json (or
--out-dir); pass --force to recompute a cell, --jobs N to run N cells at
once, each in a process of its own.

A record has the reference's keys, with these changes: ``fits_hbm`` and
``state_fits_hbm`` stand against the H100's 80 GiB where the reference
has ``fits_16GiB``; ``trace_s`` (the counted run) stands in place of
``lower_s`` and ``compile_s``; ``memory`` holds the counted run's
argument, output, alias and temporary bytes and ``peak_bytes``.
``weight_bits`` holds the stored weights' average bits (16 without
``--quant``), which the roofline's memory term reads.
``hlo_chars``, ``roofline_raw_xla``, ``memory.code_bytes`` and
``--save-hlo`` are left out: no HLO exists, and ``roofline_raw_xla`` is
the reference's reading of XLA's ``cost_analysis``, which has no torch
counterpart.

Train cells run ``ShardedTrainer``'s step (training/sharded.py) on the
rank's shards of ``abstract_train_state`` and its rows of
``Model.input_specs`` (in more than 4 microbatches, the step at 3 and 4
microbatches of as many rows, extended to M:
roofline/step_costs.py::count_repeated); prefill and decode cells the
sharded serving steps (training/sharded_serve.py) on the rank's shards
of the parameters, the global batch or token (of which a step takes the
rank's rows) and,
for decode, the rank's blocks of the dense cache, as the reference's
``build_step`` places them: every family, the ssm and hybrid families'
mamba state and the encoder-decoder's memory included. State bytes are
the parameters' (and the optimizer's for train, the cache's for decode),
as the reference counts them. Flash attention runs its blockwise plain forward
(models/flash.py::blockwise_forward): the dense plain version's products,
one 512-row q block's scores alive at a time. ``--quant w8|w4|haq`` serves
prefill and decode cells on stored int8/int4 weights (``quantize_defs``'
tree at rest, ``dequant_dot`` inside ``tp_dot``'s sites), the policy
``quant_policy_for``'s on the H100; train cells ignore it, as the
reference's do. ``--ac-mode seq_tp`` runs every cell under
``make_ac(mesh, "seq_tp")`` (the residual's rows split over ``model``
between sub-layers in train and prefill cells; a decode step's one row
is not split); its records are named with ``_seq_tp`` before the tag. A
cell the port cannot run is refused with the ROADMAP item that would lift
the refusal.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import (OptimConfig, TrainConfig, assigned_cells,
                                 get_config, get_shape)
from repro_torch.core import haq
from repro_torch.core.hardware_model import H100_SXM
from repro_torch.distributed import sharding as shlib
from repro_torch.launch.mesh import dry_world, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.models.flash import BLOCKWISE
from repro_torch.models.params import (abstract_params, tree_leaves,
                                       tree_unflatten)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import step_costs
from repro_torch.serving import quant as sq
from repro_torch.training.sharded import ShardedTrainer
from repro_torch.training.sharded_serve import ShardedServeSteps

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# archs whose optimizer state only fits 16GiB/chip with int8 Adam moments
QUANT_MOMENT_ARCHS = {"llama4-maverick-400b-a17b", "mistral-large-123b"}


class Refused(Exception):
    """A cell the port cannot run yet; the message names its ROADMAP
    item."""


def train_cfg_for(arch: str, microbatches: int = 1) -> TrainConfig:
    return TrainConfig(optim=OptimConfig(
        quantized_moments=arch in QUANT_MOMENT_ARCHS),
        microbatches=microbatches)


def quant_policy_for(cfg, mode: str, hw=H100_SXM):
    """(policy, default bits) of ``--quant mode``: w8 and w4 every weight
    at 8 or 4 bits; haq the paper's budget back-off (section 4) from W8A16
    down to 0.55 of its decode latency on ``hw``'s roofline, a
    deterministic stand-in for the trained agent (the reference prices it
    on its TPU pod)."""
    if mode == "w8":
        return None, 8
    if mode == "w4":
        return None, 4
    sites = haq.enumerate_sites(cfg, batch=128, seq=1, decode=True)
    wa = [(8, 16)] * len(sites)
    budget = 0.55 * haq.resource(sites, wa, hw, "latency")
    wa = haq.enforce_budget(sites, wa, hw, budget, "latency")
    return {s.name: w for s, (w, a) in zip(sites, wa)}, 8


def local_tree(abstract, specs, mesh):
    """This rank's shard of every leaf of ``abstract`` under ``specs``,
    as meta tensors of their own."""
    return tree_unflatten(abstract, [
        torch.empty(shlib.local_shape(tuple(a.shape), s, mesh),
                    dtype=a.dtype, device="meta")
        for a, s in zip(tree_leaves(abstract),
                        shlib.leaves_like(abstract, specs))])


def build_step(model, shape, mesh, tcfg, quant: str = "",
               ac_mode: str = "dp"):
    """(fn, args, state, weight_bits): the step this rank runs and its
    meta arguments, its shards of the state and its rows of the batch;
    ``state`` lists the (abstract tree, specs) pairs whose bytes a device
    holds at rest. ``quant`` (prefill and decode cells): the weights
    stored per ``quant_policy_for``. Raises ``Refused`` for a cell the
    port cannot run yet."""
    quant = quant if shape.kind != "train" else ""
    try:
        ac = shlib.make_ac(mesh, mode=ac_mode)
        if shape.kind == "train":
            trainer = ShardedTrainer(model, tcfg, ac, kernel=BLOCKWISE)
        else:
            steps = ShardedServeSteps(model, ac, kernel=BLOCKWISE,
                                      dot=sq.dequant_dot if quant else None)
    except (NotImplementedError, ValueError) as e:
        raise Refused(str(e)) from None
    if shape.kind == "train":
        state = local_tree(trainer.abstract, trainer.specs, mesh)
        rows, ac = trainer.rows(model.input_specs(shape))
        batch = {k: v.clone() for k, v in rows.items()}
        return functools.partial(trainer.local_step, ac=ac), (state, batch), \
            [(trainer.abstract, trainer.specs)], 16.0
    defs, weight_bits = model.defs, 16.0
    if quant:
        policy, bits = quant_policy_for(model.cfg, quant)
        defs = sq.quantize_defs(defs, policy=policy, default_bits=bits)
        weight_bits = sq.avg_weight_bits(defs)
    abstract = abstract_params(defs)
    specs = steps.param_layout(abstract)[0]
    params = local_tree(abstract, specs, mesh)
    held = [(abstract, specs)]
    ins = model.input_specs(shape)
    if shape.kind == "prefill":
        return steps.prefill, (params, ins), held, weight_bits
    cache = steps.place_cache(ins["cache"])
    held.append((ins["cache"], shlib.specs_for(
        ins["cache"], model.batch_logical_specs(shape)["cache"], mesh)))
    return steps.decode, (params, cache, ins["token"], ins["pos"]), held, \
        weight_bits


def sharded_bytes_per_device(abstract, specs, mesh) -> int:
    """Exact persistent per-device bytes for a (state/cache) tree under
    its specs: each leaf's ``local_shape`` times its element size."""
    total = 0
    for a, s in zip(tree_leaves(abstract), shlib.leaves_like(abstract,
                                                              specs)):
        n = 1
        for d in shlib.local_shape(tuple(a.shape), s, mesh):
            n *= d
        total += n * a.element_size()
    return total


def cell_record(model, shape, mesh, tcfg, *, chips: int, quant: str = "",
                ac_mode: str = "dp") -> dict:
    """The dry-run's record of one step of ``model`` at ``shape`` on
    ``mesh`` (this process its rank 0), without the cell's names."""
    cfg = model.cfg
    t0 = time.time()
    fn, args, held, weight_bits = build_step(model, shape, mesh, tcfg,
                                             quant=quant, ac_mode=ac_mode)
    state_bytes = sum(sharded_bytes_per_device(a, s, mesh)
                      for a, s in held)
    if shape.kind == "train":       # M microbatches of B / M rows
        del fn, args
        M = tcfg.microbatches

        def step_of(m):
            return build_step(
                model, dataclasses.replace(
                    shape, global_batch=m * shape.global_batch // M),
                mesh, dataclasses.replace(tcfg, microbatches=m),
                quant=quant, ac_mode=ac_mode)[:2]
        costs = step_costs.count_repeated(step_of, M)
    else:
        costs = step_costs.count_step(fn, *args)
    t_trace = time.time() - t0
    roof = ra.analyze_counted(
        costs, chips, cfg, shape, weight_bits=weight_bits,
        quantized_moments=tcfg.optim.quantized_moments)
    mem = {"argument_bytes": costs["arg_bytes"],
           "output_bytes": costs["out_bytes"],
           "alias_bytes": costs["alias_bytes"],
           "temp_bytes": costs["peak_bytes"] - costs["arg_bytes"],
           "peak_bytes": costs["peak_bytes"]}
    live = costs["peak_bytes"]
    return {
        "chips": chips,
        "params": model.param_count(),
        "active_params": ra.active_params(cfg),
        "trace_s": round(t_trace, 2),
        "memory": mem,
        "live_bytes_per_device": live,
        "state_bytes_per_device": state_bytes,
        "weight_bits": weight_bits,
        "fits_hbm": bool(live <= ra.HBM_BYTES),
        "state_fits_hbm": bool(state_bytes <= ra.HBM_BYTES),
        "collectives_per_device": {
            k: costs[k] for k in ra.COLLECTIVES + ("coll_count",)
            if costs[k]},
        "dot_flops_per_device": costs["dot_flops"],
        "roofline": roof.to_dict(),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             out_dir: Path = ART, tag: str = "", quant: str = "",
             microbatches: int = 1, ac_mode: str = "dp") -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    multi = mesh_kind == "multi"
    chips = 512 if multi else 256
    model = build_model(cfg)
    tcfg = train_cfg_for(arch, microbatches)
    with dry_world(chips):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               **cell_record(model, shape, mesh, tcfg, chips=chips,
                             quant=quant, ac_mode=ac_mode)}
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_kind}{tag}"
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
    gc.collect()
    return rec


def _run(job):
    """One cell for ``main``: ("ok", record), ("refused", message) or
    ("fail", (repr, traceback))."""
    (arch, shape, mesh_kind), kw = job
    try:
        return "ok", run_cell(arch, shape, mesh_kind, **kw)
    except Refused as e:
        return "refused", str(e)
    except Exception as e:  # noqa: BLE001 — report and continue
        return "fail", (repr(e), traceback.format_exc())


def _results(jobs, n: int):
    """``_run`` over ``jobs`` in order: here, or in ``n`` spawned
    processes."""
    if n <= 1:
        yield from map(_run, jobs)
        return
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(n, mp_context=mp.get_context("spawn")) as ex:
        yield from ex.map(_run, jobs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default="",
                    help="comma-separated arch:shape cells, in place of "
                         "--arch/--shape or --all")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", type=Path, default=ART)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    ap.add_argument("--quant", default="", choices=["", "w8", "w4", "haq"],
                    help="quantized-weight serving (prefill/decode cells; "
                         "train cells ignore it)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation for train cells")
    ap.add_argument("--ac-mode", default="dp", choices=["dp", "seq_tp"],
                    help="activation sharding: dp | seq_tp (sequence-"
                         "parallel TP; records named _seq_tp)")
    args = ap.parse_args(argv)
    if not args.all and not args.cells and not (args.arch and args.shape):
        ap.error("give --arch and --shape, --cells, or --all")

    t0 = time.time()
    cells = assigned_cells() if args.all else \
        [tuple(c.split(":")) for c in args.cells.split(",")] if args.cells \
        else [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    tag = ("_seq_tp" if args.ac_mode == "seq_tp" else "") + args.tag
    kw = dict(out_dir=args.out_dir, tag=tag, quant=args.quant,
              microbatches=args.microbatches, ac_mode=args.ac_mode)
    failures, refused, ran, todo = [], [], 0, []
    for arch, shape in cells:
        for mesh_kind in meshes:
            name = f"{arch}__{shape}__{mesh_kind}{tag}"
            path = args.out_dir / f"{name}.json"
            if path.exists() and not args.force:
                rec = json.loads(path.read_text())
                print(f"[cached] {name}: {rec['roofline']['bottleneck']}-bound"
                      f" live={rec['live_bytes_per_device']/2**30:.2f}GiB")
                ran += 1
            else:
                todo.append(((arch, shape, mesh_kind), kw))
    for ((arch, shape, mesh_kind), _), (status, out) in zip(
            todo, _results(todo, args.jobs)):
        name = f"{arch}__{shape}__{mesh_kind}{tag}"
        if status == "ok":
            r = out["roofline"]
            ran += 1
            print(f"[ok {out['trace_s']:6.1f}s] {name}: "
                  f"comp={r['t_compute_s']:.4f}s "
                  f"mem={r['t_memory_s']:.4f}s "
                  f"coll={r['t_collective_s']:.4f}s "
                  f"{r['bottleneck']}-bound "
                  f"useful={r['useful_flops_ratio']:.3f} "
                  f"mfu_bound={r['mfu_bound']:.3f} "
                  f"live={out['live_bytes_per_device']/2**30:.2f}GiB "
                  f"state={out['state_bytes_per_device']/2**30:.2f}GiB "
                  f"wbits={out['weight_bits']:.3f} "
                  f"fits={out['fits_hbm']}", flush=True)
        elif status == "refused":
            refused.append(name)
            print(f"[refused] {name}: {out}", flush=True)
        else:
            failures.append((name, out[0]))
            print(f"[FAIL] {name}: {out[0]}\n{out[1]}", flush=True)
    print(f"\n{ran} cells ran, {len(refused)} refused, {len(failures)} "
          f"failed in {time.time() - t0:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for n, e in failures:
            print(" ", n, e)
        raise SystemExit(1)
    print("all requested dry-run cells ran or were refused")


if __name__ == "__main__":
    main()
