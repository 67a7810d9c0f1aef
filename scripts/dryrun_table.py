"""Markdown rows of dry-run records (``python -m repro_torch.launch.dryrun
--out-dir DIR``), one a cell, both meshes side by side: state and live
peak a device, dot FLOPs, collective bytes, the three terms, the
bottleneck, the useful share, the stored weights' average bits, and for
the moe family the dispatch buffer's padded rows, ``E * min(C, T_local)``
over the ``T_local * k`` routed pairs a rank computes (C the global
capacity, T_local a rank's rows: models/moe.py).

    PYTHONPATH=src python scripts/dryrun_table.py DIR [--tag _haq] \\
        [--arch granite-moe-3b-a800m,...]

``--beside DIR2 --beside-tag _seq_tp`` sets each cell's records in DIR
(at ``--tag``) beside DIR2's (``--ac-mode seq_tp``'s, say), as "a -> b"
on each mesh: live peak, collective bytes, t_collective, t_compute and
the bottleneck, flagging any cell whose dot FLOPs, state, t_memory or
collective bytes of another kind than all-gather differ; then the cells
whose records agree to the byte.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import assigned_cells, get_config, \
    get_shape  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

MESHES = {"single": (1, 16), "multi": (2, 16)}     # (pod, data)


def padded_rows(arch: str, shape_name: str, mesh: str):
    """E * min(C, T_local) / (T_local * k) of a moe cell, None else."""
    cfg, shape = get_config(arch), get_shape(shape_name)
    if cfg.family != "moe":
        return None
    pod, data = MESHES[mesh]
    ranks = pod * data if shape.global_batch % (pod * data) == 0 else \
        data if shape.global_batch % data == 0 else 1
    S = 1 if shape.kind == "decode" else shape.seq_len
    T = shape.global_batch * S
    t_local = T // ranks
    rows = min(capacity(T, cfg.moe), t_local) if ranks > 1 \
        else capacity(T, cfg.moe)
    moe = cfg.moe
    return moe.num_experts * rows / (t_local * moe.experts_per_token)


def row(recs, arch, shape_name):
    def both(fn, fmt):
        return " / ".join(format(fn(recs[m]), fmt) for m in MESHES
                          if m in recs)
    r = {m: x["roofline"] for m, x in recs.items()}
    waste = [padded_rows(arch, shape_name, m) for m in MESHES if m in recs]
    cells = [
        f"{arch} {shape_name}",
        both(lambda x: x["state_bytes_per_device"] / 2**30, ".4f"),
        both(lambda x: x["live_bytes_per_device"] / 2**30, ".2f"),
        both(lambda x: x["dot_flops_per_device"], ".4e"),
        both(lambda x: sum(v for k, v in x["collectives_per_device"].items()
                           if k != "coll_count") / 1e9, ".2f"),
        " / ".join(f"{r[m]['t_compute_s']:.3g}" for m in r),
        " / ".join(f"{r[m]['t_memory_s']:.3g}" for m in r),
        " / ".join(f"{r[m]['t_collective_s']:.3g}" for m in r),
        " / ".join(sorted({r[m]["bottleneck"] for m in r})),
        " / ".join(f"{r[m]['useful_flops_ratio']:.3f}" for m in r),
        both(lambda x: x.get("weight_bits", 16.0), ".3f"),
        "-" if waste[0] is None else " / ".join(f"{w:.1f}x" for w in waste)]
    return "| " + " | ".join(cells) + " |"


def _coll(rec) -> float:
    return sum(v for k, v in rec["collectives_per_device"].items()
               if k != "coll_count") / 1e9


def beside(pairs, arch, shape_name) -> str:
    """One markdown row of a cell's (a, b) record pairs by mesh."""
    def arrow(fn, fmt):
        return " / ".join(f"{fn(a):{fmt}} -> {fn(b):{fmt}}"
                          for a, b in pairs.values())
    same = all(
        a[k] == b[k] for a, b in pairs.values()
        for k in ("dot_flops_per_device", "state_bytes_per_device")) and \
        all(a["roofline"]["t_memory_s"] == b["roofline"]["t_memory_s"]
            and {k: v for k, v in a["collectives_per_device"].items()
                 if k not in ("all-gather", "coll_count")}
            == {k: v for k, v in b["collectives_per_device"].items()
                if k not in ("all-gather", "coll_count")}
            for a, b in pairs.values())
    cells = [f"{arch} {shape_name}",
             arrow(lambda x: x["live_bytes_per_device"] / 2**30, ".2f"),
             arrow(_coll, ".1f"),
             arrow(lambda x: x["roofline"]["t_collective_s"], ".3g"),
             " / ".join(f"{a['roofline']['t_compute_s']:.3g}"
                        for a, _ in pairs.values()),
             " / ".join(f"{a['roofline']['bottleneck']} -> "
                        f"{b['roofline']['bottleneck']}"
                        for a, b in pairs.values())
             + ("" if same else " (FLOPs, state, t_mem or other "
                "collectives differ)")]
    return "| " + " | ".join(cells) + " |"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", type=Path)
    ap.add_argument("--tag", default="")
    ap.add_argument("--arch", default="",
                    help="comma-separated archs (every assigned cell's "
                         "where empty)")
    ap.add_argument("--beside", type=Path,
                    help="a second records directory, set beside DIR's")
    ap.add_argument("--beside-tag", default="")
    args = ap.parse_args(argv)
    archs = set(filter(None, args.arch.split(",")))
    if args.beside:
        print("| Cell | Live GiB | Coll. GB | t_coll s | t_comp s | Bound |")
        print("| --- " * 6 + "|")
        equal = []
        for arch, shape_name in assigned_cells():
            if archs and arch not in archs:
                continue
            pairs = {}
            for m in MESHES:
                a = args.dir / f"{arch}__{shape_name}__{m}{args.tag}.json"
                b = args.beside / \
                    f"{arch}__{shape_name}__{m}{args.beside_tag}.json"
                if a.exists() and b.exists():
                    pairs[m] = (json.loads(a.read_text()),
                                json.loads(b.read_text()))
            if not pairs:
                continue
            if all({k: v for k, v in a.items() if k != "trace_s"}
                   == {k: v for k, v in b.items() if k != "trace_s"}
                   for a, b in pairs.values()):
                equal.append(f"{arch} {shape_name}")
            else:
                print(beside(pairs, arch, shape_name))
        print(f"\nEqual to the byte: {', '.join(equal) or 'none'}")
        return
    print("| Cell | State GiB | Live GiB | Dot FLOPs | Coll. GB | t_comp s "
          "| t_mem s | t_coll s | Bound | Useful | Weight bits | Padded "
          "rows |")
    print("| --- " * 12 + "|")
    for arch, shape_name in assigned_cells():
        if archs and arch not in archs:
            continue
        recs = {}
        for m in MESHES:
            p = args.dir / f"{arch}__{shape_name}__{m}{args.tag}.json"
            if p.exists():
                recs[m] = json.loads(p.read_text())
        if recs:
            print(row(recs, arch, shape_name))


if __name__ == "__main__":
    main()
