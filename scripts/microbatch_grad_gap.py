"""Where the step-0 gradient of the whole batch parts from the same
gradient summed over microbatches, leaf by leaf, in the port.

    PYTHONPATH=src python scripts/microbatch_grad_gap.py            # tiny, CPU
    PYTHONPATH=src python scripts/microbatch_grad_gap.py --device cuda
    PYTHONPATH=src python scripts/microbatch_grad_gap.py --device cuda \\
        --full --seq 4096 --qk 0.0625

The model is gemma2-2b (tiny, or at its published widths with
``--full``), its bf16 parameters drawn from seed 0 on ``--device`` and wq,
wk times ``--qk``, as chip_smoke.py's phase 18 starts its runs. One batch
(the step-0 batch of ``data/pipeline.py::batch_for_model``) gives three
gradients:

  * ``plain``: one backward over every row, as ``make_train_step`` takes
    it with one microbatch (bf16 gradients);
  * ``split``: ``--microbatches`` backwards over the rows cut as
    ``run_train_step`` cuts them, their bf16 gradients summed in fp32 and
    divided (what a data split over as many ranks also computes);
  * ``fp32``: the parameters cast to fp32, over the same microbatches
    (in fp32 the split moves only fp32 rounding) and through the plain
    flash version (the kernel takes bf16): the arithmetic that both bf16
    runs round.

For each leaf: its norm in ``plain``, the norm of plain - split and its
share of that difference's squared norm, and each bf16 run's distance
from ``fp32``. Then the global norms, the leaves that carry most of the
gap, and, for the leaf that carries most, how the gap sits along its
rows (a few rows or all of them), and the counts in the batch of the
tokens those rows embed.

``--split-embed`` gives the token lookup its own copy of the tied
embedding table, so the table's gradient comes out as two leaves:
``embed[lookup]`` (the scatter-add of the lookup's row gradients) and
``embed`` (the rest: the unembedding's product). Each is then held
against its fp32 twin on its own.
"""
import argparse
import math

import torch

from repro_torch.configs import ShapeConfig, get_config, tiny_config
from repro_torch.data import pipeline as dp
from repro_torch.models import transformer as tr
from repro_torch.models.api import build_model
from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


def leaf_names(tree, prefix=""):
    """Slash-joined paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += leaf_names(tree[k], f"{prefix}{k}/")
        return out
    return [prefix[:-1]]


def grads(model, params, batch, microbatches=1, lookup=None,
          kernel="auto"):
    """The step's gradients as ``run_train_step`` forms them (fp32, on the
    host); with ``lookup`` (a copy of the embedding table) the token
    lookup reads that copy, whose gradient comes last."""
    B = batch["tokens"].shape[0]
    leaves = tree_leaves(params) + ([] if lookup is None else [lookup])
    real = tr.embed_tokens
    if lookup is not None:
        tr.embed_tokens = lambda p, tokens, cfg, gather=None: real(
            dict(p, embed=lookup), tokens, cfg, gather)
    total = None
    try:
        for mb in range(microbatches):
            n = B // microbatches
            part = {k: v[mb * n:(mb + 1) * n] for k, v in batch.items()}
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, part, remat=True, kernel=kernel)
            g = torch.autograd.grad(loss, leaves)
            for p in leaves:
                p.requires_grad_(False)
            g = [x.to("cpu", F32) for x in g]
            total = g if total is None else [a + b for a, b in zip(total, g)]
    finally:
        tr.embed_tokens = real
    return [x / microbatches for x in total]


def norm(x):
    return float(torch.linalg.vector_norm(x.to(F32)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--full", action="store_true",
                    help="published widths (default: tiny)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--qk", type=float, default=0.125)
    ap.add_argument("--split-embed", action="store_true",
                    help="the embedding's gradient as its lookup's and "
                         "its unembedding's shares")
    ap.add_argument("--top", type=int, default=8)
    a = ap.parse_args()
    torch.manual_seed(0)
    if a.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gemma2-2b") if a.full else tiny_config("gemma2-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=a.device).manual_seed(0),
                        a.device)
    for sub in params["blocks"].values():
        for n in ("wq", "wk"):
            sub["attn"][n].mul_(a.qk)
    batch = dp.batch_for_model(model, ShapeConfig("t", a.seq, a.batch,
                                                  "train"), None, 0,
                               a.device, full=True)
    names = leaf_names(params)
    copy = None
    if a.split_embed:
        names.append("embed[lookup]")
        copy = params["embed"].clone()
    plain = grads(model, params, batch, lookup=copy)
    split = grads(model, params, batch, a.microbatches, lookup=copy)
    p32 = tree_map(lambda x: x.to(F32), params)
    exact = grads(model, p32, batch, a.microbatches,
                  lookup=None if copy is None else copy.to(F32),
                  kernel="ref")
    del p32
    gaps = [norm(x - y) ** 2 for x, y in zip(plain, split)]
    total_gap = sum(gaps)
    gn = {k: math.sqrt(sum(norm(x) ** 2 for x in g))
          for k, g in (("plain", plain), ("split", split), ("fp32", exact))}
    print(f"gemma2-2b{'' if a.full else ' tiny'} B {a.batch} x S {a.seq}, "
          f"{a.microbatches} microbatches, wq, wk x {a.qk}, {a.device}")
    print(f"global norm: plain {gn['plain']:.6f}, split {gn['split']:.6f} "
          f"(rel {abs(gn['split'] - gn['plain']) / gn['plain']:.4g}), "
          f"fp32 {gn['fp32']:.6f}; |plain - split| "
          f"{math.sqrt(total_gap):.6f}; |plain - fp32| "
          f"{math.sqrt(sum(norm(x - y) ** 2 for x, y in zip(plain, exact))):.6f}"
          f"; |split - fp32| "
          f"{math.sqrt(sum(norm(x - y) ** 2 for x, y in zip(split, exact))):.6f}")
    print(f"{'leaf':32s} {'|plain|':>12s} {'|plain-split|':>14s} "
          f"{'share':>7s} {'|plain-fp32|':>13s} {'|split-fp32|':>13s}")
    order = sorted(range(len(names)), key=lambda i: -gaps[i])
    for i in order[:a.top]:
        print(f"{names[i]:32s} {norm(plain[i]):12.6f} "
              f"{math.sqrt(gaps[i]):14.6f} {gaps[i] / total_gap:7.2%} "
              f"{norm(plain[i] - exact[i]):13.6f} "
              f"{norm(split[i] - exact[i]):13.6f}")
    i = order[0]
    d = (plain[i] - split[i]).reshape(plain[i].shape[0], -1)
    rows = torch.linalg.vector_norm(d, dim=1) ** 2
    top = torch.sort(rows, descending=True)
    cum = torch.cumsum(top.values, 0) / rows.sum()
    k = int((cum < 0.9).sum()) + 1
    print(f"{names[i]}: {k} of its {d.shape[0]} rows carry 90% of its "
          f"squared gap; the largest rows {top.indices[:8].tolist()} "
          f"({[f'{float(v):.3g}' for v in top.values[:8] / rows.sum()]})")
    if "embed" in names[i]:
        counts = torch.bincount(batch["tokens"].reshape(-1).cpu(),
                                minlength=d.shape[0])
        print(f"  those rows' token counts in the batch: "
              f"{counts[top.indices[:8].cpu()].tolist()} (median count "
              f"over tokens seen {float(counts[counts > 0].median()):.0f})")


if __name__ == "__main__":
    main()
