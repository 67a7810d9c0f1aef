"""Divisibility-aware logical -> mesh sharding rules (port of
``repro.distributed.sharding``), and the one collective the sharded
engine runs.

Every tensor carries logical axis names (models/params.py). ``specs_for``
maps a tree of (shapes x logical axes) onto a mesh by walking each
tensor's dims left to right and assigning the first *legal* candidate
mesh-axis tuple per logical axis: legal means (a) the dim is divisible by
the mesh axes' product and (b) no mesh axis is used twice within one
tensor. A spec is a tuple with one entry per dim, as the reference's
``PartitionSpec`` holds them: a mesh-axis name, a tuple of names, or
None (replicated); ``choose_spec`` drops trailing Nones, as the
reference's does.

The rules read only a mesh's axis sizes (``axis_sizes``): a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, or a plain
``{"data": d, "model": m}`` mapping for pure callers.

The reference's ``make_ac`` (GSPMD activation hints for training and the
dry-run) waits for sharded training (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_unflatten

# fsdp == param/batch sharding axes; model == tensor-parallel axis.
FSDP = ("pod", "data")

# Candidate mesh-axis tuples per logical axis, in priority order. The empty
# tuple (replicate) is always the implicit last resort.
CANDIDATES: Dict[str, Sequence[Tuple[str, ...]]] = {
    # params
    "vocab": [("model",)],
    "embed": [FSDP, ("data",)],
    "embed2": [],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "head_dim": [],
    "d_ff": [("model",)],
    "experts": [("model",)],
    "expert_ff": [("model",)],
    "ssm_inner": [("model",)],
    "ssm_heads": [("model",)],
    "ssm_state": [],
    "conv": [],
    "layer": [],
    "null": [],
    "moment_blocks": [FSDP, ("data",)],
    # activations / caches
    "batch": [FSDP, ("data",)],
    "seq": [("data",)],
    "cache_seq": [("model",), ("data",)],
    "embed_act": [],
}

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a named DeviceMesh, of a mapping, or of an
    object whose ``shape`` is such a mapping (as a JAX mesh's is)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a serving mesh needs named dims ('data', 'model')")
    return dict(zip(names, mesh.shape))


def _axes_in_mesh(sizes, axes: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    present = tuple(a for a in axes if a in sizes)
    return present or None


def choose_spec(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
                mesh) -> Spec:
    assert len(shape) == len(logical), (shape, logical)
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        placed = None
        for cand in CANDIDATES.get(name or "", []):
            axes = _axes_in_mesh(sizes, cand)
            if not axes:
                continue
            if any(a in used for a in axes):
                continue
            size = math.prod(sizes[a] for a in axes)
            if dim % size != 0:
                continue
            placed = axes if len(axes) > 1 else axes[0]
            used.update(axes)
            break
        out.append(placed)
    while out and out[-1] is None:  # trailing Nones are implicit
        out.pop()
    return tuple(out)


def leaves_like(like, tree) -> list:
    """``tree``'s entries at the leaves of ``like``, in ``tree_leaves``
    order: a tuple (an axes tuple, a spec, a plan) where ``like`` has a
    leaf is one entry, not a subtree; a None subtree gives None."""
    out = []
    _leaves_like(like, tree, out)
    return out


def _leaves_like(a, t, out: list) -> None:
    # module-level, as params.tree_unflatten's walk: no closure cycle
    if isinstance(a, dict):
        for k in sorted(a):
            _leaves_like(a[k], None if t is None else t[k], out)
    elif isinstance(a, list):
        for i, v in enumerate(a):
            _leaves_like(v, None if t is None else t[i], out)
    else:
        out.append(t)


def logical_leaves(abstract, logical) -> list:
    """Each leaf's logical axes; a None entry replicates every dim."""
    return [(None,) * len(a.shape) if l is None else tuple(l)
            for a, l in zip(tree_leaves(abstract),
                            leaves_like(abstract, logical))]


def specs_for(abstract: Any, logical: Any, mesh) -> Any:
    """Tree of specs (``choose_spec``) matching ``abstract`` (tensors,
    meta tensors, or anything with a ``shape``)."""
    return tree_unflatten(abstract, [
        choose_spec(tuple(a.shape), l, mesh)
        for a, l in zip(tree_leaves(abstract),
                        logical_leaves(abstract, logical))])


def full_rank(spec: Spec, ndim: int) -> Spec:
    """``spec`` with its implicit trailing Nones spelled out."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shard one device holds of a tensor of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, axes in zip(shape, full_rank(spec, len(shape))):
        n = 1 if axes is None else math.prod(
            sizes[a] for a in (axes if isinstance(axes, tuple) else (axes,)))
        out.append(dim // n)
    return tuple(out)


def describe(specs: Any, abstract: Any, limit: int = 0) -> str:
    """Human-readable sharding table: path, shape, spec per leaf."""
    lines = []
    flat_s = leaves_like(abstract, specs)
    flat_a = tree_leaves(abstract)
    for path, s, a in zip(leaf_paths(abstract), flat_s, flat_a):
        lines.append(f"{''.join(f'[{k!r}]' for k in path):70s} "
                     f"{str(tuple(a.shape)):28s} {s}")
        if limit and len(lines) >= limit:
            lines.append("...")
            break
    return "\n".join(lines)


def leaf_paths(tree, prefix: Tuple = ()) -> list:
    """Key paths of every leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


# ------------------------------------------------------------ collective --
def _gather_single(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``all_gather_single`` where torch has it (2.13 on), else its older
    name ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``, in group-rank order
    (the tiled all-gather of the reference's shard_map bodies): pure data
    movement, so the result is bit-exact. A gloo group moves host memory:
    a CUDA tensor goes through the host explicitly, as gloo's
    documentation lists no all-gather of CUDA tensors, and travels as its
    bytes (gloo's reductions know no bf16)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    gloo = dist.get_backend(group) == "gloo"
    staged = gloo and src.is_cuda
    if staged:
        src = src.cpu()
    wire = src.view(torch.uint8) if gloo and src.dim() else src
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    _gather_single(out, wire, group)
    out = out.view(src.dtype)
    if staged:
        out = out.to(x.device)
    return out.movedim(0, dim).contiguous()


def broadcast_float(value: float, group=None) -> float:
    """Rank 0's ``value`` on every rank of ``group`` (fp64; on the card
    for nccl, which takes CUDA tensors only)."""
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=dist.get_global_rank(group, 0)
                   if group is not None else 0, group=group)
    return float(t.item())
