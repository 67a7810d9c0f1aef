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

``make_ac`` is the training's and the prefill's activation layout:
which rows of the global batch a rank computes on, under ``seq_tp``
which rows of the sequence it holds between sub-layers (``SplitRows``),
and, for a training batch whose sequence the rules split over ``data``,
which of its rows a rank holds and takes the loss on (``DataSeqRows``).
The collectives at the bottom are what
the sharded engine and the sharded trainer (training/sharded.py) run:
all-gathers are pure data movement, and every sum over ranks is taken in
fp32 in group-rank order, so it is the same on every rank and from run
to run. Each collective reports what it puts on the wire to the
``collective_log`` listeners (roofline/step_costs.py counts a step's
collectives there); over the ``fake`` backend (a dry-run's world,
launch/mesh.py::dry_world) the collectives run on meta tensors and move
nothing.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import tree_leaves, tree_unflatten

F32 = torch.float32

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


def scalar_sharding(mesh) -> Spec:
    """A scalar's spec on any mesh: replicated (the reference's
    ``NamedSharding(mesh, P())``)."""
    return ()


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``; 0 on every
    axis of a mesh that is only sizes."""
    sizes = axis_sizes(mesh)
    if hasattr(mesh, "get_local_rank"):
        return {a: mesh.get_local_rank(a) for a in sizes}
    return {a: 0 for a in sizes}


def _as_axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def local_block(x: torch.Tensor, spec: Spec, sizes, coords) -> torch.Tensor:
    """The block of ``x`` that the rank at ``coords`` holds under ``spec``
    (a view): a dim split over several axes counts them major to minor."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n, idx = 1, 0
        for a in _as_axes(axes):
            n *= sizes[a]
            idx = idx * sizes[a] + coords[a]
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def whole_from_block(x: torch.Tensor, spec: Spec, groups) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec`` (the
    inverse of ``local_block``): all-gathers over each split dim's axes,
    the minor axis first. Every rank of the mesh must call it."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        for a in reversed(_as_axes(axes)):
            x = all_gather_dim(x, dim, groups[a])
    return x


class ActivationLayout:
    """The activation layout of the port's training and prefill
    (``make_ac``), called as ``ac(x, kind)``. In the port every rank runs
    its own rows of the global batch, so the layout is where those rows
    come from:

    * ``"batch"``: this rank's rows of a global (B, ...) tensor. The rows
      split over the ``batch`` candidates, ("pod", "data") and then
      ("data",), the first that divides B, as the reference's
      ``_batch_axes`` picks them; whole where none does.
    * ``"resid"``: a whole (B, S, D) residual stream of the rank's batch
      rows -> the rows the blocks hold between sub-layers (``rows``). In
      ``dp`` mode ``x`` as it is: the reference constrains the residual
      to the batch split, which the port's rows hold by construction. In
      ``seq_tp`` mode the rank's block of the S sequence rows over
      ``model`` (block ``coords["model"]``, as ``local_block`` counts
      it), where the reference's condition holds: rank 3, ``model`` > 1,
      S divisible by it and S > 1; ``x`` as it is otherwise (a decode
      step's one row, a vision-stub sequence ``model`` does not divide).
      In the layout of a training batch that no batch axis divides
      (``whole_batch``: every rank takes the whole batch), the rank's block
      of the S rows over ``data`` (block ``coords["data"]``) where the
      reference's batch spec gives ``seq`` the data axis: ``data`` > 1,
      S divisible by it and S > 1 (``seq_split``; ``DataSeqRows``), whole
      over ``pod``; ``x`` as it is where the spec splits neither.
    * ``"decode_q"``, ``"decode_kv"``, ``"decode_scores"``: ``x`` as it
      is. In the reference they hint the decode cells at the partitioner
      (q replicated over ``model``, k, v and the scores split on the
      cache's sequence); the port's sharded decode step does that work
      itself (``CacheBlock``: q made whole over heads, each rank's
      softmax over its keys, ``softmax_combine``).
    * any other kind (the reference's ``"moe_buf"`` no-op included):
      ``x`` as it is.

    ``whole_batch``: every rank takes the whole global batch of a
    training step (training/sharded.py::ShardedTrainer.rows, where no
    batch axis divides its rows), so ``rows`` splits its sequence where
    the rules split it over ``data``. ``replicated``: the FSDP axes that
    hold the step's (micro)batch whole (``replicated_axes``), which the
    trainer's backward cuts over and sums over none.
    ``mesh`` is a named ``DeviceMesh`` (or sizes only: every coordinate
    0, and no split of the sequence's rows, which needs the axis's
    group)."""

    def __init__(self, mesh, mode: str = "dp", *, whole_batch: bool = False,
                 replicated: Tuple[str, ...] = ()):
        self.mesh, self.mode, self.whole_batch = mesh, mode, whole_batch
        self.replicated = tuple(replicated)
        self.sizes = axis_sizes(mesh)
        self.coords = mesh_coords(mesh)

    def batch_axes(self, b: int):
        """The mesh axes ``b`` global rows split over: a name, a tuple of
        names, or None."""
        fsdp = _axes_in_mesh(self.sizes, FSDP)
        if fsdp and b % math.prod(self.sizes[a] for a in fsdp) == 0:
            return fsdp if len(fsdp) > 1 else fsdp[0]
        if "data" in self.sizes and b % self.sizes["data"] == 0:
            return "data"
        return None

    def seq_split(self, b: int, s: int) -> bool:
        """Whether a training step over ``b`` global rows of ``s`` sequence
        rows splits the sequence over ``data`` (``DataSeqRows``): no batch
        axis divides ``b``, ``data`` > 1 divides ``s`` and ``s`` > 1, as
        the reference's ``choose_spec`` of ("batch", "seq") puts ``data``
        on the sequence. A ``pod`` axis then holds the batch whole
        (``replicated_axes``)."""
        data = self.sizes.get("data", 1)
        return self.batch_axes(b) is None and data > 1 \
            and s % data == 0 and s > 1

    def replicated_axes(self, b: int, s: int) -> Tuple[str, ...]:
        """The FSDP axes above size 1 that hold a training step's global
        (micro)batch of ``b`` rows of ``s`` sequence rows whole: each that
        takes neither the rows (``batch_axes``) nor the sequence
        (``seq_split``). Every rank of such an axis computes the same
        rows, so the step counts their gradient once (the reference's
        spec leaves the batch replicated over it, and XLA sums over it
        nothing)."""
        taken = _as_axes(self.batch_axes(b) or ()) + (
            ("data",) if self.seq_split(b, s) else ())
        return tuple(a for a in FSDP if self.sizes.get(a, 1) > 1
                     and a not in taken)

    def replicating(self, axes) -> "ActivationLayout":
        """This layout, for a step whose (micro)batch every rank of
        ``axes`` holds whole (``replicated``)."""
        if tuple(axes) == self.replicated:
            return self
        out = copy.copy(self)
        out.replicated = tuple(axes)
        return out

    def for_batch(self, b: int) -> "ActivationLayout":
        """The layout of a step over a global batch of ``b`` rows: this
        one, or where no batch axis divides ``b`` (every rank takes every
        row) the ``dp`` one, as the reference's seq_tp constrains only a
        residual whose batch it splits."""
        if self.mode == "dp" or self.batch_axes(b) is not None:
            return self
        return ActivationLayout(self.mesh)

    def rows(self, x) -> layers.WholeRows:
        """The row layout of a forward whose residual stream is ``x``
        (whole; a tensor or its shape): in a ``whole_batch`` layout
        ``DataSeqRows`` over ``data`` where the sequence splits there and
        the step does not hold its batch whole over ``data`` (whisper's
        frames, which data divides, beside decoder tokens it does not:
        the step computes every stream whole on each data rank);
        ``SplitRows`` over ``model`` where seq_tp splits it (the
        ``"resid"`` kind); ``layers.WHOLE_ROWS`` otherwise."""
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
        if len(shape) != 3:
            return layers.WHOLE_ROWS
        s = shape[1]
        if self.whole_batch and "data" not in self.replicated \
                and self.seq_split(shape[0], s):
            return DataSeqRows(self.mesh.get_group("data"),
                               self.coords["data"], s)
        tp = self.sizes.get("model", 1)
        if self.mode != "seq_tp" or tp == 1 or s % tp or s == 1:
            return layers.WHOLE_ROWS
        return SplitRows(self.mesh.get_group("model"), self.coords["model"],
                         s)

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        if kind == "resid":
            return self.rows(x).local(x)
        if kind != "batch":
            return x
        return local_block(x, (self.batch_axes(x.shape[0]),), self.sizes,
                           self.coords)


class SplitRows(layers.WholeRows):
    """seq_tp's rows of one forward: a (B, S, D) residual stream held as
    this rank's S / n rows (block ``rank``, its coordinate in ``group``,
    the model axis's n ranks) between sub-layers, the models' blocks
    calling

    * ``norm(x, scale, eps)`` on the rank's rows. A norm is per row, so
      its output rows are the whole norm's; its scale's gradient is a sum
      over every row, of which the rank holds its rows' share: the scale
      passes ``sum_grad`` over ``group`` upcast to fp32, so the shares are
      added in fp32, in group-rank order, before the cast to the leaf's
      dtype. That is the one sum seq_tp reorders;
    * ``whole(h)`` (``rows_whole``) on a norm's output before a sub-layer
      (attention, FFN, moe, mamba), which then runs on whole rows as it
      does in ``dp`` mode;
    * ``local(a)`` (``rows_local``) on the sub-layer's whole output
      before the sandwich norm and the residual add.

    The tensor-parallel sub-layers compute their output whole on every
    rank of ``group`` (``tp_dot``), so every rank holds the same whole
    output and the same whole input gradient (``sum_grad`` on the input
    of the column-split products). Neither collective sums: both are pure
    data movement, and every other value and gradient is ``dp``'s, bit for
    bit, wherever a per-row op gives the same bits on a subset of its
    rows."""

    def __init__(self, group, rank: int, length: int):
        self.group, self.rank, self.length = group, rank, length

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.shape[1] != self.length \
            else rows_local(x, self.group, self.rank)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.shape[1] == self.length else rows_whole(x, self.group)

    def norm(self, x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
        return layers.rms_norm(x, sum_grad(scale.to(F32), self.group), eps)


class DataSeqRows(layers.WholeRows):
    """The rows of a training forward whose batch's sequence splits over
    ``data`` (``ActivationLayout.seq_split``): every rank of the data
    axis's ``group`` takes the whole global batch, and holds its (B, S,
    D) residual stream as its block ``rank`` of S / n rows between
    sub-layers, the models' blocks calling

    * ``norm(x, scale, eps)``: ``rms_norm`` on the rank's rows. The
      scale's gradient is the rank's rows' share, which the trainer's sum
      over ``data`` adds to the other ranks' with every other parameter's
      (training/sharded.py), so the norm sums nothing itself;
    * ``whole(h)`` on a norm's output before a sub-layer (attention, FFN,
      moe, mamba, a fuse product), which then runs on the whole
      sequence's rows on every rank: a bf16 all-gather forward; backward,
      the fp32 reduce-scatter of the ranks' input gradients in
      group-rank order (``gather_shard`` with ``reduce=True``), as each
      rank's backward carries only its own rows' loss;
    * ``local(a)`` on the sub-layer's whole output before the sandwich
      norm and the residual add (``rows_own``: the backward gives the
      other ranks' rows zeros, with no collective).

    The final norm, the unembedding and the loss run on the rank's rows
    (``final``); the loss takes their next-token targets from the whole
    batch (``targets``), its sum and count summed over ``data``
    (``BatchRanks.sum``). The moe layers see whole rows and route them as
    one device does (``route``: no ranks), so every rank computes the
    whole aux loss; the loss takes its value on every rank and its
    gradient on the first data rank alone (``once``): the other ranks
    take it detached, so the sum over ``data`` counts it once, exactly.
    On a mesh with a ``pod`` axis above 1 each pod rank holds the same
    data group's rows, the batch whole over ``pod``
    (``ActivationLayout.replicated_axes``): the trainer sums nothing over
    ``pod``, so the first data rank of each pod replica takes the aux
    gradient, and each replica counts it once.

    Every gather moves data only, and every sub-layer runs on the whole
    sequence, so the forward is one device's on every rank. The sums that
    change order are each gathered activation's input gradient (the
    reduce-scatter) and each parameter's (the trainer's sum over
    ``data``), each the ranks' shares added in fp32 in group-rank order,
    and the loss's sum and count."""

    split_loss = True

    def __init__(self, group, rank: int, length: int):
        self.group, self.rank, self.length = group, rank, length
        self.n = length // dist.get_world_size(group)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.shape[1] != self.length \
            else rows_own(x, self.group, self.rank)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        return x if x.shape[1] == self.length \
            else gather_shard(x, 1, self.group, reduce=True)

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def route(self, ranks):
        return None

    def once(self, aux):
        if self.rank == 0 or not isinstance(aux, torch.Tensor):
            return aux
        return aux.detach()

    def own(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows (dim 1) of a whole (B, S, ...) tensor that
        takes no gradient (labels, loss weights)."""
        return t.narrow(1, self.rank * self.n, self.n)

    def targets(self, labels: torch.Tensor, weight: torch.Tensor):
        """(labels, weights) of the rank's rows' next-token losses, from
        the whole (B, S) ``labels`` and 0/1 ``weight`` of the sequence's
        rows: row i predicts row i + 1's label, weighted by row i's
        weight, and the sequence's last row (the last rank's last)
        predicts nothing, as the one-device loss's shift by one row
        (models/transformer.py::chunked_ce) takes them."""
        nxt = torch.nn.functional.pad(labels[:, 1:], (0, 1))
        w = torch.nn.functional.pad(weight[:, :-1].to(F32), (0, 1))
        return self.own(nxt), self.own(w)


def make_ac(mesh, mode: str = "dp") -> ActivationLayout:
    """The activation-layout hook for ``mesh`` (``ActivationLayout``).
    ``mode="dp"``: the batch split over the FSDP axes, activations
    replicated over ``model``. ``mode="seq_tp"`` (the reference's
    sequence-parallel TP): also the residual stream's sequence rows split
    over ``model`` between sub-layers (``SplitRows``), the norms run on
    1/TP of the rows and a remat checkpoint saves 1/TP of the residual.
    In either mode a training batch no batch axis divides has its
    sequence split over ``data`` where the rules split it there
    (``DataSeqRows``), and an FSDP axis that takes neither its rows nor
    its sequence holds it whole (``ActivationLayout.replicated_axes``)."""
    if mode not in ("dp", "seq_tp"):
        raise ValueError(f"make_ac mode must be 'dp' or 'seq_tp', got "
                         f"{mode!r}")
    return ActivationLayout(mesh, mode)


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


def partition_specs(abstract, logical, mesh):
    """Tree of full-rank specs by the divisibility-aware ``choose_spec``
    rules (trailing Nones spelled out)."""
    specs = specs_for(abstract, logical, mesh)
    return tree_unflatten(abstract, [
        full_rank(s, len(a.shape))
        for s, a in zip(leaves_like(abstract, specs),
                        tree_leaves(abstract))])


# Tensor parallelism, exactness first (the sharded engine's design,
# serving/engine/sharded.py, which the sharded trainer shares): only output
# dims are split, never a floating-point reduction. Leaves whose ``model``
# split is an *output* dim of their product are used as local slices,
# never gathered on that dim; everything else split on ``model``, and
# every ``data`` (FSDP) split, is all-gathered at use.
_LOCAL_KEYS = ("wq", "wk", "wv", "w_in", "w_gate")
_LOCAL_AXES = ("heads", "kv_heads", "d_ff")
# the parameter subtrees stacked over layers: a gather hook's path into one
# of them holds a layer's views, whose plans count the stacked dim
STACKED = ("blocks", "mamba", "mamba_ln", "enc", "dec")


def plan_shift(path) -> int:
    """The leading dims a gather plan counts that a ``gather(tree,
    path)`` call's views lack: 1 for a layer of a stacked subtree."""
    return 1 if path[0] in STACKED else 0


def gather_plans(abstract, logical, specs):
    """Per-leaf ``((dim, mesh_axis), ...)`` all-gathers to run at use:
    every split dim EXCEPT the local-use output dims of the q/k/v and FFN
    up/gate projections."""
    plans = []
    for path, l, s in zip(leaf_paths(abstract),
                          logical_leaves(abstract, logical),
                          leaves_like(abstract, specs)):
        local = any(k in path for k in _LOCAL_KEYS)
        plan = []
        for dim, axes in enumerate(tuple(s)):
            if axes is None:
                continue
            if local and l[dim] in _LOCAL_AXES:
                continue
            for ax in _as_axes(axes):
                plan.append((dim, ax))
        plans.append(tuple(plan))
    return tree_unflatten(abstract, plans)


def tp_dot(group, cfg, inner=None):
    """The ``dot`` hook of tensor parallelism over the ``model`` axis's
    process group, for a model of config ``cfg``. Each site computes what
    the unsharded port computes with ``inner`` as its hook (or without
    one, through the same functions: the lm_head's fp32 product of the
    upcast operands included); the contraction-split sites (``attn_o``,
    ``xattn_o``, ``ffn_out``) gather their activations first.

    ``inner`` (HAQ's fake quantization, core/quantization.py::
    make_quant_dot, or ``dequant_dot`` over stored weights,
    serving/quant.py) sees the operands the site holds: a rank's slice of
    a column-split weight (of its codes, with the whole scale: a stored
    weight's scale is per tensor or per layer), whole weights elsewhere.
    A fake quantizer's per-channel scale reduces over every dim but the
    last, which a head split cuts (the ``d_ff`` split of ``ffn_in`` and
    ``ffn_gate`` does not): at a q, k or v site whose weight (not stored)
    is split on heads, or sliced by ``kv_slice``, the hook is called with
    ``amax=``, a function of the fp32 slice giving the whole weight's
    per-channel amax (``group_amax`` over the slices; from the whole
    ``wk``/``wv`` under ``kv_slice``). The shape tests keep a weight that fell
    through to replicated (an odd ``d_ff``) on the plain product. The
    cross attention's q, k and v (``xattn_*``) split as the self
    attention's do; the mamba projections (``ssm_in``, ``ssm_out``) are
    plain products on whole weights: ``in_proj``'s [z | xs | B | C | dt]
    columns do not split along heads, so every rank of the group computes
    the whole mamba layer. So is the hybrid's ``fuse`` site, which a
    stored fuse weight reaches (models/transformer.py::_fuse).

    Heads that do not divide the group stay whole (``choose_spec``
    replicates them), and every rank computes the whole attention. Query
    heads that divide it over kv heads that do not: a rank's query heads
    are one group's share (``kv_span``), and it projects that group's kv
    head alone, a slice of the whole ``wk``/``wv`` (``kv_slice``), so
    that the attention's ``h = k * G + g`` holds on the rank.

    Each site also carries its backward's conjugate, which only training
    runs (serving records no graph). A column-split product's input passes
    ``sum_grad``, an identity whose backward sums its gradient over the
    group, as each rank's product holds only its heads' or columns' share
    of it; the input q, k and v share passes once, and so does the one
    the FFN's up and gate projections share, so a layer sums two input
    gradients. A sliced ``wk``/``wv`` gets back the gradient of its
    slice only, so ``kv_slice`` sums the whole weight's gradient over the
    group. The gathered activations give each rank back its block of
    their gradient, unsummed, as every rank computes the same whole
    downstream."""
    held = [None, None]          # the last column-split input, its view
    span = kv_span(cfg, dist.get_world_size(group), dist.get_rank(group))

    def enter(a, w, whole):
        # the input of a column-split product, split when w's output dim
        # is a slice of the model's
        if _shape(w)[-1 if whole == "d_ff" else 1] == getattr(cfg, whole):
            return a
        if held[0] is not a:
            held[:] = [a, sum_grad(a, group)]
        return held[1]

    def run(a, w, name, plain, amax=None):
        if inner is None:
            return plain(a, w, name)
        if amax is None or isinstance(w, dict):   # a stored scale is whole
            return inner(a, w, name)
        return inner(a, w, name, amax=amax)

    def dot(a, w, name):
        amax = None
        if name in _QKV_SITES:
            heads = "num_kv_heads" if name in _KV_SITES else "num_heads"
            if name in _KV_SITES and span is not None \
                    and _shape(w)[1] == cfg.num_kv_heads:
                whole, w = w, kv_slice(w, group, *span)

                def amax(wf):   # the whole weight's (its gradient summed)
                    return sum_grad(whole, group).to(F32).abs().amax(
                        dim=(0, 1), keepdim=True)
            elif _shape(w)[1] != getattr(cfg, heads):
                def amax(wf):
                    return group_amax(wf.abs(), (0, 1), group)
            return run(enter(a, w, heads), w, name, attn._proj_in, amax)
        if name in ("attn_o", "xattn_o"):
            if a.shape[2] != _shape(w)[0]:                # local heads
                a = gather_shard(a, 2, group, reduce=False)
            return run(a, w, name, attn._proj_out)
        if name in ("ffn_in", "ffn_gate"):
            return run(enter(a, w, "d_ff"), w, name, layers._matmul)
        if name == "ffn_out":
            if a.shape[-1] != _rows(w):                   # local d_ff
                a = gather_shard(a, a.dim() - 1, group, reduce=False)
            return run(a, w, name, layers._matmul)
        if name == "lm_head":
            return run(a, w, name, lambda a, w, _: a.to(F32) @ w.to(F32))
        if name in ("moe_in", "moe_gate", "moe_out"):
            return run(a, w, name, moe_lib._bmm)
        if name in ("ssm_in", "ssm_out", "fuse"):
            return run(a, w, name, ssm_lib._matmul)
        raise ValueError(f"unknown dot site {name!r}")
    return dot


def _shape(w) -> Tuple[int, ...]:
    """A weight's shape, or a stored weight's codes' (serving/quant.py:
    int4 codes pack two rows of the contracting dim to a byte, so their
    output dims are the weight's)."""
    if isinstance(w, dict):
        return tuple(w["q4" if "q4" in w else "q"].shape)
    return tuple(w.shape)


def _rows(w) -> int:
    """A 2-D weight's contracting dim, stored or not."""
    return _shape(w)[0] * (2 if isinstance(w, dict) and "q4" in w else 1)


_KV_SITES = ("attn_k", "attn_v", "xattn_k", "xattn_v")
_QKV_SITES = ("attn_q", "xattn_q") + _KV_SITES


def kv_span(cfg, tp: int, rank: int) -> Optional[Tuple[int, int]]:
    """The kv heads [lo, hi) that rank ``rank`` of a ``tp``-way model
    group projects when the query heads split over it and the kv heads do
    not; None when both split or neither does. A rank's query heads
    ``[rank * H / tp, (rank + 1) * H / tp)`` must then lie in one kv
    head's group (``H / tp`` divides G), so the span is one head."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    if tp == 1 or not H or H % tp or K % tp == 0:
        return None
    local, G = H // tp, H // K
    if G % local:
        raise ValueError(
            f"{cfg.name}: {local} query heads a rank (heads {H} over "
            f"model={tp}) straddle the groups of {G} that share a kv head")
    lo = rank * local // G
    return lo, lo + 1


def kv_slice(w, group, lo: int, hi: int):
    """Heads [lo, hi) of a whole (D, K, hd) ``wk``/``wv``; its gradient
    (the slice's, zero elsewhere) summed over ``group`` in the backward,
    so every rank holds the whole weight's gradient. A stored weight
    (int8 codes, serving only) gives its codes' slice, in storage of its
    own, and its whole scale."""
    if isinstance(w, dict):
        return {"q": w["q"][:, lo:hi].contiguous(), "scale": w["scale"]}
    return sum_grad(w, group)[:, lo:hi]


class _GroupAmax(torch.autograd.Function):
    """Forward: the max of ``a`` over ``dims`` (kept) and over the group's
    ranks, each holding a block of the tensor along ``dims``. Backward:
    the reference's rule for a max (``jnp.max``'s, and ``torch.amax``'s):
    the gradient, summed over the group (each rank's carries its own
    terms), split evenly among every element equal to the max, the ties
    on every rank counted."""

    @staticmethod
    def forward(ctx, a, dims, group):
        whole = all_gather_dim(a.amax(dim=dims, keepdim=True).unsqueeze(0),
                               0, group).amax(dim=0)
        hit = a == whole
        ties = all_reduce_sum(hit.sum(dim=dims, keepdim=True), group)
        ctx.save_for_backward(hit, ties)
        ctx.group = group
        return whole

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        total = all_reduce_sum(g, ctx.group)
        return hit.to(g.dtype) * (total / ties).to(g.dtype), None, None


def group_amax(a: torch.Tensor, dims, group) -> torch.Tensor:
    """``a.amax(dims, keepdim=True)`` of the whole tensor whose blocks
    along ``dims`` the ranks of ``group`` hold (``_GroupAmax``); exact and
    independent of order."""
    if dist.get_world_size(group) == 1:
        return a.amax(dim=dims, keepdim=True)
    return _GroupAmax.apply(a, tuple(dims), group)


# ------------------------------------------------------------ collective --
# Listeners ``fn(kind, nbytes)`` told of every collective this process
# issues: ``kind`` the reference's HLO name of the op on the wire, and
# ``nbytes`` its result's bytes on this rank (roofline/step_costs.py).
_LISTENERS: list = []


@contextlib.contextmanager
def collective_log(fn):
    """Tell ``fn(kind, nbytes)`` of every collective issued inside the
    block."""
    _LISTENERS.append(fn)
    try:
        yield fn
    finally:
        _LISTENERS.remove(fn)


def _wire(kind: str, t: torch.Tensor) -> None:
    n = t.numel() * t.element_size()
    for fn in _LISTENERS:
        fn(kind, n)


def _gather_single(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``all_gather_single`` where torch has it (2.13 on), else its older
    name ``all_gather_into_tensor``."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` contiguous where ``group``'s collectives take it: gloo moves
    host memory, so a CUDA tensor is staged there explicitly. Strides
    are the dense row-major ones even along dims of size 1 (which
    ``contiguous`` keeps as they are), so that the bytes view works."""
    if dist.get_backend(group) == "gloo" and x.is_cuda:
        x = x.contiguous().cpu()
    x = x.contiguous()
    if x.dim() and x.stride(-1) != 1:
        x = x.clone(memory_format=torch.contiguous_format)
    return x


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
    src = _staged(x.movedim(dim, 0), group)
    wire = src.view(torch.uint8) if dist.get_backend(group) == "gloo" \
        and src.dim() else src
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]),
                      dtype=wire.dtype, device=wire.device)
    _gather_single(out, wire, group)
    _wire("all-gather", out)
    out = out.view(src.dtype).to(x.device)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``,
    in fp32: each rank sends block r to rank r (an all-to-all of the
    tensor's bytes, so bf16 travels as bf16), and the blocks received are
    added in fp32 in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.to(F32)
    src = _staged(x.movedim(dim, 0), group)
    wire = src.view(torch.uint8) if src.dim() else src
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    _wire("all-to-all", out)
    parts = out.view(src.dtype).to(x.device).reshape(
        (n, src.shape[0] // n) + tuple(src.shape[1:]))
    total = parts[0].to(F32)
    for r in range(1, n):
        total = total + parts[r].to(F32)
    return total.movedim(0, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` in fp32, added in group-rank order
    from an all-gather: the same bits on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.to(F32)
    parts = all_gather_dim(x.unsqueeze(0), 0, group)
    total = parts[0].to(F32)
    for r in range(1, n):
        total = total + parts[r].to(F32)
    return total


class _GatherShard(torch.autograd.Function):
    """All-gather along ``dim`` forward. Backward: this rank's block of
    the gradient, summed over the group's ranks (``reduce``: a
    reduce-scatter in fp32) or as it is (every rank of the group computed
    the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, reduce):
        ctx.dim, ctx.group, ctx.reduce = dim, group, reduce
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, \
                None
        n = g.shape[ctx.dim] // dist.get_world_size(ctx.group)
        own = g.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n)
        return own.contiguous(), None, None, None


def gather_shard(x: torch.Tensor, dim: int, group, *,
                 reduce: bool) -> torch.Tensor:
    """``all_gather_dim`` with a backward (``_GatherShard``); ``x`` itself
    in a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _GatherShard.apply(x, dim, group, reduce)


class _RowsLocal(torch.autograd.Function):
    """Forward: this rank's block of ``x``'s rows (dim 1), which every
    rank of the group holds whole and alike, in storage of its own.
    Backward: the gradient's blocks all-gathered over the group, with no
    sum: downstream of the cut each rank computes its own rows alone, so
    the whole gradient is its ranks' blocks side by side."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.group = group
        n = x.shape[1] // dist.get_world_size(group)
        return x.narrow(1, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, ctx.group), None, None


def rows_local(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """seq_tp's cut of a whole (B, S, ...) activation to block ``rank``
    (this rank's in ``group``) of its S / n rows (``_RowsLocal``)."""
    return _RowsLocal.apply(x, group, rank)


class _RowsOwn(torch.autograd.Function):
    """Forward: this rank's block of ``x``'s rows (dim 1), which every
    rank of the data group holds whole and alike, in storage of its own.
    Backward: the gradient of the rank's rows, padded with zeros to the
    whole rows, with no collective. Each data rank's loss is its own
    rows' share, so its backward has nothing for the other rows; their
    ranks' gradients reach the sub-layer's input through the
    reduce-scatter at the gather before it (``DataSeqRows.whole``) and
    its parameters through the trainer's sum over ``data``. Under seq_tp
    (``_RowsLocal``) each rank computes its rows of one whole loss, so the
    whole gradient is its ranks' blocks side by side, gathered."""

    @staticmethod
    def forward(ctx, x, group, rank):
        n = x.shape[1] // dist.get_world_size(group)
        ctx.pad = (rank * n, x.shape[1] - (rank + 1) * n)
        return x.narrow(1, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        pad = (0, 0) * (g.dim() - 2) + ctx.pad
        return torch.nn.functional.pad(g, pad), None, None


def rows_own(x: torch.Tensor, group, rank: int) -> torch.Tensor:
    """``DataSeqRows``' cut of a whole (B, S, ...) activation to block
    ``rank`` of its S / n rows (``_RowsOwn``)."""
    return _RowsOwn.apply(x, group, rank)


def rows_whole(x: torch.Tensor, group) -> torch.Tensor:
    """seq_tp's gather of every rank's rows of a (B, S / n, ...)
    activation, in its dtype (bf16 as the activations are). Backward: the
    rank's block of the gradient, with no sum (``_GatherShard``,
    ``reduce=False``): every rank runs the same whole sub-layer after the
    gather, so every rank holds the same whole gradient, the
    tensor-parallel products' input gradients summed by ``sum_grad``."""
    return gather_shard(x, 1, group, reduce=False)


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the group's
    ranks (fp32, cast back)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group).to(g.dtype), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``_SumGrad``; ``x`` itself in a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _SumGrad.apply(x, group)


class _SumValue(torch.autograd.Function):
    """The sum over the group's ranks forward (``all_reduce_sum``);
    backward, the gradient as it is: every rank holds the same sum, and
    each rank's backward carries its own terms' share of it."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_value(x: torch.Tensor, group) -> torch.Tensor:
    """``_SumValue``; ``x`` itself in a group of one."""
    if dist.get_world_size(group) == 1:
        return x
    return _SumValue.apply(x, group)


class BatchRanks:
    """The ranks a batch's rows are split over, as models/moe.py's
    ``ranks`` hook and the loss's sum read them: ``groups`` the process
    groups of the batch's split axes, major first (``pod``, then
    ``data``), so that rank order is the global batch's row order. Every
    rank holds as many rows."""

    def __init__(self, groups):
        self.groups = list(groups)

    def total(self, n: int) -> int:
        """The global count of a count ``n`` each rank holds."""
        return n * math.prod(dist.get_world_size(g) for g in self.groups)

    def prefix(self, counts: torch.Tensor) -> torch.Tensor:
        """The sum of ``counts`` (integers) over the ranks before this
        one in row order: one all-gather over each axis, the minor
        first. Exact."""
        below = torch.zeros_like(counts)
        for g in reversed(self.groups):
            parts = all_gather_dim(counts.unsqueeze(0), 0, g)
            below = below + parts[:dist.get_rank(g)].sum(0)
            counts = parts.sum(0)
        return below

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (``sum_value``: fp32 in group-rank
        order, the minor axis first; the backward carries this rank's
        terms)."""
        for g in reversed(self.groups):
            x = sum_value(x, g)
        return x


def batch_ranks(ac, B: int, groups) -> Optional[BatchRanks]:
    """The ``BatchRanks`` of a global batch of ``B`` rows under ``ac``
    (``make_ac``), over the mesh's ``groups``; None where the rows split
    over no rank (every rank holds them all)."""
    axes = [a for a in _as_axes(ac.batch_axes(B) or ())
            if ac.sizes[a] > 1]
    return BatchRanks([groups[a] for a in axes]) if axes else None


def broadcast_float(value: float, group=None) -> float:
    """Rank 0's ``value`` on every rank of ``group`` (fp64; on the card
    for nccl, which takes CUDA tensors only)."""
    return broadcast_floats([value], group)[0]


def broadcast_floats(values: Sequence[float], group=None) -> list:
    """Rank 0's ``values`` on every rank of ``group``, in one broadcast;
    every rank passes as many."""
    device = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.broadcast(t, src=dist.get_global_rank(group, 0)
                   if group is not None else 0, group=group)
    _wire("collective-broadcast", t)
    return [float(v) for v in t.tolist()]


# ------------------------------------------------- the dense decode cache --
def softmax_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                    group, *, rescale: bool = True) -> torch.Tensor:
    """Attention over keys split across ``group``'s ranks, from each
    rank's softmax over its own keys: ``m`` (B, H, 1, 1) the row max,
    ``l`` (B, H, 1, 1) the sum of exp(s - m) and ``o`` (B, 1, H, hd) the
    unnormalised sum of exp(s - m) v, all fp32. One all-gather of (B, 1,
    H, hd + 2) fp32; then with M the largest m, o = sum_r o_r e^(m_r - M)
    / max(sum_r l_r e^(m_r - M), 1e-30), summed in group-rank order, so
    every rank holds the same bits. A rank whose keys are all masked has
    m at the mask value, and its terms vanish under e^(m_r - M).
    ``rescale=False`` drops the e^(m_r - M) factors (a test's control).
    Returns (B, 1, H, hd) fp32."""
    hd = o.shape[-1]
    stats = torch.cat([m, l], dim=-1).permute(0, 2, 1, 3)
    parts = all_gather_dim(torch.cat([o, stats], dim=-1).unsqueeze(0), 0,
                           group)
    o_r, m_r, l_r = parts[..., :hd], parts[..., hd:hd + 1], \
        parts[..., hd + 1:]
    scale = torch.exp(m_r - m_r.amax(dim=0)) if rescale \
        else torch.ones_like(m_r)
    num, den = o_r[0] * scale[0], l_r[0] * scale[0]
    for r in range(1, parts.shape[0]):
        num = num + o_r[r] * scale[r]
        den = den + l_r[r] * scale[r]
    return num / torch.clamp(den, min=1e-30)


class CacheBlock:
    """This rank's block of one sub-layer slot's dense decode cache, (L,
    B, T, K, hd) under ``spec`` (``choose_spec`` on ``cache_axes``), and
    what attending over it takes (models/attention.py's ``place``):

    * ``T`` split over an axis (``model``, where it divides T): the rank
      holds slots [offset, offset + T / n) of every row. Attention takes
      every head, q and the new k/v made whole over heads (``heads``),
      over the rank's keys; the ranks' partial softmaxes are then combined
      (``softmax_combine``). A ring's slots are split alike.
    * ``K`` split over ``model`` (where T does not divide it): the rank
      holds its kv heads over every slot, and attends with its query
      heads; the out-projection gathers the heads.
    * neither: the whole cache, every head.

    ``length`` is the whole T. ``group`` is T's axis's process group (or
    None), ``model`` the model axis's; ``cfg`` the model's config (a rank's
    kv head under ``kv_span``)."""

    def __init__(self, spec: Spec, length: int, sizes, coords, groups,
                 cfg):
        spec = full_rank(spec, 5)
        seq, kv = _as_axes(spec[2]) if spec[2] else (), \
            _as_axes(spec[3]) if spec[3] else ()
        n, idx = 1, 0
        for a in seq:
            n, idx = n * sizes[a], idx * sizes[a] + coords[a]
        self.spec, self.length, self.cfg = spec, length, cfg
        self.local_len = length // n
        self.offset = idx * self.local_len
        self.group = groups[seq[0]] if n > 1 else None
        self.heads_split = bool(kv) and sizes[kv[0]] > 1
        self.model = groups.get("model")
        self.tp = sizes.get("model", 1)

    @property
    def split(self) -> bool:
        """Whether the sequence is split (attention needs the combine)."""
        return self.group is not None

    def _whole(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        """(B, S, h, hd) from ``tp_dot`` -> every one of ``heads`` heads:
        a rank's heads gathered over ``model``; under ``kv_span`` (each
        rank holds its query group's one kv head) the first rank's copy of
        each. Pure copies."""
        if x.shape[2] == heads:
            return x
        x = all_gather_dim(x, 2, self.model)
        if x.shape[2] == heads:
            return x
        first = {}
        for r in range(self.tp):
            first.setdefault(kv_span(self.cfg, self.tp, r)[0], r)
        return x[:, :, [first[j] for j in range(heads)]]

    def heads(self, q, k, v):
        """q, k, v (B, S, h, hd) as ``tp_dot`` gives them -> the heads the
        block attends with: every head unless the block's kv heads split,
        where ``tp_dot``'s local heads are the block's."""
        if self.heads_split:
            return q, k, v
        K = self.cfg.num_kv_heads
        return self.query(q), self._whole(k, K), self._whole(v, K)

    def query(self, q):
        """q alone, as ``heads`` gives it: the cross attention's, over
        a block of the encoder memory's k and v."""
        return q if self.heads_split else self._whole(q, self.cfg.num_heads)

    def leaf_spec(self, name: str) -> Spec:
        """The full-rank spec of the block's k or v leaf."""
        return self.spec

    def block(self, kv: torch.Tensor) -> torch.Tensor:
        """A whole-sequence k or v cache of this rank's rows, (B, T, h, hd)
        as the forward's ``tp_dot`` leaves it, -> this rank's block: its
        slots, over every kv head made whole, or over ``tp_dot``'s local
        kv heads where the block's split (kv heads that divide ``model``
        are split at rest in ``wk``/``wv`` too)."""
        if not self.heads_split:
            kv = self._whole(kv, self.cfg.num_kv_heads)
        return kv.narrow(1, self.offset, self.local_len)

    def combine(self, m, l, o) -> torch.Tensor:
        return softmax_combine(m, l, o, self.group)


class MambaBlock:
    """This rank's block of the ssm and hybrid families' mamba decode
    cache, under ``specs`` ({"conv": spec of (L, B, W-1, C), "state":
    spec of (L, B, H, P, N)}, ``choose_spec`` on ``cache_axes``): the conv
    window split on its channels (``ssm_inner``) and the state on its
    heads (``ssm_heads``), each over ``model`` where it divides, and the
    rows over the batch's axes.

    The layer's projections are whole on every rank (``tp_dot``'s
    ``ssm_in``), so a decode step gathers the window's channels
    (``whole_conv``: B x (W-1) x C a layer), runs the recurrence on the
    rank's heads (``head_range``) against its block of the state (the
    heads' recurrences are independent: exact), gathers y over the heads
    (``whole_heads``) before the gated norm, whose sum runs over all of
    d_inner, and keeps its block of the new window (``block``). The state
    itself never moves."""

    def __init__(self, specs, sizes, coords, groups, cfg):
        self.specs = {n: full_rank(s, 5 if n == "state" else 4)
                      for n, s in specs.items()}
        self.sizes, self.coords, self.groups = sizes, coords, groups
        heads = local_block(torch.arange(cfg.ssm_heads),
                            self.specs["state"][2:3], sizes, coords)
        self.head_range = (int(heads[0]), int(heads[-1]) + 1)

    def leaf_spec(self, name: str) -> Spec:
        return self.specs[name]

    def _inner(self, name: str) -> Spec:
        # a layer's leaf of this rank's rows: the dims after the batch's
        return (None,) + self.specs[name][2:]

    def block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A whole layer's ``name`` leaf (B, ...) of this rank's rows ->
        this rank's block of it."""
        return local_block(x, self._inner(name), self.sizes, self.coords)

    def whole_conv(self, conv: torch.Tensor) -> torch.Tensor:
        """A layer's conv window block (B, W-1, C / n) -> every channel."""
        return whole_from_block(conv, self._inner("conv"), self.groups)

    def whole_heads(self, y: torch.Tensor) -> torch.Tensor:
        """(B, h, P) on the rank's heads -> (B, H, P)."""
        return whole_from_block(y, self._inner("state")[:2], self.groups)
