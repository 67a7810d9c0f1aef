"""Training split over a ("data", "model") or ("pod", "data", "model")
mesh of ranks: the port of the reference's sharded train step
(``make_train_step`` under ``jax.jit`` with ``in_shardings`` from
``train_state_logical_specs``).

One process per rank, as in the sharded engine (serving/engine/sharded.py):

  * The state at rest: every leaf of ``{"params", "opt"}`` split per
    distributed/sharding.py's rules on its logical axes: the FSDP
    ``embed`` dims over ("pod", "data") or ``data``; heads, kv heads,
    d_ff, experts, vocab and the mamba layers' ``ssm_inner`` and
    ``ssm_heads`` over ``model`` where they divide it, whole where they
    do not. A quantized moment's codes split as their
    parameter; its scales keep their last (block) dim whole on every
    rank, as the reference's spec has it.
  * The forward runs the engine's per-layer ``gather`` hook, with a
    backward. A leaf's ``data`` dims are all-gathered at use, and the
    backward reduce-scatters the whole-leaf gradient over ``data``: each
    data rank computed it on its own rows, so that is the data-parallel
    gradient sum. A dim split over ("pod", "data") is gathered over
    ``data`` and then ``pod`` (minor axis first), and reduce-scattered
    over both. Its ``model`` dims are gathered too, except the output
    dims of the column-split products (q/k/v, FFN up and gate), which stay
    local. Every rank of a ``model`` group computes the same whole
    downstream of a gathered leaf (a mamba layer, whose ``in_proj`` is
    gathered whole, is computed whole on every rank), so the backward
    keeps its block of that gradient without a sum. ``data`` is gathered
    before ``model``, so the backward slices before it reduce-scatters.
  * Tensor parallelism: the sharded engine's exactness-first sites
    (distributed/sharding.py::tp_dot) with their backward conjugates
    (``tp_dot``'s docstring): heads the model axis does not divide are
    computed whole on every rank; query heads it divides over kv heads it
    does not take a slice of the whole ``wk``/``wv`` per rank. A ``dot``
    hook (HAQ's fake quantization) runs inside ``tp_dot``'s sites, its
    per-channel scale taken over the whole weight.
  * The batch: each rank takes its rows of the global batch (``make_ac``),
    split over ("pod", "data") where that divides them, else over
    ``data``; in microbatches, its rows of each of the reference's global
    microbatches (``rows``). The loss's sum and token count are summed
    over the axes that split the rows before the division, so the loss
    is the global batch's mean. The moe layers route over the same ranks
    (models/moe.py's ``ranks``): the capacity, the pairs' slots and the
    aux loss are the global microbatch's. A leaf not split over an FSDP
    axis has its gradient summed over that axis after the backward.
  * A batch whose rows split over no batch axis, where the rules split
    its sequence over ``data`` (B 1 or 3 at data=2): every rank takes the
    whole global (micro)batch, and the model cuts the residual stream to
    the rank's block of the sequence's rows at the reference's ``ac(x,
    "resid")`` (distributed/sharding.py::DataSeqRows), so positions,
    RoPE, the local window and the causal mask stay the whole sequence's.
    Every sub-layer runs on the gathered whole rows; the final norm, the
    unembedding and the loss on the rank's rows, against the next rows'
    labels taken from the whole batch. The loss's sum and count are
    summed over ``data``; the moe layers route the whole rows as one
    device does, and the aux loss's gradient enters once.
  * An FSDP axis that takes neither the rows nor the sequence (``pod``
    under rows split over ``data`` alone or under a sequence split over
    ``data``; ``data`` too where neither its rows nor its sequence divide
    it) holds the (micro)batch whole: the reference's rule
    (``ActivationLayout.replicated_axes``, which the layout of ``rows``
    carries as ``replicated``). Every rank of such an axis computes the
    same rows from the same gathered weights, so the step counts their
    gradient once: the gather's backward over the axis is a cut (the
    rank keeps its block, with no sum, as over ``model``), no leaf's
    gradient is summed over it, and neither is the loss's sum or count
    nor the moe layers' routing. A dim split over ("pod", "data") under
    rows split over ``data`` is gathered over data, then pod; its
    backward cuts over pod, then reduce-scatters over data.
  * AdamW on the shards. The global norm is one sum of per-rank sums of
    squares; a leaf replicated over an axis is counted on one rank of it.
    The update is elementwise. A quantized moment's scales rest whole
    (the reference's spec replicates their block dim); where its last dim
    splits over ranks, each block's max is taken over every rank's
    columns of it, so the codes are the whole moment's even where a block
    straddles ranks.

Every sum over ranks is fp32 in group-rank order (distributed/sharding.py),
so every rank computes the same loss, norm and clip scale. On a mesh of
one rank every collective is an identity that records nothing, so the
step is the one-device step, bit for bit.

Exactness under a sequence split over ``data`` (``DataSeqRows``):

  * On a mesh of one rank nothing splits, and the step is the one-device
    step bit for bit, as above.
  * The forward is one device's values on every rank: every gather moves
    data only, and every sub-layer runs on whole rows.
  * The loss sums the ranks' shares (its sum and its token count) in fp32,
    in group-rank order.
  * The sums that change order are each gathered activation's input
    gradient (the reduce-scatter at the gather before each sub-layer) and
    each parameter's gradient (the reduce-scatter of a leaf split over
    ``data``, or the post-backward sum of one that is not): each is the
    ranks' shares, added in fp32 in group-rank order.

Exactness where an axis holds the batch whole: every rank of it
computes the same values, bit for bit, and no collective sums over it,
so the step is the one on the mesh without that axis (rows over
``data`` alone at pod x data: the data mesh's; nothing split: one
device's), its gradients and first loss bit for bit; the grad norm sums
its ranks' partial sums in another grouping.

Checkpoints are whole: rank 0 writes the gathered leaves, and a restore
slices them, so a checkpoint taken on one mesh restores on any other and
on one device. ``reshard_state`` (distributed/fault_tolerance.py) moves a
live state between meshes the same way.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.distributed import sharding as shlib
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim.adamw import adamw_init, adamw_update, \
    moment_block_for, moment_scale, quantize_moment
from repro_torch.training.steps import abstract_train_state, \
    run_train_step, train_state_logical_specs

F32 = torch.float32
MODEL = "model"
DATA = "data"
POD = "pod"
FSDP_AXES = (POD, DATA)          # the batch's and the FSDP dims' axes


def validate_train_mesh(cfg, mesh, *, what="training") -> None:
    """What the sharded trainer (and the sharded serving steps,
    ``what="serving"``: training/sharded_serve.py) needs from (cfg,
    mesh): axes among pod, data and model, and a rank's query heads in
    one kv head's group (``kv_span``). Every family on any such mesh."""
    sizes = shlib.axis_sizes(mesh)
    unknown = set(sizes) - {POD, DATA, MODEL}
    if unknown:
        raise ValueError(f"{what} mesh axes must be pod/data/model, got "
                         f"{sorted(sizes)}")
    shlib.kv_span(cfg, sizes.get(MODEL, 1), 0)


def _axes(entry):
    return () if entry is None else shlib._as_axes(entry)


def seq_rows(batch) -> int:
    """The sequence rows of a batch's loss: the tokens' (the decoder's),
    after the vision stub's patch rows."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                       if "patches" in batch else 0)


class StateLayout:
    """A train state's at-rest layout on a mesh: the full-rank spec of
    every leaf (``train_state_logical_specs`` through ``specs_for``),
    this rank's coordinates and the axes' process groups. ``mesh`` is a
    named ``DeviceMesh``."""

    def __init__(self, model, tcfg, mesh):
        self.model, self.tcfg, self.mesh = model, tcfg, mesh
        self.sizes = shlib.axis_sizes(mesh)
        self.coords = shlib.mesh_coords(mesh)
        self.groups = {a: mesh.get_group(a) for a in self.sizes}
        self.device = torch.device(
            "cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        self.abstract = abstract_train_state(model, tcfg)
        self.logical = train_state_logical_specs(model, tcfg)
        self.specs = shlib.partition_specs(self.abstract, self.logical,
                                           mesh)
        self.first = all(c == 0 for c in self.coords.values())

    def leaf_specs(self) -> list:
        """Every leaf's spec, in the state's ``tree_leaves`` order."""
        return shlib.leaves_like(self.abstract, self.specs)

    def _map(self, fn, tree, specs):
        return tree_unflatten(tree, [
            fn(x, s) for x, s in zip(tree_leaves(tree),
                                     shlib.leaves_like(tree, specs))])

    def local(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the whole ``x``, in storage of its own
        (even where it is all of ``x``: the optimizer updates it in
        place)."""
        return shlib.local_block(x, spec, self.sizes, self.coords).clone(
            memory_format=torch.contiguous_format)

    def shard(self, tree, specs):
        """Every leaf's block on this rank."""
        return self._map(self.local, tree, specs)

    def whole(self, x: torch.Tensor, spec) -> torch.Tensor:
        """The whole leaf from every rank's block (a collective)."""
        return shlib.whole_from_block(x, spec, self.groups)

    def host_state(self, state):
        """The whole state in host memory on rank 0, for a checkpoint (None
        on the other ranks). Every rank gathers one leaf at a time."""
        leaves = []
        for x, spec in zip(tree_leaves(state), self.leaf_specs()):
            w = self.whole(x, spec)
            leaves.append(w.to("cpu", copy=True) if self.first else None)
            del w
        return tree_unflatten(state, leaves) if self.first else None

    def restore(self, ckpt_dir: str, step=None):
        """(state, step) from a whole checkpoint: each leaf read whole on
        the host and sliced to this rank's block, on its device."""
        specs = self.leaf_specs()

        def place(whole, i):
            return self.local(whole, specs[i]).to(self.device)
        return ckpt_lib.restore(ckpt_dir, self.abstract, step, place=place)

    def first_rank_float(self, value: float) -> float:
        """Rank 0's ``value`` on every rank of the mesh."""
        for ax in (MODEL, DATA, POD):
            if ax in self.groups:
                value = shlib.broadcast_float(value, self.groups[ax])
        return value

    def barrier(self) -> None:
        """Every rank of the mesh has reached this point."""
        z = torch.zeros(1, device=self.device)
        for g in self.groups.values():
            shlib.all_reduce_sum(z, g)


class ShardedTrainer(StateLayout):
    """The train step over ``ac``'s mesh (``make_ac``): state at rest per
    the layout, the global batch in, this rank's rows computed.
    ``dot``: the HAQ hook; at ``model`` > 1 the tensor-parallel sites
    call it (``tp_dot``'s ``inner``). ``kernel``: the flash attention mode
    (kernels/ops.py; "ref" for meta tensors, which no kernel takes)."""

    def __init__(self, model, tcfg, ac, *, dot=None, kernel="auto"):
        validate_train_mesh(model.cfg, ac.mesh)
        super().__init__(model, tcfg, ac.mesh)
        self.ac, self.kernel = ac, kernel
        self.fsdp = [a for a in FSDP_AXES if self.sizes.get(a, 1) > 1]
        pa = self.abstract["params"]
        self.param_specs = shlib.leaves_like(pa, self.specs["params"])
        plans = shlib.gather_plans(pa, self.logical["params"],
                                   self.specs["params"])
        self.plans = tree_unflatten(pa, [
            tuple([e for e in reversed(p) if e[1] != MODEL]
                  + [e for e in p if e[1] == MODEL])
            for p in shlib.leaves_like(pa, plans)])
        tp = self.sizes.get(MODEL, 1)
        self.dot = shlib.tp_dot(self.groups[MODEL], model.cfg, inner=dot) \
            if tp > 1 else dot
        self.ranks = self.batch_ranks()
        # a leaf replicated over an axis counts in the norm on coordinate 0
        self._owned = [all(self.coords[a] == 0 for a in self.sizes
                           if a not in sum((_axes(e) for e in spec), ()))
                       for spec in self.param_specs]
        self._split = self._last_split()

    # ------------------------------------------------- quantized moments --
    def _last_split(self) -> list:
        """Each leaf's last-dim spec entry where its quantized moments
        split it over ranks (None where whole or not quantized)."""
        if not self.tcfg.optim.quantized_moments:
            return [None] * len(self.param_specs)
        return [spec[-1] if spec and any(
            self.sizes[a] > 1 for a in _axes(spec[-1])) else None
            for spec in self.param_specs]

    def _runs(self, i: int):
        """(b, r, start, local): leaf ``i``'s moment block ``b``
        (``moment_block_for`` of the whole shape) and this rank's ``local``
        columns of its last dim from ``start``, in runs of ``r`` = gcd(b,
        local) columns, each inside one block."""
        shape = tuple(tree_leaves(self.abstract["params"])[i].shape)
        b = moment_block_for(shape, self.tcfg.optim.moment_block)
        local = shlib.local_shape(shape, self.param_specs[i],
                                  self.sizes)[-1]
        idx = 0
        for a in _axes(self._split[i]):
            idx = idx * self.sizes[a] + self.coords[a]
        return b, math.gcd(b, local), idx * local, local

    def _run_blocks(self, i: int) -> torch.Tensor:
        """The block of each of this rank's runs of leaf ``i`` (``_runs``)."""
        b, r, start, local = self._runs(i)
        return (start + torch.arange(0, local, r, device=self.device)) // b

    def _scale_view(self, i: int, scale: torch.Tensor) -> torch.Tensor:
        """A scale at rest (every block) -> one a run of this rank's
        columns: a view of its blocks where the runs are whole blocks, a
        copy of one scale a run where blocks straddle ranks."""
        b, r, start, local = self._runs(i)
        if r == b:
            return scale.narrow(-1, start // b, local // b)
        return scale[..., self._run_blocks(i)]

    def init_state(self, generator: torch.Generator):
        """``init_train_state``'s state, split: the whole parameters drawn
        from ``generator`` (the same draws on every rank), each rank
        keeping its blocks before the optimizer state is made from them,
        so no rank holds the whole optimizer state. A quantized moment's
        scales over blocks of a split last dim rest whole on every rank,
        the zero moment's."""
        params = self.shard(self.model.init(generator, self.device),
                            self.specs["params"])
        opt = adamw_init(params, self.tcfg.optim)
        for i, mom in self._quantized(opt):
            shape = tuple(tree_leaves(self.abstract["params"])[i].shape)
            nb = shape[-1] // moment_block_for(shape,
                                               self.tcfg.optim.moment_block)
            mom["scale"] = moment_scale(torch.zeros(
                tuple(mom["scale"].shape[:-1]) + (nb,), dtype=F32,
                device=self.device))
        return {"params": params, "opt": opt}

    def _quantized(self, opt):
        """(leaf index, moment dict) of every quantized moment whose last
        dim is split over ranks."""
        pa = self.abstract["params"]
        return [(i, mom) for name in ("m", "v")
                for i, mom in enumerate(shlib.leaves_like(pa, opt[name]))
                if self._split[i] is not None]

    def _requantize(self, i: int, mom, src: torch.Tensor):
        """``quantize_moment`` of the whole moment, on this rank's columns
        ``src`` of leaf ``i``: each block's max |x| over its columns on
        every rank of the last dim's axes (a block may straddle ranks),
        written to the scales at rest; returns this rank's codes and its
        runs' scales (``_runs``). Exact: a max, then the quantizer's own
        arithmetic per element."""
        _, r, _, local = self._runs(i)
        blk = self._run_blocks(i)
        lead = tuple(src.shape[:-1])
        run_max = src.abs().reshape(lead + (local // r, r)).amax(-1)
        amax = torch.zeros(lead + (mom["scale"].shape[-1],), dtype=F32,
                           device=src.device).index_reduce_(
            -1, blk, run_max, "amax")
        for a in _axes(self._split[i]):
            amax = shlib.all_gather_dim(amax.unsqueeze(0), 0,
                                        self.groups[a]).amax(dim=0)
        mom["scale"].copy_(moment_scale(amax))
        return quantize_moment(src, r, amax=amax[..., blk])

    # ----------------------------------------------------------- the step --
    def step(self, state: Dict[str, Any], batch: Dict[str, Any]):
        """``train_step(state, global batch)``: this rank's rows of the
        batch and their layout (``rows``), then the step on them
        (``local_step``)."""
        return self.local_step(state, *self.rows(batch))

    def local_step(self, state: Dict[str, Any], rows: Dict[str, Any], ac):
        """The step on this rank's ``rows`` of the global batch, each
        microbatch's loss run under the layout ``ac`` (``rows``)."""
        return run_train_step(
            self.tcfg, lambda params, part: self.grads(params, part, ac),
            self.update)(state, rows)

    def rows(self, batch: Dict[str, Any]):
        """(this rank's rows of the global batch, the activation layout
        its loss runs under). In M microbatches of B rows, where a batch
        axis divides B (``batch_axes``): its rows of each of the
        reference's microbatches (global rows [m B, (m+1) B)), one after
        the other, so that ``run_train_step``'s microbatch m on this rank
        is its block of the reference's, under ``ac``. Where none does:
        the whole batch, under a layout of whole batches
        (``ActivationLayout(whole_batch=True)``), where the model cuts the
        sequence if the rules split it over ``data`` (``seq_split``) and
        keeps every row otherwise. Either layout carries the FSDP axes
        that hold the microbatch whole (``replicated_axes``)."""
        M = self.tcfg.microbatches
        B = batch["tokens"].shape[0] // M
        S = seq_rows(batch)
        held = self.ac.replicated_axes(B, S)
        if self.ac.batch_axes(B) is None and (held or
                                              self.ac.seq_split(B, S)):
            return batch, shlib.ActivationLayout(
                self.mesh, whole_batch=True, replicated=held)
        return {k: torch.cat([self.ac(part, "batch")
                              for part in v.chunk(M)])
                for k, v in batch.items()}, self.ac.replicating(held)

    def batch_ranks(self, replicated=()):
        """The ``BatchRanks`` of the FSDP axes that split a step's rows
        or sequence: every one but those in ``replicated`` (None where
        that leaves none)."""
        axes = [a for a in self.fsdp if a not in replicated]
        return shlib.BatchRanks([self.groups[a] for a in axes]) \
            if axes else None

    def gather(self, tree, path, replicated=()):
        """The model's ``gather`` hook: the subtree at ``path`` whole on
        this rank, with a backward (the module docstring): over ``model``
        and over the axes in ``replicated`` (those that hold the batch
        whole) a cut, over the other FSDP axes a reduce-scatter. A path
        into a stacked subtree holds one layer's views, whose plans count
        the stacked layer dim (``plan_shift``)."""
        plans = self.plans
        for key in path:
            plans = plans[key]
        shift = shlib.plan_shift(path)

        def run(x, plan):
            for dim, ax in plan:
                x = shlib.gather_shard(
                    x, dim - shift, self.groups[ax],
                    reduce=ax != MODEL and ax not in replicated)
            return x
        return tree_unflatten(tree, [
            run(x, p) for x, p in zip(tree_leaves(tree),
                                      shlib.leaves_like(tree, plans))])

    def grads(self, params, batch, ac):
        """(global mean loss, this rank's gradient blocks summed over the
        FSDP axes that split the rows, each in its leaf's dtype) on this
        rank's rows of a (micro)batch under their layout ``ac``
        (``rows``), whose ``replicated`` axes hold it whole."""
        held = ac.replicated
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        gather = functools.partial(self.gather, replicated=held) \
            if held else self.gather
        loss = self.model.loss(params, batch, remat=self.tcfg.remat,
                               dot=self.dot, kernel=self.kernel,
                               gather=gather,
                               ranks=self.batch_ranks(held) if held
                               else self.ranks, ac=ac)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        grads = [self.sum_unsplit(g, spec, held)
                 for g, spec in zip(grads, self.param_specs)]
        return loss.detach(), tree_unflatten(params, grads)

    def sum_unsplit(self, g: torch.Tensor, spec, replicated=()) -> \
            torch.Tensor:
        """A leaf's gradient summed over each FSDP axis its spec does not
        split (each of whose ranks computed it on its own rows), but for
        those in ``replicated``, whose ranks computed the same rows."""
        split = sum((_axes(e) for e in spec), ()) + tuple(replicated)
        if DATA in self.fsdp and DATA not in split:
            g = self.sum_over_data(g)
        if POD in self.fsdp and POD not in split:
            g = shlib.all_reduce_sum(g, self.groups[POD]).to(g.dtype)
        return g

    def sum_over_data(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` summed over the ranks of ``data`` (each computed it on
        its own rows), in its dtype."""
        return shlib.all_reduce_sum(g, self.groups[DATA]).to(g.dtype)

    def global_norm(self, grads) -> torch.Tensor:
        """The fp32 L2 norm of the whole gradient: this rank's sum of
        squares over the leaves it counts (in leaf order, as
        ``adamw.global_norm`` adds them), summed over the mesh."""
        total = None
        for g, owned in zip(tree_leaves(grads), self._owned):
            if owned:
                sq = torch.sum(torch.square(g.to(F32)))
                total = sq if total is None else total + sq
        if total is None:
            total = torch.zeros((), dtype=F32, device=self.device)
        for ax in (MODEL, DATA, POD):
            if ax in self.groups:
                total = shlib.all_reduce_sum(total, self.groups[ax])
        return torch.sqrt(total)

    def update(self, grads, opt):
        """``adamw_update`` on the shards, under the global norm. A
        quantized moment split along its last dim is read through its
        runs' scales (``_scale_view``) and quantized over the whole
        moment's blocks (``_requantize``)."""
        view, requantize = opt, None
        quantized = self._quantized(opt)
        if quantized:
            pa = self.abstract["params"]
            split = {id(mom): i for i, mom in quantized}
            views = {}

            def viewed(tree):
                out = []
                for mom in shlib.leaves_like(pa, tree):
                    if id(mom) in split:
                        i = split[id(mom)]
                        v = {"q": mom["q"],
                             "scale": self._scale_view(i, mom["scale"])}
                        views[id(v)] = (i, mom)
                        mom = v
                    out.append(mom)
                return tree_unflatten(pa, out)
            view = {"master": opt["master"], "m": viewed(opt["m"]),
                    "v": viewed(opt["v"]), "count": opt["count"]}

            def requantize(dst, src):
                if id(dst) in views:
                    return self._requantize(*views[id(dst)], src)
                return quantize_moment(src, self.tcfg.optim.moment_block)
        params, view, metrics = adamw_update(grads, view, self.tcfg.optim,
                                             norm=self.global_norm,
                                             requantize=requantize)
        opt["count"] = view["count"]
        return params, opt, metrics
