"""The prefill and serve steps split over a ("data", "model") or ("pod",
"data", "model") mesh of ranks: the port of the reference's
``make_prefill_step`` and ``make_serve_step`` under ``jax.jit`` with its
dry-run's shardings (``src/repro/launch/dryrun.py:90-108``), one process
per rank, as the sharded engine and trainer run.

  * Parameters at rest per ``specs_for(abstract_params, logical_specs)``,
    gathered one layer at a time by the sharded engine's ``gather`` hook
    (serving/engine/sharded.py::gather_at_use), the products through
    ``tp_dot``, kv heads sliced per rank by ``kv_span`` included. Stored
    int8/int4 weights (serving/quant.py::quantize_params) rest per the
    specs of ``quantize_defs``' tree, as the reference's dry-run places
    them: the codes split as their weight, the per-tensor or per-layer
    scales whole on every rank; ``dequant_dot`` runs inside ``tp_dot``'s
    sites on a rank's slice of the codes. The layout is read from the
    tree the steps are given (``param_layout``).
  * The batch: each rank takes its rows (``make_ac``'s ``batch`` kind);
    where no FSDP axis divides B (``long_500k``'s one row), every rank
    takes all of it. The moe layers route over the ranks the rows split
    over (models/moe.py's ``ranks``), as the reference's one program
    routes the global batch.
  * The dense cache at rest per ``specs_for(cache_specs(B, T),
    cache_axes)``: ``choose_spec`` gives the sequence the ``model`` axis
    where it divides T, and the kv heads ``model`` only where it does not
    (distributed/sharding.py::CacheBlock); where B does not take ``data``
    the sequence may fall through to it (``(None, None, 'data',
    'model')``: each data rank holds its slots of every row, over its
    model rank's kv heads).
    ``pos`` is a scalar, as in the reference's decode cells. The four
    families' caches (``placements``): the dense, moe and vlm families'
    per sub-layer slot; the ssm family's mamba conv windows and states
    (``MambaBlock``: the window on its channels, the state on its heads),
    and the hybrid's also its shared block's k/v; the encoder-decoder's
    self-attention k/v over decoder slots and its memory's mk/mv over
    encoder frames.
  * Prefill: the rank's rows through ``forward(want_cache=True)`` (ring
    layout for local layers; under ``make_ac``'s seq_tp the residual's
    sequence rows split over ``model`` between sub-layers, every
    sub-layer and so every cache computed on whole rows, as in ``dp``
    mode); each layer's caches are cut to the rank's
    block as they are made: kv heads made whole over ``model`` (copies),
    then its slots (or its kv heads). Returns the last row's logits of
    the rank's rows and the blocks.
  * Decode: q and the new k/v through ``tp_dot``, made whole over heads
    where the block holds every head; only the rank whose block holds
    slot ``pos`` (a ring's ``pos % W``) writes it; each rank's softmax
    over its keys, masked by the slots' global indices, then combined
    over the sequence's axis, ``model`` or ``data`` (``softmax_combine``);
    ``attn_o`` as ``tp_dot`` gives it.

No reduction changes order but the combine: on a world of one rank every
collective is an identity and the steps are the unsharded ones, bit for
bit; the prefill is bit for bit at any mesh where a product over a column
slice equals that slice of the whole product (the sharded engine's
condition). ``make_prefill_step`` and ``make_serve_step`` given one
``ac`` share one ``ShardedServeSteps`` (``serve_steps``), so a decode
finds the layout that its cache was placed with (``prefill`` or
``place_cache``): a block's shape alone cannot tell a sequence split from
a whole cache one ``model``-th as long.
"""
from __future__ import annotations

import weakref
from typing import Dict

import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer
from repro_torch.models.params import (abstract_params, logical_specs,
                                       tree_leaves, tree_unflatten)
from repro_torch.models.transformer import sublayer_kinds
from repro_torch.serving.engine.sharded import gather_at_use
from repro_torch.serving.quant import stored_defs
from repro_torch.training.sharded import MODEL, validate_train_mesh

KV_AXES = ("layer", "batch", "cache_seq", "kv_heads", "head_dim")
MAMBA = "mamba"                      # the ssm and hybrid state's group


def cache_spec(cfg, B: int, T: int, mesh):
    """The full-rank spec of a (L, B, T, K, hd) dense cache leaf on
    ``mesh`` (``choose_spec`` on ``cache_axes``): the sequence over
    ``model`` where it divides T, else over ``data`` where B does not
    take ``data`` and it divides T (the reference's ``cache_seq`` rule)."""
    return shlib.full_rank(shlib.choose_spec(
        (1, B, T, cfg.num_kv_heads, cfg.resolved_head_dim), KV_AXES,
        shlib.axis_sizes(mesh)), 5)


def cache_groups(cfg, cache):
    """A dense cache tree as {group: {leaf: tensor}}, keyed as a step's
    ``place`` is: a sub-layer slot ("sub{j}"), the hybrid's "shared",
    the ssm state's "mamba", or the encoder-decoder's "self" (k, v) and
    "cross" (mk, mv)."""
    if cfg.is_encdec:
        return {"self": {n: cache[n] for n in ("k", "v")},
                "cross": {n: cache[n] for n in ("mk", "mv")}}
    return cache


def _ungroup(cfg, groups):
    return {**groups["self"], **groups["cross"]} if cfg.is_encdec \
        else groups


class ShardedServeSteps:
    """The prefill and serve steps over ``ac``'s mesh (``make_ac``):
    parameters this rank's shards (``shard_params``), the global batch or
    token in, this rank's rows computed. ``dot``: the HAQ hook
    (``dequant_dot`` over stored weights, or a fake quantizer); at
    ``model`` > 1 the tensor-parallel sites call it (``tp_dot``'s
    ``inner``). ``kernel``: the flash attention mode (kernels/ops.py;
    "blockwise" for the dry-run's meta tensors)."""

    def __init__(self, model, ac, *, dot=None, kernel: str = "auto"):
        cfg = model.cfg
        mesh = ac.mesh
        validate_train_mesh(cfg, mesh, what="serving")
        self.model, self.ac, self.kernel, self.mesh = model, ac, kernel, mesh
        self.sizes = shlib.axis_sizes(mesh)
        self.coords = shlib.mesh_coords(mesh)
        self.groups = {a: mesh.get_group(a) for a in self.sizes}
        self._layouts: Dict = {}  # (specs, plans) by a tree's leaf paths
        tp = self.sizes.get(MODEL, 1)
        self.hook = dot          # held: serve_steps keys on its id
        self.dot = shlib.tp_dot(self.groups[MODEL], cfg, inner=dot) \
            if tp > 1 else dot
        self.placed = None       # (B, {group: T}) of the last placed cache

    # ------------------------------------------------------------ layout --
    def param_layout(self, params):
        """(full-rank specs, gather plans) of a parameter tree, whole or a
        rank's shards, of the model's parameters with any weights stored
        (serving/quant.py::stored_defs)."""
        key = tuple(shlib.leaf_paths(params))
        if key not in self._layouts:
            defs = stored_defs(self.model.defs, params)
            abstract, logical = abstract_params(defs), logical_specs(defs)
            specs = shlib.partition_specs(abstract, logical, self.mesh)
            self._layouts[key] = (specs, shlib.gather_plans(
                abstract, logical, specs))
        return self._layouts[key]

    def shard_params(self, params):
        """This rank's block of every whole parameter, in storage of its
        own."""
        specs = self.param_layout(params)[0]
        return tree_unflatten(params, [
            shlib.local_block(x, s, self.sizes, self.coords).clone(
                memory_format=torch.contiguous_format)
            for x, s in zip(tree_leaves(params),
                            shlib.leaves_like(params, specs))])

    def gatherer(self, params):
        """The model's ``gather`` hook for one step on ``params``: the
        subtree at ``path`` whole on this rank (the sharded engine's, a
        layer at a time), by ``params``' gather plans. A tied embedding,
        read by the lookup and again by the unembedding, is gathered once
        a step and held for the step."""
        plans, held = self.param_layout(params)[1], {}
        tied = self.model.cfg.tie_embeddings

        def gather(tree, path):
            if path in held:
                return held[path]
            sub = plans
            for key in path:
                sub = sub[key]
            out = gather_at_use(tree, sub, self.groups,
                                shift=shlib.plan_shift(path))
            if path == ("embed",) and tied:
                held[path] = out
            return out
        return gather

    def _mamba_specs(self, B: int):
        cfg = self.model.cfg
        axes = transformer.cache_axes(cfg)[MAMBA]
        return {n: shlib.choose_spec((1,) + shape, axes[n], self.sizes)
                for n, (shape, _) in ssm_lib.mamba_cache_spec(cfg, B).items()}

    def _blocks(self, B: int, lengths: Dict[str, int]):
        cfg = self.model.cfg
        return {j: shlib.MambaBlock(self._mamba_specs(B), self.sizes,
                                    self.coords, self.groups, cfg)
                if j == MAMBA else
                shlib.CacheBlock(cache_spec(cfg, B, T, self.sizes), T,
                                 self.sizes, self.coords, self.groups, cfg)
                for j, T in lengths.items()}

    def placements(self, B: int, lengths: Dict[str, int]):
        """{group: ``CacheBlock`` or ``MambaBlock``} of caches of B rows
        and ``lengths[group]`` slots (None for the mamba state), recorded
        as the layout the next decode reads."""
        place = self._blocks(B, lengths)
        self.placed = (B, dict(lengths))
        return place

    def _prefill_lengths(self, batch) -> Dict[str, int]:
        """The prefill's cache groups and their slots."""
        cfg = self.model.cfg
        if cfg.is_encdec:
            return {"self": batch["tokens"].shape[1],
                    "cross": batch["frames"].shape[1]}
        S = batch["tokens"].shape[1] + (batch["patches"].shape[1]
                                        if "patches" in batch else 0)
        if cfg.family in ("ssm", "hybrid"):
            return {MAMBA: None, **({"shared": S} if cfg.family == "hybrid"
                                    else {})}
        return {f"sub{j}": cfg.window_size if k["attn"] == "local" else S
                for j, k in enumerate(sublayer_kinds(cfg))}

    def place_cache(self, cache):
        """A whole dense cache (``cache_specs``' tree) -> this rank's
        blocks, each in storage of its own."""
        groups = cache_groups(self.model.cfg, cache)
        first = next(iter(groups.values()))
        place = self.placements(
            next(iter(first.values())).shape[1],
            {j: None if j == MAMBA else next(iter(c.values())).shape[2]
             for j, c in groups.items()})
        return _ungroup(self.model.cfg, {
            j: {n: shlib.local_block(x, place[j].leaf_spec(n), self.sizes,
                                     self.coords).clone(
                    memory_format=torch.contiguous_format)
                for n, x in c.items()} for j, c in groups.items()})

    def whole_cache(self, blocks):
        """The whole cache from every rank's blocks (a collective)."""
        place = self.layout(blocks)
        return _ungroup(self.model.cfg, {
            j: {n: shlib.whole_from_block(x, place[j].leaf_spec(n),
                                          self.groups)
                for n, x in c.items()}
            for j, c in cache_groups(self.model.cfg, blocks).items()})

    def layout(self, cache, B=None):
        """{group: block} of the last placed cache (of B rows), held to
        ``cache``'s blocks."""
        if self.placed is None:
            raise ValueError("the sharded serve step decodes a cache placed "
                             "by prefill() or place_cache() of the same "
                             "steps (make_prefill_step/make_serve_step with "
                             "one ac share them)")
        cfg = self.model.cfg
        b, lengths = self.placed
        place = self._blocks(b, lengths)
        for j, c in cache_groups(cfg, cache).items():
            for n, x in c.items():
                got = tuple(x.shape)
                if j == MAMBA:      # the whole state's every dim
                    whole, k = (got[0],) + tuple(
                        ssm_lib.mamba_cache_spec(cfg, b)[n][0]), len(got)
                else:               # rows and slots (kv heads may split)
                    whole, k = (got[0], b, lengths[j]) + got[3:], 3
                want = shlib.local_shape(whole, place[j].leaf_spec(n),
                                         self.sizes)
                if (B is not None and B != b) or got[:k] != want[:k]:
                    raise ValueError(
                        f"cache block {j}/{n} {got} is not this rank's "
                        f"block of the placed cache (B={b}, "
                        f"T={lengths[j]}: {want})")
        return place

    # ------------------------------------------------------------- steps --
    def prefill(self, params, batch):
        """``prefill_step(params, global batch) -> (last-row logits of this
        rank's rows, this rank's cache blocks)``."""
        B = batch["tokens"].shape[0]
        rows = {k: self.ac(v, "batch") for k, v in batch.items()}
        place = self.placements(B, self._prefill_lengths(batch))
        return self.model.prefill(
            params, rows, dot=self.dot, kernel=self.kernel,
            gather=self.gatherer(params), place=place,
            ranks=shlib.batch_ranks(self.ac, B, self.groups),
            ac=self.ac.for_batch(B))

    def decode(self, params, cache, token, pos):
        """``serve_step(params, cache blocks, global token (B, 1), pos) ->
        (logits of this rank's rows, the blocks)``, written in place."""
        B = token.shape[0]
        rows = self.ac(token, "batch")
        place = self.layout(cache, B)
        return self.model.decode_step(
            params, cache, rows, pos, dot=self.dot,
            gather=self.gatherer(params), place=place,
            ranks=shlib.batch_ranks(self.ac, B, self.groups))


# the steps made over each layout, by (id(model), id(dot), kernel); a
# layout's entries go with it
_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def serve_steps(model, ac, *, dot=None, kernel: str = "auto"):
    """The one ``ShardedServeSteps`` of (model, ac, dot, kernel), made on
    first use and kept while ``ac`` lives: ``make_prefill_step`` and
    ``make_serve_step`` share it, and so their cache's placement. The
    steps hold the model and the hook they were given, so the ids in the
    key stay theirs."""
    made = _STEPS.setdefault(ac, {})
    key = (id(model), id(dot), kernel)
    if key not in made:
        made[key] = ShardedServeSteps(model, ac, dot=dot, kernel=kernel)
    return made[key]
