"""Sharded serving (port of ``repro.serving.engine.sharded``): the paged KV
pool and the parameters split over a ("data", "model") mesh of ranks,
every host-side decision (admission, growth, preemption, window trim,
chunk accounting) untouched.

Design: **exactness-first tensor parallelism**, the reference's. Greedy
outputs on an N-rank mesh equal the one-device engine's token for token
(fp and quantized pools, chunked and whole-prompt prefill, GQA, windows,
preemption), so only *output* dims are ever split, never a floating-point
reduction:

  * q/k/v and the FFN's up and gate projections contract over the whole
    ``embed`` dim and are split on their output dims (``heads``,
    ``kv_heads``, ``d_ff`` on the ``model`` axis): each rank computes its
    slice of the one-device product;
  * the paged walk is parallel over kv heads: each rank walks its
    ``K/N`` heads of every page (the softmax and P·V reduce over page
    slots and head_dim, both whole), so the pool's bytes are divided by
    the ``model`` axis; the decode split plan reads the model's K, not
    the slice's (kernels/paged_attention.py::decode_splits), so each
    (sequence, head) walk sums in the one-device grouping;
  * contraction-split products (the attention out-projection over heads,
    the FFN down-projection over ``d_ff``) would need a partial-sum
    all-reduce, which is not bit-stable: their *inputs* are all-gathered
    (pure data movement) and the contraction runs whole on every rank;
  * everything else (embedding lookup, norms, residuals, the unembed,
    sampling) runs whole, replicated.

The product sites (``tp_dot``) and the per-leaf gather plans
(``gather_plans``) are distributed/sharding.py's, which the sharded
trainer (training/sharded.py) shares.

Weights stay split **at rest** per ``distributed/sharding.py``'s rules and
are gathered at use. Where the reference gathers every leaf of the
stacked tree at the top of each shard_map body, the port's layers are an
eager loop, so it gathers **one layer at a time** (the ``gather`` hook of
models/transformer.py): a rank holds its at-rest shards plus one layer's
gathered leaves, or the gathered embedding at the lookup and the
unembed. The ``data`` axis is an at-rest FSDP axis for parameters (the
``embed`` candidates); every rank decodes the whole batch.

One process per rank, the host loop replicated: every rank runs the same
scheduler on the same requests, so page tables, tokens and positions are
equal by construction, and the logits each rank samples from are
bit-identical; sampling at ``temperature > 0`` draws from the same seeded
generators. ``run(realtime=True)`` takes rank 0's clock.

Pool layout per rank (mesh ``model=N``)::

    pool["sub{j}"]["k"|"v"]         (G, num_pages, page, K/N, hd)
    quantized: {"q":    (G, num_pages, page, K/N, hd_store) int8,
                "scale": (G, num_pages, page, K/N) f32}
    page_table, positions, tokens   equal on every rank

Every rank holds a 1/N kv-head slice of every page, so one host-side page
allocation covers all shards; the span writer (pool.py) scatters locally
at the shared page ids.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import gather_plans, \
    partition_specs, tp_dot
from repro_torch.models.params import tree_leaves, tree_map, \
    tree_unflatten

MODEL_AXIS = "model"


def validate_mesh(cfg, mesh) -> None:
    """The exactness contract the sharded engine needs from (cfg, mesh)."""
    sizes = shlib.axis_sizes(mesh)
    unknown = set(sizes) - {"data", "model"}
    if unknown:
        raise ValueError(f"serving mesh axes must be data/model, "
                         f"got {sorted(sizes)}")
    tp = sizes.get(MODEL_AXIS, 1)
    if cfg.num_kv_heads % tp or cfg.num_heads % tp:
        raise ValueError(
            f"{cfg.name}: heads ({cfg.num_heads}) and kv heads "
            f"({cfg.num_kv_heads}) must divide the model axis ({tp}); the "
            f"paged walk shards on kv_heads only — page slots stay whole "
            f"so the online softmax keeps its 1-device reduction order")
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"sharded engine serves dense/moe decoders; {cfg.name} "
            f"(family={cfg.family!r}) is an open item (ROADMAP)")


def gather_at_use(tree, plans, groups, shift: int = 0):
    """Run each leaf's gather plan; ``groups`` maps a mesh axis to its
    process group, ``shift`` drops leading dims the plans count (1 for a
    layer's view of a stacked leaf). All-gathers are pure data movement:
    bit-exact by construction."""
    def run(x, plan):
        for dim, ax in plan:
            x = shlib.all_gather_dim(x, dim - shift, groups[ax])
        return x
    return tree_unflatten(tree, [
        run(x, p) for x, p in zip(tree_leaves(tree),
                                  shlib.leaves_like(tree, plans))])


class SpmdEngine:
    """Sharding context the Engine holds when built with a mesh: parameter
    and pool placement, and the ``dot`` sites and per-layer ``gather``
    hook the Engine's own step bodies take under a mesh.

    Every step shares one contract: page table, tokens and positions
    equal on every rank, parameters split per ``specs_for`` (gathered at
    use where a contraction would split), the pool split on
    ``kv_heads`` over ``model``."""

    def __init__(self, model, mesh, *, kv_bits=None):
        validate_mesh(model.cfg, mesh)
        self.model = model
        self.kv_bits = kv_bits
        self.sizes = shlib.axis_sizes(mesh)
        abstract = model.abstract_params()
        logical = model.logical_specs()
        self.param_specs = partition_specs(abstract, logical, mesh)
        self._plans = gather_plans(abstract, logical, self.param_specs)
        pool = model.pool_specs(2, 2, kv_bits=kv_bits)
        self.pool_specs = partition_specs(
            tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"),
                     pool),
            model.pool_axes(kv_bits), mesh)
        self.groups = {ax: mesh.get_group(ax) for ax in self.sizes}
        self.coords = {ax: mesh.get_local_rank(ax) for ax in self.sizes}
        self.dot = tp_dot(self.groups[MODEL_AXIS], model.cfg)

    # ----------------------------------------------------------- placement --
    def _shard(self, x, spec):
        """This rank's block of ``x`` under ``spec``, in storage of its
        own (the whole tensor can then be freed)."""
        part = shlib.local_block(x, spec, self.sizes, self.coords)
        if part.shape == x.shape:               # split over axes of size 1
            return x
        return part.clone(memory_format=torch.contiguous_format)

    def _map(self, fn, tree, specs):
        """``fn(leaf, spec)`` over a tree and its spec tree."""
        return tree_unflatten(tree, [
            fn(x, s) for x, s in zip(tree_leaves(tree),
                                     shlib.leaves_like(tree, specs))])

    def shard_params(self, params):
        """Parameters at rest: TP dims local, FSDP dims split over data."""
        return self._map(self._shard, params, self.param_specs)

    def init_pool(self, num_pages: int, page_size: int, *, device):
        """This rank's zeroed pool: every leaf's kv-head slice."""
        return self._map(
            lambda s, spec: torch.zeros(
                shlib.local_shape(s[0], spec, self.sizes), dtype=s[1],
                device=device),
            self.model.pool_specs(num_pages, page_size,
                                  kv_bits=self.kv_bits), self.pool_specs)

    def gather(self, tree, path):
        """The transformer's ``gather`` hook: the subtree at ``path`` whole
        on this rank. A "blocks" path holds one layer's views, whose
        plans count the stacked layer dim (never split)."""
        plans = self._plans
        for key in path:
            plans = plans[key]
        return gather_at_use(tree, plans, self.groups,
                             shift=shlib.plan_shift(path))

    # ---------------------------------------------------------------- clock --
    def rank0_clock(self, now: float) -> float:
        """Rank 0's ``now``: realtime admission must decide alike on
        every rank."""
        return shlib.broadcast_float(now)

    # ------------------------------------------------------------ describe --
    def event_tags(self) -> dict:
        """Mesh tags stamped on every telemetry tick event: a trace from a
        sharded run is told apart from, and grouped against, one-device
        runs. Every rank runs the same host loop, so the tags describe the
        mesh, not a rank."""
        return {"mesh_model": self.sizes.get(MODEL_AXIS, 1),
                "mesh_data": self.sizes.get("data", 1),
                "mesh_devices": math.prod(self.sizes.values())}

    def describe(self) -> str:
        tp = self.sizes.get(MODEL_AXIS, 1)
        dp = self.sizes.get("data", 1)
        return (f"mesh(model={tp}, data={dp}): pool kv_heads/{tp}, "
                f"params at rest per specs_for (gathered per layer at use), "
                f"page table + scheduler replicated on every rank")
