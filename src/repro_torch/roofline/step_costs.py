"""One step's costs on one rank, counted on meta tensors: the counterpart
of the reference's ``repro.roofline.hlo_costs``, and a new design.

The reference compiles the step under ``jax.jit`` and reparses the
optimized per-device HLO (dot FLOPs and collective bytes with while-loop
trip counts). Torch has no such program text; the port runs the step's
callable itself, once, on meta tensors (shapes and dtypes, no storage),
as this rank of a world of the mesh's size (launch/mesh.py::dry_world),
and counts what it dispatches:

  * ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``, which
    counts 2·M·N·K for every matrix product (mm, bmm, addmm, baddbmm, and
    the einsums that lower to them), the backward's and the remat
    recompute's included, as the reference's ``_dot_flops`` counts 2 x
    the result's elements x the contracted size.
  * Collective bytes (``coll_bytes``, ``coll_count`` and the bytes of each
    kind in ``COLLECTIVES``): every collective of the port goes through
    distributed/sharding.py, which reports the op that goes on the wire
    and its result's bytes on this rank (``collective_log``): an
    ``all_gather_dim`` is an all-gather of n times its input; a
    ``reduce_scatter_dim`` an all-to-all of its whole input, then a local
    sum; an ``all_reduce_sum`` an all-gather of n copies, then a local
    sum. An all-reduce would count twice, as the reference weights it
    (ring reduce-scatter plus all-gather); the port issues none.
  * ``peak_bytes``: the live peak of storage on this rank, from a
    dispatch mode that adds each new output storage's bytes when an op
    makes it and subtracts them when it is freed, on top of the
    arguments' bytes, which the caller holds throughout. ``arg_bytes``,
    and ``out_bytes`` and ``alias_bytes`` (the results' storages, and
    those of them that are argument storages updated in place) come with
    it.

A train step of M microbatches repeats one microbatch's work M times
(``count_repeated``): on meta tensors each repetition dispatches the same
ops on the same shapes, so the step is counted at three and four
microbatches and every count extended linearly to M, as the reference's
reparse multiplies a while loop's body by its trip count.

Attention must run through the plain versions (``kernel="ref"``,
kernels/ops.py): a meta tensor lives on no device, and a hand-written
kernel's work would be invisible to the counter, so the step counts the
plain attention's products (dense for short sequences; the flash plain
forward and ``flash_backward``, which skips the block pairs the mask
excludes, from ``FLASH_MIN`` tokens on).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import sharding as shlib
from repro_torch.roofline.analysis import COLLECTIVES


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of every tensor in ``tree``."""
    out = {}
    for t in pytree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


class LiveBytes(TorchDispatchMode):
    """Storage bytes alive now (``live``) and at most (``peak``): the
    storages in ``held`` (the arguments) from the start, and every new
    output storage from the op that makes it until it is freed."""

    def __init__(self, held: Dict[int, int]):
        super().__init__()
        self.live = self.peak = sum(held.values())
        self._seen: Dict[int, Any] = dict.fromkeys(held)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return out

    def _add(self, st) -> None:
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        self._seen[key] = weakref.ref(st, lambda _, k=key, n=n:
                                      self._drop(k, n))

    def _drop(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.pop(key, None)


def count_step(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` (meta tensors) once and return its counted costs
    on this rank: ``dot_flops``, ``coll_bytes``, ``coll_count``, the
    bytes of each kind in ``COLLECTIVES``, ``peak_bytes``, ``arg_bytes``,
    ``out_bytes`` and ``alias_bytes`` (the module docstring)."""
    totals: Dict[str, Any] = {"dot_flops": 0.0, "coll_bytes": 0.0,
                              "coll_count": 0}
    totals.update(dict.fromkeys(COLLECTIVES, 0.0))

    def on_wire(kind: str, nbytes: int) -> None:
        b = 2.0 * nbytes if kind == "all-reduce" else float(nbytes)
        totals[kind] += b
        totals["coll_bytes"] += b
        totals["coll_count"] += 1

    held = _storages(args)
    live = LiveBytes(held)
    flops = FlopCounterMode(display=False)
    with shlib.collective_log(on_wire), flops, live:
        result = fn(*args)
    outs = _storages(result)
    totals.update(dot_flops=float(flops.get_total_flops()),
                  peak_bytes=live.peak, arg_bytes=sum(held.values()),
                  out_bytes=sum(outs.values()),
                  alias_bytes=sum(n for k, n in outs.items() if k in held))
    return totals


def count_repeated(step_of: Callable[[int], tuple], n: int) \
        -> Dict[str, Any]:
    """``count_step`` of a step that repeats one unit of work ``n`` times
    (a train step's microbatches), from its counts at ``_AT``'s two
    repetition counts (``step_of(k)``: the step's (fn, args) at k): every
    count is linear in the repetitions from the third on, the live peak
    too, which such a repetition reaches beside the running accumulator,
    and which then moves with the arguments' bytes alone (the rows of
    each repetition). The results' bytes (``_RESULTS``) are the step's
    state and metrics at any count, taken from the larger count's.
    Exact on meta tensors, as ``count_step`` is; ``n`` at or below
    ``_AT[1]`` is counted whole."""
    def count(k):
        fn, args = step_of(k)
        return count_step(fn, *args)
    lo_n, hi_n = _AT
    if n <= hi_n:
        return count(n)
    lo, hi = count(lo_n), count(hi_n)
    per = dict(hi)
    for key, v in hi.items():
        if key not in _RESULTS:
            per[key] = v + (n - hi_n) * (v - lo[key]) // (hi_n - lo_n)
    return per


# the repetition counts ``count_repeated`` counts at: the first two
# repetitions differ from the rest (the fp32 accumulator is made on the
# first), and the live peak settles from the third on
_AT = (3, 4)
# ``count_step``'s keys that count the step's results, not its work
_RESULTS = ("out_bytes", "alias_bytes")
