"""Paged KV-cache pool: host-side page allocator + device-side pool tensors
(port of ``repro.serving.engine.pool``).

The allocator is plain Python (a free list). The device pool is the dict
from ``Model.init_pool``; page 0 is reserved as scratch: idle batch slots
and unused page-table tails write/gather there, so writes never need
masking inside the decode step.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.models.attention import write_kv
from repro_torch.models.params import tree_leaves


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical pages (page 0 is the
    scratch page and is never handed out).

    Tracks the allocated set so a double-free is rejected instead of
    silently entering the free list twice — a page freed twice would be
    handed to two sequences, which corrupts both KV streams."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: deque = deque(range(1, num_pages))
        self._allocated: set = set()
        # lifetime telemetry counters (serving/telemetry): tick events
        # report alloc/free *deltas* by differencing these, and min_free
        # is the free-page low-water mark.
        self.total_allocated = 0
        self.total_freed = 0
        self.min_free = len(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Reserve n pages, or None if the pool can't satisfy the request."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._allocated.update(pages)
        self.total_allocated += n
        self.min_free = min(self.min_free, len(self._free))
        return pages

    def free(self, pages: Sequence[int]) -> None:
        seen = set()
        for p in pages:
            if not 1 <= p < self.num_pages:
                raise ValueError(f"freeing invalid page {p}")
            if p not in self._allocated or p in seen:
                raise ValueError(f"double free of page {p}")
            seen.add(p)
        self._allocated.difference_update(seen)
        self._free.extend(pages)
        self.total_freed += len(seen)


class JitLRU:
    """Bounded per-shape cache of step closures keyed by a shape tuple. The
    reference keeps one ``jax.jit`` per padding bucket here; the port runs
    eagerly, so entries are plain closures, and the cache keeps its bound
    and its hit/miss counters (the telemetry gauges ``jit.*`` read them)
    for the compiled or CUDA-graph steps a later slice may hold."""

    def __init__(self, cap: int = 8):
        self.cap = cap
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, make: Callable):
        fn = self._d.get(key)
        if fn is None:
            self.misses += 1
            fn = make()
            self._d[key] = fn
            while len(self._d) > self.cap:
                self._d.popitem(last=False)
        else:
            self.hits += 1
            self._d.move_to_end(key)
        return fn


class PagedKVPool:
    """Device pool tensors + the allocator that tracks their occupancy.
    Each sub-layer slot's k/v pool is bf16, or quantized ({"q", "scale"},
    see serving/kvquant) under ``kv_bits``.

    Under a mesh (``spmd``, serving/engine/sharded.py) each rank holds its
    kv-head slice of every page, codes and scale tiles alike; page ids are
    the same on every rank, so the span writer scatters a cache of the
    rank's own kv heads locally, unchanged."""

    WRITE_JIT_CAP = 8   # LRU cap on per-(n_pages, cache_len) writers

    def __init__(self, model, num_pages: int, page_size: int, *, device,
                 kv_bits=None, spmd=None):
        self.allocator = PageAllocator(num_pages, page_size)
        self.page_size = page_size
        self.kv_bits = kv_bits
        if spmd is None:
            self.pool = model.init_pool(num_pages, page_size,
                                        kv_bits=kv_bits, device=device)
        else:
            self.pool = spmd.init_pool(num_pages, page_size, device=device)
        self._write_jit = JitLRU(self.WRITE_JIT_CAP)

    @property
    def num_free(self) -> int:
        return self.allocator.num_free

    def write_prefill(self, cache, pages: Sequence[int], *,
                      start: int = 0) -> None:
        """Scatter one request's prefill cache (full layout, B=1,
        bucket-padded length) into its pages, in place (the reference
        donates the pool to the same effect). Bucket-padding garbage
        beyond the true prompt lands only inside the request's own pages
        and stays behind the mask (j <= pos) or is overwritten by decode.

        ``start`` writes a per-chunk *span*: a cache holding tokens
        ``start..start+cache_len`` of the sequence lands at that offset
        within ``pages`` (chunk boundaries must be page-aligned). Pages
        past the span's end are (re)padded, so spans must be written in
        chunk order.

        Quantized slots quantize on write (models/attention.py::
        write_kv): the bf16 prefill pages become int8/int4 codes plus
        per-token scales (padding slots quantize too, harmlessly — they
        stay behind the mask)."""
        page = self.page_size
        if start % page:
            raise ValueError(
                f"span start {start} is not page-aligned (page={page})")
        pages = list(pages)[start // page:]
        n = len(pages)
        Sp = next(iter(next(iter(cache.values())).values())).shape[2]
        span = n * page

        def make():
            def write(pool, cache, idx):
                for slot, kv in cache.items():
                    for name, c in kv.items():
                        c = c[:, 0]                     # (G, Sp, K, hd)
                        if Sp >= span:
                            c = c[:, :span]
                        else:
                            c = torch.nn.functional.pad(
                                c, (0, 0, 0, 0, 0, span - Sp))
                        c = c.reshape(c.shape[0], n, page, *c.shape[2:])
                        write_kv(pool[slot][name], (slice(None), idx), c)
            return write

        fn = self._write_jit.get((n, Sp), make)
        idx = torch.tensor(pages, dtype=torch.long,
                           device=tree_leaves(self.pool)[0].device)
        fn(self.pool, cache, idx)
