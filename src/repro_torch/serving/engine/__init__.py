"""Continuous-batching serving engine with a paged KV-cache pool (port of
``repro.serving.engine``; its package docstring describes the page-table
layout, the chunked-prefill lifecycle and the telemetry this port keeps).

Pool layout, as in the reference::

    pool["sub{j}"]["k"|"v"] : (n_groups, num_pages, page_size, K, hd) bf16

Page 0 is scratch; page ids are shared by every layer. The port updates
the pool in place where the reference donates it, and walks it with the
hand-written CUDA kernels of ``repro_torch.kernels`` on the card.

Modules: `pool` (page allocator + device pool + span writer), `scheduler`
(FIFO admission / growth / preemption / eviction / window-trim),
`admission` (roofline-derived policy), `engine` (the host loop).
"""
from repro_torch.serving.engine.admission import AdmissionPolicy, \
    derive_policy
from repro_torch.serving.engine.engine import Engine
from repro_torch.serving.engine.pool import PageAllocator, PagedKVPool
from repro_torch.serving.engine.scheduler import Request, Scheduler

__all__ = ["AdmissionPolicy", "derive_policy", "Engine", "PageAllocator",
           "PagedKVPool", "Request", "Scheduler"]
