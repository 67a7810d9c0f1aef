"""Continuous-batching scheduler: FIFO admission, dynamic page growth,
preemption, eviction, backfill.

Pure host-side bookkeeping (no jax) so the policy is unit-testable without
a model. The scheduler owns batch slots and, via the page allocator, KV
pages; the engine owns the device arrays.

Pages are allocated **lazily**: admission reserves only the pages the
prompt (plus the first generated token) needs, and a sequence grows
page-by-page as decode crosses block boundaries (``ensure_capacity``).
When the pool is exhausted mid-growth, the **youngest** active sequence is
preempted — its pages are freed and it is requeued at the FIFO front with
its generated tokens folded into the prompt (recompute-style preemption, so
its next admission re-prefills the extended prompt and resumes exactly
where it stopped). Preempting youngest-first keeps the oldest sequences
draining, so the loop makes progress and admission stays starvation-free.
``reserve_upfront=True`` restores the legacy worst-case policy — every page
a request could ever need (``ceil((prompt + max_new) / page_size)``)
reserved at admission — kept as the conservative mode and the benchmark
baseline.

Head-of-line FIFO: if the front request doesn't fit, we wait for an
eviction rather than skip it (starvation-free).

Under the SPMD engine (serving/engine/sharded.py) every bit of this state
— queue, slots, page lists, births, prefill progress — stays host-side and
device-count-agnostic: a physical page id names the same logical page on
every shard (each holds a 1/N kv-head slice of it), so admission, growth,
preemption, window-trim, and chunk accounting run unchanged on any mesh.

The scheduler owns the queue-side edges of each request's telemetry span
(serving/telemetry): ``enqueue`` at submit, ``admit`` on slot grant,
``preempt``/``requeue`` on a recompute preemption, ``release`` at
eviction. The engine adds the compute-side edges (``chunk``,
``first_token``, ``finish``). Both write into the same per-engine
`Telemetry` recorder; a standalone scheduler gets its own.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.engine.pool import PageAllocator
from repro_torch.serving.telemetry import Telemetry


@dataclasses.dataclass(eq=False)
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32 token ids
    max_new: int                 # tokens to generate (>= 1)
    eos_id: Optional[int] = None
    arrival: float = 0.0         # seconds since trace start


@dataclasses.dataclass(eq=False)
class ActiveSeq:
    req: Request
    slot: int
    pages: List[int]
    birth: int = 0               # admission order (preemption picks max)
    pos: int = 0                 # tokens currently cached
    prefill_progress: int = 0    # prompt tokens resident in the pool
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def last_token(self) -> int:
        return self.generated[-1]

    @property
    def prefill_done(self) -> bool:
        """True once the whole prompt is resident (and the first token
        sampled) — chunk-pending sequences stay out of the decode batch."""
        return self.prefill_progress >= len(self.req.prompt)

    def is_done(self) -> bool:
        if len(self.generated) >= self.req.max_new:
            return True
        eos = self.req.eos_id
        return eos is not None and self.generated and \
            self.generated[-1] == eos


class Scheduler:
    def __init__(self, allocator: PageAllocator, max_batch: int,
                 max_model_len: int, *, reserve_upfront: bool = False,
                 telemetry: Optional[Telemetry] = None):
        self.allocator = allocator
        self.max_batch = max_batch
        self.max_model_len = max_model_len
        self.reserve_upfront = reserve_upfront
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.queue: deque = deque()
        self.active: Dict[int, ActiveSeq] = {}     # slot -> seq
        self._free_slots = list(reversed(range(max_batch)))
        self._births = 0
        self.num_preempted = 0

    # ---------------------------------------------------------- lifecycle --
    def submit(self, req: Request) -> None:
        total = len(req.prompt) + req.max_new
        if total > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={total} exceeds "
                f"max_model_len={self.max_model_len}")
        self.queue.append(req)
        self.telemetry.seq_event(req.rid, "enqueue",
                                 prompt=len(req.prompt), max_new=req.max_new,
                                 queue_depth=len(self.queue))

    def admit(self, now: float = float("inf")) -> List[ActiveSeq]:
        """Admit FIFO-front requests while a batch slot and enough pages are
        available — the prompt's pages plus one decode slot (and, while
        other sequences are in flight, one free page of growth headroom) by
        default; the full worst-case lifetime with ``reserve_upfront``.
        Returns newly admitted sequences (prefill still pending — the
        engine runs it)."""
        admitted = []
        while self.queue and self._free_slots:
            req = self.queue[0]
            if req.arrival > now:
                break
            tokens = len(req.prompt) + (req.max_new if self.reserve_upfront
                                        else 1)
            n = self.allocator.pages_for(tokens)
            if not self.reserve_upfront and self.active \
                    and self.allocator.num_free < n + 1:
                # growth watermark: admitting into the pool's last pages
                # invites paying a full prefill only to be preempted by an
                # older sequence's very next page boundary — leave one page
                # of headroom while anything else is in flight.
                break
            pages = self.allocator.alloc(n)
            if pages is None:
                break                       # wait for an eviction (FIFO)
            self.queue.popleft()
            slot = self._free_slots.pop()
            seq = ActiveSeq(req=req, slot=slot, pages=pages,
                            birth=self._births)
            self._births += 1
            self.active[slot] = seq
            admitted.append(seq)
            self.telemetry.seq_event(req.rid, "admit", slot=slot,
                                     pages=len(pages),
                                     queue_depth=len(self.queue))
        return admitted

    def ensure_capacity(self, seq: ActiveSeq) -> bool:
        """Grow ``seq`` page-by-page until it can cache the token at
        ``seq.pos``. False if the pool is exhausted (caller preempts)."""
        needed = self.allocator.pages_for(seq.pos + 1)
        while len(seq.pages) < needed:
            got = self.allocator.alloc(1)
            if got is None:
                return False
            seq.pages.extend(got)
        return True

    def trim_window(self, seq: ActiveSeq, window: int) -> int:
        """Free the pages of logical blocks wholly behind ``seq``'s sliding
        window (every slot at kpos <= seq.pos - window, dead for the query
        at seq.pos and every later one) — the ROADMAP's "trim the pages
        themselves" item. Only valid when EVERY attention layer is local
        (pages are shared across layers; one global layer pins the full
        history — the engine checks this once at construction).

        Freed slots stay in ``seq.pages`` as logical-block placeholders
        (page 0, the scratch sentinel the page-table tails already use):
        the walk's per-sequence lower bound ``(pos - window + 1) // page``
        never reads them, and release/preempt skip them. Returns the number
        of pages released."""
        page = self.allocator.page_size
        lo = max((seq.pos - window + 1) // page, 0)
        dead = [p for p in seq.pages[:lo] if p != 0]
        if dead:
            self.allocator.free(dead)
            seq.pages[:lo] = [0] * lo
        return len(dead)

    def decode_ready(self) -> List[ActiveSeq]:
        """Active sequences eligible for the decode batch: prompt fully
        resident in the pool. Chunk-pending sequences keep their batch
        slot but ride no decode tick until their final chunk lands."""
        return [s for s in self.active.values() if s.prefill_done]

    def prefill_pending(self) -> List[ActiveSeq]:
        """Active sequences still owing prompt chunks, admission order —
        the engine runs at most one chunk per tick for each."""
        return sorted((s for s in self.active.values()
                       if not s.prefill_done), key=lambda s: s.birth)

    def youngest_active(self) -> Optional[ActiveSeq]:
        """The preemption victim candidate: the most recently admitted
        active sequence. Pages always flow from younger to older — a
        growing sequence may preempt the youngest, and if it *is* the
        youngest it yields (self-preempts) rather than stalling an older
        sequence — so the FIFO head keeps draining."""
        if not self.active:
            return None
        return max(self.active.values(), key=lambda s: s.birth)

    def preempt(self, seq: ActiveSeq) -> None:
        """Free ``seq``'s slot and pages and requeue it at the FIFO front as
        a prompt-extension: the tokens it already generated become part of
        the prompt, so re-admission re-prefills them (recompute) and greedy
        outputs are unchanged. The caller's Request object is left intact —
        the extension rides a fresh Request with the same rid. (Sampled
        decode re-draws its RNG keys from the new generation offsets after
        a preemption.)

        A mid-prefill victim (prefill_progress < prompt, nothing generated
        yet) is only ever preempted at a chunk boundary — the engine runs
        chunks between scheduler phases — and its partially written pages
        are freed with the rest: re-admission restarts the prompt from
        chunk 0, so resumption is trivially token-identical (prefill is
        deterministic and the fresh ActiveSeq's prefill_progress is 0)."""
        del self.active[seq.slot]
        self.allocator.free([p for p in seq.pages if p != 0])
        self._free_slots.append(seq.slot)
        assert seq.req.max_new > len(seq.generated), \
            "done sequences are evicted, not preempted"
        resumed = dataclasses.replace(
            seq.req,
            prompt=np.concatenate([np.asarray(seq.req.prompt, np.int32),
                                   np.asarray(seq.generated, np.int32)]),
            max_new=seq.req.max_new - len(seq.generated))
        self.queue.appendleft(resumed)
        self.num_preempted += 1
        self.telemetry.seq_event(seq.req.rid, "preempt",
                                 generated=len(seq.generated),
                                 pages_freed=sum(p != 0 for p in seq.pages))
        self.telemetry.seq_event(seq.req.rid, "requeue",
                                 prompt=len(resumed.prompt),
                                 max_new=resumed.max_new)

    def release(self, seq: ActiveSeq) -> None:
        """Evict a finished sequence: free its pages and batch slot so the
        next admit() can backfill mid-flight (window-trimmed blocks are
        already free and ride along as page-0 placeholders)."""
        del self.active[seq.slot]
        self.allocator.free([p for p in seq.pages if p != 0])
        self._free_slots.append(seq.slot)
        self.telemetry.seq_event(seq.req.rid, "release",
                                 generated=len(seq.generated))

    # -------------------------------------------------------------- state --
    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue or self.active)
