"""The serving engine (port of ``repro.serving.engine.engine``): ties
model, paged pool, and scheduler into a host loop of interleaved prefill
and decode ticks.

One ``step()``:
  1. admission — backfill free batch slots from the FIFO queue (page-
     and slot-gated, see scheduler.py). In chunked mode (default) nothing
     runs yet; with ``chunked_prefill=False`` the whole prompt runs here,
     padded to the policy's bucket, through the model's whole-sequence
     forward (flash attention from 2048 padded tokens on), and is
     scattered into its pages;
  2. chunked prefill — every mid-prefill sequence advances by at most ONE
     ``policy.prefill_chunk``-token chunk: the chunk's K/V are written
     into the sequence's pages and its attention walks the pool (resident
     prefix + chunk) through the paged prefill kernel. The final chunk
     unembeds the last real prompt row and samples the first token;
  3. growth — every decode-ready sequence whose position crosses a page
     boundary grows by one page; on pool exhaustion the youngest active
     sequence is preempted (freed + requeued as a prompt-extension);
  4. decode tick — one batched ``decode_step_paged`` over the surviving
     prefill-complete slots (idle slots ride along against the scratch
     page and are ignored), through the paged decode kernel;
  5. eviction — finished sequences free their pages/slot immediately.

``paged_kernel`` ("auto" | "cuda" | "ref", kernels/ops.py) selects every
attention kernel the engine reaches: the paged walks and whole-prompt
flash attention. The reference jits its step closures and donates the
pool; this port runs eagerly and updates the pool in place. Every tick
emits a telemetry ``TickEvent`` whose measured time is fenced with
``torch.cuda.synchronize()`` on the card before the timer stops, next to
the admission roofline's prediction for the same dispatch shape.

``policy.kv_bits`` selects a quantized KV pool (int8, int4 or mixed per
sub-layer slot, serving/kvquant): every pool writer quantizes on write and
attention runs the fused-dequant walks. ``policy.quant_bits < 16`` serves
HAQ-quantized weights (serving/quant.py): the matmul weights are stored
int8 or int4 and the ``dequant_dot`` hook reaches every matmul of the
decode, chunk and whole-prompt prefill calls and the unembed — the W8A16
and W4A16 kernels on the stored codes on the card.

``mesh`` (a ("data", "model") DeviceMesh from launch/mesh.py, one process
per rank) serves through serving/engine/sharded.py: parameters and the
pool split over the mesh, every tick's body the same one, given the
sharded dot sites and a per-layer gather hook; every rank runs this
loop on the same requests and returns the same outputs. As in the
reference, a mesh refuses quantized weights.

The dense and moe families are served; a moe layer routes every row of a
tick, padding rows and idle slots included, through its fixed-capacity
expert dispatch (models/moe.py), as the reference's does.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.transformer import normalize_kv_bits, sublayer_kinds
from repro_torch.serving import quant as squant
from repro_torch.serving.engine.admission import AdmissionPolicy, \
    RooflinePredictor
from repro_torch.serving.engine import sharded
from repro_torch.serving.engine.pool import JitLRU, PagedKVPool
from repro_torch.serving.engine.scheduler import ActiveSeq, Request, \
    Scheduler
from repro_torch.serving.telemetry import Telemetry, TickEvent


def sample_token(logits_row, temperature: float,
                 generator: Optional[torch.Generator]) -> int:
    """One token from a (V,) f32 logits row (a host numpy array). Greedy
    takes the first maximum, as np.argmax does; sampling draws from
    ``generator``."""
    if temperature <= 0.0 or generator is None:
        return int(np.argmax(logits_row))
    probs = torch.softmax(torch.as_tensor(logits_row) / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    PREFILL_JIT_CAP = 8   # LRU cap on per-bucket prefill closures

    def __init__(self, model, params, policy: AdmissionPolicy, *,
                 temperature: float = 0.0, seed: int = 0,
                 paged_kernel: str = "auto", reserve_upfront: bool = False,
                 chunked_prefill: bool = True, mesh=None,
                 telemetry: Optional[Telemetry] = None,
                 roofline_scales=None):
        cfg = model.cfg
        if cfg.is_encdec or cfg.family not in ("dense", "moe") \
                or cfg.frontend != "none":
            raise NotImplementedError(
                f"the port's engine serves the dense and moe families so "
                f"far; {cfg.name} (family={cfg.family!r}, "
                f"frontend={cfg.frontend!r}) waits for its slice (ROADMAP)")
        if mesh is not None and policy.quant_bits < 16:
            raise NotImplementedError(
                "sharded engine with HAQ weight quantization: quantized "
                "weight dicts have no logical specs yet (ROADMAP); use "
                "kv_bits for sharded memory savings")
        self.model = model
        self.policy = policy
        self.temperature = temperature
        self.seed = seed
        dot = None
        if policy.quant_bits < 16:
            params = squant.quantize_params(
                params, default_bits=policy.quant_bits)
            dot = squant.dequant_dot
        self.kv_bits = normalize_kv_bits(cfg, policy.kv_bits)
        # sharded serving (sharded.py): parameters split at rest, the pool
        # split on kv heads; the unsharded engine is the token-exact
        # baseline the sharded one is held to
        spmd = None
        if mesh is not None:
            spmd = sharded.SpmdEngine(model, mesh, kv_bits=self.kv_bits)
            params = spmd.shard_params(params)
        self.spmd = spmd
        self.params = params
        self.device = params["embed"].device
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        # ``roofline_scales`` (a telemetry.ScaleLookup fitted on this host
        # by telemetry.calibrate) turns each tick's roofline prediction
        # into the calibrated one the autotuner searches on
        self._predict = RooflinePredictor(cfg, policy,
                                          scales=roofline_scales)

        # Allocate only the pages max_batch concurrent sequences can use,
        # capped by what the target's memory holds (policy.num_pages) and
        # floored at one full-length sequence plus scratch.
        needed = policy.max_batch * policy.pages_per_seq + 1
        num_pages = max(min(policy.num_pages, needed),
                        policy.pages_per_seq + 1)
        self.kv = PagedKVPool(model, num_pages, policy.page_size,
                              device=self.device, kv_bits=self.kv_bits,
                              spmd=spmd)
        self.scheduler = Scheduler(self.kv.allocator, policy.max_batch,
                                   policy.max_model_len,
                                   reserve_upfront=reserve_upfront,
                                   telemetry=self.telemetry)
        self._tags: Dict[str, int] = spmd.event_tags() if spmd else {}
        # Window-trim page freeing: pages are shared across layers, so
        # blocks behind the sliding window can only be released when EVERY
        # layer is local.
        kinds = sublayer_kinds(cfg)
        self._trim_window = cfg.window_size if (
            not reserve_upfront and kinds
            and all(k["attn"] == "local" for k in kinds)) else None

        # one body per step kind; under a mesh the same bodies take the
        # sharded dot sites and the per-layer gather hook
        gather = None
        if spmd is not None:
            dot, gather = spmd.dot, spmd.gather

        def prefill_body(p, toks, last_idx):
            # unembed only the last real prompt position
            hidden, cache, _, _ = model.forward(
                p, {"tokens": toks}, want_cache=True, unembed_mode="none",
                cache_layout="full", dot=dot, kernel=paged_kernel,
                gather=gather)
            return model.unembed(p, hidden[:, last_idx:last_idx + 1],
                                 dot=dot, gather=gather), cache

        self._decode = lambda p, pool, pt, tok, pos: \
            model.decode_step_paged(p, pool, pt, tok, pos,
                                    kernel=paged_kernel, dot=dot,
                                    gather=gather)
        self._chunk_prefill = lambda p, pool, pt, toks, pos: \
            model.prefill_chunk_paged(p, pool, pt, toks, pos,
                                      kernel=paged_kernel, dot=dot,
                                      gather=gather)
        self._unembed_row = lambda p, h: model.unembed(p, h, dot=dot,
                                                       gather=gather)
        self._make_prefill = lambda: prefill_body
        self._prefill_jits = JitLRU(self.PREFILL_JIT_CAP)
        self.chunked = chunked_prefill
        self.stats = {"decode_ticks": 0, "decode_tokens": 0,
                      "prefills": 0, "prefill_chunks": 0, "admitted": 0,
                      "preemptions": 0, "grown_pages": 0,
                      "trimmed_pages": 0}
        self._outputs: Dict[int, np.ndarray] = {}
        self._step_idx = 0
        self._step_admitted = 0
        self._alloc_mark = self._free_mark = 0
        self._trim_mark = self._preempt_mark = 0

    # --------------------------------------------------- telemetry views --
    @property
    def stall_log(self) -> List[float]:
        """Measured per-decode-tick prefill stall seconds."""
        return self.telemetry.stall_log_view()

    @property
    def first_token_s(self) -> Dict[int, float]:
        """rid -> time-to-first-token seconds (trace clock)."""
        return self.telemetry.first_token_view()

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def reset_stats(self) -> None:
        """Zero the counters, telemetry, and held outputs (allocator
        lifetime counters persist; the delta marks re-anchor on them)."""
        for k in self.stats:
            self.stats[k] = 0
        self.scheduler.num_preempted = 0
        self._outputs.clear()
        self.telemetry.reset()
        self._step_idx = 0
        self._step_admitted = 0
        alloc = self.kv.allocator
        self._alloc_mark = alloc.total_allocated
        self._free_mark = alloc.total_freed
        self._trim_mark = self._preempt_mark = 0
        alloc.min_free = alloc.num_free

    # --------------------------------------------------------------- step --
    def step(self, now: float = float("inf")) -> List[int]:
        """One scheduler tick: admit, run prefill work, then one batched
        decode over the prefill-complete sequences. Returns the rids that
        finished during this step."""
        self.telemetry.start_clock()
        self._step_idx += 1
        self._step_admitted = 0
        out: List[int] = []
        ready_before = len(self.scheduler.decode_ready())
        stall_pred = 0.0
        t_prefill = time.monotonic()
        for seq in self.scheduler.admit(now):
            self.stats["admitted"] += 1
            self._step_admitted += 1
            if not self.chunked:
                stall_pred += self._run_prefill(seq)
                if seq.is_done():
                    out.append(self._finish(seq))
        if self.chunked:
            for seq in self.scheduler.prefill_pending():
                stall_pred += self._run_prefill_chunk(seq)
                if seq.prefill_done and seq.is_done():
                    out.append(self._finish(seq))
        t_prefill = time.monotonic() - t_prefill
        live = self.scheduler.decode_ready()
        if live:
            finished: List[ActiveSeq] = []
            ticks_before = self.stats["decode_ticks"]
            self._decode_tick(live, finished)
            if self.stats["decode_ticks"] > ticks_before and ready_before:
                self.telemetry.stall(t_prefill, stall_pred)
            for seq in finished:
                out.append(self._finish(seq))
        self._update_gauges()
        return out

    # ---------------------------------------------------- telemetry emit --
    def _tick_deltas(self) -> Dict[str, int]:
        a = self.kv.allocator
        trimmed = self.stats["trimmed_pages"]
        preempted = self.scheduler.num_preempted
        d = {"pages_allocated": a.total_allocated - self._alloc_mark,
             "pages_freed": a.total_freed - self._free_mark,
             "pages_trimmed": trimmed - self._trim_mark,
             "preempted": preempted - self._preempt_mark}
        self._alloc_mark = a.total_allocated
        self._free_mark = a.total_freed
        self._trim_mark = trimmed
        self._preempt_mark = preempted
        return d

    def _emit_tick(self, kind: str, t_start: float, measured_s: float,
                   predicted_s: float, *, batch: int, padded_batch: int,
                   q_len: int, tokens: int, rids) -> None:
        a = self.kv.allocator
        self.telemetry.tick(TickEvent(
            kind=kind, step=self._step_idx, t_start=t_start,
            measured_s=measured_s, predicted_s=predicted_s, batch=batch,
            padded_batch=padded_batch, q_len=q_len, tokens=tokens,
            rids=tuple(rids), admitted=self._step_admitted,
            queue_depth=self.scheduler.num_queued, pool_free=a.num_free,
            pool_allocated=a.num_allocated, tags=self._tags,
            **self._tick_deltas()))

    def _update_gauges(self) -> None:
        m = self.telemetry.metrics
        a = self.kv.allocator
        page = a.page_size
        used = 0
        for seq in self.scheduler.active.values():
            live_pages = sum(p != 0 for p in seq.pages)
            trimmed = len(seq.pages) - live_pages
            used += max(min(seq.pos - trimmed * page, live_pages * page), 0)
        cap = a.num_allocated * page
        occ = used / cap if cap else 0.0
        m.gauge("pool.occupancy").set(occ)
        m.gauge("pool.fragmentation").set(1.0 - occ if cap else 0.0)
        m.gauge("pool.min_free").set(a.min_free)
        m.gauge("jit.prefill.hits").set(self._prefill_jits.hits)
        m.gauge("jit.prefill.misses").set(self._prefill_jits.misses)
        m.gauge("jit.pool_writer.hits").set(self.kv._write_jit.hits)
        m.gauge("jit.pool_writer.misses").set(self.kv._write_jit.misses)

    def _finish(self, seq: ActiveSeq) -> int:
        self.telemetry.seq_event(seq.req.rid, "finish",
                                 generated=len(seq.generated))
        self.scheduler.release(seq)
        self._outputs[seq.req.rid] = np.concatenate(
            [np.asarray(seq.req.prompt, np.int32),
             np.asarray(seq.generated, np.int32)])
        return seq.req.rid

    def _first_token(self, seq: ActiveSeq, logits_row) -> None:
        """Sample the prompt's first generated token and stamp the
        request's time-to-first-token."""
        tok = sample_token(logits_row, self.temperature,
                           self._step_generator(seq))
        seq.generated.append(tok)
        seq.pos = len(seq.req.prompt)
        self.stats["prefills"] += 1
        self.telemetry.seq_event(seq.req.rid, "first_token", token=tok)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _run_prefill(self, seq: ActiveSeq) -> float:
        """Whole-prompt prefill (chunked_prefill=False): one forward over
        the prompt padded to the policy's bucket, scattered into the
        sequence's pages afterwards. Returns the roofline's predicted
        seconds for the dispatch."""
        prompt = np.asarray(seq.req.prompt, np.int32)
        S = len(prompt)
        chunk = self.policy.prefill_chunk
        Sp = -(-S // chunk) * chunk
        toks = np.zeros((1, Sp), np.int32)
        toks[0, :S] = prompt
        t_start = time.monotonic()
        prefill = self._prefill_jits.get(Sp, self._make_prefill)
        logits, cache = prefill(self.params, self._tensor(toks), S - 1)
        self.kv.write_prefill(cache, seq.pages)
        _sync(self.device)
        pred = self._predict("prefill", 1, Sp)
        self._emit_tick("prefill", t_start, time.monotonic() - t_start,
                        pred, batch=1, padded_batch=1, q_len=Sp, tokens=S,
                        rids=(seq.req.rid,))
        seq.prefill_progress = S
        self._first_token(seq, logits[0, 0].cpu().numpy())
        return pred

    def _run_prefill_chunk(self, seq: ActiveSeq) -> float:
        """One prompt chunk through the prefill-with-cache forward. The
        final chunk unembeds the last real prompt row and samples the first
        generated token. Returns the roofline's predicted seconds for the
        chunk."""
        prompt = np.asarray(seq.req.prompt, np.int32)
        S = len(prompt)
        C = self.policy.prefill_chunk
        start = seq.prefill_progress
        end = min(start + C, S)
        toks = np.zeros((1, C), np.int32)
        toks[0, :end - start] = prompt[start:end]
        maxp = self.policy.pages_per_seq
        pt = np.zeros((1, maxp), np.int32)
        pt[0, :len(seq.pages)] = seq.pages
        t_start = time.monotonic()
        hidden, self.kv.pool = self._chunk_prefill(
            self.params, self.kv.pool, self._tensor(pt), self._tensor(toks),
            self._tensor(np.asarray([start], np.int32)))
        # fence before the step's stall timer stops: launches are async
        _sync(self.device)
        pred = self._predict("chunk", 1, C)
        self._emit_tick("chunk", t_start, time.monotonic() - t_start,
                        pred, batch=1, padded_batch=1, q_len=C,
                        tokens=end - start, rids=(seq.req.rid,))
        self.telemetry.seq_event(seq.req.rid, "chunk", start=start, end=end)
        seq.prefill_progress = end
        seq.pos = end
        self.stats["prefill_chunks"] += 1
        if end == S:
            row = S - 1 - start
            logits = self._unembed_row(self.params, hidden[:, row:row + 1])
            self._first_token(seq, logits[0, 0].cpu().numpy())
        return pred

    def _is_live(self, seq: ActiveSeq) -> bool:
        return self.scheduler.active.get(seq.slot) is seq

    def _decode_tick(self, live: List[ActiveSeq],
                     finished: List[ActiveSeq]) -> None:
        # Growth phase, oldest first: crossing a page boundary claims a new
        # page; exhaustion preempts the youngest active sequence — the
        # grower itself, if it is the youngest.
        live = sorted(live, key=lambda s: s.birth)
        for seq in live:
            if not self._is_live(seq):
                continue                    # preempted earlier this tick
            if self._trim_window:
                self.stats["trimmed_pages"] += self.scheduler.trim_window(
                    seq, self._trim_window)
            before = len(seq.pages)
            while not self.scheduler.ensure_capacity(seq):
                victim = self.scheduler.youngest_active()
                if victim is seq and self.scheduler.num_active == 1:
                    raise RuntimeError(
                        "page pool smaller than one max-length sequence")
                self.scheduler.preempt(victim)
                if victim is seq:
                    break                   # yielded to older sequences
            if self._is_live(seq):
                self.stats["grown_pages"] += len(seq.pages) - before
        self.stats["preemptions"] = self.scheduler.num_preempted
        ready = [s for s in live if self._is_live(s)]
        if not ready:
            return

        B = self.policy.max_batch
        maxp = self.policy.pages_per_seq
        tokens = np.zeros((B, 1), np.int32)
        # idle slots ride along against the scratch page; they carry the
        # minimum live position so the plain walk's batch-wide window
        # bound stays tight
        positions = np.full((B,), min(s.pos for s in ready), np.int32)
        pt = np.zeros((B, maxp), np.int32)       # 0 -> scratch page
        for seq in ready:
            tokens[seq.slot, 0] = seq.last_token
            positions[seq.slot] = seq.pos
            pt[seq.slot, :len(seq.pages)] = seq.pages
        t_start = time.monotonic()
        logits, self.kv.pool = self._decode(
            self.params, self.kv.pool, self._tensor(pt),
            self._tensor(tokens), self._tensor(positions))
        # fence before the host transfer so the tick's measured duration
        # is launch + compute, not whenever the stream drains
        _sync(self.device)
        measured = time.monotonic() - t_start
        rows = logits[:, 0].cpu().numpy()    # one host transfer per tick
        self.stats["decode_ticks"] += 1
        self._emit_tick("decode", t_start, measured,
                        self._predict("decode", B, 1), batch=len(ready),
                        padded_batch=B, q_len=1, tokens=len(ready),
                        rids=(s.req.rid for s in ready))
        for seq in ready:
            tok = sample_token(rows[seq.slot], self.temperature,
                               self._step_generator(seq))
            seq.generated.append(tok)
            seq.pos += 1
            self.stats["decode_tokens"] += 1
            if seq.is_done():
                finished.append(seq)

    def _step_generator(self, seq: ActiveSeq) -> Optional[torch.Generator]:
        """A CPU generator seeded from (engine seed, rid, step): the same
        draw whatever the batch composition."""
        if self.temperature <= 0.0:
            return None
        step_seed = (self.seed * 1_000_003 + seq.req.rid) * 1_000_003 \
            + len(seq.generated)
        return torch.Generator().manual_seed(step_seed % (2 ** 63))

    # ---------------------------------------------------------------- run --
    def run(self, requests: List[Request], *,
            realtime: bool = False) -> Dict[int, np.ndarray]:
        """Serve a trace to completion. With ``realtime=True`` requests are
        admitted no earlier than their ``arrival`` offset (wall clock; rank
        0's under a mesh); otherwise arrivals are ignored (burst)."""
        for r in requests:
            self.submit(r)
        t0 = time.monotonic()
        while self.scheduler.has_work():
            now = (time.monotonic() - t0) if realtime else float("inf")
            if realtime and self.spmd is not None:
                now = self.spmd.rank0_clock(now)
            if not self.step(now) and not self.scheduler.active:
                time.sleep(1e-4)             # waiting on future arrivals
        return {r.rid: self._outputs[r.rid] for r in requests}
