"""Hardware-aware admission policy, derived from the roofline hardware model
(port of ``repro.serving.engine.admission``; the port's serving entry
points size it for ``h100-sxm``).

`derive_policy` answers, per hardware target, the questions the scheduler
must not answer by guessing:

  * ``num_pages``   — how much KV the target's HBM holds after weights
                      (the memory roofline; paper Fig. 4's y-intercept)
  * ``max_batch``   — largest in-flight batch whose decode step still meets
                      the latency SLO (decode is memory-bound on the edge
                      chip, compute/collective-bound on pod slices)
  * ``prefill_chunk`` — prompt chunk per engine tick: the largest chunk
                      whose prefill-with-cache forward keeps the
                      *per-tick* decode stall within the stall budget
                      (``prefill_stall_factor`` SLOs) — long prompts cost
                      more ticks, never a bigger stall. Whole-prompt mode
                      reuses it as the padding-bucket quantum.
  * ``quant_bits``  — 16 (bf16) unless weights + one sequence of KV exceed
                      the HBM budget, in which case the HAQ default bit
                      policy (serving/quant.py) is applied: 8, then 4
  * ``kv_bits``     — stored KV-cache bits for the page pool
                      (serving/kvquant): every sizing quantity above is
                      priced at the quantized width, so an int8 pool holds
                      ~2x the pages and admits ~2x the resident sequences
                      in the same HBM

All quantities come from `core/hardware_model.py` OpCosts — the same
roofline that drives NAS/AMC/HAQ at search time, now queried at serve time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import hardware_model as hwm


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    hw_name: str
    max_model_len: int
    page_size: int
    num_pages: int          # pages the target's HBM can hold (incl. scratch)
    max_batch: int          # max in-flight sequences
    prefill_chunk: int      # prompt chunk per tick / padding quantum
    quant_bits: int         # 16 = bf16 weights; 8/4 = HAQ default bits
    decode_slo_s: float
    est_decode_s: float     # roofline decode-step latency at max_batch
    est_prefill_s: float    # roofline per-chunk (per-tick) prefill latency
    # stored KV-cache bits per sub-layer slot (serving/kvquant); None = bf16
    # pool. Cycled over layers like attn_pattern.
    kv_bits: Optional[Tuple[int, ...]] = None
    # serving mesh the policy was sized for (engine/sharded.py): the pool
    # shards kv_heads over `mesh_model` devices (per-device page bytes drop
    # ~Nx, so num_pages rises ~Nx in the same per-device HBM) and params
    # spread at rest over all mesh_model*mesh_data devices. 1/1 = the
    # single-device engine.
    mesh_model: int = 1
    mesh_data: int = 1

    @property
    def pages_per_seq(self) -> int:
        return -(-self.max_model_len // self.page_size)


def _kv_bits_for_layer(kv_bits, i: int) -> int:
    if kv_bits is None:
        return 16
    if isinstance(kv_bits, int):
        return kv_bits
    return kv_bits[i % len(kv_bits)]


def kv_bytes_per_token(cfg, kv_bits=None) -> int:
    """k+v bytes per cached token across all layers, at the pool's stored
    precision: bf16 by default; with a KV bit policy (int or per-sub-layer
    tuple, cycled like ``attn_pattern``) quantized slots store
    ``bits``-wide codes plus an fp32 scale per token per kv head for k and
    v each (serving/kvquant page layout). This is what sizes pages — so the
    whole admission roofline (pool capacity, expected-footprint batch,
    page bytes) is bit-policy-aware."""
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    total = 0
    for i in range(cfg.num_layers):
        b = _kv_bits_for_layer(kv_bits, i)
        per = 2 * K * (hd * b // 8)
        if b < 16:
            per += 2 * K * 4                 # fp32 scale tiles
        total += per
    return total


def _ffn_terms(cfg, i: int, tokens: int, hw, tp: int, w_bits):
    """FFN latency split into the part the sharded engine partitions over
    the model axis (up/gate projections — output-dim sharded) and the part
    that runs WHOLE on every device (the down-projection; the entire
    expert bank for MoE, whose weights are gathered at use), plus the
    at-rest weight bytes that gather costs. Their sum reproduces the
    single-device FFN latency exactly."""
    if cfg.is_moe_layer(i):
        m = cfg.moe
        mc = hwm.moe_cost(tokens, cfg.d_model, m.d_ff_expert,
                          m.num_experts, m.experts_per_token)
        return 0.0, float(mc.latency(hw, w_bits=w_bits)), \
            float(mc.weight_bytes) * w_bits / 16.0
    lin = hwm.linear_cost(tokens, cfg.d_model, cfg.d_ff, tp=tp)
    lat = float(lin.latency(hw, w_bits=w_bits))
    return 2.0 * lat, lat, float(lin.weight_bytes) * w_bits / 16.0


def step_latency(cfg, batch: int, q_len: int, ctx: int, hw: hwm.Hardware,
                 *, w_bits: int = 16, kv_bits=None,
                 mesh_model: int = 1) -> float:
    """Roofline latency of one forward step (q_len=1 -> decode tick).

    ``kv_bits`` (int or per-sub-layer tuple) prices the KV-cache reads at
    the pool's stored precision — the direct hardware feedback the kvquant
    HAQ search optimizes against. It applies to decode only: prefill
    attends its own fp activations before the pool write quantizes them.

    ``mesh_model`` prices the sharded engine FAITHFULLY to what
    engine/sharded.py runs per device: only the output-dim-sharded work
    splits N ways (q/k/v projections, the paged-attention walk — the
    decode-dominant KV reads — and the FFN up/gate projections); the
    contraction matmuls it refuses to psum-split for bit-exactness (attn
    out-projection, FFN down-projection, the MoE expert bank, unembed)
    run WHOLE on every device, and each layer additionally pays two
    residual-sized activation collectives (``hwm.allreduce_cost``) plus
    the ring all-gather of its at-rest-sharded weights
    (``hwm.gather_cost`` — the dominant ICI term for decode, which is why
    gather-based exact TP trades latency for capacity)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    tp = min(hw.chips, 16)
    shards = max(int(mesh_model), 1)
    tokens = batch * q_len
    decode = q_len == 1
    t = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.attn_pattern[i % len(cfg.attn_pattern)]
        window = cfg.window_size if kind == "local" else 0
        split = float(hwm.linear_cost(tokens, d, (H + 2 * K) * hd, tp=tp)
                      .latency(hw, w_bits=w_bits))
        split += float(hwm.attention_cost(
            batch, q_len, ctx, H, K, hd, window=window, decode=decode,
            kv_bits=_kv_bits_for_layer(kv_bits, i) if decode else 16)
            .latency(hw))
        out_proj = hwm.linear_cost(tokens, H * hd, d, tp=tp)
        whole = float(out_proj.latency(hw, w_bits=w_bits))
        f_split, f_whole, f_gather = _ffn_terms(cfg, i, tokens, hw, tp,
                                                w_bits)
        split += f_split
        whole += f_whole
        t += split / shards + whole
        if shards > 1:
            t += 2.0 * float(hwm.allreduce_cost(tokens, d, shards)
                             .latency(hw))
            gather = float(out_proj.weight_bytes) * w_bits / 16.0 + f_gather
            t += float(hwm.gather_cost(gather, shards).latency(hw))
    unembed = hwm.linear_cost(tokens, d, cfg.padded_vocab, tp=tp)
    t += float(unembed.latency(hw, w_bits=w_bits))
    if shards > 1:
        t += float(hwm.gather_cost(
            float(unembed.weight_bytes) * w_bits / 16.0, shards)
            .latency(hw))
    return t


class RooflinePredictor:
    """Memoized per-(kind, batch, q_len) roofline tick predictions for the
    telemetry layer (serving/telemetry): every engine tick event carries
    the `step_latency` prediction for its exact dispatch shape next to
    the measured wall clock, and `telemetry.calibrate` fits the two.

    Predictions price what the jit actually runs — the *padded* batch
    (idle decode slots ride along) at worst-case resident context, with
    the policy's weight bits, KV bit policy (decode only, matching
    `step_latency`), and mesh split. The memo makes the per-tick cost a
    dict lookup: decode always hits one key, chunk prefill one more, and
    whole-prompt prefill one per padding bucket.

    Hand-built policies (tests) may name a hardware target that is not in
    ``HARDWARES``; prediction is then 0.0 — "no prediction" — which
    calibration and the Chrome trace both represent explicitly rather
    than inventing a number.

    ``scales`` (a `telemetry.calibrate.ScaleLookup`, or anything with its
    ``scale(kind, batch, q_len) -> Optional[float]`` shape) turns the raw
    roofline into the host-corrected prediction the autotuner searches
    on: the memoized analytic latency is multiplied by the fitted
    measured/predicted factor for the dispatch shape (exact shape first,
    then the kind's aggregate). A kind the warmup never measured resolves
    to None and the raw roofline passes through unscaled — never zeroed."""

    def __init__(self, cfg, policy: AdmissionPolicy, scales=None):
        self.cfg = cfg
        self.policy = policy
        self.scales = scales
        self.hw = hwm.HARDWARES.get(policy.hw_name)
        self._memo: dict = {}

    def raw(self, kind: str, batch: int, q_len: int) -> float:
        """The uncalibrated analytic roofline for one dispatch shape
        (0.0 = no prediction for an unknown hardware target)."""
        key = (kind, batch, q_len)
        got = self._memo.get(key)
        if got is None:
            p = self.policy
            if self.hw is None:
                got = 0.0
            else:
                got = float(step_latency(
                    self.cfg, batch, q_len, p.max_model_len, self.hw,
                    w_bits=p.quant_bits, kv_bits=p.kv_bits,
                    mesh_model=p.mesh_model))
            self._memo[key] = got
        return got

    def __call__(self, kind: str, batch: int, q_len: int) -> float:
        got = self.raw(kind, batch, q_len)
        if self.scales is not None and got > 0.0:
            s = self.scales.scale(kind, batch, q_len)
            if s is not None:
                got *= s
        return got


def derive_policy(cfg, hw: hwm.Hardware, *, max_model_len: int,
                  page_size: int = 16, decode_slo_s: float = 0.030,
                  prefill_stall_factor: float = 4.0,
                  hbm_util: float = 0.9,
                  max_batch_cap: int = 1024,
                  expected_occupancy: float = 0.5,
                  param_bytes: Optional[int] = None,
                  kv_bits=None, mesh_model: int = 1,
                  mesh_data: int = 1) -> AdmissionPolicy:
    """Pick (num_pages, max_batch, prefill_chunk, quant_bits) for a target.

    ``param_bytes`` defaults to the analytic bf16 weight footprint
    (``cfg.param_count() * 2``); pass the exact value from
    ``Model.param_bytes()`` when available.

    ``expected_occupancy`` sizes the memory-bound batch from the *expected*
    per-sequence KV footprint (that fraction of ``max_model_len``) rather
    than the worst case: pages are allocated lazily and the engine preempts
    on exhaustion, so admission no longer has to reserve for every
    sequence simultaneously hitting max length. 1.0 restores the
    worst-case sizing that matches ``reserve_upfront`` scheduling.

    ``kv_bits`` (already normalized: None, int, or per-sub-layer tuple —
    see models/transformer.py::normalize_kv_bits and serving/kvquant)
    shrinks per-token KV bytes, so the same HBM budget holds 2-4x the
    pages and the expected-footprint batch grows with it; the decode-SLO
    search prices KV reads at the quantized width.

    ``mesh_model``/``mesh_data`` size for the SPMD engine (one hw target
    per mesh device): the whole roofline is priced **per shard**. Params
    live at rest spread across all ``mesh_model * mesh_data`` devices, and
    the pool's kv-head split divides per-device page bytes by
    ``mesh_model`` — so pool capacity (``num_pages``, and with it the
    expected-footprint resident-sequence count) rises ~Nx along the model
    axis while the decode-SLO search pays the per-layer all-reduce term
    (``step_latency(mesh_model=)``). 1/1 reproduces the single-device
    policy exactly.
    """
    if not 0.0 < expected_occupancy <= 1.0:
        raise ValueError(f"expected_occupancy must be in (0, 1], "
                         f"got {expected_occupancy}")
    if mesh_model < 1 or mesh_data < 1:
        raise ValueError(f"mesh axes must be >= 1, got "
                         f"model={mesh_model} data={mesh_data}")
    if cfg.is_encdec or cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"admission policy sizes attention KV pools; {cfg.name} "
            f"(family={cfg.family!r}) is an open item (ROADMAP)")
    if param_bytes is None:
        param_bytes = cfg.param_count() * 2
    devices = mesh_model * mesh_data
    # per-shard HBM: each mesh device is one hw target; params at rest are
    # spread across every device (TP dims local + FSDP over data), the pool
    # replicates over data and splits kv_heads over model.
    hbm_total = hw.hbm_bytes * hw.chips * hbm_util
    per_tok = kv_bytes_per_token(cfg, kv_bits)
    one_seq_kv = per_tok * max_model_len / mesh_model

    # HAQ escalation: shrink weights until weights + one sequence fit.
    quant_bits = 16
    for bits in (16, 8, 4):
        if param_bytes * bits / 16.0 / devices + one_seq_kv <= hbm_total:
            quant_bits = bits
            break
    else:
        raise ValueError(
            f"{cfg.name} cannot fit on {hw.name} x{devices}: weights at "
            f"4-bit plus one {max_model_len}-token sequence exceed "
            f"{hbm_total / 2**30:.1f} GiB per device")

    kv_budget = hbm_total - param_bytes * quant_bits / 16.0 / devices
    page_bytes = page_size * per_tok / mesh_model   # per-shard page slice
    pages_per_seq = -(-max_model_len // page_size)
    # floor at one full sequence: the quant check above guarantees weights +
    # one_seq_kv fit, but page-granular rounding could otherwise leave the
    # pool a partial page short of a max-length request, which the scheduler
    # would wait on forever. Overshoot is < 2 pages (incl. scratch page 0).
    num_pages = max(int(kv_budget // page_bytes), pages_per_seq) + 1
    # expected (not worst-case) footprint: lazy page growth + preemption
    # absorb the tail where every sequence runs to max_model_len at once.
    pages_expected = max(
        -(-int(expected_occupancy * max_model_len) // page_size), 1)
    mem_batch = max((num_pages - 1) // pages_expected, 1)

    # Decode-latency roofline: largest batch meeting the SLO (monotonic).
    lo, hi = 1, max(min(mem_batch, max_batch_cap), 1)
    if step_latency(cfg, hi, 1, max_model_len, hw, w_bits=quant_bits,
                    kv_bits=kv_bits, mesh_model=mesh_model) <= decode_slo_s:
        max_batch = hi
    else:
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if step_latency(cfg, mid, 1, max_model_len, hw,
                            w_bits=quant_bits, kv_bits=kv_bits,
                            mesh_model=mesh_model) <= decode_slo_s:
                lo = mid
            else:
                hi = mid
        max_batch = lo
    est_decode = step_latency(cfg, max_batch, 1, max_model_len, hw,
                              w_bits=quant_bits, kv_bits=kv_bits,
                              mesh_model=mesh_model)

    # Prefill chunk: largest power-of-two chunk whose prefill-with-cache
    # forward — priced at the worst-case resident context, since a late
    # chunk of a long prompt attends the whole prefix in the pool — fits
    # the stall budget. The engine runs one chunk per tick per sequence,
    # so prefill_stall_factor bounds the *per-tick* decode stall directly:
    # long prompts cost more ticks, never a bigger bucket.
    stall_budget = prefill_stall_factor * decode_slo_s
    chunk = 16
    c = 16
    while c * 2 <= max_model_len:
        c *= 2
        if step_latency(cfg, 1, c, max_model_len, hw, w_bits=quant_bits,
                        mesh_model=mesh_model) > stall_budget:
            break
        chunk = c
    est_prefill = step_latency(cfg, 1, chunk, max_model_len, hw,
                               w_bits=quant_bits, mesh_model=mesh_model)

    if kv_bits is not None and isinstance(kv_bits, int):
        kv_bits = (kv_bits,)
    return AdmissionPolicy(
        hw_name=hw.name, max_model_len=max_model_len, page_size=page_size,
        num_pages=num_pages, max_batch=max_batch, prefill_chunk=chunk,
        quant_bits=quant_bits, decode_slo_s=decode_slo_s,
        est_decode_s=est_decode, est_prefill_s=est_prefill,
        kv_bits=kv_bits, mesh_model=mesh_model, mesh_data=mesh_data)
