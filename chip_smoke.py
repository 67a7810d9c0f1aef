#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build    — nvcc every kernel source (src/repro_torch/kernels/csrc);
  2. kernels  — each hand-written kernel against its plain PyTorch version.
                Paged attention at full gemma2-2b width (H=8, K=4, hd=256,
                page=16, bf16 q; bf16 pools, and int8 and packed int4 pools
                with fp32 scales for the fused-dequant pair), then checked
                again at the main path's shapes and timed there beside its
                plain version, a one-call PyTorch yardstick
                (scaled_dot_product_attention on the gathered dense view,
                dequantized beforehand for a quantized pool; never called
                by the port) and its bound, with its launch plan
                (decode: n_split and the split and combine grids;
                prefill: its row tiles) and its achieved GB/s (decode) or
                TFLOP/s (prefill) per main-path layer. Flash attention at the
                whole-prompt path's shapes (S = 4096 and 8192, global and
                local layers, cap 0 and 50), then timed there beside its
                plain version, SDPA (is_causal where the window reaches
                every key) and its bound, per layer and as their mean,
                each layer's share of its bound printed. The weight-quantized
                matmuls (W8A16, W4A16, W8A8) at every (K, N) the quantized
                paths launch, ragged M and the main paths' rows (2, 8,
                2000, 4096), bf16 and fp32 x, per-channel and per-tensor
                scales (fp32 outputs within an fp32 ulp of the row's max
                per tensor-core step, W8A8's int32 products exact), then
                checked and timed on the same inputs at (2304 -> 9216),
                M = 8 and 4096, beside their plain versions, torch.matmul
                on the dequantized bf16 weight (torch._int_mm for W8A8, on
                x zero-padded to 24 rows at M = 8) and their bounds, and
                at M = 8 on every projection with each launch plan.
                Kernels and yardsticks are timed on the
                device (device_ms: a CUDA graph of the calls), the plain
                versions from the host (time_ms);
  3. model    — full-width gemma2-2b (26 layers, random weights from a
                seed): one prefill_chunk_paged and decode_step_paged ticks
                through the kernels and through the plain walk, on copies
                of one pool, logits compared — on a bf16 pool; one
                whole-prompt forward of 4096 tokens through flash
                attention and through its plain version; the chunk and
                ticks again on the mixed pool (int4 local layers, int8
                global ones); then with the weights stored at 8 and at 4
                bits (serving/quant.py), through dequant_dot's kernels
                against its plain version, and the bytes the stored
                weights hold against bf16;
  4. engine   — the main path: Engine.run built by repro_torch.launch.serve
                (derive_policy on h100-sxm, --max-batch 8, page 16, chunked
                prefill) over 8 prompts of 300-1200 tokens and one of 4200
                that crosses the 4096 window, 32 new tokens each, with the
                kernels' launch counts zeroed just before and read after;
                once on the bf16 pool (the two bf16 kernels launched, the
                quant pair not), once with --no-chunked-prefill (whole
                prompts padded to 4096 and 8192 rows: 26 flash launches per
                prefill and 26 paged decode launches per tick, no chunk
                kernel), once with --kv-policy {"sub0": 4, "sub1": 8} (the
                quant pair launched, the bf16 pair not), and once with the
                policy's quant_bits set to 4 (int4 FFN weights, int8
                attention projections: per decode tick and chunk 104 W8A16
                and 78 W4A16 launches, no W8A8);
  5. profile  — each of those traces again on a fresh engine under
                torch.profiler: device time by kernel and by row of the
                kernel table (a paged decode call's split and combine
                kernels summed under its row), device busy share;
  6. generate — the sequential entry point on 2 prompts of 1000 tokens, on
                2 prompts of 2560 tokens (flash prefill; launches counted),
                then on 1000 tokens through make_quant_dot's kernels (W4A16
                FFN in and gate, W8A8 FFN out, W8A16 lm_head; launches
                counted), and with W8A8 alone on FFN out through the
                kernel and through its plain version (token-identical);
  7. drift    — greedy_drift of the int8 and the mixed pool against the
                bf16 pool, teacher-forced through the kernels over one
                1000-token prompt and 32 steps (printed; only a non-finite
                value fails);
  8. haq      — (a) the HAQ search over the KV sites on h100-sxm (16
                episodes): bits within the sensitivity gate, within budget
                or at the gated floor, bytes per token and the roofline
                decode tick against bf16; then the main trace served by
                ``--kv-policy haq`` through the quant pair (and the bf16
                pair where a slot stays bf16); (b) HAQ's weight search
                over the 7 decode sites (10 episodes, so the agents
                train), each policy's ``Model.loss`` through the
                fake-quant hook on the card over a (1, 512) batch: losses
                finite, the best within budget or at the floor; (c)
                ``serve.main --autotune 32`` on 4 prompts of up to 256
                tokens, then ``--serving-config`` on its record: the
                paged kernels launched in calibration and validation,
                candidates, decode tok/s of the default and the winner,
                the Spearman rank correlation and the calibration scales;
  9. report   — one JSON line with every kernel's launches, error, times.
Prints the card's name and power limit, one JSON line of kernel numbers,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, without a CUDA device or without the repository beside it.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
BF16_FLOPS = 989e12             # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version, fp32 of the bf16 outputs. Both compute in fp32
# and differ only in summation order (about 1e-6 of a row's scale), then
# round once to bf16, so an element may land one bf16 ulp apart: 2**-7 of
# |ref|. The absolute term covers elements near zero and is tied to the
# data: 2**-7 of the row's (one query head's hd values) max |ref|, one to
# two bf16 ulps of that max. A fixed bound would not do: softmax over n
# keys of N(0,1) scores gives |o| of about sqrt(e/n), 0.02-0.05 here.
RTOL = ROW_ATOL = 2.0 ** -7
# softcap cases scale q so that the scores (about N(0,1) after hd**-0.5)
# spread to about N(0, 20**2) and reach the cap; the plain version run
# without the cap must then miss the tolerance, else the case fails as
# one that does not test the cap
CAP_Q_SCALE = 20.0
# the quantized cases: the same tolerance. The kernel and its plain
# version dequantize each element to the same fp32 number (code * scale,
# one fp32 multiply) and then do the bf16 case's arithmetic.
# The main path's KV policy: int4 on the local layers (sub0), int8 on the
# global ones (sub1).
KV_POLICY = {"sub0": 4, "sub1": 8}
# a quantized scratch page is poisoned in its codes and its scales
POISON_CODE, POISON_SCALE = 127, 1e4
# full gemma2-2b attention width
H, K, HD, PAGE = 8, 4, 256, 16
WINDOW, CAP = 4096, 50.0
# kernels vs plain walk through 26 bf16 layers: each layer's attention
# output may differ by a bf16 ulp (2**-8 relative), and the residual
# stream carries it on through every later layer, so logits are held to 3%
# of the largest |logit| (about 8 bf16 ulps compounded), and must pick the
# same greedy token wherever the plain top-2 margin exceeds that.
LOGIT_RTOL = 0.03
GEN = 32


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` called ``reps`` times back to back from the
    host, between CUDA events: the plain versions, whose host loops and
    host reads make them unfit for a CUDA graph. At tens of microseconds a
    call, the host sets this pace (see device_ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, arg_sets=((),), reps: int = 20, replays: int = 3) -> float:
    """Device ms of one ``fn(*args)``: ``reps`` calls, cycling through
    ``arg_sets``, captured once in a CUDA graph and replayed ``replays``
    times between CUDA events, so the host's launch cost is out of the
    measurement (back-to-back host calls of a 30-70 us kernel time the
    wrapper's Python). Give ``arg_sets`` several copies of inputs smaller
    than the 50 MB L2, so each call reads them from device memory as the
    main path does, not from the previous call's L2 lines."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up (builds, workspaces)
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


# ------------------------------------------------------------- kernels ----
def paged_case(seed, positions, Sq, n_blocks, bits=16, *, heads=(H, K),
               hd=HD, page=PAGE):
    """Random pools with a poisoned scratch page 0, a query chunk and a
    page table giving every sequence its own random pages (tails -> 0), at
    ``heads`` (query, kv) heads of width ``hd`` over pages of ``page``.
    ``bits`` 16: bf16 pools (pool_k, pool_v); 8 or 4: N(0,1) K/V quantized
    by the pool writers' mapping, (codes_k, scale_k, codes_v, scale_v),
    page 0's codes and scales poisoned. Returns the case with two queries:
    as drawn, and scaled for the softcap cases (``CAP_Q_SCALE``)."""
    import torch
    from repro_torch.kernels import ref
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(positions)
    P = B * n_blocks + 1
    n_q, n_kv = heads
    pool_k = torch.randn((P, page, n_kv, hd), generator=g, device=dev)
    pool_v = torch.randn((P, page, n_kv, hd), generator=g, device=dev)
    if bits == 16:
        pool_k, pool_v = pool_k.bfloat16(), pool_v.bfloat16()
        pool_k[0], pool_v[0] = 37.0, -53.0     # a leak past the mask shows
        pools = (pool_k, pool_v)
    else:
        kq, ks = ref.quantize_kv(pool_k, bits)
        vq, vs = ref.quantize_kv(pool_v, bits)
        del pool_k, pool_v
        for t in (kq, vq):
            t[0] = POISON_CODE
        for t in (ks, vs):
            t[0] = POISON_SCALE
        pools = (kq, ks, vq, vs)
    q = torch.randn((B, Sq, n_q, hd), generator=g, device=dev).bfloat16()
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    pt = torch.zeros((B, n_blocks), dtype=torch.int32)
    for b, pos in enumerate(positions):
        need = min((pos + Sq - 1) // page + 1, n_blocks)
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    pos_t = torch.tensor(positions, dtype=torch.int32, device=dev)
    q_cap = (q.float() * CAP_Q_SCALE).bfloat16()
    return {0.0: q, CAP: q_cap}, pools, pt.to(dev), pos_t


def walk_span(pos, Sq, n_blocks, window):
    """[lo, hi] blocks a chunk at ``pos`` needs (the kernels' own range)."""
    hi = min((pos + Sq - 1) // PAGE, n_blocks - 1)
    lo = max((pos - window + 1) // PAGE, 0) if window else 0
    return lo, hi


def paged_work(positions, Sq, n_blocks, window, bits=16):
    """(bytes, flops) the work these inputs need: every live K/V page read
    once per kv head (``bits`` per stored element, and a quantized pool's
    4-byte K and V scale per slot and kv head), q/table/positions read
    and the output written once; 4*hd flops per valid (query head, key)
    pair."""
    B = len(positions)
    per_slot = 2 * HD * bits // 8 + (8 if bits < 16 else 0)  # per kv head
    kv = 0
    valid = 0
    for pos in positions:
        lo, hi = walk_span(pos, Sq, n_blocks, window)
        kv += max(hi - lo + 1, 0) * PAGE * K * per_slot
        for s in range(Sq):
            qp = pos + s
            first = max(qp - window + 1, 0) if window else 0
            valid += max(min(qp, n_blocks * PAGE - 1) - first + 1, 0)
    io = 2 * B * Sq * H * HD * 2 + B * n_blocks * 4 + B * 4
    return kv + io, 4.0 * HD * valid * H


def bound_ms(positions, Sq, n_blocks, window, bits=16):
    """Least time for ``paged_work``: its bytes over device memory or its
    flops over the bf16 peak, the larger. Returns (ms, 'bytes' |
    'operations')."""
    nbytes, flops = paged_work(positions, Sq, n_blocks, window, bits)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_plan(is_dec, B, Sq, n_blocks):
    """The launch plan of a paged kernel at these shapes, as the wrapper
    makes it: decode's split count and grids, prefill's row tiles."""
    from repro_torch.kernels import paged_attention as pa
    if is_dec:
        g = pa.decode_grid(B, H, K, n_blocks, PAGE)
        return (f"n_split={g[2]}, split grid {g} = {g[0] * g[1] * g[2]} "
                f"CTAs, combine grid ({B}, {H})")
    g = pa.prefill_grid(B, Sq, H, K)
    return (f"{pa.PREFILL_ROWS}-row x {pa.PREFILL_TILE}-key tiles, grid "
            f"{g} = {g[0] * g[1] * g[2]} CTAs")


def dense_pools(pools, bits):
    """bf16 (pool_k, pool_v) holding what a case's pools hold: the pools
    themselves, or a quantized pool dequantized (for the SDPA yardstick,
    outside its timing)."""
    if bits == 16:
        return pools
    from repro_torch.kernels import ref
    kq, ks, vq, vs = pools
    return (ref.dequantize_kv(kq, ks, bits).bfloat16(),
            ref.dequantize_kv(vq, vs, bits).bfloat16())


def sdpa_yardstick(q, pool_k, pool_v, pt, positions, window):
    """One PyTorch call computing the same attention (without the softcap,
    which SDPA lacks) on the gathered dense view: the library_ms
    yardstick. The gather happens here, outside the timed call."""
    import torch
    import torch.nn.functional as F
    B, Sq = q.shape[:2]
    n_blocks = pt.shape[1]
    T = n_blocks * PAGE
    k = pool_k[pt.long()].reshape(B, T, K, HD).transpose(1, 2)
    v = pool_v[pt.long()].reshape(B, T, K, HD).transpose(1, 2)
    qpos = positions.long()[:, None] + torch.arange(Sq, device=q.device)
    j = torch.arange(T, device=q.device)
    mask = j[None, None, :] <= qpos[:, :, None]
    if window:
        mask &= j[None, None, :] > qpos[:, :, None] - window
    mask = mask[:, None]
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def mismatch(got, want):
    """Elements of ``got`` outside the tolerance around ``want`` (fp32,
    hd last)."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() > ROW_ATOL * rowmax + RTOL * want.abs()


def check_kernel(name, fwd, plain, qs, pools, pt, pos, *, window, cap,
                 live_rows=None, bits=16):
    """Hold one kernel call against its plain version over the rows that
    are defined (``live_rows``: a padded chunk's rows past the table width
    are garbage by contract), and print the case. With a cap, the plain
    version without it must miss the tolerance. Returns max |err|."""
    import torch
    q = qs[cap]
    got = fwd(q, *pools, pt, pos, window=window, cap=cap)
    torch.cuda.synchronize()
    want = plain(q, *pools, pt, pos, window=window, cap=cap)
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output (bits={bits}, window={window}, "
             f"cap={cap})")
    g, w = got.float(), want.float()
    if live_rows is not None:
        g, w = g[:, :live_rows], w[:, :live_rows]
    err = float((g - w).abs().max())
    typical = float(w.abs().mean())
    shape = f"B={q.shape[0]} Sq={q.shape[1]}" + (
        f" n_blocks={pt.shape[1]}" if pt is not None else "")
    bad = mismatch(g, w)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max |err| {err:.4g}, "
             f"mean |ref| {typical:.4g} ({shape}, bits={bits}, "
             f"window={window}, cap={cap})")
    if cap:
        nocap = plain(q, *pools, pt, pos, window=window, cap=0.0).float()
        if live_rows is not None:
            nocap = nocap[:, :live_rows]
        if not mismatch(nocap, w).any():
            fail(f"{name}: without the softcap the plain version is within "
                 f"tolerance too ({shape}, bits={bits}, window={window}): "
                 f"the case does not test the cap")
    print(f"kernels: {name} {shape} bits={bits} window={window} cap={cap}: "
          f"max |err| {err:.4g} = {err / typical:.4g} x mean |ref| "
          f"({typical:.4g})", flush=True)
    return err


def kernel_specs():
    """name -> (kernel wrapper, plain version, pool bits it takes, decode?).
    Every callable takes (q (B, Sq, H, hd), *pools, pt, pos, ...)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    def dec(fn):
        return lambda q, *a, **kw: fn(q[:, 0], *a, **kw)[:, None]

    return {
        "paged_attention_fwd": (dec(pa.paged_attention_fwd),
                                dec(ref.paged_attention_ref), (16,), True),
        "paged_prefill_fwd": (pa.paged_prefill_fwd, ref.paged_prefill_ref,
                              (16,), False),
        "paged_attention_quant_fwd": (dec(pa.paged_attention_quant_fwd),
                                      dec(ref.paged_attention_quant_ref),
                                      (8, 4), True),
        "paged_prefill_quant_fwd": (pa.paged_prefill_quant_fwd,
                                    ref.paged_prefill_quant_ref, (8, 4),
                                    False),
    }


# (bits, window) of the layers the main path runs each kernel on: a global
# (window 0) and a local (window 4096) layer, bf16 for the bf16 pair; for
# the quant pair the KV_POLICY pool's int8 global and int4 local layers
MAIN_LAYERS = {"paged_attention_fwd": ((16, 0), (16, WINDOW)),
               "paged_prefill_fwd": ((16, 0), (16, WINDOW)),
               "paged_attention_quant_fwd": ((8, 0), (4, WINDOW)),
               "paged_prefill_quant_fwd": ((8, 0), (4, WINDOW))}


def phase_kernels(prefill_chunk: int, n_blocks_main: int):
    """Phase 2: every kernel against its plain version, then timed at the
    main path's shapes. Returns name -> partial kernel record."""
    import numpy as np
    import torch

    specs = kernel_specs()
    rng = np.random.default_rng(0)
    dec_pos = sorted([0, 17, 4095, 4097, 4999]
                     + rng.integers(1, 5000, 3).tolist())
    dec_blocks = -(-5000 // PAGE) + 1
    err = {name: 0.0 for name in specs}
    decode_cases = [
        # decode, B=8, ragged positions crossing the 4096 window
        (dec_pos, 1, dec_blocks, None)]
    prefill_cases = [
        # prefill, Sq=512 chunks at non-zero starts, one crossing the window
        ([1000, 4500], 512, 320, None),
        # padded final chunk running past the table width (40 blocks)
        ([512], 512, 40, 40 * PAGE - 512)]
    for i, (name, (fwd, plain, bit_set, is_dec)) in enumerate(specs.items()):
        for bits in bit_set:
            for c, (positions, Sq, n_blocks, live) in enumerate(
                    decode_cases if is_dec else prefill_cases):
                case = paged_case(100 + 10 * i + c, positions, Sq, n_blocks,
                                  bits)
                for window in (0, 64, WINDOW):
                    for cap in (0.0, CAP):
                        e = check_kernel(name, fwd, plain, *case,
                                         window=window, cap=cap,
                                         live_rows=live, bits=bits)
                        err[name] = max(err[name], e)
                del case

    # the main path's shapes, checked at every (bits, window) and then
    # timed on the same inputs at the main path's layers: a decode tick of
    # 8 ragged sequences, the long prompt's first full prefill chunk, and
    # (for the split between kernel and padding cost) a bf16 chunk of 2048
    # rows, not part of the kernels line
    timed = []
    for name, (_, _, bit_set, is_dec) in specs.items():
        if is_dec:
            timed.append((name, bit_set, dec_pos, 1,
                          max(n_blocks_main, dec_blocks)))
        else:
            timed.append((name, bit_set, [0], prefill_chunk, n_blocks_main))
            if prefill_chunk != 2048 and 16 in bit_set:
                timed.append((name, bit_set, [0], 2048, n_blocks_main))
    records = {}
    for name, bit_set, positions, Sq, n_blocks in timed:
        fwd, plain, _, is_dec = specs[name]
        ms = plain_ms = lib_ms = b_ms = 0.0
        rates = []
        for bits in bit_set:
            qs, pools, pt, pos = paged_case(7, positions, Sq, n_blocks, bits)
            q = qs[CAP]
            for window in (0, WINDOW):
                e = check_kernel(name, fwd, plain, qs, pools, pt, pos,
                                 window=window, cap=CAP, bits=bits)
                err[name] = max(err[name], e)
                if (bits, window) not in MAIN_LAYERS[name]:
                    continue              # checked, not on the main path
                t = device_ms(lambda: fwd(q, *pools, pt, pos, window=window,
                                          cap=CAP))
                ms += t / 2
                nbytes, flops = paged_work(positions, Sq, n_blocks, window,
                                           bits)
                rates.append(f"bits {bits} window {window} {t:.4f} ms = "
                             + (f"{nbytes / t / 1e6:.0f} GB/s of "
                                f"{HBM_BYTES_PER_S / 1e9:.0f}" if is_dec
                                else f"{flops / t / 1e9:.1f} TFLOP/s of "
                                f"{BF16_FLOPS / 1e12:.0f}"))
                plain_ms += time_ms(lambda: plain(q, *pools, pt, pos,
                                                  window=window, cap=CAP),
                                    reps=2, warmup=1) / 2
                lib_ms += device_ms(sdpa_yardstick(
                    q, *dense_pools(pools, bits), pt, pos, window),
                    reps=10) / 2
                t, by = bound_ms(positions, Sq, n_blocks, window, bits)
                b_ms += t / 2
            del qs, q, pools, pt, pos
        layers = ", ".join(f"bits {b} window {w}"
                           for b, w in MAIN_LAYERS[name])
        plan = paged_plan(is_dec, len(positions), Sq, n_blocks)
        print(f"kernels: {name} B={len(positions)} Sq={Sq} "
              f"n_blocks={n_blocks}, {plan}; {'; '.join(rates)}; mean of "
              f"{layers}: {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms by {by})", flush=True)
        if name not in records:
            records[name] = {"ms": ms, "plain_ms": plain_ms,
                             "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": by}
    for name in records:
        records[name]["max_abs_err"] = err[name]
    print(f"kernels: match plain versions (max |err| {json.dumps(err)}, "
          f"tolerance {ROW_ATOL:.4g}*max|ref row| + {RTOL:.4g}*|ref|)",
          flush=True)
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------ flash attention ----
# the whole-prompt main path's shapes: the engine pads short prompts to one
# 4096-row prefill chunk and the 4200-token prompt to 8192 rows
FLASH_S = (4096, 8192)
# (window, label) of the layers each whole-prompt forward runs: global and
# local (the 4096 window bites at 8192)
FLASH_LAYERS = ((0, "global"), (WINDOW, "local"))


def flash_case(seed, S):
    """Full-width q (B=1, S, 8 heads), k, v (4 kv heads), hd 256, bf16,
    from a seed: q as drawn and scaled for the softcap cases."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, S, H, HD), generator=g, device="cuda")
    k = torch.randn((1, S, K, HD), generator=g, device="cuda").bfloat16()
    v = torch.randn((1, S, K, HD), generator=g, device="cuda").bfloat16()
    return {0.0: q.bfloat16(), CAP: (q * CAP_Q_SCALE).bfloat16()}, k, v


def flash_valid_pairs(S, window):
    """(query, key) pairs a causal layer over S tokens attends to: S(S+1)/2
    without a window, min(i + 1, window) summed over the rows with one."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_bound_ms(S, window):
    """Least time for one call: q, k, v read and the output written once
    over device memory, or 4*hd flops per valid (query head, key) pair
    over the bf16 peak. Returns (ms, 'bytes' | 'operations')."""
    t_bytes = 2 * (2 * S * H * HD + 2 * S * K * HD) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * HD * H * flash_valid_pairs(S, window) / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_sdpa(q, k, v, window):
    """One PyTorch call computing the same attention without the softcap
    (SDPA has none): is_causal for a global layer and for a local one
    whose window reaches every key (window >= S: the same mask), a boolean
    mask otherwise. The library_ms yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if not window or window >= q.shape[1]:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)


def phase_flash_kernels():
    """Phase 2, flash attention: the kernel against its plain version at
    the whole-prompt path's shapes (S = 4096 and 8192, global and local
    layers, cap 0 and 50 with the cap control), then timed on the same
    inputs at cap 50 beside the plain version, SDPA and the bound, per
    layer (with the layer's share of its bound) and as the
    mean of a global and a local layer, and printed. Returns the kernel
    record at S = 4096, the padded length of most prompts."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    def fwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def plain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    err = 0.0
    rows = {}
    for S in FLASH_S:
        qs, k, v = flash_case(40 + S // 4096, S)
        for window, _ in FLASH_LAYERS:
            for cap in (0.0, CAP):
                err = max(err, check_kernel("flash_attention_fwd", fwd,
                                            plain, qs, (k, v), None, None,
                                            window=window, cap=cap))
                torch.cuda.empty_cache()
        q = qs[CAP]
        ms = plain_ms = lib_ms = b_ms = 0.0
        parts = []
        for window, label in FLASH_LAYERS:
            t = device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, causal=True, window=window, cap=CAP), reps=10)
            p = time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window, cap=CAP), reps=2,
                warmup=1)
            torch.cuda.empty_cache()
            lib = device_ms(flash_sdpa(q, k, v, window), reps=10)
            bnd, by = flash_bound_ms(S, window)
            tflops = 4e-9 * HD * H * flash_valid_pairs(S, window) / t
            parts.append(f"{label} {t:.4f} ms ({tflops:.1f} TFLOP/s, "
                         f"{100 * bnd / t:.1f}% of its bound {bnd:.4f} ms; "
                         f"sdpa {lib:.4f} ms)")
            ms, plain_ms, lib_ms, b_ms = (ms + t / 2, plain_ms + p / 2,
                                          lib_ms + lib / 2, b_ms + bnd / 2)
        print(f"kernels: flash_attention_fwd B=1 S={S} H={H} K={K} hd={HD} "
              f"cap {CAP}: {'; '.join(parts)}; mean {ms:.4f} ms (plain "
              f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms by {by})", flush=True)
        rows[S] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bound_by": by}
        del qs, q, k, v
        torch.cuda.empty_cache()
    print(f"kernels: flash_attention_fwd matches its plain version (max "
          f"|err| {err:.4g}, tolerance {ROW_ATOL:.4g}*max|ref row| + "
          f"{RTOL:.4g}*|ref|)", flush=True)
    return dict(rows[FLASH_S[0]], max_abs_err=err)


# ---------------------------------------------------- quantized matmuls ----
INT8_OPS = 1979e12              # H100 SXM dense int8 tensor-core peak
# (K, N) of every matmul the weight-quantized paths launch at gemma2-2b
# width: q, k/v, o, FFN in/gate, FFN out, and the lm_head of the hook path
QMM_SHAPES = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
              (9216, 2304), (2304, 256000))
QMM_RAGGED_M = (1, 5, 37, 1000)
# the rows the main paths give each shape: the engine's decode tick (8
# sequences) and prefill chunk (4096 rows) on every projection; generate's
# decode step (2 sequences) and prefill (2 x 1000 tokens, the lm_head
# unembedding all of them) on the FFN and the lm_head
LM_HEAD = (2304, 256000)
QMM_MAIN_M = {**{kn: (2, 8, 2000, 4096) for kn in QMM_SHAPES
                 if kn != LM_HEAD}, LM_HEAD: (2, 2000)}
QMM_TIMED = (2304, 9216)        # timed at M = 8 (decode) and 4096 (a chunk)
# bytes of weight copies the timed calls cycle through: four times the
# H100's 50 MB L2, as a decode tick streams 26 layers' weights past it
QMM_COLD_BYTES = 200 * 10 ** 6
INT_MM_MIN_ROWS = 24            # torch._int_mm needs more than 16 rows
# fp32 x through W8A16/W4A16: the kernel splits x into three bf16 terms
# (x = x0 + x1 + x2 exactly) whose products with the integer codes are
# exact, so what separates kernel and plain version is fp32 accumulation.
# The tensor cores' fp32 accumulation may drop up to an fp32 ulp of the
# running sum per mma step (it truncates), and there are 3 * K / 16 steps
# (three x terms, 16-deep steps), so such outputs are held to
# 3K/16 * 2**-23 of the row's max |ref| (5e-5 at K = 2304, 2e-4 at 9216).
# The plain version on x rounded to bf16 once (about 1e-3 of a typical
# output off) must miss that bound, else the case could not tell a kernel
# that drops x's low bits.
def fp32_row_atol(K: int) -> float:
    return 3 * K / 16 * 2.0 ** -23


def qmm_specs():
    """name -> (kernel wrapper, plain version, weight quantizer). Every
    callable takes (x, codes, scale) with x as the caller gives it; W8A8
    quantizes x per tensor first, as ops.quant_matmul does, and casts to
    x's dtype."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref

    def a8(fn):
        def call(x, codes, scale):
            xq, xs = ref.quantize_a8(x)
            return fn(xq, xs, codes, scale, out_dtype=x.dtype)
        return call

    return {
        "quant_matmul_w8a16": (qm.quant_matmul_w8a16,
                               ref.quant_matmul_w8a16, ref.quantize_w8),
        "quant_matmul_w4a16": (qm.quant_matmul_w4a16,
                               ref.quant_matmul_w4a16,
                               ref.quantize_w4_packed),
        "quant_matmul_w8a8": (a8(qm.quant_matmul_w8a8),
                              a8(ref.quant_matmul_w8a8), ref.quantize_w8),
    }


def fp32_mismatch(got, want, K):
    """Elements of ``got`` further than fp32_row_atol(K) of the row's max
    |want| from ``want`` (fp32, N last)."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() > fp32_row_atol(K) * rowmax


# fp32-x W8A16/W4A16 cases: the largest |err| / row max |ref| seen
FP32_SEEN = {}


def check_qmm(name, fwd, plain, x, codes, scale, what):
    """Hold one weight-quantized matmul against its plain version on x:
    bf16 outputs within the kernel tolerance; fp32 outputs of W8A16/W4A16
    within fp32_row_atol(K) of the row's max, which x rounded to bf16 must
    miss (the ratio err / row max is kept in ``FP32_SEEN``); fp32 outputs
    of W8A8 equal bit for bit (the int32 products exact). Returns max
    |err|."""
    import torch
    got = fwd(x, codes, scale)
    torch.cuda.synchronize()
    want = plain(x, codes, scale)
    M, K = x.shape
    N = codes.shape[1]
    if got.dtype != x.dtype or got.shape != (M, N) or \
            not torch.isfinite(got.float()).all():
        fail(f"{name}: bad output {got.dtype} {tuple(got.shape)} ({what})")
    gf, wf = got.float(), want.float()
    e = float((gf - wf).abs().max())
    fp32 = x.dtype == torch.float32
    if fp32 and name == "quant_matmul_w8a8":
        if not torch.equal(got, want):
            fail(f"{name}: fp32 output differs from the plain version's "
                 f"by up to {e:.4g} ({what}): the int32 products are not "
                 f"exact")
        return e
    if fp32:
        ratio = float(((gf - wf).abs() / wf.abs().amax(-1, keepdim=True))
                      .max())
        FP32_SEEN[name] = max(FP32_SEEN.get(name, 0.0), ratio)
    bad = fp32_mismatch(gf, wf, K) if fp32 else mismatch(gf, wf)
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements off, max |err| {e:.4g} "
             f"({what}, {'fp32 bound' if fp32 else 'bf16 bound'})")
    if fp32 and not fp32_mismatch(
            plain(x.bfloat16().float(), codes, scale), wf, K).any():
        fail(f"{name}: x rounded to bf16 stays within the fp32 bound "
             f"({what}): the case cannot see a kernel that drops x's low "
             f"bits")
    return e


def qmm_bound_ms(name, M, K, N):
    """Least time for one call: x, the stored codes, the scales and the
    bf16 output moved once over device memory, or 2*M*K*N operations over
    the bf16 (W8A16, W4A16) or int8 (W8A8) tensor-core peak."""
    code_bytes = K * N // 2 if name == "quant_matmul_w4a16" else K * N
    x_bytes = M * K * (1 if name == "quant_matmul_w8a8" else 2)
    t_bytes = (x_bytes + code_bytes + 4 * N + 4 + 2 * M * N) \
        / HBM_BYTES_PER_S * 1e3
    peak = INT8_OPS if name == "quant_matmul_w8a8" else BF16_FLOPS
    t_ops = 2.0 * M * K * N / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_call(name, x, codes, scale):
    """(kernel wrapper, plain version, arguments) of one timed call: W8A8
    takes x quantized beforehand, the others x as it is."""
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import ref
    if name != "quant_matmul_w8a8":
        return getattr(qm, name), getattr(ref, name), (x, codes, scale)
    xq, xs = ref.quantize_a8(x)
    return qm.quant_matmul_w8a8, ref.quant_matmul_w8a8, (xq, xs, codes,
                                                          scale)


def cold_weight_sets(args):
    """The call's arguments with distinct copies of its codes (the
    second-to-last argument), QMM_COLD_BYTES in all, so that each timed
    call reads its codes from device memory."""
    codes = args[-2]
    copies = max(1, -(-QMM_COLD_BYTES // codes.nbytes))
    return [args] + [args[:-2] + (codes.clone(), args[-1])
                     for _ in range(copies - 1)]


def qmm_library(name, x, codes, scale):
    """(fn, arg sets on cold weights, label) of the one-call PyTorch
    yardstick the port never calls: torch.matmul on the weight dequantized
    to bf16 beforehand (W8A16, W4A16), or torch._int_mm on x quantized
    beforehand and the codes as a column-major B (W8A8). _int_mm takes
    more than 16 rows: fewer are zero-padded to INT_MM_MIN_ROWS, and the
    label says so."""
    import torch
    from repro_torch.kernels import ref
    if name == "quant_matmul_w8a8":
        a, _ = ref.quantize_a8(x)
        label = "torch._int_mm"
        if a.shape[0] < INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros((INT_MM_MIN_ROWS - a.shape[0],
                                           a.shape[1]))])
            label += f" on x zero-padded to {INT_MM_MIN_ROWS} rows"
        b = codes.t().contiguous().t()
        fn = torch._int_mm
    else:
        unpacked = ref.unpack_w4(codes) if name == "quant_matmul_w4a16" \
            else codes
        a, b = x, (unpacked.float() * scale).bfloat16()
        fn, label = torch.matmul, "torch.matmul on bf16 weights"
    copies = max(1, -(-QMM_COLD_BYTES // b.nbytes))
    return fn, [(a, b)] + [(a, b.clone()) for _ in range(copies - 1)], label


def phase_qmm_kernels():
    """Phase 2, the weight-quantized matmuls: each kernel against its
    plain version (``check_qmm``) at every (K, N) the paths launch, ragged
    M and the rows the main paths give that shape, bf16 and fp32 x,
    per-channel and per-tensor scales; then each checked again and timed
    on the same inputs at (2304 -> 9216), M = 8 and 4096, beside its plain
    version, a one-call PyTorch yardstick the port never calls and its
    bound. Returns name -> kernel record (the M = 4096 numbers) and prints
    both."""
    import torch
    from repro_torch.kernels import quant_matmul as qm

    specs = qmm_specs()
    err = {name: 0.0 for name in specs}
    g = torch.Generator(device="cuda").manual_seed(21)
    neg_pairs = 0
    for K, N in QMM_SHAPES:
        Ms = QMM_RAGGED_M + QMM_MAIN_M[(K, N)]
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        for name, (fwd, plain, quantize) in specs.items():
            codes, scale = quantize(w)
            if name == "quant_matmul_w4a16":
                # bytes whose two nibbles are both negative codes
                neg_pairs += int(((codes.to(torch.int16) & 0x88) == 0x88)
                                 .sum())
            for per_tensor in (False, True):
                s = scale.amax().reshape(1) if per_tensor else scale
                for M in Ms:
                    x = torch.randn((M, K), generator=g, device="cuda")
                    for dt in (torch.bfloat16, torch.float32):
                        e = check_qmm(name, fwd, plain, x.to(dt), codes, s,
                                      f"M={M}, K={K}, N={N}, {dt}, "
                                      f"per_tensor={per_tensor}")
                        err[name] = max(err[name], e)
                    del x
                    torch.cuda.empty_cache()
            del codes, scale
        print(f"kernels: quant matmuls (K={K}, N={N}) match plain at M "
              f"{Ms}, bf16/fp32 x, per-channel/per-tensor scales",
              flush=True)
        del w
        torch.cuda.empty_cache()
    if neg_pairs == 0:
        fail("quant_matmul_w4a16: no byte held two negative codes")
    print(f"kernels: W4A16 cases held {neg_pairs} bytes with both nibbles "
          f"negative; fp32 W8A16/W4A16 outputs within 3K/16 * 2**-23 x row "
          f"max |ref| (largest |err| / row max {json.dumps(FP32_SEEN)}; x "
          f"rounded to bf16 misses it); W8A8 fp32 outputs equal the plain "
          f"version's (exact int32 products)", flush=True)

    # checked, then timed, on the kernels' own inputs: W8A8 gets x
    # quantized beforehand
    K, N = QMM_TIMED
    records = {}
    w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    for name, (fwd, plain, quantize) in specs.items():
        codes, scale = quantize(w)
        row = {}
        for M in (8, 4096):
            x = torch.randn((M, K), generator=g,
                            device="cuda").bfloat16()
            what = f"timed inputs, M={M}, K={K}, N={N}"
            err[name] = max(err[name], check_qmm(name, fwd, plain, x, codes,
                                                 scale, what))
            kernel, plain_fn, args = qmm_call(name, x, codes, scale)
            if name == "quant_matmul_w8a8" and not torch.equal(
                    kernel(*args, out_dtype=torch.float32),
                    plain_fn(*args, out_dtype=torch.float32)):
                # the timed call's accumulator, exact: fp32 out bit for bit
                fail(f"{name}: fp32 output differs from the plain "
                     f"version's ({what}): the int32 products are not "
                     f"exact")
            ms = device_ms(kernel, cold_weight_sets(args))
            plain_ms = time_ms(lambda: plain_fn(*args), reps=5)
            lib_fn, lib_sets, lib_label = qmm_library(name, x, codes, scale)
            lib_ms = device_ms(lib_fn, lib_sets)
            del lib_sets
            b_ms, by = qmm_bound_ms(name, M, K, N)
            plan = qm.qmm_plan(M, N, K)
            print(f"kernels: {name} M={M} K={K} N={N}: {ms:.4f} ms (plain "
                  f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms "
                  f"[{lib_label}], bound {b_ms:.5f} ms by {by}; "
                  f"{2e-9 * M * K * N / ms:.1f} T(FL)OP/s; plan BT "
                  f"{plan['BT']} MT {plan['MT']} n_split {plan['n_split']} "
                  f"grid {plan['grid']})", flush=True)
            row[M] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "library": lib_label, "bound_ms": b_ms,
                      "bound_by": by, "plan": plan}
            del x, args
        records[name] = dict(row[4096], max_abs_err=err[name],
                             decode=row[8])
        del codes, scale
    del w
    torch.cuda.empty_cache()

    # a decode tick (M = 8) on every projection: the wgmma kernels' launch
    # plans (K splits), two calls bit-identical (the reduces sum in a fixed
    # order), timed beside the library call, each call on cold weights
    for K, N in QMM_SHAPES:
        if (K, N) == LM_HEAD:
            continue
        w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
        x = torch.randn((8, K), generator=g, device="cuda").bfloat16()
        for name, (fwd, plain, quantize) in specs.items():
            codes, scale = quantize(w)
            what = f"decode, M=8, K={K}, N={N}"
            err[name] = max(err[name], check_qmm(name, fwd, plain, x, codes,
                                                 scale, what))
            kernel, _, args = qmm_call(name, x, codes, scale)
            if not torch.equal(kernel(*args), kernel(*args)):
                fail(f"{name}: two calls differ ({what})")
            sets = cold_weight_sets(args)
            ms = device_ms(kernel, sets, max(20, min(len(sets), 200)))
            lib_fn, lib_sets, lib_label = qmm_library(name, x, codes, scale)
            lib_ms = device_ms(lib_fn, lib_sets,
                               max(20, min(len(lib_sets), 200)))
            b_ms, by = qmm_bound_ms(name, 8, K, N)
            plan = qm.qmm_plan(8, N, K)
            print(f"kernels: {name} M=8 K={K} N={N}: {ms:.4f} ms, plan BT "
                  f"{plan['BT']} MT {plan['MT']} n_split {plan['n_split']} "
                  f"grid {plan['grid']} (library {lib_ms:.4f} ms "
                  f"[{lib_label}], bound {b_ms:.5f} ms by {by})", flush=True)
            records[name].setdefault("decode_shapes", {})[f"{K}x{N}"] = {
                "ms": ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "n_split": plan["n_split"]}
            del codes, scale, args, sets, lib_sets
            torch.cuda.empty_cache()
        del w, x
    print(f"kernels: quant matmuls match plain versions (max |err| "
          f"{json.dumps(err)}; bf16 tolerance {ROW_ATOL:.4g}*max|ref row| + "
          f"{RTOL:.4g}*|ref|, fp32 3K/16*2**-23*max|ref row|)",
          flush=True)
    return records


KERNEL_SOURCES = {
    "paged_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:144"),
    "paged_prefill_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:323"),
    "paged_attention_quant_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:227"),
    "paged_prefill_quant_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:410"),
    "flash_attention_fwd": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:88"),
    "quant_matmul_w8a16": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:47"),
    "quant_matmul_w4a16": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:94"),
    "quant_matmul_w8a8": (
        "cuda", "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul.py:141"),
}
# the device kernels each row of the kernel table launches, by name
# prefix in the profiler's key (anonymous namespaces dropped): a decode
# wrapper call is a split kernel and a combine kernel, summed under its row
DEVICE_ROWS = {
    "paged_attention_fwd": ("paged_decode_split_kernel<Bf16Pool",
                            "paged_decode_combine_kernel<Bf16Pool"),
    "paged_prefill_fwd": ("paged_prefill_kernel<Bf16Pool",),
    "paged_attention_quant_fwd": ("paged_decode_split_kernel<Int",
                                  "paged_decode_combine_kernel<Int"),
    "paged_prefill_quant_fwd": ("paged_prefill_kernel<Int",),
    "flash_attention_fwd": ("flash_fwd_kernel",),
    "quant matmuls": ("wq_kernel", "splitk_reduce_kernel", "w8a8_kernel",
                      "splitk_reduce_s32_kernel", "qmm_kernel"),
}
BF16_KERNELS = ("paged_attention_fwd", "paged_prefill_fwd")
QUANT_KERNELS = ("paged_attention_quant_fwd", "paged_prefill_quant_fwd")
# the whole-prompt main path (--no-chunked-prefill): flash attention in
# every prefill forward, the bf16 paged decode walk
WHOLE_KERNELS = ("flash_attention_fwd", "paged_attention_fwd")
# the engine's weight-quantized main path: stored int4 FFN weights and int8
# attention projections over the bf16 pool
WQ_KERNELS = BF16_KERNELS + ("quant_matmul_w8a16", "quant_matmul_w4a16")
WQ_BITS = 4
# the generate path through the HAQ dot hook's kernels: W4A16 on FFN in and
# gate, W8A8 on FFN out, W8A16 on the (tied) lm_head
GEN_QUANT_POLICY = {"ffn_in": (4, 16), "ffn_gate": (4, 16),
                    "ffn_out": (8, 8), "lm_head": (8, 16)}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict of parameters."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def reset_all_launches() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm
    pa.reset_launches()
    fa.reset_launches()
    qm.reset_launches()


def all_launches() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qm
    return {**pa.LAUNCHES, **fa.LAUNCHES, **qm.LAUNCHES}


def phase_model(model, params, kv_bits=None, ticks=1, w_bits=None):
    """Phase 3: one chunk and ``ticks`` decode steps of the full-width
    model through the kernels and through the plain walk, on copies of one
    pool (bf16, or quantized under ``kv_bits``); returns the largest logit
    difference. With ``w_bits`` the parameters are stored at that width
    (serving/quant.py) and the two sides differ in the ``dot`` hook alone:
    the weight-quantized matmul kernels (``make_dequant_dot("cuda")``)
    against the plain dequantize-then-matmul (``"ref"``), both over the
    paged kernels."""
    import torch
    from repro_torch.models.params import tree_map

    dev = params["embed"].device
    cfg = model.cfg
    if w_bits:
        from repro_torch.serving.quant import make_dequant_dot, \
            quantize_params
        bf16_bytes = tensor_bytes(params)
        params = quantize_params(params, default_bits=w_bits)
        torch.cuda.synchronize()
        label = f"model[w={w_bits}b]"
        print(f"{label}: parameters held {tensor_bytes(params) / 1e9:.4f} GB "
              f"against {bf16_bytes / 1e9:.4f} GB in bf16 "
              f"({tensor_bytes(params) / bf16_bytes:.4f}x), from the "
              f"tensors", flush=True)
        sides = {"cuda": {"kernel": "cuda", "dot": make_dequant_dot("cuda")},
                 "ref": {"kernel": "cuda", "dot": make_dequant_dot("ref")}}
    else:
        label = f"model[kv={kv_bits or 'bf16'}]"
        sides = {m: {"kernel": m, "dot": None} for m in ("cuda", "ref")}
    g = torch.Generator().manual_seed(3)
    B, C, n_blocks = 2, 512, 80
    pool = model.init_pool(B * n_blocks + 1, PAGE, device=dev,
                           kv_bits=kv_bits)
    pt = (torch.arange(B * n_blocks, dtype=torch.int32)
          .reshape(B, n_blocks) + 1).to(dev)
    toks = torch.randint(2, cfg.vocab_size, (B, 2 * C + ticks), generator=g,
                         dtype=torch.int32).to(dev)
    start = torch.zeros((B,), dtype=torch.int32, device=dev)
    model.prefill_chunk_paged(params, pool, pt, toks[:, :C], start,
                              **sides["cuda"])         # resident prefix
    logits = {}
    for mode, kw in sides.items():
        copy = tree_map(torch.clone, pool)
        hidden, _ = model.prefill_chunk_paged(
            params, copy, pt, toks[:, C:2 * C], start + C, **kw)
        logits[mode] = {"chunk": model.unembed(params, hidden[:, -1:],
                                               dot=kw["dot"])}
        for t in range(ticks):
            step, _ = model.decode_step_paged(
                params, copy, pt, toks[:, 2 * C + t:2 * C + t + 1],
                start + 2 * C + t, **kw)
            logits[mode][f"decode{t}" if ticks > 1 else "decode"] = step
        del copy
    err = max(compare_logits(label, what, logits["cuda"][what][:, 0],
                             logits["ref"][what][:, 0])
              for what in logits["ref"])
    del logits, pool
    torch.cuda.empty_cache()
    return err


def compare_logits(label, what, a, b):
    """Kernel-path logits ``a`` against plain-path logits ``b`` (rows, V):
    within LOGIT_RTOL of the largest |b|, and the same greedy token
    wherever b's top-2 margin exceeds that. Returns max |a - b|."""
    import torch
    if not torch.isfinite(a).all():
        fail(f"{label} {what}: non-finite logits")
    d = float((a - b).abs().max())
    tol = LOGIT_RTOL * float(b.abs().max())
    top2 = torch.topk(b, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = a.argmax(-1) == b.argmax(-1)
    if d > tol or not bool((same | ~clear).all()):
        fail(f"{label} {what}: kernel vs plain logits differ by {d:.4g} "
             f"(tolerance {tol:.4g}), greedy tokens "
             f"{a.argmax(-1).tolist()} vs {b.argmax(-1).tolist()}")
    print(f"{label}: {what} logits kernel vs plain max |diff| {d:.4g} "
          f"(tolerance {tol:.4g}, |logit| up to "
          f"{float(b.abs().max()):.3g})", flush=True)
    return d


def phase_model_whole(model, params, S=4096):
    """Phase 3, whole prompt: one full-width forward over S tokens with
    every layer's attention through flash_attention_fwd (kernel "cuda",
    one launch per layer counted) and through its plain version ("ref");
    the logits of rows spread over the prompt compared. Returns the
    largest logit difference."""
    import torch
    dev = params["embed"].device
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(2, model.cfg.vocab_size, (1, S), generator=g,
                         dtype=torch.int32).to(dev)
    rows = torch.tensor([0, 511, 2047, 2048, 3071, S - 1], device=dev)
    L = model.cfg.num_layers
    logits = {}
    for mode in ("cuda", "ref"):
        torch.cuda.synchronize()
        reset_all_launches()
        hidden, _, _, _ = model.forward(params, {"tokens": toks},
                                        unembed_mode="none", kernel=mode)
        n = all_launches()["flash_attention_fwd"]
        if n != (L if mode == "cuda" else 0):
            fail(f"model[whole-prompt]: kernel {mode!r} launched "
                 f"flash_attention_fwd {n} times over {L} layers")
        logits[mode] = model.unembed(params, hidden[:, rows])[0]
        del hidden
        torch.cuda.empty_cache()
    err = compare_logits(f"model[whole-prompt S={S}]",
                         f"rows {rows.tolist()}", logits["cuda"],
                         logits["ref"])
    print(f"model[whole-prompt S={S}]: {L} flash_attention_fwd launches per "
          f"forward", flush=True)
    return err


def main_trace(cfg):
    """8 prompts of 300-1200 tokens and one of 4200 (it crosses the 4096
    window of the local layers), GEN new tokens each."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(300, 1201, 8).tolist() + [4200]
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, S)
                    .astype(np.int32), max_new=GEN)
            for i, S in enumerate(lens)]


def phase_engine(model, params, extra_args=(), expect=BF16_KERNELS,
                 bf16_pages=None, quant_bits=None, bf16_summary=None):
    """Phase 4: the main path, through the launcher's own construction
    (``extra_args`` added to its command line; ``quant_bits`` overrides
    the derived policy's weight bits, as the reference's tests do). The
    kernels in ``expect`` must launch during the run and every other
    kernel must not; with quantized weights every decode tick and chunk
    launches W8A16 on the 4 attention projections and W4A16 on the 3 FFN
    matmuls of each layer; with --no-chunked-prefill every whole-prompt
    prefill launches flash attention once per layer. Returns (launches,
    policy, args, summary)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--max-batch", "8", "--page-size",
         str(PAGE), *extra_args])
    reqs = main_trace(model.cfg)
    max_len = max(len(r.prompt) + r.max_new for r in reqs)
    policy = serve.make_policy(model.cfg, model, args, max_len)
    if quant_bits:
        policy = dataclasses.replace(policy, quant_bits=quant_bits)
    label = f"engine[kv={policy.kv_bits or 'bf16'}, " \
        f"quant={policy.quant_bits}b]"
    print(f"{label}: admission[{args.hw}] max_batch={policy.max_batch} "
          f"prefill_chunk={policy.prefill_chunk} pages={policy.num_pages}"
          + (f" (bf16 policy: {bf16_pages} pages, "
             f"{policy.num_pages / bf16_pages:.2f}x)" if bf16_pages else "")
          + f" quant={policy.quant_bits}b"
          + f" max_model_len={policy.max_model_len}", flush=True)
    engine = serve.make_engine(model, params, policy, args)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    for r in reqs:
        o = outs[r.rid]
        if len(o) != len(r.prompt) + r.max_new:
            fail(f"{label}: request {r.rid} returned {len(o)} tokens, "
                 f"want {len(r.prompt) + r.max_new}")
        if not np.array_equal(o[:len(r.prompt)], r.prompt) or \
                o.min() < 0 or o.max() >= model.cfg.vocab_size:
            fail(f"{label}: request {r.rid} output malformed")
    for name, n in launches.items():
        if name in expect and n <= 0:
            fail(f"{label}: kernel {name} was never launched on the main "
                 f"path")
        if name not in expect and n:
            fail(f"{label}: kernel {name} was launched {n} times on a path "
                 f"that should not reach it")
    st = engine.stats
    ticks = engine.telemetry.ticks
    L = model.cfg.num_layers
    if not engine.chunked:
        # one flash launch per layer in each whole-prompt prefill, one
        # paged decode launch per layer in each decode tick
        n_pre = sum(t.kind == "prefill" for t in ticks)
        for name, per, n in (("flash_attention_fwd", "prefill", n_pre),
                             ("paged_attention_fwd", "decode tick",
                              st["decode_ticks"])):
            if launches[name] != L * n:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"want {L} per {per} ({n} of them)")
    if policy.quant_bits < 16:
        calls = st["decode_ticks"] + st["prefill_chunks"]
        for name, per_layer in (("quant_matmul_w8a16", 4),
                                ("quant_matmul_w4a16", 3)):
            if launches[name] != per_layer * L * calls:
                fail(f"{label}: {name} launched {launches[name]} times, "
                     f"want {per_layer * L} per decode tick and chunk "
                     f"({calls} of them)")
    gen_total = st["decode_tokens"] + st["prefills"]
    kind = "chunk" if engine.chunked else "prefill"
    dec = [t.measured_s for t in ticks if t.kind == "decode"]
    pre = [t for t in ticks if t.kind == kind]
    rows = sum(t.q_len for t in pre)
    real = sum(t.tokens for t in pre)
    print(f"{label}: {kind} ticks ran {rows} query rows for {real} prompt "
          f"tokens: {100 * (1 - real / rows):.1f}% padding", flush=True)
    pre_ms = 1e3 * sum(t.measured_s for t in pre) / len(pre)
    by_len = {}
    for t in pre:
        by_len.setdefault(t.q_len, []).append(1e3 * t.measured_s)
    print(f"{label}: {kind} ticks by padded rows: " + ", ".join(
        f"{n} rows x{len(v)} mean {sum(v) / len(v):.3f} ms"
        for n, v in sorted(by_len.items())), flush=True)
    print(f"{label}: served {len(reqs)} requests, {gen_total} tokens in "
          f"{dt:.3f} s ({gen_total / dt:.2f} tok/s), "
          f"{st['decode_ticks']} decode ticks (mean "
          f"{1e3 * sum(dec) / len(dec):.3f} ms), {len(pre)} {kind} ticks "
          f"(mean {pre_ms:.3f} ms), {st['preemptions']} preemptions; "
          f"launches {json.dumps(launches)}", flush=True)
    summary = {"tok_s": gen_total / dt, "decode_ms": 1e3 * sum(dec) / len(dec),
               "prefill_ms": pre_ms}
    if bf16_summary:
        print(f"{label}: against the bf16 run: "
              + ", ".join(f"{k} {summary[k]:.3f} vs {bf16_summary[k]:.3f}"
                          for k in summary), flush=True)
    return launches, policy, args, summary


def phase_profile(model, params, policy, args):
    """Where the main path's device time goes: the same trace once more on
    a fresh engine under torch.profiler. Returns (kernel name -> device
    ms, device-busy ms, wall ms); device numbers are None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve

    engine = serve.make_engine(model, params, policy, args)
    reqs = main_trace(model.cfg)
    label = f"profile[kv={policy.kv_bits or 'bf16'}, " \
        f"quant={policy.quant_bits}b]"
    torch.cuda.synchronize()
    # device activity only: host-op events would multiply the trace and
    # its post-processing without adding device time
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    launched = 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            key = e.key.replace("(anonymous namespace)::", "")
            by_name[key] = by_name.get(key, 0.0) + us / 1e3
            launched += e.count
    busy = sum(by_name.values())
    if busy <= 0:
        print(f"{label}: the profiler saw no device time (not measured)",
              flush=True)
        return None, None, wall_ms
    rows = []
    for row, prefixes in DEVICE_ROWS.items():
        parts = [(k, v) for k, v in by_name.items()
                 if any(k.startswith(p) or f" {p}" in k for p in prefixes)]
        total = sum(v for _, v in parts)
        if total:
            rows.append(f"{row} {total:.1f} ms ({100 * total / busy:.1f}%)"
                        + (" = " + " + ".join(
                            f"{k.split('(')[0].removeprefix('void ')} "
                            f"{v:.1f}"
                            for k, v in parts) if len(parts) > 1 else ""))
    print(f"{label}: device time by kernel-table row: " + "; ".join(rows),
          flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: main path {wall_ms:.1f} ms wall, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy / wall_ms):.1f}%), {launched} device "
          f"activities; top device time: "
          + "; ".join(f"{k[:80]} {v:.1f} ms ({100 * v / busy:.1f}%)"
                      for k, v in top), flush=True)
    return by_name, busy, wall_ms


def phase_generate(model, params):
    """Phase 5: the sequential entry point on the card."""
    import torch
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    t0 = time.perf_counter()
    out = generate(model, params, prompt, 16, page_size=PAGE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if out.shape != (2, 1016) or not torch.equal(out[:, :1000], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate: malformed output {tuple(out.shape)}")
    print(f"generate: 2 x 1000-token prompts + 16 tokens in {dt:.3f} s",
          flush=True)


def phase_generate_long(model, params, S=2560, gen=16):
    """Phase 6, long prompts: ``generate`` on 2 prompts of S tokens through
    the kernels, launches zeroed before and read after: its whole-prompt
    prefill launches flash_attention_fwd once per layer, each of its
    gen - 1 decode steps the paged decode kernel once per layer, and
    nothing else. Returns the launches."""
    import torch
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, S), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, gen, page_size=PAGE)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    if out.shape != (2, S + gen) or not torch.equal(out[:, :S], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate[S={S}]: malformed output {tuple(out.shape)}")
    L = model.cfg.num_layers
    want = {"flash_attention_fwd": L, "paged_attention_fwd": L * (gen - 1)}
    for name, n in launches.items():
        if n != want.get(name, 0):
            fail(f"generate[S={S}]: {name} launched {n} times, want "
                 f"{want.get(name, 0)}")
    print(f"generate[S={S}]: 2 x {S}-token prompts + {gen} tokens in "
          f"{dt:.3f} s through the kernels; launches {json.dumps(launches)}",
          flush=True)
    return launches


def phase_generate_quant(model, params):
    """Phase 6, quantized: ``generate`` through the HAQ dot hook's kernels
    (``make_quant_dot(GEN_QUANT_POLICY, use_kernel=True)``) on 2 prompts of
    1000 tokens, launches zeroed before and read after: per forward (the
    prefill and each decode step) W4A16 on FFN in and gate and W8A8 on FFN
    out of every layer, and W8A16 on the lm_head. Returns the launches."""
    import torch
    from repro_torch.core.quantization import make_quant_dot
    from repro_torch.launch.serve import generate
    g = torch.Generator().manual_seed(6)
    prompt = torch.randint(2, model.cfg.vocab_size, (2, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    dot = make_quant_dot(GEN_QUANT_POLICY, use_kernel=True)
    gen = 16
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    out = generate(model, params, prompt, gen, page_size=PAGE, dot=dot)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    if out.shape != (2, 1000 + gen) or not torch.equal(out[:, :1000], prompt) \
            or int(out.min()) < 0 or int(out.max()) >= model.cfg.vocab_size:
        fail(f"generate[quant]: malformed output {tuple(out.shape)}")
    L, forwards = model.cfg.num_layers, gen
    want = {"quant_matmul_w4a16": 2 * L * forwards,
            "quant_matmul_w8a8": L * forwards,
            "quant_matmul_w8a16": forwards}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"generate[quant]: {name} launched {launches[name]} times, "
                 f"want {n} ({forwards} forwards)")
    print(f"generate[quant]: 2 x 1000-token prompts + {gen} tokens through "
          f"{json.dumps(GEN_QUANT_POLICY)} in {dt:.3f} s; launches "
          f"{json.dumps(launches)}", flush=True)

    # W8A8 alone on FFN out, through the kernel and through its plain
    # version: the kernel's bf16 outputs equal the plain version's bit for
    # bit, so the generated tokens must be identical
    from repro_torch.kernels import ops as kops
    base = make_quant_dot({})

    def w8a8_only(mode):
        def site(x, w, name):
            if name == "ffn_out" and w.dim() == 2:
                return kops.quant_matmul(x, w, w_bits=8, a_bits=8, mode=mode)
            return base(x, w, name)
        return site

    toks = {}
    for mode in ("cuda", "ref"):
        reset_all_launches()
        toks[mode] = generate(model, params, prompt, gen, page_size=PAGE,
                              dot=w8a8_only(mode))
        torch.cuda.synchronize()
        n = all_launches()["quant_matmul_w8a8"]
        if n != (L * forwards if mode == "cuda" else 0):
            fail(f"generate[w8a8 {mode}]: W8A8 launched {n} times")
    if not torch.equal(toks["cuda"], toks["ref"]):
        fail("generate[w8a8]: the kernel's tokens differ from the plain "
             "version's")
    print(f"generate[w8a8]: W8A8 on FFN out through the kernel "
          f"({L * forwards} launches) and through its plain version: "
          f"{gen} tokens x 2 identical", flush=True)
    return launches


def phase_drift(model, params):
    """Phase 7: teacher-forced logit drift of the int8 and the KV_POLICY
    pool against the bf16 pool, through the kernels, over one 1000-token
    prompt and its 32-token greedy continuation. Printed, not gated: the
    weights are random, so the size of the drift says nothing about a
    trained model; only a non-finite value fails."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.serving.kvquant import greedy_drift, \
        teacher_forced_logits

    g = torch.Generator().manual_seed(11)
    prompt = torch.randint(2, model.cfg.vocab_size, (1, 1000), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    tokens = generate(model, params, prompt, GEN + 1,
                      page_size=PAGE)[0].cpu().numpy()
    t0 = time.perf_counter()
    fp = teacher_forced_logits(model, params, tokens, 1000, page_size=PAGE)
    for kv_bits in (8, KV_POLICY):
        rep = greedy_drift(model, params, tokens, 1000, kv_bits=kv_bits,
                           page_size=PAGE, fp_logits=fp)
        if not np.isfinite(rep["max_abs"]):
            fail(f"drift[kv={kv_bits}]: non-finite logits")
        print(f"drift[kv={json.dumps(kv_bits)}]: max |logit drift| "
              f"{rep['max_abs']:.4g} over {len(fp)} teacher-forced steps "
              f"(|logit| up to {float(np.abs(fp).max()):.3g}); greedy "
              f"flips at steps {rep['flip_steps']}; smallest bf16 top-2 "
              f"margin {float(rep['margins'].min()):.4g}", flush=True)
    print(f"drift: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------- HAQ search and autotuner --
# the autotune part's trace: 4 prompts of 4-256 tokens, 16 new tokens each
AUTOTUNE_ARGS = ["--arch", "gemma2-2b", "--requests", "4", "--prompt-len",
                 "256", "--gen", "16", "--max-batch", "8"]
AUTOTUNE_BUDGET = 32
WEIGHT_HAQ_EPISODES = 10    # the agents train at episode 10 (7 sites x 10
                            # transitions fill the 64-row replay batch)


def phase_haq_kv(model, params, bf16_pages, bf16_summary):
    """Phase 8a: the HAQ search over the full-width model's KV sites on
    h100-sxm (16 episodes), its bits checked against the sensitivity gate
    and the budget; then the main trace served through the launcher's
    own ``--kv-policy haq`` path (its 8-episode search), through the
    quant pair where every slot is quantized and both pairs where a slot
    stays bf16."""
    from repro_torch.core.haq import enumerate_kv_sites
    from repro_torch.core.hardware_model import H100_SXM
    from repro_torch.serving.kvquant import allowed_kv_bits, \
        search_kv_policy

    cfg = model.cfg
    max_len = max(len(r.prompt) + r.max_new for r in main_trace(cfg))
    t0 = time.perf_counter()
    res = search_kv_policy(cfg, H100_SXM, max_model_len=max_len,
                           episodes=16)
    dt = time.perf_counter() - t0
    sites = enumerate_kv_sites(cfg, 1, max_len)
    for s, b in zip(sites, res["bits"]):
        if b not in allowed_kv_bits(s):
            fail(f"haq[kv]: {s.name} searched to {b} bits, outside its "
                 f"gate {allowed_kv_bits(s)}")
    floor = tuple(min(allowed_kv_bits(s)) for s in sites)
    if res["resource"] > res["budget"] and res["bits"] != floor:
        fail(f"haq[kv]: {res['bits']} over budget ({res['resource']} > "
             f"{res['budget']}) with a slot above its gated floor {floor}")
    print(f"haq[kv]: searched bits {res['policy']} in {dt:.2f} s (16 "
          f"episodes, agent on the host); {res['kv_bytes_per_token']} "
          f"B/token against bf16's {res['kv_bytes_per_token_fp']} "
          f"({res['kv_bytes_per_token'] / res['kv_bytes_per_token_fp']:.4f}"
          f"x); roofline decode tick (h100-sxm, B=1, ctx {max_len}) "
          f"{1e3 * res['est_decode_s']:.6f} ms against bf16's "
          f"{1e3 * res['est_decode_s_fp']:.6f} ms; resident bytes "
          f"{res['resource']:.6g} against a budget of {res['budget']:.6g}",
          flush=True)
    launcher = search_kv_policy(cfg, H100_SXM, max_model_len=max_len,
                                episodes=8)["bits"]
    expect = QUANT_KERNELS if all(b < 16 for b in launcher) \
        else QUANT_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    _, policy, _, _ = phase_engine(
        model, params, ["--kv-policy", "haq"], expect=expect,
        bf16_pages=bf16_pages, bf16_summary=bf16_summary)
    if tuple(policy.kv_bits) != tuple(launcher):
        fail(f"haq[kv]: the launcher served kv={policy.kv_bits}, its "
             f"search gives {launcher}")
    print(f"haq[kv]: served on the searched pool {policy.kv_bits} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_haq_weights(model, params):
    """Phase 8b: HAQ's weight search on full-width gemma2-2b's 7 decode
    sites (batch 8) on h100-sxm, each policy scored by ``Model.loss``
    through the fake-quant hook on the card over one (1, 512) batch of
    random tokens from seed 0; losses finite, the best policy within the
    budget or at the all-minimum floor (the reference test's check)."""
    import math
    import torch
    from repro_torch.core import haq
    from repro_torch.core.hardware_model import H100_SXM
    from repro_torch.core.quantization import make_quant_dot

    cfg = model.cfg
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(2, cfg.vocab_size, (1, 512), generator=g,
                           dtype=torch.int32).to(params["embed"].device)
    batch = {"tokens": tokens, "labels": tokens}
    losses = []

    def eval_policy(policy):
        loss = float(model.loss(params, batch, dot=make_quant_dot(policy)))
        if not math.isfinite(loss):
            fail(f"haq[weights]: non-finite loss {loss} at {policy}")
        losses.append(loss)
        return loss

    t0 = time.perf_counter()
    bf16 = float(model.loss(params, batch))
    sites = haq.enumerate_sites(cfg, 8, 1, decode=True)
    res = haq.search(cfg, sites, eval_policy,
                     haq.HAQConfig(episodes=WEIGHT_HAQ_EPISODES),
                     hw=H100_SXM)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    best = res["best"]
    floor = haq.resource(sites, [(min(haq.W_BITS), min(haq.A_BITS))]
                         * len(sites), H100_SXM, "latency")
    if not (best["resource"] <= best["budget"] * (1 + 1e-12)
            or abs(best["resource"] - floor) <= 1e-12 * floor):
        fail(f"haq[weights]: best policy at {best['resource']} s over its "
             f"budget {best['budget']} s and above the floor {floor} s")
    agent = res["agents"][0]
    trained = agent.episode >= agent.cfg.warmup_episodes \
        and agent.buffer.n >= agent.cfg.batch
    print(f"haq[weights]: {len(losses)} policies scored in {dt:.1f} s "
          f"({WEIGHT_HAQ_EPISODES} episodes, {agent.buffer.n} transitions, "
          f"agents trained: {trained}); best {best['policy']}; "
          f"roofline latency {1e3 * best['resource']:.6f} ms against a "
          f"budget of {1e3 * best['budget']:.6f} ms (W8A8 "
          f"{1e3 * best['base_resource']:.6f} ms); loss "
          f"{best['loss']:.6f} against the bf16 model's {bf16:.6f} "
          f"(all sites 16 bits: {res['base_loss']:.6f}); episode losses "
          f"{[round(x, 4) for x in losses]}", flush=True)


def phase_autotune():
    """Phase 8c: ``serve.main --autotune`` on full-width gemma2-2b (the
    launcher builds its own model from seed 0), then ``--serving-config``
    on the record it wrote. Launches are counted over each call; the
    calibration and validation engines' launches are the first call's
    less the second's (both end by serving the winner on the same
    trace), and the paged kernels must be among them."""
    import torch
    from repro_torch.launch import serve

    with tempfile.TemporaryDirectory() as tmp:
        out_file = Path(tmp) / "serving.json"
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        serve.main(AUTOTUNE_ARGS + ["--autotune", str(AUTOTUNE_BUDGET),
                                    "--autotune-out", str(out_file)])
        torch.cuda.synchronize()
        tuned = all_launches()
        t1 = time.perf_counter()
        reset_all_launches()
        serve.main(AUTOTUNE_ARGS + ["--serving-config", str(out_file)])
        torch.cuda.synchronize()
        served = all_launches()
        t2 = time.perf_counter()
        record = json.loads(out_file.read_text())
    validation = {k: tuned[k] - served[k] for k in tuned}
    for names in (("paged_attention_fwd", "paged_attention_quant_fwd"),
                  ("paged_prefill_fwd", "paged_prefill_quant_fwd")):
        if sum(validation[k] for k in names) <= 0:
            fail(f"autotune: no launch of {names} during calibration and "
                 f"validation ({json.dumps(validation)})")
        if sum(served[k] for k in names) <= 0:
            fail(f"autotune: --serving-config never launched {names}")
    prov = record["provenance"]
    corr = prov["rank_correlation"]
    print(f"autotune: {prov['candidates']} candidates "
          f"({prov['admissible']} admissible), winner "
          f"{record['knobs']} kv_bits={record['kv_bits']}; measured "
          f"decode {prov['measured_decode_tok_s']:.3f} tok/s against the "
          f"default's {prov['default_decode_tok_s']:.3f} "
          f"({prov['searched_vs_default']:.4f}x); predicted "
          f"{prov['predicted_decode_tok_s']:.3f}; Spearman rank "
          f"correlation predicted vs measured: "
          + ("n/a (fewer than 3 measured or a constant side)"
             if corr is None else f"{corr:.4f}"), flush=True)
    cal = prov["calibration"]
    print(f"autotune: calibration kinds {sorted(cal['by_kind'])}, scales "
          f"by kind {json.dumps(cal['by_kind'])}, by shape "
          f"{json.dumps(cal['by_shape'])}", flush=True)
    print(f"autotune: launches in calibration and validation "
          f"{json.dumps(validation)}; --serving-config "
          f"{json.dumps(served)}; --autotune call {t1 - t0:.1f} s, "
          f"--serving-config call {t2 - t1:.1f} s", flush=True)


# ------------------------------------------------ tiny gemma2-2b (hd 32) --
# tiny gemma2-2b (the reference's tiny_config): 4 query heads, 2 kv heads of
# width 32, a local window of 32; served at pages of 16 and 64 (a page of 64
# spans two 32-key decode tiles), chunked and whole-prompt, and at a page of
# 48 chunked (tiles that start in the middle of a page); the kernels also
# checked at pages below, at and above the tiles, and at pages that neither
# divide a tile nor are a multiple of one (3, 24, 48, 96)
TINY_HEADS, TINY_HD, TINY_WINDOW = (4, 2), 32, 32
TINY_PAGES = (16, 64)
TINY_CHUNKED_PAGES = (48,)
TINY_KERNEL_PAGES = (2, 16, 64, 128, 3, 24, 48, 96, 256)
TINY_GEN = 16


def phase_tiny_kernels():
    """Phase 1b: every attention kernel at hd 32 against its plain version
    (tolerance as phase 2): decode and prefill over bf16, int8 and int4
    pools at pages below, at and above the 32-key decode tile and pages
    whose tiles start mid-page (TINY_KERNEL_PAGES), positions across the
    tiny window and page edges, windows {0, 32} and caps {0, 50}; flash
    over 2560 tokens. A failure ends the run."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    positions = [0, 31, 33, 64, 129, 300]
    for page in TINY_KERNEL_PAGES:
        for name, (fwd, plain, bit_set, is_dec) in kernel_specs().items():
            Sq = 1 if is_dec else 70
            n_blocks = (max(positions) + Sq) // page + 3
            for bits in bit_set:
                qs, pools, pt, pos = paged_case(
                    300 + page + bits, positions, Sq, n_blocks, bits,
                    heads=TINY_HEADS, hd=TINY_HD, page=page)
                for window in (0, TINY_WINDOW):
                    for cap in (0.0, CAP):
                        check_kernel(f"{name}[hd=32 page={page}]", fwd,
                                     plain, qs, pools, pt, pos,
                                     window=window, cap=cap, bits=bits)
    g = torch.Generator(device="cuda").manual_seed(17)
    S = 2560
    n_q, n_kv = TINY_HEADS
    q = torch.randn((1, S, n_q, TINY_HD), generator=g, device="cuda")
    k = torch.randn((1, S, n_kv, TINY_HD), generator=g,
                    device="cuda").bfloat16()
    v = torch.randn((1, S, n_kv, TINY_HD), generator=g,
                    device="cuda").bfloat16()
    qs = {0.0: q.bfloat16(), CAP: (q * CAP_Q_SCALE).bfloat16()}

    def fwd(q, k, v, pt, pos, *, window, cap):
        return fa.flash_attention_fwd(q, k, v, causal=True, window=window,
                                      cap=cap)

    def plain(q, k, v, pt, pos, *, window, cap):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                       cap=cap)

    for window in (0, TINY_WINDOW):
        for cap in (0.0, CAP):
            check_kernel("flash_attention_fwd[hd=32]", fwd, plain, qs,
                         (k, v), None, None, window=window, cap=cap)


def tiny_trace(cfg, whole: bool):
    """Chunked runs: 8 prompts of 40-100 tokens (past the window of 32 and
    page edges). Whole-prompt runs: 4 prompts of FLASH_MIN = 2048 tokens,
    so that the engine (which pads a prompt to its 2048-row bucket) and
    ``generate`` (which pads nothing) both prefill through flash on the
    same rows. TINY_GEN new tokens each."""
    import numpy as np
    from repro_torch.models.flash import FLASH_MIN
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(3)
    lens = [FLASH_MIN] * 4 if whole else rng.integers(40, 101, 8).tolist()
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, S)
                    .astype(np.int32), max_new=TINY_GEN)
            for i, S in enumerate(lens)]


def phase_tiny_engine(kv_policy_file):
    """Phase 1c: the north star's tiny main path on the card: tiny
    gemma2-2b served by the engine with ``--paged-kernel cuda`` at pages of
    16 and 64, chunked (32-token chunks) and whole-prompt (2048-token
    prompts, through flash), and at a page of 48 chunked, over a bf16 pool
    and the KV_POLICY pool. Each
    run must launch the attention kernels of its path (and no other), and
    give tokens identical to the port's own ``generate`` on each prompt:
    kernel "cuda", the same page size and pool (bf16, or the KV_POLICY
    bits quantized on write), prefilling as the run does (``generate``'s
    ``prefill_chunk``, or its whole-sequence forward)."""
    import numpy as np
    import torch
    from repro_torch.configs import tiny_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model

    model = build_model(tiny_config("gemma2-2b"))
    cfg = model.cfg
    if cfg.resolved_head_dim != TINY_HD or \
            (cfg.num_heads, cfg.num_kv_heads) != TINY_HEADS:
        fail(f"tiny gemma2-2b is not hd {TINY_HD}, heads {TINY_HEADS}")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    runs = list(itertools.product(TINY_PAGES, (True, False), (False, True)))
    runs += list(itertools.product(TINY_CHUNKED_PAGES, (True,),
                                   (False, True)))
    for page, chunked, kv in runs:
        reqs = tiny_trace(cfg, whole=not chunked)
        max_len = max(len(r.prompt) + r.max_new for r in reqs)
        argv = ["--arch", "gemma2-2b", "--tiny", "--paged-kernel", "cuda",
                "--page-size", str(page), "--max-batch", "8"]
        argv += ["--prefill-chunk", "32"] if chunked else \
            ["--no-chunked-prefill", "--prefill-chunk", "2048"]
        if kv:
            argv += ["--kv-policy", str(kv_policy_file)]
        args = serve.build_parser().parse_args(argv)
        policy = serve.make_policy(cfg, model, args, max_len)
        engine = serve.make_engine(model, params, policy, args)
        label = (f"tiny[page={page} {'chunked' if chunked else 'whole'} "
                 f"kv={policy.kv_bits or 'bf16'}]")
        dec = "paged_attention_quant_fwd" if kv else "paged_attention_fwd"
        pre = ("paged_prefill_quant_fwd" if kv else "paged_prefill_fwd") \
            if chunked else "flash_attention_fwd"
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        outs = engine.run(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = all_launches()
        # the oracle: generate over the same pool, prefilling as the run
        # does (32-token chunks through the paged walk, or the whole
        # prompt through the whole-sequence forward)
        want = {r.rid: serve.generate(
            model, params, torch.from_numpy(r.prompt[None]).cuda(),
            r.max_new, page_size=page, kernel="cuda", kv_bits=policy.kv_bits,
            prefill_chunk=policy.prefill_chunk if chunked else 0)[0]
            .cpu().numpy() for r in reqs}
        for name, n in launches.items():
            if name in (dec, pre) and n <= 0:
                fail(f"{label}: kernel {name} was never launched")
            if name not in (dec, pre) and n:
                fail(f"{label}: kernel {name} launched {n} times on a path "
                     f"that should not reach it")
        same = 0
        for r in reqs:
            got, ref_toks = outs[r.rid], want[r.rid]
            if got.shape != ref_toks.shape:
                fail(f"{label}: request {r.rid} returned {got.shape}, "
                     f"generate {ref_toks.shape}")
            diff = np.nonzero(got != ref_toks)[0]
            if diff.size:
                i = int(diff[0])
                fail(f"{label}: request {r.rid} (prompt {len(r.prompt)}) "
                     f"differs from generate at token {i}: "
                     f"{got[i:i + 4].tolist()} vs "
                     f"{ref_toks[i:i + 4].tolist()}")
            same += 1
        ran = {k: v for k, v in launches.items() if v}
        print(f"{label}: {same}/{len(reqs)} requests token-identical to "
              f"generate, {engine.stats['decode_ticks']} decode ticks in "
              f"{dt:.3f} s; launches {json.dumps(ran)}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import build
        from repro_torch.models.api import build_model
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()

    secs = build.build_all()
    print(f"build: {json.dumps(secs)} s of nvcc, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    phase_tiny_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        policy_file = Path(tmp) / "kv_policy.json"
        policy_file.write_text(json.dumps(KV_POLICY))
        phase_tiny_engine(policy_file)

    model = build_model(get_config("gemma2-2b"))
    from repro_torch.launch import serve
    probe = serve.make_policy(
        model.cfg, model, serve.build_parser().parse_args(
            ["--arch", "gemma2-2b", "--max-batch", "8"]),
        max(len(r.prompt) + r.max_new for r in main_trace(model.cfg)))
    records = phase_kernels(prefill_chunk=probe.prefill_chunk,
                            n_blocks_main=probe.pages_per_seq)
    records["flash_attention_fwd"] = phase_flash_kernels()
    records.update(phase_qmm_kernels())

    t1 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    torch.cuda.synchronize()
    print(f"model: gemma2-2b {model.param_count()} params "
          f"({model.param_bytes() / 1e9:.2f} GB) initialised in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    phase_model(model, params)
    phase_model_whole(model, params)
    phase_model(model, params, kv_bits=KV_POLICY, ticks=3)
    for w_bits in (8, 4):
        phase_model(model, params, w_bits=w_bits)
    launches, policy, args, bf16_summary = phase_engine(model, params)
    phase_profile(model, params, policy, args)
    wp_launches, wp_policy, wp_args, _ = phase_engine(
        model, params, ["--no-chunked-prefill"], expect=WHOLE_KERNELS,
        bf16_summary=bf16_summary)
    phase_profile(model, params, wp_policy, wp_args)
    with tempfile.TemporaryDirectory() as tmp:
        policy_file = Path(tmp) / "kv_policy.json"
        policy_file.write_text(json.dumps(KV_POLICY))
        q_launches, q_policy, q_args, _ = phase_engine(
            model, params, ["--kv-policy", str(policy_file)],
            expect=QUANT_KERNELS, bf16_pages=policy.num_pages,
            bf16_summary=bf16_summary)
    phase_profile(model, params, q_policy, q_args)
    w_launches, w_policy, w_args, _ = phase_engine(
        model, params, expect=WQ_KERNELS, quant_bits=WQ_BITS,
        bf16_summary=bf16_summary)
    phase_profile(model, params, w_policy, w_args)
    phase_generate(model, params)
    phase_generate_long(model, params)
    g_launches = phase_generate_quant(model, params)
    phase_drift(model, params)
    t_haq = time.perf_counter()
    phase_haq_kv(model, params, policy.num_pages, bf16_summary)
    t_w = time.perf_counter()
    phase_haq_weights(model, params)
    t_a = time.perf_counter()
    phase_autotune()
    print(f"haq: KV part {t_w - t_haq:.1f} s, weight part {t_a - t_w:.1f} "
          f"s, autotune part {time.perf_counter() - t_a:.1f} s", flush=True)

    # launches per kernel from the run of the path it serves
    source_run = {**{k: launches for k in BF16_KERNELS},
                  **{k: q_launches for k in QUANT_KERNELS},
                  "flash_attention_fwd": wp_launches,
                  "quant_matmul_w8a16": w_launches,
                  "quant_matmul_w4a16": w_launches,
                  "quant_matmul_w8a8": g_launches}
    line = {"kernels": []}
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        r = records[name]
        n = source_run[name][name]
        line["kernels"].append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card_line())
    print(json.dumps(line))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
