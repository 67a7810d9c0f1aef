"""Serving launcher (port of ``repro.launch.serve``) — a thin CLI over the
continuous-batching engine, with the sequential batched ``generate`` kept
as the reference baseline.

``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8``
``python -m repro_torch.launch.serve --arch gemma2-2b --tiny --device cpu``
``python -m repro_torch.launch.serve --arch gemma2-2b --tiny --device cpu \\
  --sequential``
``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8 \\
  --kv-bits 8``
``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8 \\
  --kv-policy POLICY.json``   (e.g. ``{"sub0": 4, "sub1": 8}``)
``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8 \\
  --kv-policy haq``
``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8 \\
  --autotune 32 --autotune-out SERVING_gemma2.json``
``python -m repro_torch.launch.serve --arch gemma2-2b --max-batch 8 \\
  --serving-config SERVING_gemma2.json``
``python -m repro_torch.launch.serve --arch gemma2-2b --sequential \\
  --quant-policy QUANT.json``  (e.g. ``{"ffn_in": [4, 16]}``)

Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no CPU request it stops with an error. ``--kv-bits`` and
``--kv-policy`` serve from a quantized KV pool (serving/kvquant);
``--kv-policy haq`` runs the HAQ search over KV sites first.
``--autotune`` searches the serving config (serving/autotune: calibrate
on the trace, search, validate the top candidates on the engine) and
serves with the measured winner; ``--serving-config`` loads a searched
config back. ``--quant-policy`` (sequential mode only, as in the
reference) maps HAQ sites to ``[w_bits, a_bits]`` and serves through
``make_quant_dot``'s fake-quant hook; the engine's weight quantization
comes from the admission policy's ``quant_bits``. The reference's
``--mesh`` waits for the sharded engine.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config, tiny_config
from repro_torch.core.hardware_model import DEFAULT_HW, HARDWARES
from repro_torch.core.quantization import make_quant_dot
from repro_torch.models import attention
from repro_torch.models.api import build_model
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import normalize_kv_bits
from repro_torch.serving.engine import Engine, Request, derive_policy


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. No silent fallback to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    return device


def _identity_paged_pool(cache, B: int, max_len: int, page: int):
    """Scatter a full-layout prefill cache into a fresh identity-mapped page
    pool: sequence b's logical block i lives at physical page 1 + b*ppseq
    + i (page 0 stays the scratch page, as in the engine)."""
    ppseq = -(-max_len // page)
    span = ppseq * page
    device = next(iter(cache["sub0"].values())).device
    pt = (torch.arange(B * ppseq, dtype=torch.int32, device=device)
          .reshape(B, ppseq) + 1)

    def to_pages(c):                     # (G, B, S, K, hd) full layout
        c = F.pad(c, (0, 0, 0, 0, 0, span - c.shape[2]))
        c = c.reshape(c.shape[0], B * ppseq, page, *c.shape[3:])
        pool = torch.zeros((c.shape[0], B * ppseq + 1) + c.shape[2:],
                           dtype=c.dtype, device=c.device)
        pool[:, 1:] = c
        return pool

    return tree_map(to_pages, cache), pt


def _quantized_like(model, pool, kv_bits):
    """An identity pool's pages written into a pool of ``kv_bits`` (codes
    and per-token scales where a slot is quantized), through the pool
    writer the engine uses."""
    pages0 = next(iter(pool["sub0"].values()))
    out = model.init_pool(pages0.shape[1], pages0.shape[2], kv_bits=kv_bits,
                          device=pages0.device)
    for slot, kv in pool.items():
        for name, pages in kv.items():
            attention.write_kv(out[slot][name], (slice(None),), pages)
    return out


def _chunked_prefill(model, params, prompt_tokens, gen_len, page_size,
                     kernel, dot, kv_bits, chunk):
    """The prompt (B, S) in ``chunk``-token steps through
    ``prefill_chunk_paged`` over a fresh identity-mapped pool (the last
    chunk padded, its padding rows behind the mask). Returns (logits of
    the last prompt row (B, 1, V), pool, page table)."""
    B, S = prompt_tokens.shape
    padded = -(-S // chunk) * chunk
    ppseq = -(-max(S + gen_len, padded) // page_size)
    device = prompt_tokens.device
    pool = model.init_pool(B * ppseq + 1, page_size, kv_bits=kv_bits,
                           device=device)
    pt = (torch.arange(B * ppseq, dtype=torch.int32, device=device)
          .reshape(B, ppseq) + 1)
    toks = torch.zeros((B, padded), dtype=torch.int32, device=device)
    toks[:, :S] = prompt_tokens
    for start in range(0, S, chunk):
        hidden, pool = model.prefill_chunk_paged(
            params, pool, pt, toks[:, start:start + chunk],
            torch.full((B,), start, dtype=torch.int32, device=device),
            kernel=kernel, dot=dot)
    row = S - 1 - (padded - chunk)
    return (model.unembed(params, hidden[:, row:row + 1], dot=dot), pool,
            pt)


def _sample(logits, temperature, generator):
    logits = logits[:, -1]
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(model, params, prompt_tokens, gen_len: int, *, temperature=0.0,
             generator=None, page_size: int = 16, kernel: str = "auto",
             dot=None, kv_bits=None, prefill_chunk: int = 0):
    """prompt (B, S) int32 on the parameters' device -> (B, S+gen_len).

    Sequential baseline: one fixed batch, no admission — kept as the
    exactness reference. It prefills the whole prompt with the
    whole-sequence forward (flash attention for prompts of 2048 tokens or
    more, which must then be a multiple of 512 long, as in the reference)
    and decodes through the same paged-attention walk as the engine over
    an identity page table. ``kernel`` selects the attention kernels of
    both; ``dot`` (e.g. ``make_quant_dot(policy)``) overrides every matmul
    of both. ``kv_bits`` (as ``--kv-bits``/``--kv-policy`` give it)
    quantizes the pool on write, as the engine's pool does;
    ``prefill_chunk`` > 0 prefills the prompt in chunks of that many
    tokens through the paged prefill walk over the pool, as the engine's
    chunked prefill does, instead of the whole-sequence forward."""
    B, S = prompt_tokens.shape
    if prefill_chunk:
        logits, pool, pt = _chunked_prefill(
            model, params, prompt_tokens, gen_len, page_size, kernel, dot,
            kv_bits, prefill_chunk)
    else:
        logits, cache = model.prefill(params, {"tokens": prompt_tokens},
                                      cache_layout="full", dot=dot,
                                      kernel=kernel)
        pool, pt = _identity_paged_pool(cache, B, S + gen_len, page_size)
        if kv_bits is not None:
            pool = _quantized_like(model, pool, kv_bits)
    out = [prompt_tokens.to(torch.int32)]
    tok = _sample(logits, temperature, generator)
    for i in range(gen_len):
        out.append(tok)
        if i == gen_len - 1:
            break
        positions = torch.full((B,), S + i, dtype=torch.int32,
                               device=prompt_tokens.device)
        logits, pool = model.decode_step_paged(params, pool, pt, tok,
                                               positions, kernel=kernel,
                                               dot=dot)
        tok = _sample(logits, temperature, generator)
    return torch.cat(out, dim=1)


def _make_requests(args, cfg):
    rng = np.random.default_rng(0)
    reqs = []
    lo = min(4, args.prompt_len)
    for i in range(args.requests):
        S = int(rng.integers(lo, args.prompt_len + 1))
        prompt = rng.integers(2, cfg.vocab_size, S).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=args.gen))
    return reqs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--hw", default=DEFAULT_HW, choices=sorted(HARDWARES),
                    help="roofline target the admission policy is sized "
                         "for")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--requests", type=int, default=8,
                    help="engine mode: number of requests in the trace")
    ap.add_argument("--batch", type=int, default=4,
                    help="sequential mode: fixed batch size")
    ap.add_argument("--max-batch", type=int, default=0,
                    help="override the policy's max in-flight batch")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV pool page size in tokens (both modes)")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=("auto", "cuda", "ref"),
                    help="attention kernels, paged and whole-prompt: the "
                         "CUDA kernels, their plain PyTorch versions, or "
                         "auto (CUDA on the card)")
    ap.add_argument("--reserve-upfront", action="store_true",
                    help="legacy admission: reserve every page of "
                         "prompt+max_new at admission instead of growing "
                         "lazily with preemption")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine mode: override the policy's prompt chunk "
                         "(tokens per prefill tick; 0 keeps the derived "
                         "value)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="engine mode: prefill whole prompts, padded to a "
                         "multiple of the prefill chunk, in one forward "
                         "(flash attention from 2048 padded tokens on)")
    ap.add_argument("--expected-occupancy", type=float, default=None,
                    help="fraction of max_model_len the admission policy "
                         "assumes a typical sequence occupies (default "
                         "0.5, or 1.0 with --reserve-upfront)")
    ap.add_argument("--sequential", action="store_true",
                    help="fixed-batch generate loop instead of the engine")
    ap.add_argument("--quant-policy", default="",
                    help="json file: {site: [w_bits, a_bits]} "
                         "(sequential mode only)")
    ap.add_argument("--trace-out", default="",
                    help="engine mode: write the telemetry Chrome trace "
                         "to this path and print the telemetry summary")
    ap.add_argument("--kv-bits", type=int, default=16, choices=(4, 8, 16),
                    help="engine mode: stored KV-cache bits for the paged "
                         "pool, uniform across layers (16 = bf16; 8/4 = "
                         "int pages with per-token per-head scales, "
                         "dequantized inside the paged-attention walk)")
    ap.add_argument("--kv-policy", default="",
                    help="engine mode: per-layer KV bit policy — 'haq' "
                         "runs the HAQ search over KV sites "
                         "(serving/kvquant/policy.py: roofline feedback, "
                         "sensitivity-gated int4), or a json file mapping "
                         "sub-layer slots to bits, e.g. "
                         "'{\"sub0\": 4, \"sub1\": 8}'; overrides "
                         "--kv-bits")
    ap.add_argument("--serving-config", default="",
                    help="engine mode: load a searched serving config JSON "
                         "(serving/autotune, written by --autotune-out) "
                         "instead of hand-picking knobs; it owns page "
                         "size, prefill chunk, occupancy, KV policy and "
                         "the batch cap")
    ap.add_argument("--autotune", type=int, default=0, metavar="BUDGET",
                    help="engine mode: autotune the serving config before "
                         "serving — calibrate the admission roofline on a "
                         "warmup run, search the config space (DDPG + "
                         "evolution) with this many objective evaluations, "
                         "validate the top candidates on the engine, and "
                         "serve the trace with the measured winner "
                         "(0 = off)")
    ap.add_argument("--autotune-out", default="",
                    help="with --autotune: write the searched serving "
                         "config JSON here for --serving-config to load "
                         "back ('' disables)")
    return ap


def kv_bits_arg(cfg, args, max_model_len: int):
    """The KV bit spec ``--kv-bits``/``--kv-policy`` ask for: None (bf16),
    an int, or a per-sub-layer tuple — searched on ``--hw`` for
    ``max_model_len`` (``haq``) or from the policy file."""
    if args.kv_policy == "haq":
        from repro_torch.serving.kvquant import search_kv_policy
        res = search_kv_policy(cfg, HARDWARES[args.hw],
                               max_model_len=max_model_len, episodes=8)
        print(f"kvquant[haq]: {res['policy']} "
              f"({res['kv_bytes_per_token_fp']}->"
              f"{res['kv_bytes_per_token']} B/token)")
        return res["bits"]
    if args.kv_policy:
        with open(args.kv_policy) as f:
            return normalize_kv_bits(cfg, json.load(f))
    return None if args.kv_bits == 16 else args.kv_bits


def make_policy(cfg, model, args, max_model_len: int):
    """The admission policy the engine runs under: derived on ``--hw`` for
    ``max_model_len`` and the KV bits asked for, with the batch/chunk
    overrides applied."""
    occupancy = args.expected_occupancy
    if occupancy is None:
        occupancy = 1.0 if args.reserve_upfront else 0.5
    policy = derive_policy(cfg, HARDWARES[args.hw],
                           max_model_len=max_model_len,
                           page_size=args.page_size,
                           expected_occupancy=occupancy,
                           param_bytes=model.param_bytes(),
                           kv_bits=kv_bits_arg(cfg, args, max_model_len))
    over = {}
    if args.max_batch:
        over["max_batch"] = args.max_batch
    if args.prefill_chunk:
        over["prefill_chunk"] = args.prefill_chunk
    return dataclasses.replace(policy, **over) if over else policy


def serving_config_policy(ap, cfg, model, params, args, reqs,
                          max_model_len: int):
    """The admission policy a searched serving config gives:
    ``--serving-config`` loads one, ``--autotune`` searches one on
    ``reqs`` (and writes it to ``--autotune-out``). One device: the
    space's mesh dimension is 1 until the sharded engine is ported."""
    from repro_torch.serving.autotune import (ConfigSpace,
                                              autotune_serving_config,
                                              load_serving_config,
                                              save_serving_config)
    hw = HARDWARES[args.hw]
    space = ConfigSpace(cfg, hw, max_model_len=max_model_len,
                        max_devices=1, max_batch_cap=args.max_batch or 8,
                        param_bytes=model.param_bytes())
    if args.serving_config:
        sc, record = load_serving_config(args.serving_config)
        if (record.get("arch"), record.get("hw"),
                record.get("max_model_len")) != \
                (cfg.name, hw.name, max_model_len):
            print(f"serving-config: note — searched for "
                  f"{record.get('arch')}@{record.get('max_model_len')} "
                  f"on {record.get('hw')}, serving "
                  f"{cfg.name}@{max_model_len} on {hw.name}")
        print(f"serving-config[{record.get('hw')}]: {sc.as_dict()}")
    else:
        t0 = time.time()
        tune = autotune_serving_config(model, params, space, reqs,
                                       budget=args.autotune, seed=0)
        sc = tune.winner.scored.config
        corr = tune.rank_correlation
        print(f"autotune[{hw.name}]: {tune.search.evaluated} "
              f"candidates ({tune.search.admissible} admissible) in "
              f"{time.time() - t0:.1f}s -> "
              f"{tune.winner.decode_tok_s:.1f} decode tok/s vs "
              f"default {tune.default.decode_tok_s:.1f} "
              f"({tune.searched_vs_default:.2f}x), rank corr "
              + ("n/a" if corr is None else f"{corr:.2f}"))
        print(f"autotune[{hw.name}]: winner {sc.as_dict()}")
        if args.autotune_out:
            save_serving_config(args.autotune_out, tune.record(space))
            print(f"autotune: wrote {args.autotune_out} "
                  f"(load with --serving-config)")
    bad = space.violations(sc)
    if bad:
        ap.error(f"serving config not admissible for {cfg.name}@"
                 f"{max_model_len} on {hw.name}: {'; '.join(bad)}")
    return space.to_policy(sc)


def make_engine(model, params, policy, args) -> Engine:
    return Engine(model, params, policy, temperature=args.temperature,
                  paged_kernel=args.paged_kernel,
                  reserve_upfront=args.reserve_upfront,
                  chunked_prefill=not args.no_chunked_prefill)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        ap.error("--prompt-len must be >= 1")
    if args.quant_policy and not args.sequential:
        ap.error("--quant-policy applies to --sequential mode only; the "
                 "engine derives its quantization from the admission policy")
    if args.sequential and (args.kv_policy or args.kv_bits != 16):
        ap.error("--kv-bits/--kv-policy apply to engine mode only; the "
                 "sequential baseline is the bf16 exactness reference")
    if args.sequential and args.trace_out:
        ap.error("--trace-out applies to engine mode only; the sequential "
                 "baseline has no telemetry recorder")
    if args.sequential and (args.autotune or args.serving_config):
        ap.error("--autotune/--serving-config apply to engine mode only; "
                 "the sequential baseline has no admission policy to tune")
    if args.autotune and args.serving_config:
        ap.error("--serving-config loads a finished search; drop it or "
                 "drop --autotune")
    if args.autotune_out and not args.autotune:
        ap.error("--autotune-out only makes sense with --autotune")
    if (args.autotune or args.serving_config) and (
            args.kv_policy or args.kv_bits != 16):
        ap.error("--kv-bits/--kv-policy are knobs the serving config "
                 "owns; drop them when using --autotune/--serving-config")
    device = resolve_device(args.device)
    # fp32 products stay fp32 (the fp32 unembed, the logits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = tiny_config(args.arch) if args.tiny else get_config(args.arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)

    if args.sequential:
        dot = None
        if args.quant_policy:
            with open(args.quant_policy) as f:
                qpolicy = {k: tuple(v) for k, v in json.load(f).items()}
            dot = make_quant_dot(qpolicy)
            print(f"serving with quantization policy over "
                  f"{len(qpolicy)} sites")
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(
            2, cfg.vocab_size, (args.batch, args.prompt_len))
            .astype(np.int32)).to(device)
        gen = torch.Generator(device=device).manual_seed(1) \
            if args.temperature > 0 else None
        t0 = time.time()
        out = generate(model, params, prompt, args.gen,
                       temperature=args.temperature, generator=gen,
                       page_size=args.page_size, kernel=args.paged_kernel,
                       dot=dot)
        out = out.cpu().numpy()
        dt = time.time() - t0
        print(f"{cfg.name}: generated {args.gen} tokens x batch "
              f"{args.batch} in {dt:.2f}s "
              f"({args.gen * args.batch / dt:.1f} tok/s) on {device}")
        print("sample:", out[0, args.prompt_len:args.prompt_len + 16])
        return

    max_len = args.prompt_len + args.gen
    reqs = _make_requests(args, cfg)
    if args.serving_config or args.autotune:
        policy = serving_config_policy(ap, cfg, model, params, args, reqs,
                                       max_len)
    else:
        policy = make_policy(cfg, model, args, max_len)
    print(f"admission[{args.hw}]: max_batch={policy.max_batch} "
          f"prefill_chunk={policy.prefill_chunk} "
          f"chunked={not args.no_chunked_prefill} "
          f"quant={policy.quant_bits}b "
          f"kv={policy.kv_bits or 'bf16'} pages={policy.num_pages} "
          f"page_size={policy.page_size} "
          f"(est decode {policy.est_decode_s * 1e3:.2f}ms/step)")
    engine = make_engine(model, params, policy, args)
    t0 = time.time()
    outs = engine.run(reqs)
    dt = time.time() - t0
    gen_total = engine.stats["decode_tokens"] + engine.stats["prefills"]
    print(f"{cfg.name}: served {len(reqs)} requests, {gen_total} tokens in "
          f"{dt:.2f}s ({gen_total / dt:.1f} tok/s, "
          f"{engine.stats['decode_ticks']} decode ticks, "
          f"{engine.stats['prefill_chunks']} prefill chunks, "
          f"{engine.stats['preemptions']} preemptions, "
          f"{engine.stats['grown_pages']} pages grown) on {device}")
    first = outs[0]
    print("sample:", first[len(reqs[0].prompt):len(reqs[0].prompt) + 16])
    if args.trace_out:
        from repro_torch.serving.telemetry import summarize, \
            write_chrome_trace
        write_chrome_trace(engine.telemetry, args.trace_out)
        print(f"telemetry: wrote Chrome trace to {args.trace_out} "
              f"(open in https://ui.perfetto.dev)")
        print(summarize(engine.telemetry))


if __name__ == "__main__":
    main()
