"""Greedy-drift measurement for quantized KV pools (port of
``repro.serving.kvquant.drift``).

A quantized pool cannot promise token-identical greedy outputs — it
promises bounded logit drift. The measurement is teacher-forced: replay
one fixed token stream through a bf16 pool and a quantized pool and
compare the per-step logits. Both runs see identical contexts, so the
logit gap is exactly the KV-quantization error, with no argmax-flip
cascade in it.

A greedy quantized run is token-identical to the bf16 run until the first
step whose bf16 top-2 logit margin is within 2x the measured drift — a
flip beyond that margin would need a logit error larger than the bound.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.serve import _identity_paged_pool
from repro_torch.serving.kvquant.quantize import quantize_pool


def teacher_forced_logits(model, params, tokens, prompt_len: int, *,
                          page_size: int = 16, kv_bits=None,
                          kernel: str = "auto") -> np.ndarray:
    """Replay ``tokens`` (prompt + continuation) through a paged pool,
    feeding the given continuation instead of sampling, and return the fp32
    logits for every continuation position — ``out[i]`` predicts
    ``tokens[prompt_len + i]``.

    ``kv_bits=None`` replays through the bf16 pool; otherwise the prefill
    cache is converted with the writers' per-token mapping and decode
    quantizes on write, so the replay runs the serving path (the
    fused-dequant walk included). Runs on the parameters' device."""
    tokens = np.asarray(tokens, np.int32)
    T = len(tokens)
    assert 0 < prompt_len < T, (prompt_len, T)
    dev = params["embed"].device
    toks = torch.from_numpy(tokens).to(dev)
    logits, cache = model.prefill(params, {"tokens": toks[None, :prompt_len]},
                                  cache_layout="full")
    pool, pt = _identity_paged_pool(cache, 1, T, page_size)
    if kv_bits is not None:
        pool = quantize_pool(pool, model.cfg, kv_bits)
    out = [logits[0, -1].float().cpu().numpy()]
    for t in range(prompt_len, T - 1):
        logits, pool = model.decode_step_paged(
            params, pool, pt, toks[None, t:t + 1],
            torch.tensor([t], dtype=torch.int32, device=dev), kernel=kernel)
        out.append(logits[0, 0].float().cpu().numpy())
    return np.stack(out)


def greedy_drift(model, params, tokens, prompt_len: int, *,
                 kv_bits, page_size: int = 16, kernel: str = "auto",
                 fp_logits: np.ndarray = None) -> dict:
    """Max-abs teacher-forced logit drift of a KV bit policy against the
    bf16 pool over one token stream, plus the top-2 bf16 margin at every
    step (what a flip must beat). Keys: ``max_abs`` drift, ``margins``
    (n,), ``flip_steps`` where the quantized argmax differs, ``fp_logits``
    — pass the latter back in to compare several bit policies against one
    bf16 replay."""
    fp = fp_logits if fp_logits is not None else \
        teacher_forced_logits(model, params, tokens, prompt_len,
                              page_size=page_size, kernel=kernel)
    qq = teacher_forced_logits(model, params, tokens, prompt_len,
                               page_size=page_size, kv_bits=kv_bits,
                               kernel=kernel)
    drift = float(np.max(np.abs(fp - qq)))
    top2 = np.sort(fp, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    flips = np.nonzero(np.argmax(fp, -1) != np.argmax(qq, -1))[0]
    return {"max_abs": drift, "margins": margins,
            "flip_steps": flips.tolist(), "fp_logits": fp}
