"""Deterministic synthetic LM data, host-sharded and restart-exact (port
of ``repro.data.pipeline``).

The batch of a step is a pure function of (seed, step): a restarted job
resumes with byte-identical data and no shuffle state to checkpoint.
Each process draws only its slice of the global batch. The rows are Zipf
unigrams with a copied prefix (an induction signal), so the loss falls.
The tokens come from numpy's generators exactly as the reference draws
them, so both packages see the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.4
    copy_frac: float = 0.5      # fraction of sequence that is copied prefix


def _host_slice(global_batch: int) -> tuple[int, int]:
    """(first row, rows) of this process: its rank's share of the batch
    under an initialised ``torch.distributed`` group, else all of it."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        n, idx = dist.get_world_size(), dist.get_rank()
    else:
        n, idx = 1, 0
    per = global_batch // n
    return idx * per, per


def batch_at(dcfg: DataConfig, step: int, *, full: bool = False
             ) -> Dict[str, np.ndarray]:
    """The batch for ``step`` (pure function). full=True ignores host
    slicing."""
    start, per = (0, dcfg.global_batch) if full else _host_slice(
        dcfg.global_batch)
    rows = []
    for r in range(start, start + per):
        rng = np.random.default_rng(
            (dcfg.seed * 1_000_003 + step) * 65_521 + r)
        toks = np.clip(rng.zipf(dcfg.zipf_a, size=dcfg.seq_len), 2,
                       dcfg.vocab_size - 1)
        half = int(dcfg.seq_len * dcfg.copy_frac)
        if half > 1:
            toks[half:2 * half] = toks[:half]   # copy span (induction signal)
        rows.append(toks)
    tokens = np.stack(rows).astype(np.int32)
    return {"tokens": tokens, "labels": tokens}


def batches(dcfg: DataConfig, start_step: int = 0
            ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(dcfg, step)
        step += 1


def batch_for_model(model, shape, dcfg: Optional[DataConfig], step: int,
                    device="cpu", *, full: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """The model's batch for ``step`` on ``device`` (``full``: the whole
    global batch, whatever the process group; ``batch_at``): int32 tokens and
    labels; for the encoder-decoder also ``frames`` (B, S, d_model) and a
    decoder of max(S // dec_ratio, 2) tokens; for the vision stub
    ``patches`` (B, int(S * patch_frac), d_model) and S minus that many
    tokens. The stub frontends' embeddings are standard normal draws from
    numpy's generator seeded ``seed * 7 + step``, rounded to bf16, as the
    reference draws them."""
    cfg = model.cfg
    dcfg = dcfg or DataConfig(cfg.vocab_size, shape.seq_len,
                              shape.global_batch)
    rng = np.random.default_rng(dcfg.seed * 7 + step)

    def tensors(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    def embeds(rows):
        a = rng.standard_normal((shape.global_batch, rows, cfg.d_model))
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)

    if cfg.is_encdec:
        Sd = max(shape.seq_len // cfg.dec_ratio, 2)
        dec = batch_at(dataclasses.replace(dcfg, seq_len=Sd), step,
                       full=full)
        return {"frames": embeds(shape.seq_len), **tensors(dec)}
    if cfg.frontend == "vision_stub":
        Sp = int(shape.seq_len * cfg.patch_frac)
        txt = batch_at(dataclasses.replace(dcfg, seq_len=shape.seq_len - Sp),
                       step, full=full)
        return {"patches": embeds(Sp), **tensors(txt)}
    return tensors(batch_at(dcfg, step, full=full))
