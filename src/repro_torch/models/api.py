"""Model facade (port of ``repro.models.api``): ``build_model(cfg)``
returns a ``Model`` with the entry points the serving engine,
``launch.serve.generate``, the trainer (training/steps.py) and the
searches call, for every family: the encoder-decoder (``cfg.is_encdec``)
through models/encdec.py, the others through models/transformer.py.
Parameters are nested dicts of tensors with the
reference's pytree keys (see models/convert.py). The ``dot``
hook threads HAQ quantization through every matmul: it receives
(x, w, site_name) and returns the product (core/quantization.py,
serving/quant.py)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models import params as plib
from repro_torch.models.layers import WHOLE_ROWS
from repro_torch.models.params import tree_map


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    defs: Any

    # -- parameters ---------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> Any:
        """Random parameters on ``device`` from ``generator`` (a generator
        of that device)."""
        return plib.init_params(self.defs, generator, device)

    def abstract_params(self) -> Any:
        """The parameter tree as meta tensors: shapes and dtypes, no
        storage (the reference's ShapeDtypeStructs)."""
        return plib.abstract_params(self.defs)

    def logical_specs(self) -> Any:
        """Each parameter's logical axis names (distributed/sharding.py)."""
        return plib.logical_specs(self.defs)

    def param_count(self) -> int:
        return plib.param_count(self.defs)

    def param_bytes(self) -> int:
        return plib.param_bytes(self.defs)

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch, *, want_cache=False,
                unembed_mode="full", cache_layout="ring", dot=None,
                kernel="auto", remat=False, gather=None, place=None,
                ranks=None, ac=None):
        """Whole-sequence forward; ``kernel`` picks the flash-attention
        path of sequences of FLASH_MIN tokens or more: "auto" (CUDA kernel
        on CUDA tensors, plain version on CPU ones), "cuda" or "ref".
        ``remat`` recomputes each layer group in the backward;
        ``cache_layout`` "ring" gives the dense decode's caches, "full"
        the chronological ones the page pool takes
        (transformer.forward). The encoder-decoder takes {frames, tokens}
        and ignores ``cache_layout``, as in the reference
        (encdec.forward). ``gather`` is the sharded engine's, trainer's
        and serving steps' hook (every family's layers whole at use),
        ``place`` the sharded serving steps' cache layout, ``ranks`` the
        ranks the batch is split over, which the moe layers read, ``ac``
        the activation layout (make_ac's seq_tp splits the residual's
        rows over the model axis) (transformer.forward, encdec.forward)."""
        if self.cfg.is_encdec:
            return encdec.forward(params, batch, self.cfg,
                                  want_cache=want_cache, remat=remat,
                                  dot=dot, unembed_mode=unembed_mode,
                                  kernel=kernel, gather=gather, place=place,
                                  ac=ac)
        return transformer.forward(params, batch, self.cfg,
                                   want_cache=want_cache,
                                   unembed_mode=unembed_mode,
                                   cache_layout=cache_layout, dot=dot,
                                   kernel=kernel, remat=remat,
                                   gather=gather, place=place, ranks=ranks,
                                   ac=ac)

    def loss(self, params, batch, *, remat=False, dot=None, kernel="auto",
             gather=None, ranks=None, ac=None):
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (chunked, transformer.chunked_ce) plus 0.01 x
        the moe layers' load-balance loss, as the reference's: the
        training objective (training/steps.py, whose gradients flow
        through it, flash's backward included) and HAQ's and AMC's quality
        feedback. Their parameters require no gradient, so scoring builds
        no graph. The vlm family scores its text rows only: the hidden
        states after the patch rows. ``gather`` and ``ranks`` are the
        sharded trainer's hooks (training/sharded.py): parameters whole
        per layer at use, and the ranks that split the batch
        (distributed/sharding.py::BatchRanks), over which the loss's sum
        and count are summed (the vlm's text rows included: its token
        count is the global batch's) and the moe layers route; ``ac`` the
        activation layout (``forward``).

        Where ``ac`` splits the batch's sequence over data (every rank
        given the whole batch: distributed/sharding.py::DataSeqRows), the
        rank's hidden rows are its block of the sequence's (the vision
        stub's patch and text rows alike), each scored against the next
        row's label and weighted by its own row's text mask, the last row
        of the sequence by none; the moe aux loss is the whole batch's on
        every rank, its gradient taken on the first data rank alone
        (``DataSeqRows.once``)."""
        hidden, _, aux, fmask = self.forward(params, batch,
                                             unembed_mode="none", dot=dot,
                                             kernel=kernel, remat=remat,
                                             gather=gather, ranks=ranks,
                                             ac=ac)
        labels = batch["labels"]
        data_sum = None if ranks is None else ranks.sum
        B, S = labels.shape
        rows = self._loss_rows(B, S + (batch["patches"].shape[1]
                                      if "patches" in batch else 0), ac)
        if rows.split_loss:
            weight = torch.ones(labels.shape, dtype=torch.float32,
                                device=labels.device) if fmask is None \
                else fmask
            nxt, w = rows.targets(torch.nn.functional.pad(
                labels, (weight.shape[1] - S, 0)), weight)
            ce = transformer.chunked_ce(params, hidden, nxt, self.cfg,
                                        dot=dot, gather=gather,
                                        loss_mask=w, data_sum=data_sum,
                                        shifted=True)
            return ce + 0.01 * rows.once(aux)
        if fmask is not None:
            hidden = hidden[:, -labels.shape[1]:]
        ce = transformer.chunked_ce(params, hidden, labels, self.cfg,
                                    dot=dot, gather=gather,
                                    data_sum=data_sum)
        return ce + 0.01 * aux

    def _loss_rows(self, B: int, S: int, ac):
        """The row layout of the loss's (B, S) sequence (the decoder's,
        or the vision stub's patch and text rows) under ``ac``."""
        if ac is None:
            return WHOLE_ROWS
        return ac.rows((B, S, self.cfg.d_model))

    def prefill(self, params, batch, *, cache_layout="ring",
                unembed_mode="last", dot=None, kernel="auto", gather=None,
                place=None, ranks=None, ac=None):
        """(logits, caches) of ``forward(want_cache=True)``. ``gather``,
        ``place``, ``ranks`` and ``ac`` are the sharded serving steps'
        hooks (training/sharded_serve.py): the parameters whole per layer
        at use, each layer's caches cut to this rank's block, the ranks
        the batch is split over and the activation layout
        (transformer.forward, encdec.forward)."""
        logits, cache, _, _ = self.forward(params, batch, want_cache=True,
                                           unembed_mode=unembed_mode,
                                           cache_layout=cache_layout,
                                           dot=dot, kernel=kernel,
                                           gather=gather, place=place,
                                           ranks=ranks, ac=ac)
        return logits, cache

    def unembed(self, params, hidden, *, dot=None, gather=None):
        """Project hidden states (B, S, D) to fp32 logits."""
        return transformer.unembed(params, hidden, self.cfg, dot=dot,
                                   gather=gather)

    def decode_step(self, params, cache, token, pos, *, dot=None,
                    gather=None, place=None, ranks=None):
        """One token (B, 1) at position ``pos`` over dense caches (a
        ``prefill``'s, grown to the decode length, or ``init_cache``'s),
        updated in place; returns (logits (B, 1, V), cache). The
        reference's ``generate`` path for ssm and hybrid and
        training/steps.py::make_serve_step. ``gather``, ``place`` and
        ``ranks``: the sharded serving steps' hooks
        (transformer.decode_step)."""
        if self.cfg.is_encdec:
            return encdec.decode_step(params, cache, token, pos, self.cfg,
                                      dot=dot, gather=gather, place=place)
        return transformer.decode_step(params, cache, token, pos, self.cfg,
                                       dot=dot, gather=gather, place=place,
                                       ranks=ranks)

    def decode_step_paged(self, params, pool, page_table, token, positions,
                          *, kernel="auto", dot=None, gather=None):
        """Continuous-batching decode over the paged pool (updated in
        place). ``kernel``: "auto" (CUDA kernel on CUDA tensors, plain walk
        on CPU ones), "cuda" or "ref"."""
        return transformer.decode_step_paged(params, pool, page_table, token,
                                             positions, self.cfg,
                                             kernel=kernel, dot=dot,
                                             gather=gather)

    def prefill_chunk_paged(self, params, pool, page_table, tokens,
                            positions, *, kernel="auto", dot=None,
                            gather=None):
        """Chunked prefill of tokens (B, Sq) starting at ``positions[b]``;
        returns (hidden (B, Sq, D), pool). See
        transformer.prefill_chunk_paged."""
        return transformer.prefill_chunk_paged(params, pool, page_table,
                                               tokens, positions, self.cfg,
                                               kernel=kernel, dot=dot,
                                               gather=gather)

    # -- caches -------------------------------------------------------------
    def cache_specs(self, batch: int, seq_len: int):
        """The dense decode caches as (shape, dtype) pairs."""
        fn = encdec.cache_specs if self.cfg.is_encdec \
            else transformer.cache_specs
        return fn(self.cfg, batch, seq_len)

    def init_cache(self, batch: int, seq_len: int, *, device):
        return transformer.zeros(self.cache_specs(batch, seq_len), device)

    def pool_specs(self, num_pages: int, page_size: int, kv_bits=None):
        return transformer.pool_specs(self.cfg, num_pages, page_size,
                                      kv_bits=kv_bits)

    def pool_axes(self, kv_bits=None):
        """The pool's logical axes (kv_heads is the one split)."""
        return transformer.pool_axes(self.cfg, kv_bits)

    def init_pool(self, num_pages: int, page_size: int, kv_bits=None, *,
                  device):
        return transformer.init_pool(self.cfg, num_pages, page_size,
                                     device=device, kv_bits=kv_bits)

    # -- inputs -------------------------------------------------------------
    def input_specs(self, shape) -> Dict[str, Any]:
        """Meta-tensor stand-ins for one step's inputs at ``shape`` (the
        reference's ShapeDtypeStructs): a train or prefill batch, or a
        decode step's caches, token and position."""
        B, S = shape.global_batch, shape.seq_len
        cfg = self.cfg
        if shape.kind == "decode":
            return {"cache": tree_map(lambda s: _meta(*s),
                                      self.cache_specs(B, S)),
                    "token": _meta((B, 1), torch.int32),
                    "pos": _meta((), torch.int32)}
        if cfg.is_encdec:
            Sd = max(S // cfg.dec_ratio, 2)
            batch = {"frames": _meta((B, S, cfg.d_model), torch.bfloat16),
                     "tokens": _meta((B, Sd), torch.int32)}
        elif cfg.frontend == "vision_stub":
            Sp = int(S * cfg.patch_frac)
            batch = {"patches": _meta((B, Sp, cfg.d_model), torch.bfloat16),
                     "tokens": _meta((B, S - Sp), torch.int32)}
        else:
            batch = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            batch["labels"] = _meta(tuple(batch["tokens"].shape),
                                    torch.int32)
        return batch

    def batch_logical_specs(self, shape) -> Dict[str, Any]:
        """Logical axes of ``input_specs(shape)``, key for key."""
        if shape.kind == "decode":
            fn = encdec.cache_axes if self.cfg.is_encdec \
                else transformer.cache_axes
            return {"cache": fn(self.cfg), "token": ("batch", "seq"),
                    "pos": ()}
        axes = {"frames": ("batch", "seq", "embed_act"),
                "patches": ("batch", "seq", "embed_act"),
                "tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return {k: axes[k] for k in self.input_specs(shape)}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_model(cfg) -> Model:
    defs = encdec.param_defs(cfg) if cfg.is_encdec \
        else transformer.param_defs(cfg)
    return Model(cfg=cfg, defs=defs)
