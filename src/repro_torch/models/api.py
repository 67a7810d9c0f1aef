"""Model facade (port of ``repro.models.api``): ``build_model(cfg)``
returns a ``Model`` with the entry points the serving engine and
``launch.serve.generate`` call. Parameters are nested dicts of tensors
with the reference's pytree keys (see models/convert.py). The ``dot``
hook threads HAQ quantization through every matmul: it receives
(x, w, site_name) and returns the product (core/quantization.py,
serving/quant.py)."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import params as plib
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    defs: Any

    # -- parameters ---------------------------------------------------------
    def init(self, generator: torch.Generator, device) -> Any:
        """Random parameters on ``device`` from ``generator`` (a generator
        of that device)."""
        return plib.init_params(self.defs, generator, device)

    def param_count(self) -> int:
        return plib.param_count(self.defs)

    def param_bytes(self) -> int:
        return plib.param_bytes(self.defs)

    # -- compute ------------------------------------------------------------
    def forward(self, params, batch, *, want_cache=False,
                unembed_mode="full", cache_layout="full", dot=None,
                kernel="auto"):
        """Whole-sequence forward; ``kernel`` picks the flash-attention
        path of sequences of FLASH_MIN tokens or more: "auto" (CUDA kernel
        on CUDA tensors, plain version on CPU ones), "cuda" or "ref"."""
        return transformer.forward(params, batch, self.cfg,
                                   want_cache=want_cache,
                                   unembed_mode=unembed_mode,
                                   cache_layout=cache_layout, dot=dot,
                                   kernel=kernel)

    def loss(self, params, batch, *, dot=None):
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (chunked, transformer.chunked_ce): HAQ's
        quality feedback. Forward only, under ``torch.no_grad()``; the
        training path and its backward wait for their slice."""
        with torch.no_grad():
            hidden, _, aux, _ = self.forward(params, batch,
                                             unembed_mode="none", dot=dot)
            ce = transformer.chunked_ce(params, hidden, batch["labels"],
                                        self.cfg, dot=dot)
        return ce + 0.01 * aux

    def prefill(self, params, batch, *, cache_layout="full",
                unembed_mode="last", dot=None, kernel="auto"):
        logits, cache, _, _ = self.forward(params, batch, want_cache=True,
                                           unembed_mode=unembed_mode,
                                           cache_layout=cache_layout,
                                           dot=dot, kernel=kernel)
        return logits, cache

    def unembed(self, params, hidden, *, dot=None):
        """Project hidden states (B, S, D) to fp32 logits."""
        return transformer.unembed(params, hidden, self.cfg, dot=dot)

    def decode_step_paged(self, params, pool, page_table, token, positions,
                          *, kernel="auto", dot=None):
        """Continuous-batching decode over the paged pool (updated in
        place). ``kernel``: "auto" (CUDA kernel on CUDA tensors, plain walk
        on CPU ones), "cuda" or "ref"."""
        return transformer.decode_step_paged(params, pool, page_table, token,
                                             positions, self.cfg,
                                             kernel=kernel, dot=dot)

    def prefill_chunk_paged(self, params, pool, page_table, tokens,
                            positions, *, kernel="auto", dot=None):
        """Chunked prefill of tokens (B, Sq) starting at ``positions[b]``;
        returns (hidden (B, Sq, D), pool). See
        transformer.prefill_chunk_paged."""
        return transformer.prefill_chunk_paged(params, pool, page_table,
                                               tokens, positions, self.cfg,
                                               kernel=kernel, dot=dot)

    # -- caches -------------------------------------------------------------
    def pool_specs(self, num_pages: int, page_size: int, kv_bits=None):
        return transformer.pool_specs(self.cfg, num_pages, page_size,
                                      kv_bits=kv_bits)

    def init_pool(self, num_pages: int, page_size: int, kv_bits=None, *,
                  device):
        return transformer.init_pool(self.cfg, num_pages, page_size,
                                     device=device, kv_bits=kv_bits)


def build_model(cfg) -> Model:
    return Model(cfg=cfg, defs=transformer.param_defs(cfg))
