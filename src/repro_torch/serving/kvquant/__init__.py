"""Mixed-precision KV-cache quantization for the serving engine's paged
pool (port of ``repro.serving.kvquant``).

At long contexts the decode roofline is dominated by KV-cache bytes, not
weight bytes. Pages are stored int8 or int4 per sub-layer slot, priced into
admission (2-4x more pages in the same device memory), and dequantized
*inside* the paged-attention block walk — never as a materialized fp KV
view.

Quantized page layout
---------------------
The bf16 pool stores, per sub-layer slot ``sub{j}`` (see serving/engine)::

    pool["sub{j}"]["k"|"v"] : (n_groups, num_pages, page_size, K, hd) bf16

A slot quantized to ``bits`` in {8, 4} stores instead::

    pool["sub{j}"]["k"|"v"] = {
        "q":     (n_groups, num_pages, page_size, K, hd_store) int8,
        "scale": (n_groups, num_pages, page_size, K)            fp32,
    }

with ``hd_store = hd`` for int8 and ``hd // 2`` for int4 — int4 packs two
codes per byte along head_dim (element ``2i`` in the low nibble, ``2i+1``
in the high; kernels/ref.py::pack_int4_hd). The stored bitwidth is encoded
by the shape itself (``kv_bits_of``), so no bits tag rides the pool.

Scale placement
---------------
Scales are symmetric per page *slot* (token) and per kv head: each physical
page carries its own ``(page_size, K)`` fp32 scale tile next to its codes.
Per-token granularity is what makes quantize-on-write exact bookkeeping:
prefill scatters whole quantized pages, decode writes one ``(K, hd)`` token
into ``page_table[b, pos // page]`` slot ``pos % page`` — and neither ever
re-scales a resident token. The coarser per-page granularity is kept in
``quantize_kv`` for error-bound studies. Scale overhead is ``8 * K`` bytes
per token per layer (k and v), priced into
``admission.kv_bytes_per_token``.

At attention time the scale tiles ride the same page-table walk as their
pages (kernels/paged_attention.py::paged_attention_quant_fwd and
paged_prefill_quant_fwd, hand-written CUDA on the card;
kernels/ref.py::paged_attention_quant_ref and paged_prefill_quant_ref as
the plain versions): each (page, hd) tile is dequantized inside the
online-softmax block loop.

Bit policy
----------
A policy is given by hand: an int, or a per-sub-layer dict such as
``{"sub0": 4, "sub1": 8}`` (int4 on gemma2's local layers, int8 on its
global ones), through ``normalize_kv_bits``. The reference's HAQ search
over KV sites (``policy.py``: ``search_kv_policy``, ``kv_sensitivity``,
``allowed_kv_bits``) is not ported yet: it needs ``core/haq.py`` and
``core/rl/ddpg.py`` (ROADMAP Queue 1, item 10).

The bf16 pool remains the exactness baseline; quantized greedy drift
against it is measured by ``drift.greedy_drift``.
"""
from repro_torch.serving.kvquant.drift import greedy_drift, \
    teacher_forced_logits
from repro_torch.serving.kvquant.quantize import (dequantize_kv, kv_bits_of,
                                                  normalize_kv_bits,
                                                  pack_int4_hd, quantize_kv,
                                                  quantize_pool,
                                                  unpack_int4_hd)

__all__ = ["quantize_kv", "dequantize_kv", "kv_bits_of", "pack_int4_hd",
           "unpack_int4_hd", "quantize_pool", "normalize_kv_bits",
           "greedy_drift", "teacher_forced_logits"]
