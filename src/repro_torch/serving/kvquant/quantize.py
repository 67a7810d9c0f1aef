"""Pool-level KV quantization (port of
``repro.serving.kvquant.quantize``).

The element-wise storage mapping (symmetric per-token per-head scales,
int4 packed along head_dim) lives in kernels/ref.py next to the walks that
consume it — the CUDA kernels, the plain walks and the pool writers must
all agree on it bit for bit. This module re-exports those primitives and
adds the pool-level converter used for offline conversion and drift
measurement.
"""
from __future__ import annotations

from repro_torch.kernels.ref import (dequantize_kv, kv_bits_of, pack_int4_hd,
                                     quantize_kv, unpack_int4_hd)
from repro_torch.models.transformer import normalize_kv_bits

__all__ = ["quantize_kv", "dequantize_kv", "kv_bits_of", "pack_int4_hd",
           "unpack_int4_hd", "quantize_pool", "normalize_kv_bits"]


def quantize_pool(pool, cfg, kv_bits):
    """Convert a bf16 page pool (``Model.init_pool`` layout) to the
    quantized layout under ``kv_bits`` (anything normalize_kv_bits takes).

    Every slot is quantized with the writers' per-token per-head mapping,
    so a converted pool is indistinguishable from one filled by
    quantize-on-write. Slots whose policy entry is 16 pass through."""
    bits = normalize_kv_bits(cfg, kv_bits)
    if bits is None:
        return pool
    out = {}
    for sub, kv in pool.items():
        b = bits[int(sub[3:])]
        if b == 16:
            out[sub] = kv
            continue
        out[sub] = {}
        for name in ("k", "v"):
            q, scale = quantize_kv(kv[name], b)
            out[sub][name] = {"q": q, "scale": scale}
    return out
