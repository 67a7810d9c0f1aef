"""Analytic roofline hardware model (port of
``repro.core.hardware_model``): the paper's "hardware in the loop" for
HAQ's latency/energy/size feedback and the admission policy's sizing.

Per-op costs (flops, weight bytes, activation bytes, collective bytes)
priced on a ``Hardware`` target as the max of compute, memory and
collective time (``latency``), as joules (``energy``), or as FLOPs per
memory byte (``intensity``). Plain Python floats: the reference's
traced-array support serves its NAS latency loss; here the latency
table (core/latency_table.py) prices ops once, as numpy, so floats do.

The energy constants (``pj_per_flop``, ``pj_per_hbm_byte``,
``pj_per_ici_byte``) are the reference's public-literature scale values
for every target, ``h100-sxm`` included: they were not measured on an
H100, so an ``energy``-mode search ranks policies, it does not price the
card.

Targets: the reference's three TPU v5e entries, kept for comparison, and
``h100-sxm`` — NVIDIA's data-sheet numbers for one H100 SXM: 989 TFLOP/s
dense bf16, 1,979 TOP/s int8, 3.35 TB/s of device memory, 80 GiB, NVLink
at 450 GB/s each way. The port's serving entry points default to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    chips: int
    peak_flops_bf16: float = 197e12   # per chip
    peak_flops_int8: float = 394e12   # v5e int8 MXU path
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per link
    hbm_bytes: float = 16 * 2**30
    # energy constants (public-literature scale values, not measured)
    pj_per_flop: float = 0.25         # bf16 MAC ~0.2-0.3 pJ on 5nm-class
    pj_per_hbm_byte: float = 120.0
    pj_per_ici_byte: float = 40.0

    def peak_flops(self, w_bits) -> float:
        """Matmul peak vs weight precision: weights of 8 bits or fewer run
        on the int8 path."""
        return self.peak_flops_int8 if w_bits <= 8 else self.peak_flops_bf16


V5E_EDGE = Hardware("v5e-1chip", chips=1)
V5E_POD = Hardware("v5e-pod256", chips=256)
V5E_2POD = Hardware("v5e-2pod512", chips=512,
                    ici_bw=25e9)  # pod axis traverses slower links
H100_SXM = Hardware("h100-sxm", chips=1, peak_flops_bf16=989e12,
                    peak_flops_int8=1979e12, hbm_bw=3.35e12, ici_bw=450e9,
                    hbm_bytes=80 * 2**30)

HARDWARES: Dict[str, Hardware] = {h.name: h for h in
                                  (V5E_EDGE, V5E_POD, V5E_2POD, H100_SXM)}
DEFAULT_HW = H100_SXM.name


def mxu_pad(dim, tile: int = 128) -> float:
    """Effective dim after matrix-unit tile padding."""
    return math.ceil(float(dim) / tile) * tile


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Roofline terms for one op at one precision setting."""
    flops: float
    weight_bytes: float
    act_bytes: float
    coll_bytes: float = 0.0

    def _bytes(self, w_bits, a_bits) -> float:
        return (self.weight_bytes * w_bits / 16.0
                + self.act_bytes * a_bits / 16.0)

    def latency(self, hw: Hardware, w_bits=16, a_bits=16) -> float:
        t_comp = self.flops / (hw.peak_flops(w_bits) * hw.chips)
        t_mem = self._bytes(w_bits, a_bits) / (hw.hbm_bw * hw.chips)
        t_coll = self.coll_bytes / (hw.ici_bw * hw.chips)
        return max(t_comp, t_mem, t_coll)

    def energy(self, hw: Hardware, w_bits=16, a_bits=16) -> float:
        # MAC energy scales ~linearly with operand width
        e_flop = self.flops * hw.pj_per_flop * 1e-12 * \
            min(w_bits, a_bits) / 16.0
        e_mem = self._bytes(w_bits, a_bits) * hw.pj_per_hbm_byte * 1e-12
        e_coll = self.coll_bytes * hw.pj_per_ici_byte * 1e-12
        return e_flop + e_mem + e_coll

    def intensity(self, w_bits=16, a_bits=16) -> float:
        """Operational intensity (FLOPs per memory byte)."""
        return self.flops / max(self._bytes(w_bits, a_bits), 1.0)


# ------------------------------------------------------------- op costs ----
def linear_cost(tokens: int, d_in: int, d_out: int, *, tp: int = 1,
                pad: bool = True) -> OpCost:
    """Dense matmul (tokens, d_in) x (d_in, d_out), TP-sharded on d_out;
    ``pad`` rounds both dims up to the matrix-unit tile."""
    di = mxu_pad(d_in) if pad else float(d_in)
    do = mxu_pad(d_out) if pad else float(d_out)
    return OpCost(
        flops=2.0 * tokens * di * do,
        weight_bytes=di * do * 2.0,
        act_bytes=2.0 * tokens * (di + do),
        coll_bytes=2.0 * tokens * do / max(tp, 1),  # partial-sum reduce
    )


def attention_cost(batch: int, q_len: int, kv_len: int, n_heads: int,
                   n_kv: int, head_dim: int, *, window: int = 0,
                   decode: bool = False, kv_bits: int = 16) -> OpCost:
    """``kv_bits`` scales the KV-cache read traffic for a quantized page
    pool, plus the fp32 per-token per-head scale tiles stored beside the
    codes. Compute is unchanged."""
    eff_kv = min(window, kv_len) if window else kv_len
    flops = 4.0 * batch * q_len * eff_kv * n_heads * head_dim
    kv_bytes = 2.0 * batch * eff_kv * n_kv * head_dim * 2.0 * (kv_bits / 16.0)
    if kv_bits < 16:
        kv_bytes += 2.0 * batch * eff_kv * n_kv * 4.0   # scale tiles
    act = 2.0 * batch * q_len * n_heads * head_dim * 2.0
    return OpCost(flops=flops, weight_bytes=0.0, act_bytes=kv_bytes + act)


def allreduce_cost(tokens: int, d_model: int, shards: int) -> OpCost:
    """Ring all-reduce of a (tokens, d_model) bf16 activation across a
    tensor-parallel group: every rank moves ~2*(N-1)/N of the buffer."""
    n = max(int(shards), 1)
    coll = 2.0 * tokens * d_model * 2.0 * (n - 1) / n
    return OpCost(flops=0.0, weight_bytes=0.0, act_bytes=0.0,
                  coll_bytes=coll)


def gather_cost(nbytes, shards: int) -> OpCost:
    """Ring all-gather of ``nbytes`` of sharded-at-rest state onto every
    rank ((N-1)/N of the buffer crosses the interconnect per rank)."""
    n = max(int(shards), 1)
    return OpCost(flops=0.0, weight_bytes=0.0, act_bytes=0.0,
                  coll_bytes=float(nbytes) * (n - 1) / n)


def ssd_cost(batch: int, seq: int, d_inner: int, d_state: int,
             chunk: int) -> OpCost:
    """Mamba2 SSD: intra-chunk quadratic + state updates."""
    heads = max(d_inner // 64, 1)
    intra = 2.0 * batch * seq * chunk * heads * 64
    state = 4.0 * batch * seq * d_inner * d_state
    return OpCost(flops=intra + state, weight_bytes=0.0,
                  act_bytes=2.0 * batch * seq * d_inner * 2.0)


def moe_cost(tokens: int, d_model: int, d_ff: int, n_experts: int,
             top_k: int) -> OpCost:
    """Top-k expert FFN + all-to-all dispatch."""
    active = linear_cost(tokens * top_k, d_model, d_ff)
    a2a = 2.0 * tokens * top_k * d_model * 2.0  # dispatch + combine
    return OpCost(
        flops=active.flops * 3.0,                       # in/gate/out
        weight_bytes=mxu_pad(d_model) * mxu_pad(d_ff) * 3.0 * n_experts * 2.0,
        act_bytes=active.act_bytes * 3.0,
        coll_bytes=a2a,
    )
