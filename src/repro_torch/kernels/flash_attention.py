"""Python wrapper of the hand-written Hopper flash-attention forward
(``csrc/flash_attention.cu``).

``flash_attention_fwd`` replaces the Pallas TPU kernel of the same name in
``repro.kernels.flash_attention``: dense attention of q (B, S, H, hd) over
k, v (B, T, K, hd) with GQA (query head h = k*G + g reads kv head k),
causal, local-window or full, with the softcap before the mask. It serves
whole-prompt prefill: every forward of ``models/flash.py::FLASH_MIN``
tokens or more (``chunked_prefill=False`` in the engine, and ``generate``).

What bounds it on the H100: the operations, 4*hd flops per valid (query
head, key) pair, over the tensor cores' rate. The kernel runs both
products on wgmma (fp32 accumulation, P from registers), feeds them by
TMA into K and V rings on mbarriers, has two consumer warpgroups take
turns at the tensor cores so that one's softcap and exp overlap the
other's products, loads each K/V tile once for 128 fused rows (the G
heads of one kv head over ``flash_plan``'s P positions) and skips kv
tiles above the diagonal or below the window — see the source's header
note.

On a CPU tensor the wrapper returns its plain version
(``kernels/ref.py::flash_attention_ref``); on a CUDA tensor it launches
the kernel or raises. ``LAUNCHES`` counts kernel launches, nothing else.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of the kernel; the wrapper adds one where it launches, and only
# there (chip_smoke.py zeroes it around the main path)
LAUNCHES = {"flash_attention_fwd": 0}

HEAD_DIMS = (32, 64, 128, 256)   # the head widths the kernel is built for
ROWS = 128                       # fused query rows a CTA (the kernel's kBM)


def kv_tile(hd: int) -> int:
    """Keys a kv tile of the kernel (its Layout::kBN): 80 at hd 256, where
    the P V accumulator takes 128 registers a thread and two K and two V
    stages of 80 keys fill the shared memory beside q, else 128."""
    return 80 if hd == 256 else 128


@dataclass(frozen=True)
class FlashPlan:
    """The kernel's work split over a (sequence, kv head) pair:
    ``positions`` query positions a CTA (its G heads each: ``positions * G
    <= ROWS`` fused rows, row r = p*G + g), ``tiles`` CTAs, ``bn`` keys a
    kv tile. The kernel takes ``positions``; it derives the CTA count and
    each CTA's kv-tile range from it and the shapes itself
    (``flash_fwd_kernel``: CTA i takes row tile ``tiles - 1 - i``, from
    the first position's window start to the last position's diagonal),
    and ``tests/test_torch_flash_hopper.py`` checks a mirror of that
    range against the reference's mask."""
    S: int
    T: int
    causal: bool
    window: int
    positions: int
    bn: int
    tiles: int


def flash_plan(S: int, T: int, G: int, causal: bool, window: int,
               hd: int) -> FlashPlan:
    """The kernel's work split, from the shapes alone: ROWS // G
    positions a CTA, ceil(S / positions) CTAs per (sequence, kv head),
    kv tiles of ``kv_tile(hd)`` keys."""
    if not 1 <= G <= ROWS:
        raise ValueError(f"flash kernel: G = H/K must be in 1..{ROWS}, "
                         f"got {G}")
    P = ROWS // G
    return FlashPlan(S, T, bool(causal), int(window), P, kv_tile(hd),
                     -(-S // P))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, window) -> None:
    named = (("q", q), ("k", k), ("v", v))
    if not all(t.is_cuda and t.device == q.device for _, t in named):
        raise ValueError("flash attention kernel: q, k and v must be on one "
                         "CUDA device")
    if any(t.dtype != torch.bfloat16 for _, t in named):
        raise TypeError(f"flash attention kernel takes bf16 q, k, v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel: {name} must be "
                             f"16-byte aligned (TMA)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, T, K, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    _, T, K, _ = k.shape
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} (need the same B and hd, H a "
                         f"multiple of K)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernel is built for hd in {HEAD_DIMS}, got {hd}")
    if B == 0 or S == 0 or T == 0:
        raise ValueError(f"empty attention: B={B}, S={S}, T={T}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, cap=0.0,
                        return_lse=False):
    """q (B, S, H, hd) bf16; k, v (B, T, K, hd) bf16, H = K*G. ``causal``:
    key j <= query i; ``window`` > 0: key j > i - window (with or without
    ``causal``); ``cap`` > 0: scores softcapped before the mask. Returns
    (B, S, H, hd) bf16, and with ``return_lse`` also each row's fp32
    log-sum-exp (B, H, S), the backward's input (models/flash.py): the
    kernel writes it in its epilogue, within about 2**-9 of the plain
    version's (its l sums the bf16-rounded weights); without it the kernel
    writes none and ``out`` is the same. A query with no valid key at all
    (only possible with ``causal=False``, a window, and the query past
    T + window - 2) is undefined: the kernel averages v over the kv tiles
    it visits, as the Pallas kernel does over its own, where the plain
    version averages all of v."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       cap=cap, return_lse=return_lse)
    _check(q, k, v, int(window))
    B, S, H, hd = q.shape
    _, T, K, _ = k.shape
    plan = flash_plan(S, T, H // K, bool(causal), int(window), hd)
    lib = build.load("flash_attention")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(),
                            None if lse is None else lse.data_ptr(),
                            B, S, T, H, K, hd, plan.positions, int(causal),
                            int(window), float(cap), stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")
    LAUNCHES["flash_attention_fwd"] += 1
    return (out, lse) if return_lse else out
