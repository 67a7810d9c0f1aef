"""Python wrappers of the hand-written Hopper paged-attention kernels
(``csrc/paged_attention.cu``).

``paged_attention_fwd`` replaces the Pallas TPU kernel
``repro.kernels.paged_attention.paged_attention_fwd`` (one-token decode)
and ``paged_prefill_fwd`` replaces ``paged_prefill_fwd`` (chunked
prefill). Both walk ``page_table[b]`` page by page with an fp32 online
softmax, the softcap before the mask and the local window, and never build
the dense chronological KV view.

What bounds them on the H100: the bytes of the live K/V pages each
(sequence, kv head) walks, over 3.35 TB/s. The design loads each page
once per kv head for all G query heads (decode) or a BM-row tile of them
(prefill), streams pages through a two-stage cp.async ring, and keeps
the softmax state in shared memory — see the source's header note.

On a CPU tensor each wrapper returns its plain version from
``kernels/ref.py``; on a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper, nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of each kernel; a wrapper adds one where it launches, and only
# there (chip_smoke.py zeroes these around the main path)
LAUNCHES = {"paged_attention_fwd": 0, "paged_prefill_fwd": 0}

PREFILL_BM = 32       # query rows (of the flattened Sq*G) per prefill CTA
SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, pool_k, pool_v, page_table, positions, rows):
    if not (q.is_cuda and pool_k.is_cuda and pool_v.is_cuda
            and page_table.is_cuda and positions.is_cuda):
        raise ValueError("paged attention kernel: every tensor must be on "
                         "the CUDA device")
    if q.dtype != torch.bfloat16 or pool_k.dtype != torch.bfloat16 \
            or pool_v.dtype != torch.bfloat16:
        raise TypeError(f"paged attention kernel takes bf16 q and pools, "
                        f"got {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged attention kernel takes int32 page_table and "
                        "positions")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("page_table", page_table), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be "
                             f"contiguous")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4:
        raise ValueError(f"pools must both be (P, page, K, hd), got "
                         f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    _, page, K, hd = pool_k.shape
    H = q.shape[-2]
    if q.shape[-1] != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool_k.shape)}")
    if hd % 32 or hd > 256:
        raise ValueError(f"kernel needs hd % 32 == 0 and hd <= 256, got {hd}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (cp.async)")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError("page_table must be (B, n_blocks) and positions "
                         "(B,)")
    lib = build.load("paged_attention")
    smem = lib.paged_smem_bytes(rows, hd, page)
    if smem > SMEM_LIMIT:
        raise ValueError(f"page={page}, hd={hd}, {rows} rows need {smem} B "
                         f"of shared memory, over {SMEM_LIMIT}")
    return lib


def _raise_on(lib, rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.paged_error_string(rc).decode()}")


def paged_attention_fwd(q, pool_k, pool_v, page_table, positions, *,
                        window=0, cap=0.0):
    """q (B, H, hd) bf16; pool_k/v (P, page, K, hd) bf16; page_table
    (B, n_blocks) int32 (unused tails -> scratch page 0); positions (B,)
    int32. Returns (B, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool_k, pool_v, page_table,
                                       positions, window=window, cap=cap)
    B, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib = _check(q, pool_k, pool_v, page_table, positions, H // K)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, H, K, hd, page, page_table.shape[1], int(window), float(cap),
        stream)
    _raise_on(lib, rc, "paged_attention_fwd")
    LAUNCHES["paged_attention_fwd"] += 1
    return out


def paged_prefill_fwd(q, pool_k, pool_v, page_table, positions, *,
                      window=0, cap=0.0):
    """q (B, Sq, H, hd) bf16 — one prompt chunk per sequence whose K/V are
    already in the pool; positions (B,) int32 position of each chunk's
    first token. Returns (B, Sq, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, pool_k, pool_v, page_table,
                                     positions, window=window, cap=cap)
    B, Sq, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib = _check(q, pool_k, pool_v, page_table, positions, PREFILL_BM)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_prefill_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, Sq, H, K, hd, page, page_table.shape[1], int(window), float(cap),
        PREFILL_BM, stream)
    _raise_on(lib, rc, "paged_prefill_fwd")
    LAUNCHES["paged_prefill_fwd"] += 1
    return out
