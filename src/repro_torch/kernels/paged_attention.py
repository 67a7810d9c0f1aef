"""Python wrappers of the hand-written Hopper paged-attention kernels
(``csrc/paged_attention.cu``).

Each replaces the Pallas TPU kernel of the same name in
``repro.kernels.paged_attention``: ``paged_attention_fwd`` (one-token
decode) and ``paged_prefill_fwd`` (chunked prefill) over a bf16 page pool,
``paged_attention_quant_fwd`` and ``paged_prefill_quant_fwd`` over a
quantized one (int8, or int4 packed two per byte along hd, with fp32
per-slot, per-head scales; the bitwidth is read from the stored shape).
All four walk ``page_table[b]`` with an fp32 online softmax, the softcap
before the mask and the local window, and never build the dense
chronological KV view.

What bounds them on the H100: decode, the bytes of the live K/V pages
over 3.35 TB/s; prefill, its operations over the tensor cores' rate. The
decode wrappers launch two kernels: a split kernel, grid (B, K*G/GC,
n_split), whose CTAs each walk an equal share of their sequence's own
32-key tiles through a three-stage cp.async ring and leave fp32 partials
(m, l, acc) in a scratch tensor this module allocates, then a combine
kernel that merges them in a fixed order. ``decode_splits`` picks n_split
from the shapes alone, never from ``positions`` (no host read, so a CUDA
graph can capture the call). The prefill wrappers launch one
tensor-core kernel (mma.sync) over 128-row tiles of the chunk's fused
(Sq*G) rows and 64-key K/V tiles; a quantized pool's codes become bf16
tiles once per landed tile. See the source's header note.

The kernels are built for hd in ``HEAD_DIMS`` and take pages of any
size from 1 key up (the reference's own rule): a 32-key decode tile or a
64-key prefill tile may hold several pages, part of one, or start in the
middle of one page and end in the middle of the next, since the copies
address key j at pool slot ``page_table[j // page] * page + j % page``
(``tile_slots``). ``check_geometry`` raises on any other hd and on pages
below 1.

On a CPU tensor each wrapper returns its plain version from
``kernels/ref.py``; on a CUDA tensor it launches the kernels or raises.
``LAUNCHES`` counts wrapper calls that launched, one per call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of each kernel; a wrapper adds one where it launches, and only
# there, one per call even where the call launches the split and the
# combine kernels (chip_smoke.py zeroes these around the main path)
LAUNCHES = {"paged_attention_fwd": 0, "paged_prefill_fwd": 0,
            "paged_attention_quant_fwd": 0, "paged_prefill_quant_fwd": 0}

SMEM_LIMIT = 232448   # bytes of shared memory one H100 block may use
HEAD_DIMS = (32, 64, 128, 256)   # the head widths the kernels are built for
# the kernels address a pool slot (page id * page + offset) in 32 bits
MAX_POOL_SLOTS = 2 ** 31 - 1
DECODE_TILE = 32      # keys per decode ring stage, the unit a split takes
DECODE_THREADS = 256  # threads per decode split CTA (at most; decode_threads)
PREFILL_ROWS = 128    # fused (Sq*G) query rows per prefill CTA
PREFILL_TILE = 64     # keys per prefill K/V tile
# decode splits: about two split CTAs per SM of the H100's 132, each split
# keeping at least MIN_SPLIT_TILES tiles of the table's width
SPLIT_TARGET_CTAS = 2 * 132
MIN_SPLIT_TILES = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def decode_splits(B: int, K: int, n_blocks: int, page: int) -> int:
    """Splits per (sequence, kv head) of the decode walk, from the shapes
    alone: enough for SPLIT_TARGET_CTAS CTAs over B*K pairs, at most one
    per MIN_SPLIT_TILES 32-key tiles of the page table's width, at least
    one. Each sequence's CTAs share its own live tiles (``split_tiles``);
    splits past them walk nothing. ``K`` is the model's kv-head count,
    also for a sharded engine's pool slice of it: the plan, and so each
    walk's summation grouping, is then the one-device engine's."""
    tiles = -(-n_blocks * page // DECODE_TILE)
    want = -(-SPLIT_TARGET_CTAS // max(B * K, 1))
    return max(1, min(want, tiles // MIN_SPLIT_TILES))


def decode_threads(hd: int) -> int:
    """Threads of a decode split CTA (the kernel's DecodeLayout::kThreads):
    hd/8 lanes per walker and at most one walker per key of a tile, so
    DECODE_THREADS from hd = 64 up and 128 at hd = 32."""
    return min(DECODE_THREADS, DECODE_TILE * hd // 8)


def head_group(G: int) -> int:
    """Query heads one decode split CTA serves (the kernel's GC): 4, 2 or
    1, the largest that divides G; G/GC CTAs share a kv head."""
    return 4 if G % 4 == 0 else 2 if G % 2 == 0 else 1


def decode_grid(B: int, H: int, K: int, n_blocks: int, page: int,
                kv_heads=None):
    """The decode split kernel's grid (B, K*G/GC, n_split) over a pool of
    K kv heads, of a model's ``kv_heads`` (default K)."""
    return (B, K * (H // K) // head_group(H // K),
            decode_splits(B, kv_heads or K, n_blocks, page))


def prefill_grid(B: int, Sq: int, H: int, K: int):
    """The prefill kernel's grid (B, K, 128-row tiles of the Sq*G rows)."""
    return (B, K, -(-Sq * (H // K) // PREFILL_ROWS))


def decode_blocks(pos: int, window: int, page: int, n_blocks: int):
    """[lo, hi] blocks the decode query at ``pos`` needs (the kernel's and
    the Pallas kernel's _block_range, hi clamped to the table width);
    lo > hi when it needs none."""
    hi = min(pos // page, n_blocks - 1)
    lo = max((pos - window + 1) // page, 0) if window else 0
    return lo, hi


def split_tiles(lo: int, hi: int, page: int, split: int, n_split: int):
    """[t0, t1): the 32-key tiles split ``split`` of ``n_split`` walks of
    the blocks [lo, hi] (as the kernel computes them): an equal contiguous
    share of the tiles that hold them."""
    t_lo = lo * page // DECODE_TILE
    n_t = (hi * page + page - 1) // DECODE_TILE - t_lo + 1 if lo <= hi else 0
    return (t_lo + split * n_t // n_split,
            t_lo + (split + 1) * n_t // n_split)


def tile_slots(pt_row, t: int, rows: int, page: int, lo: int, hi: int):
    """Pool slots (page id * page + offset) of the ``rows`` keys of tile
    ``t`` (keys t*rows .. t*rows + rows - 1), as the kernels' copies compute
    them: key j lies in block j // page at offset j % page; -1 where the
    block is outside the live [lo, hi] (a zero-filled row)."""
    out = []
    for r in range(rows):
        key = t * rows + r
        blk = key // page
        out.append(int(pt_row[blk]) * page + key % page
                   if lo <= blk <= hi else -1)
    return out


def check_geometry(hd: int, page: int) -> None:
    """Raise ValueError unless the kernels are built for head width ``hd``
    and ``page`` is a page size, at least 1 key (no fallback to the plain
    walk)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"kernels are built for hd in {HEAD_DIMS}, got {hd}")
    if page < 1:
        raise ValueError(f"kernels take a page size of at least 1 key, got "
                         f"{page}")


def _check(q, pool_k, pool_v, page_table, positions, prefill, scales=()):
    """Validate a launch; ``scales`` (k_scale, v_scale) marks a quantized
    pool. Returns (library, bits of the pool)."""
    if pool_k.dim() == 4:
        check_geometry(q.shape[-1], pool_k.shape[1])
        if pool_k.shape[0] * pool_k.shape[1] > MAX_POOL_SLOTS:
            raise ValueError(f"a pool of {pool_k.shape[0]} pages of "
                             f"{pool_k.shape[1]} keys has more than "
                             f"{MAX_POOL_SLOTS} slots (the kernels' 32-bit "
                             f"slot index)")
    named = (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
             ("page_table", page_table), ("positions", positions))
    if scales:
        named += (("k_scale", scales[0]), ("v_scale", scales[1]))
    if not all(t.is_cuda for _, t in named):
        raise ValueError("paged attention kernel: every tensor must be on "
                         "the CUDA device")
    pool_dtype = torch.int8 if scales else torch.bfloat16
    if q.dtype != torch.bfloat16 or pool_k.dtype != pool_dtype \
            or pool_v.dtype != pool_dtype:
        raise TypeError(f"paged attention kernel takes bf16 q and "
                        f"{pool_dtype} pools, got {q.dtype}, {pool_k.dtype}, "
                        f"{pool_v.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise TypeError("paged attention kernel takes fp32 scales")
    if page_table.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged attention kernel takes int32 page_table and "
                        "positions")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel: {name} must be "
                             f"contiguous")
    if pool_k.shape != pool_v.shape or pool_k.dim() != 4:
        raise ValueError(f"pools must both be (P, page, K, hd_store), got "
                         f"{tuple(pool_k.shape)} and {tuple(pool_v.shape)}")
    _, page, K, _ = pool_k.shape
    H, hd = q.shape[-2], q.shape[-1]
    bits = ref.kv_bits_of(pool_k, hd) if scales else 16
    if (not scales and pool_k.shape[-1] != hd) or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool_k.shape)}")
    if any(s.shape != pool_k.shape[:3] for s in scales):
        raise ValueError(f"scales must be (P, page, K) = "
                         f"{tuple(pool_k.shape[:3])}, got "
                         f"{[tuple(s.shape) for s in scales]}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16 \
            or q.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned "
                         "(16-byte loads, cp.async)")
    if any(s.data_ptr() % 4 for s in scales):
        raise ValueError("scales must be 4-byte aligned (cp.async)")
    B = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or positions.shape != (B,):
        raise ValueError("page_table must be (B, n_blocks) and positions "
                         "(B,)")
    lib = build.load("paged_attention")
    smem = lib.paged_smem_bytes(int(prefill), hd, bits)
    if not 0 < smem <= SMEM_LIMIT:
        raise ValueError(f"hd={hd}, {bits}-bit pool: the kernel needs {smem} "
                         f"B of shared memory, over {SMEM_LIMIT}")
    return lib, bits


def _partials(q, n_split: int):
    """fp32 scratch for the decode split kernel's partials: acc
    (B, H, n_split, hd), then (m, l) (B, H, n_split, 2)."""
    B, H, hd = q.shape
    return torch.empty(B * H * n_split * (hd + 2), dtype=torch.float32,
                       device=q.device)


def _raise_on(lib, rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.paged_error_string(rc).decode()}")


def paged_attention_fwd(q, pool_k, pool_v, page_table, positions, *,
                        window=0, cap=0.0, kv_heads=None):
    """q (B, H, hd) bf16; pool_k/v (P, page, K, hd) bf16; page_table
    (B, n_blocks) int32 (unused tails -> scratch page 0); positions (B,)
    int32; ``kv_heads`` the model's kv-head count where the pool holds a
    shard's K of it (the split plan's input, default K). Returns
    (B, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, pool_k, pool_v, page_table,
                                       positions, window=window, cap=cap)
    B, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, _ = _check(q, pool_k, pool_v, page_table, positions, False)
    n_blocks = page_table.shape[1]
    n_split = decode_splits(B, kv_heads or K, n_blocks, page)
    part = _partials(q, n_split)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), part.data_ptr(),
        out.data_ptr(), B, H, K, hd, page, n_blocks, int(window),
        float(cap), n_split, stream)
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
    lib, _ = _check(q, pool_k, pool_v, page_table, positions, True)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_prefill_bf16(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        page_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, Sq, H, K, hd, page, page_table.shape[1], int(window), float(cap),
        stream)
    _raise_on(lib, rc, "paged_prefill_fwd")
    LAUNCHES["paged_prefill_fwd"] += 1
    return out


def paged_attention_quant_fwd(q, pool_k, k_scale, pool_v, v_scale,
                              page_table, positions, *, window=0, cap=0.0,
                              kv_heads=None):
    """Fused-dequant paged decode. q (B, H, hd) bf16; pool_k/v
    (P, page, K, hd_store) int8 with hd_store = hd (int8) or hd//2 (int4
    packed along hd); k/v_scale (P, page, K) fp32; page_table, positions
    and ``kv_heads`` as paged_attention_fwd. Returns (B, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_attention_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    B, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, bits = _check(q, pool_k, pool_v, page_table, positions, False,
                       (k_scale, v_scale))
    n_blocks = page_table.shape[1]
    n_split = decode_splits(B, kv_heads or K, n_blocks, page)
    part = _partials(q, n_split)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_decode_quant(
        q.data_ptr(), pool_k.data_ptr(), k_scale.data_ptr(),
        pool_v.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), part.data_ptr(), out.data_ptr(), B, H, K, hd,
        page, n_blocks, int(window), float(cap), bits, n_split, stream)
    _raise_on(lib, rc, "paged_attention_quant_fwd")
    LAUNCHES["paged_attention_quant_fwd"] += 1
    return out


def paged_prefill_quant_fwd(q, pool_k, k_scale, pool_v, v_scale,
                            page_table, positions, *, window=0, cap=0.0):
    """Fused-dequant chunked prefill. q (B, Sq, H, hd) bf16, the chunk's
    K/V already quantized into the pool; pools and scales as
    paged_attention_quant_fwd; positions (B,) chunk starts. Returns
    (B, Sq, H, hd) bf16."""
    if q.device.type == "cpu":
        return ref.paged_prefill_quant_ref(
            q, pool_k, k_scale, pool_v, v_scale, page_table, positions,
            window=window, cap=cap)
    B, Sq, H, hd = q.shape
    _, page, K, _ = pool_k.shape
    lib, bits = _check(q, pool_k, pool_v, page_table, positions, True,
                       (k_scale, v_scale))
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_prefill_quant(
        q.data_ptr(), pool_k.data_ptr(), k_scale.data_ptr(),
        pool_v.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), B, Sq, H, K, hd, page,
        page_table.shape[1], int(window), float(cap), bits, stream)
    _raise_on(lib, rc, "paged_prefill_quant_fwd")
    LAUNCHES["paged_prefill_quant_fwd"] += 1
    return out
