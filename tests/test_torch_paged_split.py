"""The redesigned paged walks' arithmetic, on the CPU: the decode wrapper's
split plan, a plain-torch emulation of the split decode kernel (walkers,
their merge inside a CTA, the combine across splits) held against the
port's and the reference's plain walks, and an emulation of the
tensor-core prefill kernel's rounding points held against the plain
quantized walk at the kernels' tolerance. The CUDA kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py); what they
compute, tile by tile, is what these emulations compute.

Tolerances. The split decode keeps the plain walk's fp32 arithmetic and
changes only the summation order: 1e-5 in fp32, as the plain walks are
held to each other. The prefill rounds P (times the V scale) to bf16 and
sums q.code as exact bf16 products: held to the kernels' bf16 tolerance
(2**-7 |ref| + 2**-7 row max |ref|, ``bf16_close``), which a variant that
applies the softcap after the mask, or drops the K scale, must miss."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import bf16_close  # noqa: E402

torch.set_num_threads(1)

F32 = torch.float32
NEG = -1e30
TOL = 1e-5
H, K, HD, PAGE = 8, 4, 256, 16
POISON = (37.0, -53.0)


# ------------------------------------------------------------ the plan ----
def test_split_plan_reads_shapes_only():
    """decode_splits takes (B, K, n_blocks, page) and nothing of the data:
    positions never reach the host. At B = 8 and the main path's table it
    gives at least two CTAs per SM; every split keeps MIN_SPLIT_TILES
    tiles of the table; at least one split."""
    assert list(inspect.signature(tpa.decode_splits).parameters) == \
        ["B", "K", "n_blocks", "page"]
    n = tpa.decode_splits(8, K, 314, PAGE)
    assert 8 * K * n >= tpa.SPLIT_TARGET_CTAS
    grid = tpa.decode_grid(8, H, K, 314, PAGE)
    assert grid == (8, K, n) and grid[0] * grid[1] * grid[2] >= 132
    for B in (1, 2, 8, 64, 512):
        for n_blocks in (1, 2, 7, 40, 314, 1000):
            n = tpa.decode_splits(B, K, n_blocks, PAGE)
            tiles = -(-n_blocks * PAGE // tpa.DECODE_TILE)
            assert n >= 1
            assert n == 1 or tiles // n >= tpa.MIN_SPLIT_TILES
    assert tpa.decode_splits(64, K, 314, PAGE) < tpa.decode_splits(
        1, K, 314, PAGE)


@pytest.mark.parametrize("window", [0, 64, 4096])
def test_split_tiles_cover_every_block_once(window):
    """For every position (page edges, the window's edge, the table's
    end and past it) and split count, the splits' tiles restricted to the
    live blocks [lo, hi] cover each block exactly once, in order; splits
    past a short sequence's tiles walk nothing."""
    n_blocks = 320
    for pos in (0, 1, 15, 16, 17, 63, 64, 4095, 4096, 4097, 4999,
                n_blocks * PAGE - 1, n_blocks * PAGE + 100):
        lo, hi = tpa.decode_blocks(pos, window, PAGE, n_blocks)
        for n_split in (1, 2, 3, 9, 66, 200):
            seen = []
            prev_end = None
            for split in range(n_split):
                t0, t1 = tpa.split_tiles(lo, hi, PAGE, split, n_split)
                assert t0 <= t1
                if prev_end is not None:
                    assert t0 == prev_end
                prev_end = t1
                per = tpa.DECODE_TILE // PAGE
                seen += [blk for blk in range(t0 * per, t1 * per)
                         if lo <= blk <= hi]
            assert seen == list(range(lo, hi + 1)), (pos, n_split)


# ---------------------------------------------------- decode emulation ----
def _gather(pool, scale, pt_row, keys, live, page, bits, hd):
    """fp32 (n, K, hd) rows of ``keys`` (values of a bf16 pool, codes of a
    quantized one) and (n, K) scales, zero where not ``live`` (the
    kernel's zero-filled copies)."""
    blk = (keys // page).clamp(max=pt_row.shape[0] - 1)
    pid = torch.where(live, pt_row[blk].long(), 0)
    rows = pool[pid, keys % page]
    if bits == 4:
        rows = tref.unpack_int4_hd(rows)
    rows = torch.where(live[:, None, None], rows.to(F32), 0.0)
    if scale is None:
        return rows, None
    sc = torch.where(live[:, None], scale[pid, keys % page], 0.0)
    return rows, sc


def merge(parts):
    """The combine kernel: partials [(m, l, acc)] merged in order,
    out = sum e^{m_i - M} acc_i / max(sum e^{m_i - M} l_i, 1e-30)."""
    m = torch.stack([p[0] for p in parts])
    M = m.amax(0)
    w = torch.exp(m - M)
    ls = (w * torch.stack([p[1] for p in parts])).sum(0)
    acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
    return acc / ls.clamp_min(1e-30)[..., None]


def emulate_split_decode(q, pools, pt, pos, *, window, cap, bits,
                         n_split=None):
    """What the split decode kernel and its combine compute, in plain
    fp32 torch: per sequence and split, the split's 32-key tiles, each
    walker's KPW keys of every tile with its own online softmax (q
    pre-scaled, the K scale on the reduced score, the V scale on the
    weight), the walkers merged once at the end of the split, then the
    splits merged by ``merge``."""
    B, Hq, hd = q.shape
    if bits == 16:
        pool_k, pool_v = pools
        k_scale = v_scale = None
    else:
        pool_k, k_scale, pool_v, v_scale = pools
    page, Kh = pool_k.shape[1], pool_k.shape[2]
    G = Hq // Kh
    n_blocks = pt.shape[1]
    if n_split is None:
        n_split = tpa.decode_splits(B, Kh, n_blocks, page)
    NW = tpa.decode_threads(hd) // (hd // 8)    # walkers per CTA
    KPW = tpa.DECODE_TILE // NW                 # keys per walker per tile
    qf = q.to(F32).reshape(B, Kh, G, hd) * hd ** -0.5
    out = torch.empty((B, Kh, G, hd), dtype=F32)
    for b in range(B):
        p = int(pos[b])
        lo, hi = tpa.decode_blocks(p, window, page, n_blocks)
        k_hi = min(p, n_blocks * page - 1)
        k_lo = max(p - window + 1, 0) if window else 0
        parts = []
        for split in range(n_split):
            t0, t1 = tpa.split_tiles(lo, hi, page, split, n_split)
            m = torch.full((NW, Kh, G), NEG, dtype=F32)
            l = torch.zeros((NW, Kh, G), dtype=F32)
            acc = torch.zeros((NW, Kh, G, hd), dtype=F32)
            for t in range(t0, t1):
                keys = t * tpa.DECODE_TILE + torch.arange(tpa.DECODE_TILE)
                blk = keys // page
                live = (blk >= lo) & (blk <= hi)
                kr, ks = _gather(pool_k, k_scale, pt[b], keys, live, page,
                                 bits, hd)
                vr, vs = _gather(pool_v, v_scale, pt[b], keys, live, page,
                                 bits, hd)
                s = torch.einsum("kgd,jkd->jkg", qf[b], kr)
                if ks is not None:
                    s = s * ks[:, :, None]
                if cap:
                    s = cap * torch.tanh(s / cap)
                valid = (keys >= k_lo) & (keys <= k_hi)
                s = torch.where(valid[:, None, None], s, NEG)
                sw = s.reshape(NW, KPW, Kh, G)
                mx = torch.maximum(m, sw.amax(1))
                corr = torch.exp(m - mx)
                pw = torch.exp(sw - mx[:, None])
                l = l * corr + pw.sum(1)
                if vs is not None:
                    pw = pw * vs.reshape(NW, KPW, Kh)[..., None]
                acc = acc * corr[..., None] + torch.einsum(
                    "wjkg,wjkd->wkgd", pw, vr.reshape(NW, KPW, Kh, hd))
                m = mx
            M = m.amax(0)
            f = torch.exp(m - M)
            parts.append((M, (l * f).sum(0), (acc * f[..., None]).sum(0)))
        out[b] = merge(parts)
    return out.reshape(B, Hq, hd)


def _decode_case(bits, seed=0, num_pages=24):
    """B = 8 at full head width over a few pages (the table reuses them),
    ragged positions: 0, page edges, both sides of the 4096 window's
    edge, the longest at 4999; poisoned scratch page 0 in every tail.
    Returns numpy (q, pools, pt, pos) and q scaled by 20 for the cap."""
    rng = np.random.default_rng(seed)
    positions = np.array([0, 15, 16, 200, 4095, 4096, 4097, 4999], np.int32)
    n_blocks = 4999 // PAGE + 1 + 6          # wider than any live range
    pk = rng.standard_normal((num_pages, PAGE, K, HD)).astype(np.float32)
    pv = rng.standard_normal((num_pages, PAGE, K, HD)).astype(np.float32)
    if bits == 16:
        pk[0], pv[0] = POISON
        pools = (pk, pv)
    else:
        kq, ks = tref.quantize_kv(torch.from_numpy(pk), bits)
        vq, vs = tref.quantize_kv(torch.from_numpy(pv), bits)
        kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e4, 1e4
        pools = tuple(t.numpy() for t in (kq, ks, vq, vs))
    q = rng.standard_normal((len(positions), H, HD)).astype(np.float32)
    pt = np.zeros((len(positions), n_blocks), np.int32)
    for b, p in enumerate(positions):
        need = p // PAGE + 1
        pt[b, :need] = rng.integers(1, num_pages, need)
    return q, pools, pt, positions


def _refs(bits, q, pools, pt, pos, window, cap):
    """The port's plain decode walk and the reference's, on one input."""
    if bits == 16:
        t = tref.paged_attention_ref(
            torch.from_numpy(q), *map(torch.from_numpy, pools),
            torch.from_numpy(pt), torch.from_numpy(pos), window=window,
            cap=cap)
        j = jref.paged_attention_ref(
            jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(pt),
            jnp.asarray(pos), window=window, cap=cap)
    else:
        t = tref.paged_attention_quant_ref(
            torch.from_numpy(q), *map(torch.from_numpy, pools),
            torch.from_numpy(pt), torch.from_numpy(pos), window=window,
            cap=cap)
        j = jref.paged_attention_quant_ref(
            jnp.asarray(q), *map(jnp.asarray, pools), jnp.asarray(pt),
            jnp.asarray(pos), window=window, cap=cap)
    return t, np.asarray(j)


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("window", [0, 64, 4096])
def test_split_decode_matches_plain_walks(bits, window):
    """The split-and-merge emulation at the wrapper's own n_split (B = 8:
    nine splits, most of the short sequences' empty; at window 64 the
    sequence at 4999 has a walker whose keys all lie below the window,
    carrying exp(0) weights into the CTA merge) equals the port's plain
    walk and the reference's within 1e-5, over a poisoned scratch page, at
    caps 0, 50 (gemma2's) and 2 (which bites on these unit-scale scores;
    at scores of tens, as q scaled by 20 gives, the two plain walks
    themselves differ by 2e-5 in fp32)."""
    q, pools, pt, pos = _decode_case(bits, seed=bits + window)
    tp = tuple(map(torch.from_numpy, pools))
    for cap in (0.0, 50.0, 2.0):
        got = emulate_split_decode(torch.from_numpy(q), tp,
                                   torch.from_numpy(pt), pos, window=window,
                                   cap=cap, bits=bits)
        t, j = _refs(bits, q, pools, pt, pos, window, cap)
        assert float((got - t).abs().max()) < TOL
        assert float(np.abs(got.numpy() - j).max()) < TOL


@pytest.mark.parametrize("n_split", [1, 2, 5, 66, 157])
def test_split_decode_any_split_count(n_split):
    """The result does not depend on the split count: one split (the old
    single walk), a few, and as many as the longest sequence has tiles
    (every short sequence's splits but one empty), window 64, cap 2."""
    q, pools, pt, pos = _decode_case(8, seed=n_split)
    got = emulate_split_decode(torch.from_numpy(q),
                               tuple(map(torch.from_numpy, pools)),
                               torch.from_numpy(pt), pos, window=64,
                               cap=2.0, bits=8, n_split=n_split)
    t, j = _refs(8, q, pools, pt, pos, 64, 2.0)
    assert float((got - t).abs().max()) < TOL
    assert float(np.abs(got.numpy() - j).max()) < TOL


def test_merge_wipes_masked_and_empty_partials():
    """A split that walked nothing leaves (-1e30, 0, 0); one whose keys
    were all masked carries the reference's exp(0) weights (m = -1e30,
    l = its key count, acc = the sum of its v rows). Merged with a split
    that saw a valid key, both vanish: e^{-1e30 - M} = 0. Alone, an empty
    split gives zeros (acc / max(0, 1e-30))."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn((32, HD), generator=g)
    s = torch.randn(5, generator=g)
    p = torch.exp(s - s.max())
    valid = (s.max().reshape(1), p.sum().reshape(1),
             (p[:, None] * v[:5]).sum(0, keepdim=True))
    empty = (torch.full((1,), NEG), torch.zeros(1), torch.zeros((1, HD)))
    masked = (torch.full((1,), NEG), torch.full((1,), 27.0),
              v[5:].sum(0, keepdim=True))
    want = valid[2] / valid[1][:, None]
    for parts in ([empty, valid], [masked, valid, empty],
                  [valid, masked], [empty, masked, empty, valid]):
        assert float((merge(parts) - want).abs().max()) < TOL
    assert float(merge([empty, empty]).abs().max()) == 0.0


# --------------------------------------------------- prefill emulation ----
def emulate_prefill(q, pools, pt, pos, *, window, cap, bits,
                    cap_after_mask=False, drop_k_scale=False):
    """What the tensor-core prefill kernel computes, at its rounding
    points, in plain torch: 128-row tiles of the position-major fused rows
    r = s*G + g, 64-key tiles over the blocks the rows need (zero-filled
    outside them), S = q.code^T from the bf16 q as it is (exact products,
    fp32 sums), the K scale and hd**-0.5 on the fp32 score, softcap, mask,
    online softmax, P (times the V scale) rounded to bf16 for P.V, l over
    the unscaled weights (over the rounded weights for a bf16 pool, as
    flash attention). ``cap_after_mask`` and ``drop_k_scale`` are the
    faulty variants the tolerance must catch."""
    B, Sq, Hq, hd = q.shape
    if bits == 16:
        pool_k, pool_v = pools
        k_scale = v_scale = None
    else:
        pool_k, k_scale, pool_v, v_scale = pools
    page, Kh = pool_k.shape[1], pool_k.shape[2]
    G = Hq // Kh
    n_blocks = pt.shape[1]
    T = n_blocks * page
    rows = Sq * G
    scale = hd ** -0.5
    out = torch.empty((B, Sq, Kh, G, hd), dtype=F32)
    qb = q.to(F32).reshape(B, Sq, Kh, G, hd)
    for b in range(B):
        p0 = int(pos[b])
        for kh in range(Kh):
            qr_all = qb[b, :, kh].reshape(rows, hd)
            o_all = torch.empty((rows, hd), dtype=F32)
            for R0 in range(0, rows, tpa.PREFILL_ROWS):
                R1 = min(R0 + tpa.PREFILL_ROWS, rows)
                qr = qr_all[R0:R1]
                qp = p0 + torch.arange(R0, R1) // G
                q_first, q_last = p0 + R0 // G, p0 + (R1 - 1) // G
                hi_blk = min(q_last // page, n_blocks - 1)
                lo_blk = max((q_first - window + 1) // page, 0) \
                    if window else 0
                lo = lo_blk * page // tpa.PREFILL_TILE
                hi = (hi_blk * page + page - 1) // tpa.PREFILL_TILE
                m = torch.full((R1 - R0,), NEG, dtype=F32)
                l = torch.zeros((R1 - R0,), dtype=F32)
                acc = torch.zeros((R1 - R0, hd), dtype=F32)
                for j in range(lo, hi + 1):
                    keys = j * tpa.PREFILL_TILE + torch.arange(
                        tpa.PREFILL_TILE)
                    blk = keys // page
                    live = (blk >= lo_blk) & (blk <= hi_blk)
                    kr, ks = _gather(pool_k, k_scale, pt[b], keys, live,
                                     page, bits, hd)
                    vr, vs = _gather(pool_v, v_scale, pt[b], keys, live,
                                     page, bits, hd)
                    x = qr @ kr[:, kh].T
                    if ks is not None and not drop_k_scale:
                        x = x * (ks[:, kh] * scale)[None]
                    else:
                        x = x * scale
                    valid = (keys[None] < T) & (keys[None] <= qp[:, None])
                    if window:
                        valid &= keys[None] > qp[:, None] - window
                    if cap_after_mask:
                        x = torch.where(valid, x, NEG)
                        if cap:
                            x = cap * torch.tanh(x / cap)
                    else:
                        if cap:
                            x = cap * torch.tanh(x / cap)
                        x = torch.where(valid, x, NEG)
                    mx = torch.maximum(m, x.amax(1))
                    corr = torch.exp(m - mx)
                    pw = torch.exp(x - mx[:, None])
                    if vs is None:
                        pb = pw.bfloat16().to(F32)
                        l = l * corr + pb.sum(1)
                    else:
                        l = l * corr + pw.sum(1)
                        pb = (pw * vs[:, kh][None]).bfloat16().to(F32)
                    acc = acc * corr[:, None] + pb @ vr[:, kh]
                    m = mx
                o_all[R0:R1] = acc / l.clamp_min(1e-30)[:, None]
            out[b, :, kh] = o_all.reshape(Sq, G, hd)
    return out.reshape(B, Sq, Hq, hd).bfloat16()


def _prefill_case(bits, seed=0, num_pages=20):
    """Two chunks of 70 positions (140 fused rows: two row tiles, the
    second partial) at 0 and at 37, full head width, a few pages, a
    poisoned scratch page in the tails; q scaled by 20 so the scores reach
    a cap of 50. The query at position 0 (every head) points away from
    its one key, so its only valid score is capped near -50: a softcap
    applied after the mask would give the masked keys the same -50."""
    rng = np.random.default_rng(seed)
    positions = np.array([0, 37], np.int32)
    Sq, n_blocks = 70, 8
    pk = rng.standard_normal((num_pages, PAGE, K, HD)).astype(np.float32)
    pv = rng.standard_normal((num_pages, PAGE, K, HD)).astype(np.float32)
    pt = np.zeros((2, n_blocks), np.int32)
    for b, p in enumerate(positions):
        need = (p + Sq - 1) // PAGE + 1
        pt[b, :need] = rng.choice(np.arange(1, num_pages), need,
                                  replace=False)
    q = rng.standard_normal((2, Sq, H, HD)).astype(np.float32) * 20.0
    k0 = pk[pt[0, 0], 0]                                 # (K, hd)
    q[0, 0] = -20.0 * np.repeat(k0, H // K, axis=0)
    if bits == 16:
        pk[0], pv[0] = POISON
        pools = tuple(torch.from_numpy(a).bfloat16() for a in (pk, pv))
    else:
        kq, ks = tref.quantize_kv(torch.from_numpy(pk), bits)
        vq, vs = tref.quantize_kv(torch.from_numpy(pv), bits)
        kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e4, 1e4
        pools = (kq, ks, vq, vs)
    return (torch.from_numpy(q).bfloat16(), pools, torch.from_numpy(pt),
            torch.from_numpy(positions))


@pytest.mark.parametrize("bits", [8, 4, 16])
@pytest.mark.parametrize("window", [0, 64])
def test_prefill_rounding_points_within_tolerance(bits, window):
    """At cap 50, the prefill kernel's rounding points (bf16 q.code, the K
    scale and hd**-0.5 afterwards, P times the V scale rounded to bf16)
    stay within the kernels' bf16 tolerance of the plain quantized walk
    (and of the plain bf16 walk with flash attention's rounding points);
    the softcap applied after the mask, and the K scale dropped, miss
    it."""
    q, pools, pt, pos = _prefill_case(bits, seed=bits + window)
    plain = tref.paged_prefill_ref if bits == 16 \
        else tref.paged_prefill_quant_ref
    want = plain(q, *pools, pt, pos, window=window, cap=50.0).float()
    got = emulate_prefill(q, pools, pt, pos, window=window, cap=50.0,
                          bits=bits).float()
    assert bf16_close(got, want)
    late_cap = emulate_prefill(q, pools, pt, pos, window=window, cap=50.0,
                               bits=bits, cap_after_mask=True).float()
    assert not bf16_close(late_cap, want)
    if bits != 16:
        no_scale = emulate_prefill(q, pools, pt, pos, window=window,
                                   cap=50.0, bits=bits,
                                   drop_k_scale=True).float()
        assert not bf16_close(no_scale, want)


# ------------------------------------- tiny heads (hd 32), any page ----
TINY_H, TINY_K, TINY_HD, TINY_WINDOW = 4, 2, 32, 32
# pages below, at and above the 32-key decode and 64-key prefill tiles, and
# pages that neither divide a tile nor are a multiple of one (3, 24, 48,
# 96), whose tiles start in the middle of a page and end in the next
PAGES = (1, 2, 3, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256)
ODD_PAGES = (3, 24, 48, 96)


@pytest.mark.parametrize("page", [0, -1])
def test_wrappers_refuse_other_pages(page):
    """A page below 1 raises ValueError with the rule, before anything
    reaches a kernel (no fallback); so does an hd outside HEAD_DIMS."""
    q = torch.zeros((2, TINY_H, TINY_HD), dtype=torch.bfloat16)
    pool = torch.zeros((3, max(page, 0), TINY_K, TINY_HD),
                       dtype=torch.bfloat16)
    pt = torch.zeros((2, 4), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="page size"):
        tpa.check_geometry(TINY_HD, page)
    with pytest.raises(ValueError, match="page size"):
        tpa._check(q, pool, pool, pt, pos, False)
    for hd in (16, 48, 512):
        with pytest.raises(ValueError, match="hd"):
            tpa.check_geometry(hd, 16)


@pytest.mark.parametrize("page", [3, 24, 48, 96, 256])
def test_wrappers_take_any_page(page):
    """Pages that neither divide a 32-key decode tile nor are a multiple of
    one, and a page of eight decode tiles, pass the geometry rule at every
    hd of HEAD_DIMS; on CPU tensors the launch check then stops at the
    device, not at the page."""
    for hd in tpa.HEAD_DIMS:
        tpa.check_geometry(hd, page)
    q = torch.zeros((2, TINY_H, TINY_HD), dtype=torch.bfloat16)
    pool = torch.zeros((3, page, TINY_K, TINY_HD), dtype=torch.bfloat16)
    pt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        tpa._check(q, pool, pool, pt, torch.zeros((2,), dtype=torch.int32),
                   False)


def test_wrappers_refuse_pools_past_32_bit_slots():
    """A pool of 2**31 slots or more (page id * page + offset) raises
    before anything reaches a kernel: the kernels index slots in 32 bits.
    The shape alone decides (an expanded view holds no memory)."""
    q = torch.zeros((2, TINY_H, TINY_HD), dtype=torch.bfloat16)
    pt = torch.zeros((2, 4), dtype=torch.int32)
    pos = torch.zeros((2,), dtype=torch.int32)
    pool = torch.zeros((1, 1, TINY_K, TINY_HD), dtype=torch.bfloat16) \
        .expand(2 ** 25, 64, TINY_K, TINY_HD)
    with pytest.raises(ValueError, match="slots"):
        tpa._check(q, pool, pool, pt, pos, False)


def test_every_config_head_width_is_built():
    """Every attention-bearing config the port registers (num_heads > 0),
    full and tiny_config, resolves to a head width the kernels are built
    for (HEAD_DIMS): a config added with another width fails here, on the
    CPU, and not at its first launch on the card."""
    from repro_torch.configs import ARCHS, tiny_config
    widths = set()
    for name, cfg in ARCHS.items():
        for c in (cfg, tiny_config(name)):
            if c.num_heads:
                hd = c.resolved_head_dim
                assert hd in tpa.HEAD_DIMS, (c.name, hd)
                widths.add(hd)
    assert widths == set(tpa.HEAD_DIMS)


@pytest.mark.parametrize("page", PAGES)
def test_wrappers_take_every_page_and_hd(page):
    """Every page of PAGES and hd of HEAD_DIMS passes the geometry rule; on
    CPU tensors the launch check then stops at the device."""
    for hd in tpa.HEAD_DIMS:
        tpa.check_geometry(hd, page)
    assert TINY_HD in tpa.HEAD_DIMS
    q = torch.zeros((2, TINY_H, TINY_HD), dtype=torch.bfloat16)
    pool = torch.zeros((3, page, TINY_K, TINY_HD), dtype=torch.bfloat16)
    pt = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        tpa._check(q, pool, pool, pt, torch.zeros((2,), dtype=torch.int32),
                   False)


@pytest.mark.parametrize("page", PAGES)
@pytest.mark.parametrize("rows", [tpa.DECODE_TILE, tpa.PREFILL_TILE])
def test_tile_slots_match_block_walk(page, rows):
    """The kernels' copies address key j of a tile as pool slot
    page_table[j // page] * page + j % page: at every page size, for
    decode (32-key) and prefill (64-key) tiles, the rows they gather are
    the rows of the plain walk's chronological block view, and the rows
    of blocks outside [lo, hi] are the zero-filled ones."""
    rng = np.random.default_rng(page + rows)
    n_blocks = max(2, 512 // page)
    num_pages = n_blocks + 5
    pool = torch.from_numpy(rng.standard_normal(
        (num_pages, page, TINY_K, TINY_HD)).astype(np.float32))
    pt = rng.permutation(np.arange(1, num_pages))[:n_blocks].astype(np.int32)
    # the plain walk's view: block i is pool[pt[i]], its keys in order
    dense = torch.cat([pool[int(pt[i])] for i in range(n_blocks)])
    flat = pool.reshape(num_pages * page, TINY_K, TINY_HD)
    T = n_blocks * page
    for lo, hi in ((0, n_blocks - 1), (1, n_blocks - 2), (n_blocks // 2,
                                                          n_blocks // 2)):
        for t in range(-(-T // rows)):
            slots = tpa.tile_slots(pt, t, rows, page, lo, hi)
            for r, slot in enumerate(slots):
                key = t * rows + r
                live = lo <= key // page <= hi
                assert (slot >= 0) == live, (t, r)
                if live:
                    assert torch.equal(flat[slot], dense[key])


@pytest.mark.parametrize("page", [1, 4, 32, 64, 128, 3, 24, 48, 96, 256])
@pytest.mark.parametrize("window", [0, TINY_WINDOW, 300])
def test_split_tiles_cover_every_key_once(page, window):
    """With a page smaller than, equal to or larger than the 32-key tile,
    or one whose tiles start mid-page (3, 24, 48, 96), the splits' tiles
    restricted to the live blocks cover each key of [lo, hi] exactly once,
    in order, for every split count."""
    n_blocks = max(2, 2048 // page)
    for pos in (0, 1, 31, 32, 33, 63, 64, 127, 128, 129, 1000,
                n_blocks * page - 1, n_blocks * page + 7):
        lo, hi = tpa.decode_blocks(pos, window, page, n_blocks)
        want = [k for k in range(lo * page, (hi + 1) * page)] \
            if lo <= hi else []
        for n_split in (1, 2, 3, 7, 64):
            seen = []
            for split in range(n_split):
                t0, t1 = tpa.split_tiles(lo, hi, page, split, n_split)
                keys = range(t0 * tpa.DECODE_TILE, t1 * tpa.DECODE_TILE)
                seen += [k for k in keys if lo <= k // page <= hi]
            assert seen == want, (pos, n_split)


@pytest.mark.parametrize("page", [*ODD_PAGES, 256])
def test_tiles_mid_page_are_masked_and_clipped(page):
    """The kernels' tile arithmetic at pages whose tiles start mid-page
    (and at 256, eight decode tiles and four prefill tiles a page), for
    every position up to past the table's end and windows that cut
    mid-page. Decode: a key of the split tiles whose block lies outside
    [lo, hi] (block lo - 1 at a window edge, hi + 1 at the end) is outside
    the key mask [k_lo, k_hi] too, and k_hi clips the last tile at the
    table's end. Prefill (64-key tiles over a 128-row chunk tile): the tile
    range [lo, hi] rounds outward, holding every key of the blocks the
    rows need, and a key of a tile whose block is outside them is masked
    for every row."""
    n_blocks = max(3, 640 // page)
    T = n_blocks * page
    if page == 256:
        assert page // tpa.DECODE_TILE == 8 and page // tpa.PREFILL_TILE == 4
    for window in (0, TINY_WINDOW, 100):
        for pos in range(0, T + 40, 7):
            lo, hi = tpa.decode_blocks(pos, window, page, n_blocks)
            k_hi = min(pos, T - 1)
            k_lo = max(pos - window + 1, 0) if window else 0
            t0, t1 = tpa.split_tiles(lo, hi, page, 0, 1)
            for key in range(t0 * tpa.DECODE_TILE, t1 * tpa.DECODE_TILE):
                live = lo <= key // page <= hi
                if not live:
                    assert not k_lo <= key <= k_hi, (pos, window, key)
                if key >= T:
                    assert key > k_hi
        for p0 in range(0, T, 37):
            for R0, R1 in ((0, 70), (64, 128)):   # a row tile's rows (G = 1)
                q_first, q_last = p0 + R0, p0 + R1 - 1
                hi_blk = min(q_last // page, n_blocks - 1)
                lo_blk = max((q_first - window + 1) // page, 0) \
                    if window else 0
                lo = lo_blk * page // tpa.PREFILL_TILE
                hi = (hi_blk * page + page - 1) // tpa.PREFILL_TILE
                assert lo * tpa.PREFILL_TILE <= lo_blk * page
                assert (hi + 1) * tpa.PREFILL_TILE >= (hi_blk + 1) * page
                for key in range(lo * tpa.PREFILL_TILE,
                                 (hi + 1) * tpa.PREFILL_TILE):
                    if lo_blk <= key // page <= hi_blk:
                        continue
                    for qp in range(q_first, q_last + 1):
                        valid = key < T and key <= qp and \
                            (not window or key > qp - window)
                        assert not valid, (p0, R0, window, key, qp)


@pytest.mark.parametrize("H,K,GC", [(TINY_H, TINY_K, 2), (4, 4, 1)])
def test_decode_plan_tiny_heads(H, K, GC):
    """Tiny gemma2-2b's heads (H = 4, K = 2: G = 2) and G = 1: the head
    group, the grid and the split count from the shapes alone; at hd 32
    the split CTA has 128 threads, 32 walkers of 4 lanes, one key each."""
    assert tpa.head_group(H // K) == GC
    assert tpa.decode_threads(TINY_HD) == 128
    assert tpa.decode_threads(TINY_HD) // (TINY_HD // 8) == tpa.DECODE_TILE
    for hd in (64, 128, 256):
        assert tpa.decode_threads(hd) == tpa.DECODE_THREADS
    for page in PAGES:
        for B, n_blocks in ((1, 1), (8, max(1, 128 // page)),
                            (8, max(1, 4096 // page)), (64, 3)):
            n = tpa.decode_splits(B, K, n_blocks, page)
            tiles = -(-n_blocks * page // tpa.DECODE_TILE)
            assert n >= 1 and (n == 1 or tiles // n >= tpa.MIN_SPLIT_TILES)
            assert tpa.decode_grid(B, H, K, n_blocks, page) == \
                (B, K * (H // K) // GC, n)


def _tiny_case(bits, page, Sq, seed):
    """Tiny gemma2-2b's attention shapes (H = 4, K = 2, hd = 32) over a
    page pool of ``page`` keys: positions across the tiny window of 32 and
    page edges, scratch page 0 poisoned in every tail. Returns torch
    (q, pools, pt, pos): q (B, Sq, H, hd) bf16 (Sq = 0: (B, H, hd))."""
    rng = np.random.default_rng(seed)
    positions = np.array([0, 31, 33, 63, 64, 100, 129, 250], np.int32)
    last = int(positions.max()) + max(Sq, 1)
    n_blocks = last // page + 2
    num_pages = len(positions) * n_blocks + 1
    shape = (num_pages, page, TINY_K, TINY_HD)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    pt = np.zeros((len(positions), n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for b, p in enumerate(positions):
        need = (p + max(Sq, 1) - 1) // page + 1
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    if bits == 16:
        pk[0], pv[0] = POISON
        pools = tuple(torch.from_numpy(a).bfloat16() for a in (pk, pv))
    else:
        kq, ks = tref.quantize_kv(torch.from_numpy(pk), bits)
        vq, vs = tref.quantize_kv(torch.from_numpy(pv), bits)
        kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e4, 1e4
        pools = (kq, ks, vq, vs)
    qshape = (len(positions), Sq, TINY_H, TINY_HD) if Sq \
        else (len(positions), TINY_H, TINY_HD)
    q = torch.from_numpy(rng.standard_normal(qshape).astype(np.float32))
    return (q.bfloat16(), pools, torch.from_numpy(pt),
            torch.from_numpy(positions))


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("page", [2, 16, 64, 128, *ODD_PAGES])
def test_split_decode_tiny_matches_plain_walks(bits, page):
    """The split decode emulation at hd 32 (4-lane walkers, one key each)
    and pages below, at and above the 32-key tile, and pages whose tiles
    start mid-page (3, 24, 48, 96: at 48 a tile holds the end of one block
    and the start of the next, and the tiny window of 32 starts mid-page,
    so a tile may hold keys of block lo - 1, zero-filled and masked), with
    gemma2's cap of 50, equals the port's plain walk and the reference's
    within 1e-5."""
    q, pools, pt, pos = _tiny_case(bits, page, 0, seed=page + bits)
    qf = q.float()
    for window in (0, TINY_WINDOW):
        got = emulate_split_decode(qf, pools, pt, pos, window=window,
                                   cap=50.0, bits=bits)
        t, j = _refs(bits, qf.numpy(), tuple(a.float().numpy()
                                             if a.dtype == torch.bfloat16
                                             else a.numpy() for a in pools),
                     pt.numpy(), pos.numpy(), window, 50.0)
        assert float((got - t).abs().max()) < TOL
        assert float(np.abs(got.numpy() - j).max()) < TOL


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("page", [2, 64, 128, *ODD_PAGES])
def test_prefill_tiny_rounding_points_within_tolerance(bits, page):
    """The tensor-core prefill's rounding points at hd 32 (two k16 steps
    of q.k^T, four n8 tiles of P.V per warp) over pages of 2 (32 pages a
    64-key tile), 64 and 128 (half a page a tile) and pages whose 64-key
    tiles start mid-page (3, 24, 48, 96; the tile range rounded outward),
    the tiny window, cap 50: within the kernels' bf16 tolerance of the
    plain walk."""
    q, pools, pt, pos = _tiny_case(bits, page, 40, seed=page + bits)
    plain = tref.paged_prefill_ref if bits == 16 \
        else tref.paged_prefill_quant_ref
    for window in (0, TINY_WINDOW):
        want = plain(q, *pools, pt, pos, window=window, cap=50.0).float()
        got = emulate_prefill(q, pools, pt, pos, window=window, cap=50.0,
                              bits=bits).float()
        assert bf16_close(got, want)
