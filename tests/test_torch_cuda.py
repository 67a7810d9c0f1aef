"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card only: the bf16 pair and the fused-dequant pair over
int8 and packed-int4 pools, at full gemma2-2b head width (and the split
decode walk's and the tensor-core prefill walk's edges: B = 1/8/64, empty
splits, window and diagonal edges, ragged and padded chunks, other head
widths and groups), flash attention
(whole-prompt prefill: every head width, query-head group, batch, ragged
S and T, grids under and over the card's SMs, the encoder-decoder's
single query rows and S != T full attention, hd 128 at G = 4), and the
three
weight-quantized matmuls (W8A16, W4A16, W8A8). Imports no JAX
(the card's machine has none); run there, from the repository root, with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX). Without a card every
test here skips."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import (PROBE_V, bf16_close,  # noqa: E402
                              flash_rounding_probe, paged_case)


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_cuda_kernels_match_plain(window, cap):
    """On a card: both CUDA kernels against their plain versions at full
    gemma2-2b head width, bf16, at the tolerance chip_smoke.py states. With
    a cap, q is scaled so the scores reach it, and the plain version
    without the cap must miss the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, pk, pv, pt, pos = paged_case(3, 40, 8, 4, 256, 16, 8, num_pages=30)
    if cap:
        q = q * 20.0      # scores about N(0, 20**2): the cap bites
    dev = "cuda"
    q, pk, pv = (torch.from_numpy(a).to(dev).bfloat16() for a in (q, pk, pv))
    pt, pos = torch.from_numpy(pt).to(dev), torch.from_numpy(pos).to(dev)
    for fwd, plain, qq in (
            (tpa.paged_prefill_fwd, tref.paged_prefill_ref, q),
            (tpa.paged_attention_fwd, tref.paged_attention_ref, q[:, 0].contiguous())):
        got = fwd(qq, pk, pv, pt, pos, window=window, cap=cap).float()
        want = plain(qq, pk, pv, pt, pos, window=window, cap=cap).float()
        assert bf16_close(got, want)
        if cap:
            nocap = plain(qq, pk, pv, pt, pos, window=window).float()
            assert not bf16_close(nocap, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_cuda_quant_kernels_match_plain(bits, window, cap):
    """On a card: both fused-dequant CUDA kernels against their plain
    versions at full gemma2-2b head width over an int8 or packed-int4 pool
    whose scratch page's codes and scales are poisoned, at the tolerance of
    test_cuda_kernels_match_plain: both sides dequantize each element to
    the same fp32 number. With a cap, the plain version without it must
    miss the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, pk, pv, pt, pos = paged_case(3, 40, 8, 4, 256, 16, 8, num_pages=30)
    if cap:
        q = q * 20.0      # scores about N(0, 20**2): the cap bites
    dev = "cuda"
    q = torch.from_numpy(q).to(dev).bfloat16()
    kq, ks = tref.quantize_kv(torch.from_numpy(pk).to(dev), bits)
    vq, vs = tref.quantize_kv(torch.from_numpy(pv).to(dev), bits)
    kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e4, 1e4
    pools = (kq, ks, vq, vs)
    pt, pos = torch.from_numpy(pt).to(dev), torch.from_numpy(pos).to(dev)
    for fwd, plain, qq in (
            (tpa.paged_prefill_quant_fwd, tref.paged_prefill_quant_ref, q),
            (tpa.paged_attention_quant_fwd, tref.paged_attention_quant_ref,
             q[:, 0].contiguous())):
        got = fwd(qq, *pools, pt, pos, window=window, cap=cap).float()
        want = plain(qq, *pools, pt, pos, window=window, cap=cap).float()
        assert bf16_close(got, want)
        if cap:
            nocap = plain(qq, *pools, pt, pos, window=window).float()
            assert not bf16_close(nocap, want)


# the paged kernels' plain versions and wrappers by pool bits: (decode
# kernel, its plain version, prefill kernel, its plain version)
_PAGED = {16: (tpa.paged_attention_fwd, tref.paged_attention_ref,
               tpa.paged_prefill_fwd, tref.paged_prefill_ref)}
_PAGED[8] = _PAGED[4] = (tpa.paged_attention_quant_fwd,
                         tref.paged_attention_quant_ref,
                         tpa.paged_prefill_quant_fwd,
                         tref.paged_prefill_quant_ref)
PAGE = 16


def _pool_case(positions, Sq, n_blocks, bits, *, H=8, K=4, hd=256,
               num_pages=257, seed=0, page=PAGE):
    """On the card: N(0, 1) pools (bf16, or quantized by the pool writers'
    mapping) whose scratch page 0 is poisoned, a chunk of Sq queries per
    sequence (as drawn, and scaled by 20 so that the scores reach a cap of
    50), and a page table giving each sequence's live blocks random pages
    (drawn with replacement) and its tails page 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = len(positions)
    pk = torch.randn((num_pages, page, K, hd), generator=g, device="cuda")
    pv = torch.randn((num_pages, page, K, hd), generator=g, device="cuda")
    if bits == 16:
        pk, pv = pk.bfloat16(), pv.bfloat16()
        pk[0], pv[0] = 37.0, -53.0
        pools = (pk, pv)
    else:
        kq, ks = tref.quantize_kv(pk, bits)
        vq, vs = tref.quantize_kv(pv, bits)
        kq[0], vq[0], ks[0], vs[0] = 127, 127, 1e4, 1e4
        pools = (kq, ks, vq, vs)
    q = torch.randn((B, Sq, H, hd), generator=g, device="cuda")
    qs = {0.0: q.bfloat16(), 50.0: (q * 20.0).bfloat16()}
    cpu = torch.Generator().manual_seed(seed)
    pt = torch.zeros((B, n_blocks), dtype=torch.int32)
    for b, pos in enumerate(positions):
        need = min((pos + Sq - 1) // page + 1, n_blocks)
        pt[b, :need] = torch.randint(1, num_pages, (need,), generator=cpu,
                                     dtype=torch.int32)
    pos_t = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return qs, pools, pt.cuda(), pos_t


def _paged_launched(name, fn):
    before = tpa.LAUNCHES[name]
    out = fn()
    assert tpa.LAUNCHES[name] == before + 1
    return out


def _check_paged(fwd, plain, q, pools, pt, pos, window, cap, live=None):
    """One kernel call against its plain version (over the rows a padded
    chunk defines, ``live``), one launch counted; with a cap, the plain
    version without it must miss the tolerance."""
    name = fwd.__name__
    got = _paged_launched(name, lambda: fwd(q, *pools, pt, pos,
                                            window=window, cap=cap))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got.float()).all())
    want = plain(q, *pools, pt, pos, window=window, cap=cap).float()
    g = got.float()
    if live is not None:
        g, want = g[:, :live], want[:, :live]
    assert bf16_close(g, want), (name, window, cap)
    if cap:
        nocap = plain(q, *pools, pt, pos, window=window).float()
        if live is not None:
            nocap = nocap[:, :live]
        assert not bf16_close(nocap, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("B", [1, 8, 64])
def test_cuda_decode_split_edges(bits, B):
    """On a card: the split decode walk and its combine over each pool
    type at B = 1 (the most splits), 8 and 64, positions cycling through
    {9000, 0, 15, 16, 4095, 4096} (page edges, the 4096 window's edge, a
    long walk), a page table 400 blocks wider than the longest live range
    (so most splits of the short sequences walk nothing), windows {0, 64,
    4096} and caps {0, 50}, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    # B = 1 walks the longest sequence (a lone position 0 would leave the
    # cap nothing to change)
    positions = [(9000, 0, 15, 16, 4095, 4096)[i % 6] for i in range(B)]
    n_blocks = 9000 // PAGE + 1 + 400
    qs, pools, pt, pos = _pool_case(positions, 1, n_blocks, bits, seed=B)
    fwd, plain = _PAGED[bits][:2]
    n_split = tpa.decode_splits(B, 4, n_blocks, PAGE)
    assert n_split >= 1 and (B > 8 or B * 4 * n_split >= 132)
    for window in (0, 64, 4096):
        for cap in (0.0, 50.0):
            _check_paged(fwd, plain, qs[cap][:, 0].contiguous(), pools, pt,
                         pos, window, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("positions,Sq,n_blocks,live", [
    # 400 fused rows (not a multiple of 128); chunks whose 64-position
    # tiles straddle the diagonal, the window edge (64, and 4096 at
    # positions 4000-4289) and a page edge
    ([0, 4000, 4090], 200, 300, None),
    # a padded final chunk running past the page-table width
    ([512], 256, 40, 40 * PAGE - 512),
])
def test_cuda_prefill_tile_edges(bits, positions, Sq, n_blocks, live):
    """On a card: the tensor-core prefill walk over each pool type at
    windows {0, 64, 4096} and caps {0, 50}, against the plain version over
    the rows the chunk defines."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    qs, pools, pt, pos = _pool_case(positions, Sq, n_blocks, bits,
                                    seed=Sq + bits)
    fwd, plain = _PAGED[bits][2:]
    for window in (0, 64, 4096):
        for cap in (0.0, 50.0):
            _check_paged(fwd, plain, qs[cap], pools, pt, pos, window, cap,
                         live)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("H,K,hd", [(8, 2, 128), (6, 2, 64), (4, 4, 256)])
def test_cuda_paged_head_shapes(bits, H, K, hd):
    """On a card: both walks at the other head widths (64, 128) and head
    groups (G = 4: one CTA per kv head; G = 3: one per query head; G = 1)
    the kernels are built for, window 64, cap 50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    positions = [5, 700, 1500]
    qs, pools, pt, pos = _pool_case(positions, 40, 100, bits, H=H, K=K,
                                    hd=hd, num_pages=64, seed=H + hd)
    dec, dplain, pre, pplain = _PAGED[bits]
    q = qs[50.0]
    _check_paged(dec, dplain, q[:, 0].contiguous(), pools, pt, pos, 64, 50.0)
    _check_paged(pre, pplain, q, pools, pt, pos, 64, 50.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("page", [2, 16, 64, 128])
def test_cuda_paged_tiny_heads(bits, page):
    """On a card: both walks at tiny gemma2-2b's heads (H = 4, K = 2,
    hd = 32: 4-lane decode walkers, two k16 steps of q.k^T; an int4 row
    is one 16-B piece) over pages below, at and above the 32-key decode
    tile (a 64-key prefill tile is half a page of 128), positions across
    the tiny window of 32 and page edges, a 70-token chunk, windows {0,
    32} and caps {0, 50}, against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    positions = [0, 31, 33, 64, 129, 300]
    n_blocks = (300 + 70) // page + 3
    qs, pools, pt, pos = _pool_case(positions, 70, n_blocks, bits, H=4,
                                    K=2, hd=32, num_pages=6 * n_blocks + 1,
                                    seed=page + bits, page=page)
    dec, dplain, pre, pplain = _PAGED[bits]
    for window in (0, 32):
        for cap in (0.0, 50.0):
            q = qs[cap]
            _check_paged(dec, dplain, q[:, 0].contiguous(), pools, pt, pos,
                         window, cap)
            _check_paged(pre, pplain, q, pools, pt, pos, window, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("page", [3, 24, 48, 96, 256])
def test_cuda_paged_any_page(bits, page):
    """On a card: both walks over each pool type at pages that do not
    divide a 32-key decode tile or a 64-key prefill tile and are not a
    multiple of one (3, 24, 48, 96), so that tiles start in the middle of
    a page and end in the middle of the next, and at 256 (eight decode
    tiles and four prefill tiles a page): tiny gemma2-2b's heads, then
    full width (hd 256, G = 2), a 70-token chunk, positions across the
    windows (32 and 64 keys, both cutting mid-page) and page edges,
    windows {0, the window} and caps {0, 50}, against the plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dec, dplain, pre, pplain = _PAGED[bits]
    for H, K, hd, win in ((4, 2, 32, 32), (8, 4, 256, 64)):
        positions = [0, 31, 33, 47, 48, 95, 129, 300]
        n_blocks = (300 + 70) // page + 3
        qs, pools, pt, pos = _pool_case(
            positions, 70, n_blocks, bits, H=H, K=K, hd=hd,
            num_pages=len(positions) * n_blocks + 1, seed=page + bits + hd,
            page=page)
        for window in (0, win):
            for cap in (0.0, 50.0):
                q = qs[cap]
                _check_paged(dec, dplain, q[:, 0].contiguous(), pools, pt,
                             pos, window, cap)
                _check_paged(pre, pplain, q, pools, pt, pos, window, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("page", [0])
def test_cuda_paged_refuses_other_pages(page):
    """On a card: a page below 1 raises ValueError and launches nothing
    (no fallback to the plain walk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q = torch.zeros((2, 4, 32), dtype=torch.bfloat16, device="cuda")
    pool = torch.zeros((3, page, 2, 32), dtype=torch.bfloat16, device="cuda")
    pt = torch.zeros((2, 4), dtype=torch.int32, device="cuda")
    pos = torch.zeros((2,), dtype=torch.int32, device="cuda")
    before = dict(tpa.LAUNCHES)
    with pytest.raises(ValueError, match="page size"):
        tpa.paged_attention_fwd(q, pool, pool, pt, pos)
    with pytest.raises(ValueError, match="page size"):
        tpa.paged_prefill_fwd(q[:, None], pool, pool, pt, pos)
    assert tpa.LAUNCHES == before


def _flash_inputs(S, T, H, K, hd, q_scale=1.0, seed=0, B=1):
    """Random bf16 q (B, S, H, hd), k and v (B, T, K, hd) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (torch.randn((B, S, H, hd), generator=g, device="cuda")
         * q_scale).bfloat16()
    k = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, T, K, hd), generator=g, device="cuda").bfloat16()
    return q, k, v


def _flash_launched(fn):
    before = tfa.LAUNCHES["flash_attention_fwd"]
    out = fn()
    assert tfa.LAUNCHES["flash_attention_fwd"] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 64, 4096])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("H,K", [(4, 4), (8, 4)])
def test_cuda_flash_matches_plain(window, cap, H, K):
    """On a card: the flash kernel against its plain version, causal over
    4608 tokens (past the 4096 window) at gemma2-2b's head width, G = 1
    and 2, at the tolerance of test_cuda_kernels_match_plain; one launch
    counted. With a cap, q is scaled so the scores reach it, and the plain
    version without the cap must miss the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = _flash_inputs(4608, 4608, H, K, 256,
                            q_scale=20.0 if cap else 1.0)
    got = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, causal=True, window=window, cap=cap))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = tref.flash_attention_ref(q, k, v, causal=True, window=window,
                                    cap=cap).float()
    assert bf16_close(got.float(), want)
    if cap:
        nocap = tref.flash_attention_ref(q, k, v, causal=True,
                                         window=window).float()
        assert not bf16_close(nocap, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_cuda_flash_tiny_heads(window, cap):
    """On a card: flash at tiny gemma2-2b's heads (H = 4, K = 2, hd = 32:
    two k16 steps of q.k^T, four n8 tiles of P.v per warp), causal over
    2560 tokens, the tiny window of 32, against the plain version; with a
    cap the plain version without it must miss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = _flash_inputs(2560, 2560, 4, 2, 32,
                            q_scale=20.0 if cap else 1.0, seed=7)
    got = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, causal=True, window=window, cap=cap))
    want = tref.flash_attention_ref(q, k, v, causal=True, window=window,
                                    cap=cap).float()
    assert bf16_close(got.float(), want)
    if cap:
        nocap = tref.flash_attention_ref(q, k, v, causal=True,
                                         window=window).float()
        assert not bf16_close(nocap, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("T,window", [(640, 0), (640, 64), (200, 0)])
def test_cuda_flash_full_attention(hd, T, window):
    """On a card: causal=False with T != S (S = 300, neither a multiple of
    the 128-row tile nor of the kv tile; T past S and short of it),
    with and without a window, every head width the kernel is built for,
    G = 2. Every query keeps a valid key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = _flash_inputs(300, T, 8, 4, hd, seed=hd + T)
    got = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, causal=False, window=window))
    want = tref.flash_attention_ref(q, k, v, causal=False,
                                    window=window).float()
    assert bf16_close(got.float(), want)


def _check_flash(S, T, H, K, hd, *, causal=True, window=0, cap=0.0, B=1,
                 seed=0):
    """One kernel launch on random inputs against the plain version at the
    kernel tolerance; with a cap, q is scaled so that scores reach it and
    the plain version without the cap must miss."""
    q, k, v = _flash_inputs(S, T, H, K, hd, q_scale=20.0 if cap else 1.0,
                            seed=seed, B=B)
    got = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, causal=causal, window=window, cap=cap))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    kw = dict(causal=causal, window=window)
    want = tref.flash_attention_ref(q, k, v, cap=cap, **kw).float()
    assert bf16_close(got.float(), want)
    if cap:
        assert not bf16_close(tref.flash_attention_ref(q, k, v, **kw).float(),
                              want)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 12])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_cuda_flash_groups(G, window, cap):
    """On a card: every query-head group the configs have (G = 1 whisper,
    2 gemma2, 3 granite-moe, 4 granite, 5 llama4, 6 nemotron, 12 mistral-
    large) at hd 128 over 1000 causal tokens: the q box's 128 // G
    positions, rows past P*G idle where G does not divide 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(1000, 1000, 2 * G, 2, 128, window=window, cap=cap, seed=G)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (0, 50.0), (64, 50.0),
                                        (4096, 0.0)])
def test_cuda_flash_head_widths(hd, window, cap):
    """On a card: every head width the kernel is built for (64-byte rows
    under the 64-byte swizzle at hd 32, one to four 128-byte chunks
    above; 80-key tiles at hd 256, 128 below) at G = 2, causal over 700
    tokens, windows 0, 64 and 4096 and caps 0 and 50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(700, 700, 4, 2, hd, window=window, cap=cap, seed=hd)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
def test_cuda_flash_batch(hd):
    """On a card: B = 2 sequences (the q box's and the K/V boxes' fourth
    coordinate), causal over 1500 tokens, window 512, cap 50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(1500, 1500, 8, 4, hd, window=512, cap=50.0, B=2, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(300, 200), (300, 640), (640, 300),
                                 (37, 640), (5, 5), (1, 1), (1, 300)])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_ragged(S, T, causal):
    """On a card: S and T that are multiples of neither the positions a
    CTA takes nor the kv tile (keys past T are TMA's zero fill, dropped by
    the mask; positions past S are zero rows, never stored), and S below
    the 64 positions a G = 2 tile takes, causal and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(S, T, 8, 4, 256, causal=causal, seed=S + T)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,S", [(1, 1, 640), (1, 4, 2048), (2, 4, 4096)])
def test_cuda_flash_grid(B, K, S):
    """On a card: grids of 10, 128 and 512 CTAs, under and over the card's
    132 SMs (G = 2, hd 256, causal, cap 50)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(S, S, 2 * K, K, 256, cap=50.0, B=B, seed=B * K)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,K,hd,causal", [
    (1, 16384, 20, 20, 64, False),
    (1, 8192, 32, 8, 128, False),
    (2048, 16384, 20, 20, 64, False),
    (512, 4096, 32, 8, 128, False),
    (4096, 4096, 32, 8, 128, True)])
def test_cuda_flash_encoder_decoder_geometries(S, T, H, K, hd, causal):
    """On a card: the geometries whisper-large-v3 and llava-next-mistral-7b
    give flash: one query row over a long memory (a decode step's cross
    attention: one valid position in the q box, the rest TMA's zero
    fill, never stored), full attention with S != T (cross attention over
    the encoder), and hd 128 at G = 4 (llava's causal prefill)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(S, T, H, K, hd, causal=causal, seed=S + T + hd)


@pytest.mark.cuda
@pytest.mark.parametrize("positions", [[8192], [8195, 100, 6000]])
def test_cuda_paged_decode_llava_heads(positions):
    """On a card: the paged decode at llava-next-mistral-7b's 32 query
    heads over 8 kv heads of 128 (G = 4), past 8192 positions, no window
    or cap."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    qs, pools, pt, pos = _pool_case(positions, 1, 520, 16, H=32, K=8,
                                    hd=128, num_pages=1100, seed=41)
    dec, dplain, _, _ = _PAGED[16]
    _check_paged(dec, dplain, qs[0.0][:, 0].contiguous(), pools, pt, pos,
                 0, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 256])
def test_cuda_flash_l_over_rounded_weights(hd):
    """On a card: on ``flash_rounding_probe``'s inputs (constant v, every
    weight but one rounding down by nearly 2**-8 to bf16), the kernel's
    output is v in every element: l is summed over the same rounded
    weights that multiply v. l over the unrounded weights would give the
    bf16 value one ulp below v in every element, which the kernel
    tolerance cannot tell apart."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = flash_rounding_probe(hd, device="cuda")
    got = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, causal=False, window=0, cap=0.0))
    assert bool((got == PROBE_V).all())


@pytest.mark.cuda
def test_cuda_flash_refuses_bad_inputs():
    """On a card: fp32 q, a CPU k beside CUDA q, a non-contiguous q, an
    unsupported head width, H not a multiple of K and a misaligned q each
    raise, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = _flash_inputs(256, 256, 8, 4, 128)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(TypeError):
        tfa.flash_attention_fwd(q.float(), k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(*_flash_inputs(256, 256, 8, 4, 96))
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(*_flash_inputs(256, 256, 6, 4, 128))
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(buf[1:].view(q.shape), k, v)
    assert tfa.LAUNCHES == before


def _qmm_inputs(M, K, N, per_tensor, seed=0):
    """Random weights quantized both ways, bf16 and fp32 x (on the card).
    ``per_tensor`` replaces the per-channel scales by one (1,) scale, as
    serving/quant.py stores them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=g, device="cuda")
    x = torch.randn((M, K), generator=g, device="cuda")
    q8, s8 = tref.quantize_w8(w)
    q4, s4 = tref.quantize_w4_packed(w)
    if per_tensor:
        s8, s4 = s8.amax().reshape(1), s4.amax().reshape(1)
    return x, (q8, s8), (q4, s4)


# fp32 x through W8A16/W4A16: the kernel splits x into three bf16 terms
# whose products with the integer codes are exact, so what separates it
# from the plain version is fp32 accumulation: the tensor cores may drop
# up to an fp32 ulp of the running sum per mma step, over 3 * K / 16
# steps. Outputs are held to that many ulps of the row's max |ref|
# (chip_smoke.py states the same bound); a kernel that rounds x to bf16
# once (about 1e-3 of a typical output off) misses it.
def fp32_close(got, want, K):
    rowmax = want.abs().amax(-1, keepdim=True)
    return bool(((got - want).abs() <= 3 * K / 16 * 2.0 ** -23 * rowmax)
                .all())


def _launched(name, fn):
    before = tqm.LAUNCHES[name]
    out = fn()
    assert tqm.LAUNCHES[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 37])
@pytest.mark.parametrize("per_tensor", [False, True])
def test_cuda_quant_matmul_match_plain(M, per_tensor):
    """On a card: the three weight-quantized matmuls against their plain
    versions at a ragged M, bf16 and fp32 x, per-channel and per-tensor
    scales; one launch counted per call. W8A16/W4A16 are held to the
    kernel tolerance with bf16 x (one bf16 ulp of the element plus one of
    the row's max, from summation order) and to ``fp32_close`` with fp32
    x, which x rounded to bf16 must miss; W8A8 with an fp32 output must
    equal its plain version bit for bit — the int32 accumulator is exact
    and the rescale runs in the same order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    x, (q8, s8), (q4, s4) = _qmm_inputs(M, 256, 192, per_tensor)
    for dt in (torch.bfloat16, torch.float32):
        xd = x.to(dt)
        for name, fn, plain, w, s in (
                ("quant_matmul_w8a16", tqm.quant_matmul_w8a16,
                 tref.quant_matmul_w8a16, q8, s8),
                ("quant_matmul_w4a16", tqm.quant_matmul_w4a16,
                 tref.quant_matmul_w4a16, q4, s4)):
            got = _launched(name, lambda: fn(xd, w, s))
            assert got.dtype == dt and got.shape == (M, 192)
            want = plain(xd, w, s).float()
            if dt == torch.float32:
                assert fp32_close(got, want, xd.shape[1])
                # control: x rounded to bf16 once must miss that bound
                assert not fp32_close(plain(xd.bfloat16().float(), w, s),
                                      want, xd.shape[1])
            else:
                assert bf16_close(got.float(), want)
        xq, xs = tref.quantize_a8(xd)
        got = _launched("quant_matmul_w8a8", lambda: tqm.quant_matmul_w8a8(
            xq, xs, q8, s8, out_dtype=dt))
        want = tref.quant_matmul_w8a8(xq, xs, q8, s8, out_dtype=dt)
        if dt == torch.float32:
            assert torch.equal(got, want)
        else:
            assert bf16_close(got.float(), want.float())


@pytest.mark.cuda
def test_cuda_quant_matmul_refuses_bad_inputs():
    """On a card: a CPU weight beside a CUDA x, a misaligned x and a K
    that is not a multiple of the tile each raise, and launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    x, (q8, s8), _ = _qmm_inputs(8, 256, 128, False)
    xb = x.bfloat16()
    before = dict(tqm.LAUNCHES)
    with pytest.raises(ValueError):
        tqm.quant_matmul_w8a16(xb, q8.cpu(), s8)
    buf = torch.zeros(8 * 256 + 1, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        tqm.quant_matmul_w8a16(buf[1:].view(8, 256), q8, s8)
    with pytest.raises(ValueError):
        tqm.quant_matmul_w8a16(xb[:, :96].contiguous(), q8[:96], s8)
    assert tqm.LAUNCHES == before


# gemma2-2b's (K, N) the quant matmuls run at (chip_smoke.py QMM_SHAPES)
# and the rows the main paths give them
QMM_SHAPES = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
              (9216, 2304), (2304, 256000))
QMM_ROWS = (1, 2, 8, 37, 2000, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QMM_SHAPES)
@pytest.mark.parametrize("per_tensor", [False, True])
def test_cuda_wgmma_quant_matmul_shapes(K, N, per_tensor):
    """On a card: the wgmma W8A16 and W4A16 over bf16 x at every shape the
    paths launch, M in {1, 2, 8, 37, 2000, 4096} (split-K at the small
    ones on all but the lm_head), per-channel and per-tensor scales,
    within the bf16 bound of the plain version; one launch counted per
    call; a split call run twice gives the same bits (a fixed-order
    reduce, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    g = torch.Generator(device="cuda").manual_seed(K + N)
    w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    for name, fn, plain, quantize in (
            ("quant_matmul_w8a16", tqm.quant_matmul_w8a16,
             tref.quant_matmul_w8a16, tref.quantize_w8),
            ("quant_matmul_w4a16", tqm.quant_matmul_w4a16,
             tref.quant_matmul_w4a16, tref.quantize_w4_packed)):
        codes, scale = quantize(w)
        if per_tensor:
            scale = scale.amax().reshape(1)
        for M in QMM_ROWS:
            if N == 256000 and M == 4096:
                continue              # the lm_head unembeds 2000 rows
            x = torch.randn((M, K), generator=g, device="cuda").bfloat16()
            got = _launched(name, lambda: fn(x, codes, scale))
            assert got.dtype == torch.bfloat16 and got.shape == (M, N)
            assert bf16_close(got.float(), plain(x, codes, scale).float()), \
                (name, K, N, M)
            if tqm.qmm_splits(M, N, K) > 1:
                assert torch.equal(fn(x, codes, scale), got)


W8A8_ROWS = (1, 2, 5, 8, 37, 1000, 2000, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", QMM_SHAPES)
@pytest.mark.parametrize("per_tensor", [False, True])
def test_cuda_w8a8_shapes(K, N, per_tensor):
    """On a card: W8A8 on the s8 wgmma kernel at every shape the paths
    launch, M in {1, 2, 5, 8, 37, 1000, 2000, 4096} (split-K wherever
    qmm_splits says; the lm_head unembeds at most 2000 rows), per-channel
    and per-tensor scales: the fp32 output equals the plain version bit
    for bit (an exact int32 accumulator, the rescale in the plain
    version's order, at every split count), the bf16 output equals the
    plain version's fp32 output rounded once; one launch counted per
    call; a split call run twice gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    g = torch.Generator(device="cuda").manual_seed(K + N + 1)
    w = torch.randn((K, N), generator=g, device="cuda") * K ** -0.5
    codes, scale = tref.quantize_w8(w)
    if per_tensor:
        scale = scale.amax().reshape(1)
    name = "quant_matmul_w8a8"
    for M in W8A8_ROWS:
        if N == 256000 and M == 4096:
            continue
        xq, xs = tref.quantize_a8(torch.randn((M, K), generator=g,
                                              device="cuda"))
        want = tref.quant_matmul_w8a8(xq, xs, codes, scale,
                                      out_dtype=torch.float32)
        got = _launched(name, lambda: tqm.quant_matmul_w8a8(
            xq, xs, codes, scale, out_dtype=torch.float32))
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert torch.equal(got, want), (K, N, M, tqm.qmm_plan(M, N, K))
        got16 = _launched(name, lambda: tqm.quant_matmul_w8a8(
            xq, xs, codes, scale))
        assert got16.dtype == torch.bfloat16
        assert torch.equal(got16, want.bfloat16()), (K, N, M)
        if tqm.qmm_splits(M, N, K) > 1:
            assert torch.equal(tqm.quant_matmul_w8a8(
                xq, xs, codes, scale, out_dtype=torch.float32), got)
        del want, got, got16
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_fp32_x_takes_the_mma_template(bits):
    """On a card: fp32 x goes to the mma.sync template (its entry
    point, not the wgmma one, is called) and meets its 3K/16 * 2**-23
    bound, which x rounded to bf16 misses; bf16 x goes to the wgmma one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import build
    x, (q8, s8), (q4, s4) = _qmm_inputs(37, 2304, 1024, False, seed=bits)
    fn, plain, w, s = (tqm.quant_matmul_w8a16, tref.quant_matmul_w8a16,
                       q8, s8) if bits == 8 else \
        (tqm.quant_matmul_w4a16, tref.quant_matmul_w4a16, q4, s4)
    lib = build.load("quant_matmul")
    calls = []
    entries = {e: getattr(lib, e) for e in ("qmm_wa16_f32", "qmm_wa16_bf16")}
    for entry, orig in entries.items():

        def spy(*args, _orig=orig, _entry=entry):
            calls.append(_entry)
            return _orig(*args)
        setattr(lib, entry, spy)
    try:
        got = fn(x, w, s)
        assert calls == ["qmm_wa16_f32"] and got.dtype == torch.float32
        want = plain(x, w, s).float()
        assert fp32_close(got, want, x.shape[1])
        assert not fp32_close(plain(x.bfloat16().float(), w, s), want,
                              x.shape[1])
        fn(x.bfloat16(), w, s)
        assert calls == ["qmm_wa16_f32", "qmm_wa16_bf16"]
    finally:
        for entry, orig in entries.items():
            setattr(lib, entry, orig)


# ------------------------------------------------- granite-moe on the card --
# full granite-moe-3b-a800m attention: 24 query heads over 8 kv heads
# (G = 3, so a decode split CTA serves GC = 1 head) of width 64
MOE_H, MOE_K, MOE_HD = 24, 8, 64


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_cuda_paged_kernels_at_granite_moe_geometry(window, cap):
    """On a card: the bf16 decode and prefill kernels at hd 64, G = 3
    (decode GC = 1), page 16, ragged positions and a padded chunk, against
    their plain versions, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    assert tpa.head_group(MOE_H // MOE_K) == 1
    fwd, plain, pfwd, pplain = _PAGED[16]
    positions = [0, 17, 700, 4095, 4097, 2000, 33, 1500]
    qs, pools, pt, pos = _pool_case(positions, 1, 4200 // PAGE + 2, 16,
                                    H=MOE_H, K=MOE_K, hd=MOE_HD, seed=3)
    _check_paged(fwd, plain, qs[cap][:, 0].contiguous(), pools, pt, pos,
                 window, cap)
    qs, pools, pt, pos = _pool_case([0, 300, 900], 512, 90, 16, H=MOE_H,
                                    K=MOE_K, hd=MOE_HD, seed=4)
    _check_paged(pfwd, pplain, qs[cap], pools, pt, pos, window, cap,
                 live=90 * PAGE - 900)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2048, 4096])
def test_cuda_flash_at_granite_moe_geometry(S):
    """On a card: flash attention at hd 64, 24 heads over 8 (G = 3),
    causal, the S an AMC episode's ``Model.loss`` runs at."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(S, S, MOE_H, MOE_K, MOE_HD, seed=S)


def _moe_layer(seed=0):
    """Full granite-moe width moe params on the card, from a seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.models.params import init_params
    cfg = get_config("granite-moe-3b-a800m")
    g = torch.Generator(device="cuda").manual_seed(seed)
    return cfg, init_params(tmoe.moe_defs(cfg.d_model, cfg.moe), g, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 4096])
def test_cuda_moe_apply_is_deterministic(T):
    """On a card: moe_apply at full granite-moe width (40 experts, top 8,
    capacity 1.25) on a decode tick's rows (8) and a chunk's (4096, where
    pairs drop): two calls give the same bits (no atomics in the combine),
    and the drop-free decode tick keeps every routed pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.models import moe as tmoe
    cfg, p = _moe_layer()
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn((1, T, cfg.d_model), generator=g,
                    device="cuda").bfloat16()
    y1, a1 = tmoe.moe_apply(p, x, cfg.moe, cfg.activation)
    y2, a2 = tmoe.moe_apply(p, x, cfg.moe, cfg.activation)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)
    assert bool(torch.isfinite(y1.float()).all())
    _, _, idx = tmoe.route(p, x.reshape(T, -1), cfg.moe)
    _, keep, _ = tmoe.dispatch(idx, tmoe.capacity(T, cfg.moe),
                               cfg.moe.num_experts)
    if T == 8:
        assert bool(keep.all())


@pytest.mark.cuda
def test_cuda_tiny_moe_engine_matches_generate():
    """On a card: tiny granite-moe (hd 32, capacity 4.0) served through
    the kernels at pages 16 and 48, chunked: the engine's tokens equal the
    port's ``generate`` over the same pool, request by request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import numpy as np
    from repro_torch.configs import tiny_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import AdmissionPolicy, Engine, Request
    model = build_model(tiny_config("granite-moe-3b-a800m"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, 512, int(n))
                    .astype(np.int32), max_new=8)
            for i, n in enumerate(rng.integers(20, 90, 5))]
    for page in (16, 48):
        policy = AdmissionPolicy(
            hw_name="test", max_model_len=128, page_size=page,
            num_pages=10_000, max_batch=4, prefill_chunk=32, quant_bits=16,
            decode_slo_s=0.03, est_decode_s=0.0, est_prefill_s=0.0)
        before = dict(tpa.LAUNCHES)
        outs = Engine(model, params, policy, paged_kernel="cuda").run(reqs)
        for name in ("paged_attention_fwd", "paged_prefill_fwd"):
            assert tpa.LAUNCHES[name] > before[name], name
        for r in reqs:
            want = generate(model, params,
                            torch.from_numpy(r.prompt[None]).cuda(),
                            r.max_new, page_size=page, kernel="cuda",
                            prefill_chunk=32)[0].cpu().numpy()
            assert np.array_equal(outs[r.rid], want), (page, r.rid)


@pytest.mark.cuda
def test_cuda_amc_masked_loss_matches_cpu():
    """On a card: one ``amc.apply_ratios`` on tiny granite-moe (bf16
    parameters from one seed, keep 0.5: one of two kv groups and two of
    four experts) gives the CPU's masked parameters bit for bit, and
    ``Model.loss`` over 2048 tokens (flash in every layer on the card, its
    plain version on the CPU) the CPU's loss within the logits bound
    chip_smoke.py holds kernel logits to, 3% of the largest |logit|,
    carried to the mean cross-entropy: twice that, since a token's CE
    moves by at most twice its largest logit change."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.configs import tiny_config
    from repro_torch.core import amc
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(tiny_config("granite-moe-3b-a800m"))
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(2, 512, (1, 2048),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    layers = amc.enumerate_layers(model, 4096)
    out = {}
    for dev in ("cpu", "cuda"):
        p = amc.apply_ratios(tree_map(lambda a: a.to(dev), cpu), layers,
                             [0.5] * len(layers))
        batch = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        before = tfa.LAUNCHES["flash_attention_fwd"]
        loss = float(model.loss(p, batch))
        n = tfa.LAUNCHES["flash_attention_fwd"] - before
        out[dev] = (tree_map(lambda a: a.cpu(), p), loss, n)
    (p_cpu, l_cpu, n_cpu), (p_gpu, l_gpu, n_gpu) = out["cpu"], out["cuda"]
    assert n_cpu == 0 and n_gpu == model.cfg.num_layers
    for a, b in zip(tree_leaves(p_cpu), tree_leaves(p_gpu)):
        assert torch.equal(a, b)
    z = model.forward(p_cpu, {"tokens": toks})[0][..., :model.cfg.vocab_size]
    assert abs(l_gpu - l_cpu) <= 2 * 0.03 * float(z.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_dequant_dot_on_expert_batches(bits):
    """On a card: ``dequant_dot`` at the moe sites of full granite-moe
    width (x (40, C, d) against stored (40, d, f) codes, one per-layer
    scale): the W8A16/W4A16 kernels one expert at a time, one launch per
    expert, against the kernels' plain versions expert by expert, at the
    kernels' bf16 tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.serving import quant as squant
    cfg, p = _moe_layer(seed=bits)
    q = squant.quantize_params({"blocks": {"sub0": {"moe": {
        k: v[None] for k, v in p.items() if k != "router"}}}},
        default_bits=bits)["blocks"]["sub0"]["moe"]
    q = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in q.items()}
    E, C = cfg.moe.num_experts, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((E, C, cfg.d_model), generator=g,
                    device="cuda").bfloat16()
    h = torch.randn((E, C, cfg.moe.d_ff_expert), generator=g,
                    device="cuda").bfloat16()
    name = "quant_matmul_w4a16" if bits == 4 else "quant_matmul_w8a16"
    plain = getattr(tref, name)
    for a, site, key in ((x, "moe_in", "w_in"), (x, "moe_gate", "w_gate"),
                         (h, "moe_out", "w_out")):
        w = q[key]
        codes = w["q4"] if bits == 4 else w["q"]
        before = tqm.LAUNCHES[name]
        got = squant.dequant_dot(a, w, site).float()
        assert tqm.LAUNCHES[name] == before + E
        want = torch.stack([plain(a[e], codes[e], w["scale"])
                            for e in range(E)]).float()
        assert got.shape == want.shape and got.shape[:2] == (E, C)
        assert bf16_close(got, want), site


# the kernel's lse against the plain version's: the kernel's l sums the
# bf16-rounded weights (up to 2**-9 of each, relative), and its scores
# carry the softcap2 and ex2.approx errors (within 5e-5 at a cap of 50),
# so its log-sum-exp sits within 2**-8 of the plain m + log(l)
LSE_ATOL = 2.0 ** -8
# the backward on the kernel's out and lse against autograd of the fp32
# dense plain version: P off by the lse's 2**-9, delta = dout . out read
# from the bf16 out, each gradient rounded to bf16; an emulation of those
# errors on the CPU reaches 4.2e-3 of max |g|
BWD_TOL = 2.0 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("H,K,hd,window,cap", [
    (8, 4, 256, 0, 50.0), (8, 4, 256, 4096, 0.0), (8, 4, 256, 64, 50.0),
    (24, 8, 64, 0, 0.0), (4, 2, 32, 32, 50.0)])
def test_cuda_flash_lse(H, K, hd, window, cap):
    """On a card: the kernel's lse within LSE_ATOL of the plain version's
    at gemma2-2b's, granite-moe's and tiny heads; ``out`` with the lse
    asked for equal bit for bit to ``out`` without it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, k, v = _flash_inputs(2560, 2560, H, K, hd,
                            q_scale=20.0 if cap else 1.0, seed=hd + H)
    kw = dict(causal=True, window=window, cap=cap)
    out, lse = _flash_launched(lambda: tfa.flash_attention_fwd(
        q, k, v, return_lse=True, **kw))
    assert lse.shape == (1, H, 2560) and lse.dtype == torch.float32
    assert torch.equal(out, tfa.flash_attention_fwd(q, k, v, **kw))
    _, want = tref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert float((lse - want).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("H,K,hd,kind,cap", [
    (8, 4, 256, "global", 50.0), (8, 4, 256, "local", 0.0),
    (24, 8, 64, "global", 0.0)])
def test_cuda_flash_backward(H, K, hd, kind, cap):
    """On a card: models/flash.py's forward through the kernel (one launch,
    with its lse) and its backward, dq, dk and dv within BWD_TOL of each
    gradient's max |g| from autograd of the fp32 dense plain version, at
    gemma2-2b's heads (hd 256, G 2) and granite-moe's (hd 64, G 3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.models import flash as tflash
    S, window = 2048, (512 if kind == "local" else 0)
    q, k, v = _flash_inputs(S, S, H, K, hd, q_scale=20.0 if cap else 1.0,
                            seed=hd)
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = _flash_launched(lambda: tflash.flash_attention(
        *ins, kind, window, cap, kernel="cuda"))
    got = torch.autograd.grad(out, ins, dout)
    ref_ins = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tref.flash_attention_ref(
        *ref_ins, causal=True, window=window, cap=cap), ref_ins,
        dout.float())
    for a, b, t in zip(want, got, (q, k, v)):
        assert b.dtype == torch.bfloat16 and b.shape == t.shape
        err = float((a - b.float()).abs().max() / a.abs().max())
        assert err <= BWD_TOL, err


# -------------------------------------------- the SSM family and NAS ----
@pytest.mark.cuda
@pytest.mark.parametrize("H,K,S,window,B", [
    (32, 32, 4096, 0, 2),          # zamba2-1.2b's shared attention, G = 1
    (8, 4, 2048, 0, 1),            # the NAS supernet's attention ops
    (8, 4, 2048, 1024, 1),
    (8, 4, 2048, 4096, 1)])
def test_cuda_flash_ssm_and_nas_geometries(H, K, S, window, B):
    """On a card: flash at hd 64 at the geometries the hybrid's prefill and
    the NAS search give it (G = 1 with 128 positions a CTA; 8 over 4 heads
    at windows 0, 1024 and 4096 over 2048 tokens), against the plain
    version at the kernel tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _check_flash(S, S, H, K, 64, window=window, B=B, seed=H + window)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_cuda_generate_ssm_families_match_cpu(arch):
    """On a card: tiny mamba2 and zamba2 through ``generate``'s dense-cache
    branch (prompts of 2048 tokens: the hybrid's shared attention through
    the flash kernel, once per application), against the CPU port's plain
    path on the same parameters (its prefill and decode steps, the same
    calls ``generate`` makes): greedy tokens identical wherever the CPU's
    top-2 margin exceeds 3% of its largest |logit| (chip_smoke.py's
    LOGIT_RTOL); the first differing token ends the comparison."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.configs import tiny_config
    from repro_torch.launch.serve import _grow_cache, generate
    from repro_torch.models.api import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.models.transformer import hybrid_groups
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(tiny_config(arch))
    V, S, gen = model.cfg.vocab_size, 2048, 8
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda a: a.cuda(), cpu)
    prompt = torch.randint(2, V, (2, S),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    before = tfa.LAUNCHES["flash_attention_fwd"]
    got = generate(model, gpu, prompt.cuda(), gen).cpu()
    n = tfa.LAUNCHES["flash_attention_fwd"] - before
    apps = len(hybrid_groups(model.cfg)) \
        if model.cfg.family == "hybrid" else 0
    assert n == apps
    # the CPU's plain path, step by step, with its logits
    logits, cache = model.prefill(cpu, {"tokens": prompt},
                                  cache_layout="full")
    cache = _grow_cache(cache, S, S + gen)
    steps = [logits[:, -1, :V]]
    toks = [steps[0].argmax(-1)[:, None].to(torch.int32)]
    for i in range(gen - 1):
        logits, cache = model.decode_step(cpu, cache, toks[-1],
                                          torch.tensor(S + i))
        steps.append(logits[:, -1, :V])
        toks.append(steps[-1].argmax(-1)[:, None].to(torch.int32))
    want = torch.cat(toks, dim=1)
    for b in range(2):
        for t in range(gen):
            if got[b, S + t] != want[b, t]:
                top = torch.topk(steps[t][b].float(), 2).values
                bound = 0.03 * float(steps[t][b].abs().max())
                assert float(top[0] - top[1]) <= bound, (b, t)
                break
