"""Port kernels (src/repro_torch/kernels): the plain PyTorch paged walks
against the reference's JAX walks and Pallas kernels (interpret mode) on
the same numpy inputs, the port's dense oracles, the dispatch contract,
and — on a card only — the CUDA kernels against their plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

# fp32 parity: both walks do the same fp32 arithmetic and differ only in
# summation order, so outputs of magnitude ~1 agree to well under 1e-5.
TOL = 1e-5


def _case(B, Sq, H, K, hd, page, n_blocks, *, num_pages=11, seed=0,
          overrun=False):
    """Random fp32 pools (numpy) with a poisoned scratch page 0, ragged
    chunk starts (one at 0), shuffled pages and scratch-page tails.
    ``overrun`` puts the last sequence's chunk past the table width."""
    rng = np.random.default_rng(seed)
    pool_k = rng.standard_normal((num_pages, page, K, hd)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages, page, K, hd)).astype(np.float32)
    pool_k[0] = 37.0                          # a masking bug reads these
    pool_v[0] = -53.0
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    positions = rng.integers(0, n_blocks * page - Sq + 1, B).astype(np.int32)
    positions[0] = 0
    if overrun:
        positions[-1] = n_blocks * page - Sq // 2
    pt = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        need = min((positions[b] + Sq - 1) // page + 1, n_blocks)
        pt[b, :need] = rng.choice(np.arange(1, num_pages), need,
                                  replace=False)
    return q, pool_k, pool_v, pt, positions


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(a) for a in args])


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# the reference's sweep shapes (tests/test_kernels.py,
# tests/test_chunked_prefill.py), trimmed to the shapes whose first JAX
# call pays its compile: each distinct shape costs about a second here
@pytest.mark.parametrize("page,n_blocks", [(8, 6), (16, 4), (32, 2)])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("H,K", [(4, 2), (4, 1)])
def test_decode_walk_matches_reference(page, n_blocks, window, cap, H, K):
    """paged_attention_ref: port == reference walk == port dense oracle
    across page sizes, windows, softcaps, GQA shapes, ragged positions and
    the poisoned scratch page."""
    q, pk, pv, pt, pos = _case(3, 1, H, K, 32, page, n_blocks)
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(
        (q[:, 0], pk, pv, pt, pos))
    want = jref.paged_attention_ref(jq, jk, jv, jt, jp, window=window,
                                    cap=cap)
    got = tref.paged_attention_ref(tq, tk, tv, tt, tp, window=window,
                                   cap=cap)
    dense = tref.paged_attention_dense_ref(tq, tk, tv, tt, tp,
                                           window=window, cap=cap)
    assert _max_err(got, want) < TOL
    assert _max_err(dense, want) < TOL


@pytest.mark.parametrize("page,n_blocks", [(8, 6), (16, 4), (32, 2)])
@pytest.mark.parametrize("Sq", [5, 16])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_prefill_walk_matches_reference(page, n_blocks, Sq, window, cap):
    """paged_prefill_ref: port == reference walk across chunk sizes, page
    sizes, windows, softcaps and ragged chunk starts (GQA G=2; Sq == 1 and
    G=4 are the decode sweep's); the port's dense oracle agrees too."""
    case = _case(3, Sq, 4, 2, 32, page, n_blocks)
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(case)
    want = jref.paged_prefill_ref(jq, jk, jv, jt, jp, window=window, cap=cap)
    got = tref.paged_prefill_ref(tq, tk, tv, tt, tp, window=window, cap=cap)
    dense = tref.paged_prefill_dense_ref(tq, tk, tv, tt, tp, window=window,
                                         cap=cap)
    assert _max_err(got, want) < TOL
    assert _max_err(dense, want) < TOL


@pytest.mark.parametrize("window", [0, 24])
def test_prefill_walk_overrun_chunk(window):
    """A final chunk padded past the page-table width: the hi clamp keeps
    the walk inside the table, and every row inside it matches the
    reference."""
    page, n_blocks, Sq = 8, 4, 12
    case = _case(2, Sq, 4, 2, 32, page, n_blocks, overrun=True)
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(case)
    want = np.asarray(jref.paged_prefill_ref(jq, jk, jv, jt, jp,
                                             window=window))
    got = tref.paged_prefill_ref(tq, tk, tv, tt, tp, window=window).numpy()
    live = n_blocks * page - int(case[4][-1])
    assert np.isfinite(got).all()
    assert _max_err(got[:, :live], want[:, :live]) < TOL


def test_decode_walk_matches_pallas_interpret():
    """One case of the reference's Pallas decode kernel, run in interpret
    mode, against the port's plain walk (GQA, window, softcap)."""
    q, pk, pv, pt, pos = _case(3, 1, 4, 2, 32, 16, 4, seed=2)
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(
        (q[:, 0], pk, pv, pt, pos))
    want = jpa.paged_attention_fwd(jq, jk, jv, jt, jp, window=24, cap=30.0,
                                   interpret=True)
    got = tpa.paged_attention_fwd(tq, tk, tv, tt, tp, window=24, cap=30.0)
    assert _max_err(got, want) < TOL


def test_prefill_walk_matches_pallas_interpret():
    """One case of the reference's Pallas chunked-prefill kernel, run in
    interpret mode, against the port's plain walk."""
    case = _case(2, 5, 4, 2, 32, 8, 6, seed=4)
    (jq, jk, jv, jt, jp), (tq, tk, tv, tt, tp) = _both(case)
    want = jpa.paged_prefill_fwd(jq, jk, jv, jt, jp, window=24, cap=30.0,
                                 interpret=True)
    got = tpa.paged_prefill_fwd(tq, tk, tv, tt, tp, window=24, cap=30.0)
    assert _max_err(got, want) < TOL


def test_dispatch_modes_on_cpu():
    """"auto" and "ref" take the plain walk for CPU tensors and give the
    same answer; "cuda" refuses CPU tensors instead of falling back;
    unknown modes are rejected; the wrappers count no launch on the CPU
    path."""
    q, pk, pv, pt, pos = (torch.from_numpy(a) for a in
                          _case(2, 1, 4, 2, 32, 8, 4))
    q = q[:, 0].bfloat16()
    pk, pv = pk.bfloat16(), pv.bfloat16()
    tpa.reset_launches()
    auto = tops.paged_attention(q, pk, pv, pt, pos, window=24, mode="auto")
    plain = tops.paged_attention(q, pk, pv, pt, pos, window=24, mode="ref")
    assert auto.dtype == torch.bfloat16
    assert torch.equal(auto, plain)
    with pytest.raises(ValueError, match="cuda"):
        tops.paged_attention(q, pk, pv, pt, pos, mode="cuda")
    with pytest.raises(ValueError, match="unknown"):
        tops.paged_attention_prefill(q[:, None], pk, pv, pt, pos,
                                     mode="pallas")
    assert tpa.LAUNCHES == {"paged_attention_fwd": 0,
                            "paged_prefill_fwd": 0}


def _bf16_close(got, want):
    """Kernel vs plain version, both fp32 inside and rounded once to bf16:
    one bf16 ulp of the element (2**-7 * |want|) plus 2**-7 of the row's
    max |want| for elements near zero — tied to the data, since softmax
    outputs shrink as contexts grow."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return bool(torch.all((got - want).abs()
                          <= 2.0 ** -7 * (rowmax + want.abs())))


@pytest.mark.cuda
@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 50.0)])
def test_cuda_kernels_match_plain(window, cap):
    """On a card: both CUDA kernels against their plain versions at full
    gemma2-2b head width, bf16, at the tolerance chip_smoke.py states. With
    a cap, q is scaled so the scores reach it, and the plain version
    without the cap must miss the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    q, pk, pv, pt, pos = _case(3, 40, 8, 4, 256, 16, 8, num_pages=30)
    if cap:
        q = q * 20.0      # scores about N(0, 20**2): the cap bites
    dev = "cuda"
    q, pk, pv = (torch.from_numpy(a).to(dev).bfloat16() for a in (q, pk, pv))
    pt, pos = torch.from_numpy(pt).to(dev), torch.from_numpy(pos).to(dev)
    for fwd, plain, qq in (
            (tpa.paged_prefill_fwd, tref.paged_prefill_ref, q),
            (tpa.paged_attention_fwd, tref.paged_attention_ref, q[:, 0])):
        got = fwd(qq, pk, pv, pt, pos, window=window, cap=cap).float()
        want = plain(qq, pk, pv, pt, pos, window=window, cap=cap).float()
        assert _bf16_close(got, want)
        if cap:
            nocap = plain(qq, pk, pv, pt, pos, window=window).float()
            assert not _bf16_close(nocap, want)
