"""Port kernels (src/repro_torch/kernels): the plain PyTorch paged walks
against the reference's JAX walks and Pallas kernels (interpret mode) on
the same numpy inputs, the port's dense oracles and the dispatch
contract. The CUDA kernels are held against their plain versions in
tests/test_torch_cuda.py, which imports no JAX so that it runs on the
card; the quantized walks' CPU parity is in tests/test_torch_kvquant.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import paged_case as _case  # noqa: E402

torch.set_num_threads(1)

# fp32 parity: both walks do the same fp32 arithmetic and differ only in
# summation order, so outputs of magnitude ~1 agree to well under 1e-5.
TOL = 1e-5


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
                            "paged_prefill_fwd": 0,
                            "paged_attention_quant_fwd": 0,
                            "paged_prefill_quant_fwd": 0}
