"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a card only: the bf16 pair and the fused-dequant pair over
int8 and packed-int4 pools, at full gemma2-2b head width. Imports no JAX
(the card's machine has none); run there, from the repository root, with

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX). Without a card every
test here skips."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import bf16_close, paged_case  # noqa: E402


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
