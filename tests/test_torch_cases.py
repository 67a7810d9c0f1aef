"""Inputs shared by the port's kernel tests (this module holds no test):
random paged-attention cases (numpy), the kernel-vs-plain tolerance, the
quant matmuls' split-K chunks and flash attention's rounding probe. Imports no JAX, so the tests that run
on the card can use it there."""
import numpy as np
import torch

from repro_torch.kernels import quant_matmul as tqm


def paged_case(B, Sq, H, K, hd, page, n_blocks, *, num_pages=11, seed=0,
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


def bf16_close(got, want):
    """Kernel vs plain version, both fp32 inside and rounded once to bf16:
    one bf16 ulp of the element (2**-7 * |want|) plus 2**-7 of the row's
    max |want| for elements near zero — tied to the data, since softmax
    outputs shrink as contexts grow."""
    rowmax = want.abs().amax(-1, keepdim=True)
    return bool(torch.all((got - want).abs()
                          <= 2.0 ** -7 * (rowmax + want.abs())))


def split_chunks(K, n_split):
    """[(k0, k1)]: the K range split i of a wgmma quant matmul walks (the
    kernels' step0 = i * steps, steps = K / 64 / n_split), in order."""
    steps = K // tqm.TILE // n_split
    return [(i * steps * tqm.TILE, (i + 1) * steps * tqm.TILE)
            for i in range(n_split)]


# the constant v of ``flash_rounding_probe`` and the bf16 value a row
# gives when l is summed over the unrounded weights
PROBE_V = 1.875
PROBE_V_UNROUNDED_L = 1.8671875


def flash_rounding_probe(hd, S=64, T=256, H=4, K=2, device="cpu"):
    """bf16 q (1, S, H, hd), k, v (1, T, K, hd) for full attention
    (causal=False, no window, no cap) on which the rounding of P shows in
    the bf16 output. hd is 64 or 256 (hd**-0.5 a power of two, so the
    scores are exact): q is e_0; key 0 scores 1.0 and every other key
    0.310546875, so each other weight is exp(-0.689453125) = 0.50185,
    which rounds to bf16 0.5, 2**-8 * 0.95 below it; v is PROBE_V
    everywhere. An output that is a convex combination of v rows, as with
    l summed over the same rounded weights that multiply v, is PROBE_V
    exactly; with l over the unrounded weights, every row is PROBE_V *
    128.5 / 128.97 = 1.86814, which rounds to PROBE_V_UNROUNDED_L."""
    assert hd in (64, 256) and T >= 2
    root = hd ** 0.5                     # 8 or 16: exact in bf16
    q = torch.zeros((1, S, H, hd))
    q[..., 0] = 1.0
    k = torch.zeros((1, T, K, hd))
    k[:, 0, :, 0] = root                 # score 1.0
    k[:, 1:, :, 0] = 2.484375 * root / 8  # score 0.310546875
    v = torch.full((1, T, K, hd), PROBE_V)
    return tuple(t.bfloat16().to(device) for t in (q, k, v))
