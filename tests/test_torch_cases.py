"""Inputs shared by the port's kernel tests (this module holds no test):
random paged-attention cases (numpy), the kernel-vs-plain tolerance and
the quant matmuls' split-K chunks. Imports no JAX, so the tests that run
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
