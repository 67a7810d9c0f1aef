"""The redesigned W8A16/W4A16 kernels' plan and arithmetic, on the CPU:
the wgmma tiles (tokens on wgmma's N axis, 64 or 128 channels a CTA), the
split-K plan (equal 64-aligned K chunks, at least 132 CTAs at decode, one
split at a 4096-row chunk), and a plain-torch emulation of what the
kernels compute (fp32 partial products over each split's K chunk, summed
in split order, then the scale and the bf16 cast) held against the port's
and the reference's plain quantized matmuls. The CUDA kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: the emulation keeps the plain version's fp32 arithmetic and
changes the summation order, then rounds once to bf16, as the kernels do:
the kernels' bf16 bound, 2**-7 |ref| + 2**-7 (row max |ref|)
(``bf16_close``); a variant that drops a split, or applies the scale
twice, must miss it."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_cases import bf16_close, split_chunks  # noqa: E402

torch.set_num_threads(1)

# gemma2-2b's projections (K, N): q/o, the kv pair, ffn in/gate, ffn out
PROJECTIONS = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
               (9216, 2304))


def test_tiles():
    """Tokens sit on wgmma's N axis: 8 for a decode tick of up to 8, the
    least power of two from 8 that holds M up to 64, 128 beyond; a CTA
    takes 128 channels where N allows, else 64."""
    assert [tqm.token_tile(M) for M in (1, 2, 8, 9, 16, 17, 37, 64, 65,
                                        2000, 4096)] == \
        [8, 8, 8, 16, 16, 32, 64, 64, 128, 128, 128]
    assert tqm.channel_tile(9216) == 128 and tqm.channel_tile(2304) == 128
    assert tqm.channel_tile(192) == 64 and tqm.channel_tile(64) == 64


@pytest.mark.parametrize("K,N", PROJECTIONS)
def test_split_plan_on_projections(K, N):
    """At M = 8 the chunks cover K exactly, in order, each an equal number
    of 64-deep steps, and the grid holds at least 132 CTAs; at M = 4096
    there is one split. The plan reads shapes only."""
    assert list(inspect.signature(tqm.qmm_splits).parameters) == \
        ["M", "N", "K"]
    n = tqm.qmm_splits(8, N, K)
    chunks = split_chunks(K, n)
    assert chunks[0][0] == 0 and chunks[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert len({k1 - k0 for k0, k1 in chunks}) == 1
    assert all(k0 % tqm.TILE == 0 and (k1 - k0) % tqm.TILE == 0
               for k0, k1 in chunks)
    assert N // tqm.channel_tile(N) * n >= tqm.SMS
    assert tqm.qmm_splits(4096, N, K) == 1


def test_split_plan_any_shape():
    """Every plan divides the K steps; a split grid fills the SMs unless
    every split is already one step; a full grid is never split."""
    for K in (64, 128, 640, 2304, 9216):
        for N in (64, 192, 1024, 9216, 256000):
            for M in (1, 8, 37, 100, 2000, 4096):
                n = tqm.qmm_splits(M, N, K)
                steps = K // tqm.TILE
                ctas = N // tqm.channel_tile(N) * -(-M // tqm.token_tile(M))
                assert n >= 1 and steps % n == 0
                if ctas >= tqm.SMS:
                    assert n == 1
                elif n > 1:
                    assert ctas * n >= tqm.SMS or n == steps


def emulate_wq(x, codes, scale, bits, n_split, *, drop_split=False,
               double_scale=False):
    """What the wgmma kernel and its reduce compute: per split, the fp32
    product of the bf16 x and the exact codes over its K chunk (the
    tensor cores' fp32 accumulation), the partials summed in split order,
    times the scale, rounded to bf16."""
    w = tref.unpack_w4(codes) if bits == 4 else codes
    xf = x.float()
    parts = [xf[:, k0:k1] @ w[k0:k1].float()
             for k0, k1 in split_chunks(x.shape[1], n_split)]
    if drop_split:
        parts = parts[1:]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    out = acc * scale
    if double_scale:
        out = out * scale
    return out.bfloat16()


def _case(K, N, M, bits, per_tensor, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         * K ** -0.5)
    codes, scale = (tref.quantize_w4_packed if bits == 4
                    else tref.quantize_w8)(w)
    if per_tensor:
        scale = scale.amax().reshape(1)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .bfloat16()
    return x, codes, scale


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("per_tensor", [False, True])
@pytest.mark.parametrize("M,K,N", [(8, 2304, 1024), (2, 640, 256),
                                   (37, 512, 192)])
def test_split_reduction_matches_plain(bits, per_tensor, M, K, N):
    """At the plan's split count (18 at gemma2-2b's kv projection, and as
    many as the small shapes' K steps), the emulated partials summed in
    order match the port's and the reference's plain W8A16/W4A16 within
    the bf16 bound; dropping a split or scaling twice misses it."""
    x, codes, scale = _case(K, N, M, bits, per_tensor, seed=K + N + bits)
    n_split = tqm.qmm_splits(M, N, K)
    assert n_split > 1
    plain = tref.quant_matmul_w4a16 if bits == 4 else tref.quant_matmul_w8a16
    jplain = jref.quant_matmul_w4a16 if bits == 4 \
        else jref.quant_matmul_w8a16
    want = plain(x, codes, scale).float()
    jwant = torch.from_numpy(np.asarray(jplain(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()))
        .astype(jnp.float32)))
    got = emulate_wq(x, codes, scale, bits, n_split).float()
    assert bf16_close(got, want) and bf16_close(got, jwant)
    assert not bf16_close(emulate_wq(x, codes, scale, bits, n_split,
                                     drop_split=True).float(), want)
    assert not bf16_close(emulate_wq(x, codes, scale, bits, n_split,
                                     double_scale=True).float(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_split_count_does_not_change_result(bits):
    """One split and every divisor of the K steps give results within the
    bf16 bound of each other: the split changes only the order of fp32
    sums."""
    K, N, M = 768, 128, 8
    x, codes, scale = _case(K, N, M, bits, False, seed=bits)
    one = emulate_wq(x, codes, scale, bits, 1).float()
    for n in (2, 3, 4, 6, 12):
        assert bf16_close(emulate_wq(x, codes, scale, bits, n).float(), one)
