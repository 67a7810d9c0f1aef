"""Port model calls (src/repro_torch/models) against the reference on tiny
gemma2-2b with the reference's own parameters (models/convert.py):
``forward`` logits, ``decode_step_paged`` at positions crossing the tiny
window of 32, and a three-chunk ``prefill_chunk_paged`` whose last chunk
is padded past the page table — logits and the pool pages they write —
plus the guarantee that neither paged call builds a dense KV view.

Tolerances. In fp32 parameters both packages do the same arithmetic in
other orders: logits (|logit| ~ 1) agree to 2e-4 and pool pages, rounded
to the bf16 pool from fp32 k/v, to one bf16 ulp. In bf16 parameters the
tiny model amplifies rounding — with its fan-in-scaled init the residual
stream reaches ~70 — so the reference's own bf16 logits differ from its
fp32 logits by ~0.3; the port's bf16 logits are held to twice that gap
measured on the same inputs (two bf16 runs rounding at different places),
floored at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

FP32_LOGIT_TOL = 2e-4
BF16_ULP = 2.0 ** -7          # one bf16 ulp is at most this of |x|
BF16_FLOOR = 2e-2


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_tiny("gemma2-2b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = t_build(t_tiny("gemma2-2b"))
    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jpd = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.bfloat16
                           else a, jp)
        out[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
    return jm, tm, out


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check_logits(got, want, dtype, want_fp32):
    err = np.abs(_np(got) - _np(want)).max()
    if dtype == "fp32":
        assert err < FP32_LOGIT_TOL, err
    else:
        noise = np.abs(_np(want) - _np(want_fp32)).max()
        assert err <= max(2 * noise, BF16_FLOOR), (err, noise)


def _check_pool(tpool, jpool):
    """Pool pages past the scratch page agree to one bf16 ulp."""
    for slot in jpool:
        for kv in ("k", "v"):
            a = _np(tpool[slot][kv])[:, 1:]
            b = _np(jpool[slot][kv])[:, 1:]
            assert np.all(np.abs(a - b) <= BF16_ULP * np.abs(b) + 1e-6)


def _pool_state(cfg, num_pages, page, seed):
    """A random bf16-representable pool (numpy), as both packages hold it."""
    rng = np.random.default_rng(seed)
    n_groups = cfg.num_layers // 2
    shape = (n_groups, num_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {f"sub{j}": {kv: np.asarray(
        jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        for kv in ("k", "v")} for j in range(2)}


def _to_jax(pool):
    return jax.tree.map(jnp.asarray, pool)


def _to_torch(pool):
    return from_jax_params(pool)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_logits_match(models, dtype):
    jm, tm, params = models
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jm.cfg.vocab_size, (2, 40)).astype(np.int32)

    def jax_logits(p):
        return jm.forward(p, {"tokens": jnp.asarray(toks)},
                          cache_layout="full")[0]

    want = jax_logits(params[dtype][0])
    got = tm.forward(params[dtype][1], {"tokens": torch.from_numpy(toks)})[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    _check_logits(got, want, dtype, jax_logits(params["fp32"][0]))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_paged_matches(models, dtype):
    """One decode step at positions before, at and past the tiny window
    (32), with idle-slot-style scratch tails; logits and the written
    pool."""
    jm, tm, params = models
    cfg = jm.cfg
    page, n_blocks, B = 8, 10, 4
    num_pages = B * n_blocks + 1
    pool = _pool_state(cfg, num_pages, page, seed=1)
    positions = np.array([5, 31, 33, 70], np.int32)
    rng = np.random.default_rng(2)
    pt = np.zeros((B, n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        need = positions[b] // page + 1
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    tok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)

    def jax_step(p):
        return jm.decode_step_paged(p, _to_jax(pool), jnp.asarray(pt),
                                    jnp.asarray(tok), jnp.asarray(positions),
                                    kernel="ref")

    want, jpool = jax_step(params[dtype][0])
    got, tpool = tm.decode_step_paged(
        params[dtype][1], _to_torch(pool), torch.from_numpy(pt),
        torch.from_numpy(tok), torch.from_numpy(positions))
    _check_logits(got, want, dtype, jax_step(params["fp32"][0])[0])
    if dtype == "fp32":
        _check_pool(tpool, jpool)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_three_chunk_prefill_matches(models, dtype):
    """A 20-token prompt in chunks of 8 over a 20-slot page table: the
    third chunk is padded past the table (its overflow rows go to the
    scratch page). Every chunk's last real row and the final pool match."""
    jm, tm, params = models
    cfg = jm.cfg
    page, n_blocks, C, S = 4, 5, 8, 20
    num_pages = n_blocks + 3
    pool = _pool_state(cfg, num_pages, page, seed=3)
    pt = np.array([[3, 1, 6, 2, 5]], np.int32)
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, cfg.vocab_size, S).astype(np.int32)

    def run_jax(p):
        jpool, rows = _to_jax(pool), []
        for start in range(0, S, C):
            toks = np.zeros((1, C), np.int32)
            toks[0, :min(C, S - start)] = prompt[start:start + C]
            h, jpool = jm.prefill_chunk_paged(
                p, jpool, jnp.asarray(pt), jnp.asarray(toks),
                jnp.asarray([start], jnp.int32), kernel="ref")
            last = min(C, S - start) - 1
            rows.append(jm.unembed(p, h[:, last:last + 1]))
        return rows, jpool

    def run_torch(p):
        tpool, rows = _to_torch(pool), []
        for start in range(0, S, C):
            toks = np.zeros((1, C), np.int32)
            toks[0, :min(C, S - start)] = prompt[start:start + C]
            h, tpool = tm.prefill_chunk_paged(
                p, tpool, torch.from_numpy(pt), torch.from_numpy(toks),
                torch.tensor([start], dtype=torch.int32))
            last = min(C, S - start) - 1
            rows.append(tm.unembed(p, h[:, last:last + 1]))
        return rows, tpool

    want, jpool = run_jax(params[dtype][0])
    got, tpool = run_torch(params[dtype][1])
    want32, _ = run_jax(params["fp32"][0])
    for g, w, w32 in zip(got, want, want32):
        _check_logits(g, w, dtype, w32)
    if dtype == "fp32":
        _check_pool(tpool, jpool)


def _decode_step_paged_case(models, dtype, page, n_blocks, positions):
    """One decode step of B = len(positions) sequences over pages of
    ``page`` keys, through both packages: logits and the written pool."""
    jm, tm, params = models
    cfg = jm.cfg
    B = len(positions)
    num_pages = B * n_blocks + 1
    pool = _pool_state(cfg, num_pages, page, seed=5)
    positions = np.array(positions, np.int32)
    rng = np.random.default_rng(6)
    pt = np.zeros((B, n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        need = positions[b] // page + 1
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    tok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)

    def jax_step(p):
        return jm.decode_step_paged(p, _to_jax(pool), jnp.asarray(pt),
                                    jnp.asarray(tok), jnp.asarray(positions),
                                    kernel="ref")

    want, jpool = jax_step(params[dtype][0])
    got, tpool = tm.decode_step_paged(
        params[dtype][1], _to_torch(pool), torch.from_numpy(pt),
        torch.from_numpy(tok), torch.from_numpy(positions))
    _check_logits(got, want, dtype, jax_step(params["fp32"][0])[0])
    if dtype == "fp32":
        _check_pool(tpool, jpool)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_paged_page64_matches(models, dtype):
    """One decode step over pages of 64 keys, wider than the kernels'
    32-key decode tile: positions before, at and past the tiny window and
    past the first page edge; logits and the written pool."""
    _decode_step_paged_case(models, dtype, 64, 3, [5, 33, 64, 150])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_paged_page48_matches(models, dtype):
    """One decode step over pages of 48 keys, which neither divide the
    kernels' 32-key decode tile nor are a multiple of it: the tiny window
    of 32 starts mid-page (at 64: keys 33-64 span blocks 0 and 1; at 150:
    blocks 2 and 3), a position on a page edge (96); logits and the written
    pool."""
    _decode_step_paged_case(models, dtype, 48, 4, [5, 64, 96, 150])


# A chunk reads back the k/v that it and earlier chunks wrote to the bf16
# pool. The two packages compute those k/v in fp32 in other orders, so a
# few round to neighbouring bf16 values (the one-ulp pool check), and a
# row over ~100 keys then moves by up to ~2e-3 (1.8e-3 measured on these
# inputs, at pages of 4 and 64 alike): the fp32 rows of a 100-token
# prompt are held to 5e-3. So is the port at page 64 against itself at
# page 4: only the order of the walk changes, which is enough to round a
# few k/v the other way (8.1e-4 measured).
POOL_READBACK_TOL = 5e-3


def _prefill_chunks_case(models, dtype, page, pt):
    """A 100-token prompt in chunks of 24 over pages of ``page`` keys (page
    table ``pt``) through both packages: every chunk's last real row
    against the reference, and against the port itself over pages of 4
    holding the same slots."""
    jm, tm, params = models
    cfg = jm.cfg
    C, S = 24, 100
    pt = np.array(pt, np.int32)
    pool = _pool_state(cfg, pt.shape[1] + 2, page, seed=7)
    rng = np.random.default_rng(8)
    prompt = rng.integers(2, cfg.vocab_size, S).astype(np.int32)
    # the same slots as pages of 4: page p is pages sub*p .. sub*p + sub-1
    sub = page // 4
    pool4 = {name: {kv: a.reshape(a.shape[0], -1, 4, *a.shape[3:])
                    for kv, a in d.items()} for name, d in pool.items()}
    pt4 = (sub * pt[:, :, None] + np.arange(sub)).reshape(1, -1)

    def chunks():
        for start in range(0, S, C):
            toks = np.zeros((1, C), np.int32)
            toks[0, :min(C, S - start)] = prompt[start:start + C]
            yield start, toks, min(C, S - start) - 1

    def run_jax(p):
        jpool, rows = _to_jax(pool), []
        for start, toks, last in chunks():
            h, jpool = jm.prefill_chunk_paged(
                p, jpool, jnp.asarray(pt), jnp.asarray(toks),
                jnp.asarray([start], jnp.int32), kernel="ref")
            rows.append(jm.unembed(p, h[:, last:last + 1]))
        return rows, jpool

    def run_torch(p, pool, pt):
        tpool, rows = _to_torch(pool), []
        for start, toks, last in chunks():
            h, tpool = tm.prefill_chunk_paged(
                p, tpool, torch.from_numpy(pt), torch.from_numpy(toks),
                torch.tensor([start], dtype=torch.int32))
            rows.append(tm.unembed(p, h[:, last:last + 1]))
        return rows, tpool

    want, _ = run_jax(params[dtype][0])
    got, _ = run_torch(params[dtype][1], pool, pt)
    got4, _ = run_torch(params[dtype][1], pool4, pt4)
    want32, _ = run_jax(params["fp32"][0])
    for g, g4, w, w32 in zip(got, got4, want, want32):
        if dtype == "fp32":
            assert np.abs(_np(g) - _np(w)).max() < POOL_READBACK_TOL
            assert np.abs(_np(g) - _np(g4)).max() < POOL_READBACK_TOL
        else:
            _check_logits(g, w, dtype, w32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_chunks_page64_match(models, dtype):
    """A 100-token prompt in chunks of 24 over pages of 64 keys (a chunk
    lies inside one page or crosses into the next): every chunk's last
    real row against the reference, and against the port itself over
    pages of 4 holding the same slots. (The k/v the chunks write drift
    past one bf16 ulp over 100 tokens; the decode test checks the pool.)"""
    _prefill_chunks_case(models, dtype, 64, [[3, 1]])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_chunks_page48_match(models, dtype):
    """The same prompt over pages of 48 keys, which neither divide a
    64-key prefill tile nor are a multiple of it (the chunks at 24 and 72
    cross page edges, and the tiny window of 32 starts mid-page), against
    the reference and against the port over pages of 4."""
    _prefill_chunks_case(models, dtype, 48, [[3, 1, 4]])


class _ShapeLog(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_paged_calls_never_build_dense_kv(models):
    """Neither decode_step_paged nor prefill_chunk_paged produces a tensor
    shaped like the dense chronological KV view, flat (B, maxp*page, K, hd)
    or pre-reshape (B, maxp, page, K, hd); the dense oracle does (positive
    control)."""
    _, tm, params = models
    cfg = tm.cfg
    B, maxp, page = 4, 6, 8
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    banned = {(B, maxp * page, K, hd), (B, maxp, page, K, hd)}
    p = params["bf16"][1]
    pool = tm.init_pool(B * maxp + 1, page, device="cpu")
    pt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp) + 1
    i32 = torch.int32
    with _ShapeLog() as log:
        tm.decode_step_paged(p, pool, pt, torch.zeros((B, 1), dtype=i32),
                             torch.tensor([3, 9, 30, 40], dtype=i32))
        tm.prefill_chunk_paged(p, pool, pt, torch.zeros((B, 5), dtype=i32),
                               torch.tensor([0, 8, 20, 40], dtype=i32))
    assert not (log.shapes & banned), log.shapes & banned
    q = torch.zeros((B, cfg.num_heads, hd), dtype=torch.bfloat16)
    pk = pool["sub0"]["k"][0]
    with _ShapeLog() as ctl:
        tref.paged_attention_dense_ref(q, pk, pk, pt,
                                       torch.zeros(B, dtype=torch.int32))
    assert ctl.shapes & banned, "shape scan lost its teeth"
