"""The port's quantized KV pool (src/repro_torch/serving/kvquant and the
quant paths through kernels, models, pool, engine and launcher) against the
reference on tiny gemma2-2b (hd=32, window 32), on the same numpy inputs.

Tolerances. The storage mapping (codes, int4 packing, scales) must be
bit-identical: both packages compute amax/qmax + 1e-12 and round half to
even in fp32. The plain quant walks do the same fp32 arithmetic as the
reference's on the same codes and differ only in summation order: 1e-5.
Whole model calls in fp32 parameters quantize k/v that each package
computed in its own summation order — and the reference, compiled, takes
amax / qmax as amax * (1 / qmax), an ulp away — so a value sitting within
an fp32 rounding of a code boundary may land one code apart (observed:
none or a handful of the ~10^4 codes per call); one int4 step is a
seventh of the
token's largest |k|, so a flipped code may move a logit by about 1e-2.
Codes are held to at most one apart, in at most 1 in 1000 positions, and
logits to 2e-2 (to 2e-4, the bf16 pool's fp32 bound, where every code
agrees).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving import kvquant as j_kvq  # noqa: E402
from repro.serving.engine import pool as j_pool  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving import kvquant as t_kvq  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine, \
    Request  # noqa: E402
from repro_torch.serving.engine import pool as t_pool  # noqa: E402

torch.set_num_threads(1)

WALK_TOL = 1e-5
LOGIT_TOL = 2e-4
LOGIT_FLIP_TOL = 2e-2
CODE_FLIP_SHARE = 1e-3
# the reference's documented greedy-drift bounds for the untrained tiny
# model (tests/test_kvquant.py), and its preemption agreement bound
DRIFT_TOL = {8: 1.0, 4: 1.6}
PREEMPT_MATCH_TOL = 0.9


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
        return a.numpy() if a.dtype == torch.int8 else a.float().numpy()
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _policy(**kw):
    base = dict(hw_name="test", max_model_len=64, page_size=16,
                num_pages=10_000, max_batch=4, prefill_chunk=16,
                quant_bits=16, decode_slo_s=0.03, est_decode_s=0.0,
                est_prefill_s=0.0)
    base.update(kw)
    return AdmissionPolicy(**base)


def _req(rid, S, gen, *, vocab=512):
    rng = np.random.default_rng(rid)
    return Request(rid=rid, prompt=rng.integers(2, vocab, S)
                   .astype(np.int32), max_new=gen)


# ------------------------------------------------------- storage mapping --
@pytest.mark.parametrize("shape", [(3, 8, 2, 32), (2, 16, 4, 256)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("granularity", ["token", "page"])
def test_quantize_kv_bit_identical(shape, bits, granularity):
    """quantize_kv / dequantize_kv: codes (packed for int4), scales and the
    dequantized values equal the reference's, for fp32 and bf16 inputs."""
    rng = np.random.default_rng(bits + shape[-1])
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                   # an all-zero row: scale 1e-12
    for jx, tx in ((jnp.asarray(x), torch.from_numpy(x)),
                   (jnp.asarray(x, jnp.bfloat16),
                    torch.from_numpy(x).bfloat16())):
        jq, js = jref.quantize_kv(jx, bits, granularity=granularity)
        tq, ts = tref.quantize_kv(tx, bits, granularity=granularity)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(_np(tq), _np(jq))
        assert np.array_equal(_np(ts), _np(js))
        assert np.array_equal(
            _np(tref.dequantize_kv(tq, ts, bits, granularity=granularity)),
            _np(jref.dequantize_kv(jq, js, bits, granularity=granularity)))


def test_int4_packing_bit_identical():
    """pack_int4_hd / unpack_int4_hd: every byte value unpacks to the
    reference's sign-extended nibbles, packing equals the reference's, and
    unpack inverts pack."""
    every = np.arange(-128, 128, dtype=np.int8).reshape(8, 32)
    assert np.array_equal(_np(tref.unpack_int4_hd(torch.from_numpy(every))),
                          _np(jref.unpack_int4_hd(jnp.asarray(every))))
    codes = np.random.default_rng(0).integers(-7, 8, (3, 5, 2, 32)) \
        .astype(np.int8)
    packed = tref.pack_int4_hd(torch.from_numpy(codes))
    assert packed.shape == (3, 5, 2, 16) and packed.dtype == torch.int8
    assert np.array_equal(_np(packed), _np(jref.pack_int4_hd(
        jnp.asarray(codes))))
    assert np.array_equal(_np(tref.unpack_int4_hd(packed)), codes)


def test_kv_bits_of_matches_reference():
    for minor, bits in ((32, 8), (16, 4)):
        t = torch.zeros((2, 4, 1, minor), dtype=torch.int8)
        assert tref.kv_bits_of(t, 32) == bits == \
            jref.kv_bits_of(jnp.zeros((2, 4, 1, minor), jnp.int8), 32)
    with pytest.raises(ValueError):
        tref.kv_bits_of(torch.zeros((2, 4, 1, 8), dtype=torch.int8), 32)
    with pytest.raises(ValueError):
        tref.kv_qmax(5)


# ------------------------------------------------------------ the walks ---
def _quant_case(B, Sq, H, K, hd, page, n_blocks, bits, *, num_pages=11,
                seed=0):
    """Quantized pools (numpy, the reference's codes) with scratch page 0's
    codes AND scales poisoned, ragged chunk starts, shuffled pages and
    scratch-page tails."""
    rng = np.random.default_rng(seed)
    fk = rng.standard_normal((num_pages, page, K, hd)).astype(np.float32)
    fv = rng.standard_normal((num_pages, page, K, hd)).astype(np.float32)
    kq, ks = (np.array(a) for a in jref.quantize_kv(jnp.asarray(fk), bits))
    vq, vs = (np.array(a) for a in jref.quantize_kv(jnp.asarray(fv), bits))
    kq[0], vq[0] = 55, -55
    ks[0], vs[0] = 97.0, 83.0
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    positions = rng.integers(0, n_blocks * page - Sq + 1, B).astype(np.int32)
    positions[0] = 0
    pt = np.zeros((B, n_blocks), np.int32)
    for b in range(B):
        need = min((positions[b] + Sq - 1) // page + 1, n_blocks)
        pt[b, :need] = rng.choice(np.arange(1, num_pages), need,
                                  replace=False)
    return q, kq, ks, vq, vs, pt, positions


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(a) for a in args])


def _max_err(a, b):
    return float(np.max(np.abs(_np(a) - _np(b))))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (24, 0.0), (0, 30.0)])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_quant_walks_match_reference(bits, window, cap, kind):
    """paged_attention_quant_ref (decode, page 8) and
    paged_prefill_quant_ref (Sq=5 chunks, page 16): port == reference walk
    on the same codes, across bitwidths, windows and softcaps, with ragged
    positions, GQA and the poisoned scratch page; the port's dense oracle
    over the dequantized pool agrees too."""
    if kind == "decode":
        case = _quant_case(3, 1, 4, 2, 32, 8, 6, bits)
        case = (case[0][:, 0],) + case[1:]
        jfn, tfn = jref.paged_attention_quant_ref, \
            tref.paged_attention_quant_ref
        dense = tref.paged_attention_dense_ref
    else:
        case = _quant_case(3, 5, 4, 2, 32, 16, 4, bits, seed=1)
        jfn, tfn = jref.paged_prefill_quant_ref, tref.paged_prefill_quant_ref
        dense = tref.paged_prefill_dense_ref
    (jq, jkq, jks, jvq, jvs, jt, jp), (tq, tkq, tks, tvq, tvs, tt, tp) = \
        _both(case)
    want = jfn(jq, jkq, jks, jvq, jvs, jt, jp, window=window, cap=cap)
    got = tfn(tq, tkq, tks, tvq, tvs, tt, tp, window=window, cap=cap)
    oracle = dense(tq, tref.dequantize_kv(tkq, tks, bits),
                   tref.dequantize_kv(tvq, tvs, bits), tt, tp,
                   window=window, cap=cap)
    assert _max_err(got, want) < WALK_TOL
    assert _max_err(oracle, want) < WALK_TOL


@pytest.mark.parametrize("kind,bits", [("decode", 4), ("prefill", 8)])
def test_quant_walks_match_pallas_interpret(kind, bits):
    """One case of each reference Pallas fused-dequant kernel, run in
    interpret mode, against the port's wrapper on CPU tensors (its plain
    walk), with window and softcap."""
    if kind == "decode":
        case = _quant_case(3, 1, 4, 2, 32, 16, 4, bits, seed=2)
        case = (case[0][:, 0],) + case[1:]
        jfn, tfn = jpa.paged_attention_quant_fwd, tpa.paged_attention_quant_fwd
    else:
        case = _quant_case(2, 5, 4, 2, 32, 8, 6, bits, seed=4)
        jfn, tfn = jpa.paged_prefill_quant_fwd, tpa.paged_prefill_quant_fwd
    jargs, targs = _both(case)
    want = jfn(*jargs, window=24, cap=30.0, interpret=True)
    got = tfn(*targs, window=24, cap=30.0)
    assert _max_err(got, want) < WALK_TOL


def test_quant_dispatch_modes_on_cpu():
    """"auto" and "ref" agree on CPU tensors for both quant entry points;
    "cuda" refuses CPU tensors; no launch is counted."""
    q, kq, ks, vq, vs, pt, pos = (torch.from_numpy(a) for a in _quant_case(
        2, 4, 4, 2, 32, 8, 4, 4))
    tpa.reset_launches()
    for fn, qq in ((tops.paged_attention_quant, q[:, 0]),
                   (tops.paged_attention_prefill_quant, q)):
        auto = fn(qq, kq, ks, vq, vs, pt, pos, window=24, mode="auto")
        plain = fn(qq, kq, ks, vq, vs, pt, pos, window=24, mode="ref")
        assert torch.equal(auto, plain)
        with pytest.raises(ValueError, match="cuda"):
            fn(qq, kq, ks, vq, vs, pt, pos, mode="cuda")
    assert not any(tpa.LAUNCHES.values())


# ---------------------------------------------------- pool and writers ----
@pytest.mark.parametrize("kv_bits", [None, 16, 8, 4, (4, 8), {"sub0": 8}])
def test_pool_specs_match_reference(models, kv_bits):
    """pool_specs: every slot's layout (bf16 pages, or int8 codes of width
    hd or hd/2 plus fp32 (.., page, K) scales) equals the reference's."""
    jm, tm, _ = models
    want = jm.pool_specs(9, 16, kv_bits=kv_bits)
    got = tm.pool_specs(9, 16, kv_bits=kv_bits)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {tuple(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(
                  got, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert len(flat_w) == len(flat_g)
    for path, spec in flat_w:
        shape, dtype = flat_g[tuple(str(getattr(k, "key", k))
                                    for k in path)]
        assert tuple(spec.shape) == shape
        assert np.dtype(spec.dtype).name == str(dtype).split(".")[-1]
    pool = tm.init_pool(9, 16, kv_bits=kv_bits, device="cpu")
    assert all(not t.any() for t in tree_leaves(pool))


def test_write_prefill_quantizes_like_reference(models):
    """PagedKVPool.write_prefill on a mixed (int4 local, int8 global) pool,
    whole-prompt and page-aligned span writes: every written page holds
    exactly the reference mapping's codes and scales
    (``repro.kernels.ref.quantize_kv`` on the page-shaped cache), and
    matches the reference writer itself within that writer's own contract.
    The reference writer runs compiled, and XLA evaluates amax / qmax there
    as amax * (1 / qmax): a scale may sit one fp32 ulp away, and a code
    at a rounding tie one step away."""
    jm, tm, _ = models
    cfg = jm.cfg
    page = 4
    jp = j_pool.PagedKVPool(jm, 12, page, kv_bits=(4, 8))
    tp = t_pool.PagedKVPool(tm, 12, page, device="cpu", kv_bits=(4, 8))
    rng = np.random.default_rng(0)
    shape = (cfg.num_layers // 2, 1, 10, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    written = {}
    for pages, start in (([3, 7, 2], 0), ([3, 7, 2, 9, 5], 8)):
        cache = {f"sub{j}": {kv: np.asarray(jnp.asarray(
            rng.standard_normal(shape) * 2, jnp.bfloat16)) for kv in "kv"}
            for j in range(2)}
        jp.write_prefill(jax.tree.map(jnp.asarray, cache), pages,
                         start=start)
        tp.write_prefill(from_jax_params(cache), pages, start=start)
        span = pages[start // page:]
        for j in range(2):
            for kv in "kv":
                c = cache[f"sub{j}"][kv][:, 0].astype(np.float32)
                c = np.pad(c, ((0, 0), (0, len(span) * page - c.shape[1]),
                               (0, 0), (0, 0)))
                c = c.reshape(c.shape[0], len(span), page, *c.shape[2:])
                for i, p in enumerate(span):
                    written[(j, kv, p)] = c[:, i]
    for j, bits in ((0, 4), (1, 8)):
        for kv in "kv":
            jl, tl = jp.pool[f"sub{j}"][kv], tp.pool[f"sub{j}"][kv]
            assert tl["q"].shape[-1] == (32 if bits == 8 else 16)
            for p in (3, 7, 2, 9, 5):
                want_q, want_s = jref.quantize_kv(
                    jnp.asarray(written[(j, kv, p)]), bits)
                assert np.array_equal(_np(tl["q"][:, p]), _np(want_q))
                assert np.array_equal(_np(tl["scale"][:, p]), _np(want_s))
            ts, js = _np(tl["scale"]), _np(jl["scale"])
            assert np.all(np.abs(ts - js) <= 2.0 ** -23 * np.abs(js))
            tc, jc = _np(tl["q"]), _np(jl["q"])
            if bits == 4:
                tc = _np(tref.unpack_int4_hd(tl["q"]))
                jc = np.asarray(jref.unpack_int4_hd(jl["q"]))
            d = np.abs(tc.astype(np.int16) - jc.astype(np.int16))
            assert d.max() <= 1
            assert not d[ts == js].any()


def _quant_pool_state(cfg, num_pages, page, kv_bits, seed):
    """A random pool, quantized by the reference's mapping (numpy)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers // 2, num_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    fp = {f"sub{j}": {kv: jnp.asarray(rng.standard_normal(shape),
                                      jnp.bfloat16) for kv in "kv"}
          for j in range(2)}
    return jax.tree.map(np.asarray, j_kvq.quantize_pool(fp, cfg, kv_bits))


def _check_call(got, want, tpool, jpool):
    """Logits and the written pools, with the code-flip rule of the module
    docstring."""
    flips = total = 0
    for leaf_t, leaf_j in zip(tree_leaves(tpool),
                              jax.tree.leaves(jpool)):
        a, b = _np(leaf_t), _np(leaf_j)
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int16) - b.astype(np.int16))
            if b.shape[-1] * 2 == 32:          # packed int4: each nibble
                d = np.abs(_np(tref.unpack_int4_hd(leaf_t)).astype(np.int16)
                           - np.asarray(jref.unpack_int4_hd(
                               jnp.asarray(b))).astype(np.int16))
            d = d[:, 1:]                        # past the scratch page
            assert d.max() <= 1
            flips += int((d > 0).sum())
            total += d.size
    assert flips <= CODE_FLIP_SHARE * total, (flips, total)
    err = _max_err(got, want)
    assert err < (LOGIT_TOL if flips == 0 else LOGIT_FLIP_TOL), (err, flips)


@pytest.mark.parametrize("kv_bits", [8, 4, (4, 8)])
def test_decode_step_on_quantized_pool_matches(models, kv_bits):
    """decode_step_paged (fp32 parameters) on an int8, int4 and mixed pool
    at positions before, at and past the tiny window: logits and the
    quantize-on-write codes against the reference on the same pool."""
    jm, tm, params = models
    cfg = jm.cfg
    page, n_blocks, B = 8, 10, 4
    num_pages = B * n_blocks + 1
    pool = _quant_pool_state(cfg, num_pages, page, kv_bits, seed=1)
    positions = np.array([5, 31, 33, 70], np.int32)
    rng = np.random.default_rng(2)
    pt = np.zeros((B, n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        need = positions[b] // page + 1
        pt[b, :need] = perm[b * n_blocks:b * n_blocks + need]
    tok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)
    jpr, tpr = params["fp32"]
    want, jpool = jm.decode_step_paged(
        jpr, jax.tree.map(jnp.asarray, pool), jnp.asarray(pt),
        jnp.asarray(tok), jnp.asarray(positions), kernel="ref")
    got, tpool = tm.decode_step_paged(
        tpr, from_jax_params(pool), torch.from_numpy(pt),
        torch.from_numpy(tok), torch.from_numpy(positions))
    _check_call(got, want, tpool, jpool)


@pytest.mark.parametrize("kv_bits", [8, 4, (4, 8)])
def test_prefill_chunks_on_quantized_pool_match(models, kv_bits):
    """A 20-token prompt in chunks of 8 over a 20-slot table (the third
    chunk padded past it) through prefill_chunk_paged on an int8, int4 and
    mixed pool: every chunk's last real row and the final pool."""
    jm, tm, params = models
    cfg = jm.cfg
    page, C, S = 4, 8, 20
    pool = _quant_pool_state(cfg, 8, page, kv_bits, seed=3)
    pt = np.array([[3, 1, 6, 2, 5]], np.int32)
    prompt = np.random.default_rng(4).integers(2, cfg.vocab_size, S) \
        .astype(np.int32)
    jpr, tpr = params["fp32"]
    jp, tp = jax.tree.map(jnp.asarray, pool), from_jax_params(pool)
    want, got = [], []
    for start in range(0, S, C):
        toks = np.zeros((1, C), np.int32)
        toks[0, :min(C, S - start)] = prompt[start:start + C]
        last = min(C, S - start) - 1
        h, jp = jm.prefill_chunk_paged(
            jpr, jp, jnp.asarray(pt), jnp.asarray(toks),
            jnp.asarray([start], jnp.int32), kernel="ref")
        want.append(np.asarray(jm.unembed(jpr, h[:, last:last + 1])))
        h, tp = tm.prefill_chunk_paged(
            tpr, tp, torch.from_numpy(pt), torch.from_numpy(toks),
            torch.tensor([start], dtype=torch.int32))
        got.append(tm.unembed(tpr, h[:, last:last + 1]).numpy())
    _check_call(np.stack(got), np.stack(want), tp, jp)


@pytest.mark.parametrize("kv_bits", [None, (4, 8)])
def test_teacher_forced_logits_match_reference(models, kv_bits):
    """kvquant.teacher_forced_logits (fp32 parameters): the port's replay
    through its bf16 or mixed pool against the reference's."""
    jm, tm, params = models
    tokens = np.random.default_rng(5).integers(2, 512, 30).astype(np.int32)
    jpr, tpr = params["fp32"]
    want = j_kvq.teacher_forced_logits(jm, jpr, tokens, 24, kv_bits=kv_bits,
                                       kernel="ref")
    got = t_kvq.teacher_forced_logits(tm, tpr, tokens, 24, kv_bits=kv_bits)
    assert got.shape == want.shape == (6, 512)
    assert _max_err(got, want) < (LOGIT_TOL if kv_bits is None
                                  else LOGIT_FLIP_TOL)


# ----------------------------------------------------------------- engine --
@pytest.mark.parametrize("kv_bits", [8, (4, 8)])
def test_chunk_size_does_not_change_quantized_outputs(models, kv_bits):
    """The reference's contract on quantized pools: many small chunks and
    one whole-prompt chunk give the same greedy tokens, since per-token
    scales never re-scale a resident token."""
    _, tm, params = models
    tp = params["bf16"][1]
    reqs = [_req(0, 37, 6), _req(1, 22, 5)]
    outs = {}
    for name, chunk in (("small", 8), ("whole", 64)):
        engine = Engine(tm, tp, _policy(prefill_chunk=chunk,
                                        kv_bits=kv_bits))
        outs[name] = engine.run([_req(r.rid, len(r.prompt), r.max_new)
                                 for r in reqs])
        assert engine.kv.allocator.num_allocated == 0
    for r in reqs:
        assert np.array_equal(outs["small"][r.rid], outs["whole"][r.rid]), \
            r.rid


@pytest.mark.parametrize("kv_bits", [(8,), (4, 8)])
def test_engine_quantized_drift_bounded(models, kv_bits):
    """The engine on an int8 and a mixed pool serves with clean
    bookkeeping, and its greedy stream's teacher-forced logit drift
    against the port's own bf16 pool stays under the reference's bound."""
    _, tm, params = models
    tp = params["bf16"][1]
    reqs = [_req(0, 8, 6), _req(1, 12, 5)]
    engine = Engine(tm, tp, _policy(kv_bits=kv_bits))
    outs = engine.run(reqs)
    assert engine.kv_bits == ((8, 8) if kv_bits == (8,) else kv_bits)
    assert isinstance(engine.kv.pool["sub0"]["k"], dict)
    assert engine.kv.allocator.num_allocated == 0
    for r in reqs:
        assert outs[r.rid].shape == (len(r.prompt) + r.max_new,)
    rep = t_kvq.greedy_drift(tm, tp, outs[0], len(reqs[0].prompt),
                             kv_bits=kv_bits)
    assert np.isfinite(rep["max_abs"])
    assert rep["max_abs"] <= DRIFT_TOL[min(kv_bits)], rep["max_abs"]


def test_engine_quantized_preemption_roundtrip(models):
    """An int8-pool run survives forced preemption and requeue: tokens
    before the preemption are kept verbatim as the prompt's extension, and
    per-token agreement with the unpressured run stays above the
    reference's bound (the re-prefilled KV is quantized afresh)."""
    _, tm, params = models
    tp = params["bf16"][1]
    reqs = [_req(0, 12, 44), _req(1, 12, 44)]
    pre = Engine(tm, tp, _policy(max_batch=2, num_pages=7, kv_bits=(8,)))
    outs_pre = pre.run(reqs)
    assert pre.stats["preemptions"] >= 1
    assert pre.kv.allocator.num_allocated == 0
    no = Engine(tm, tp, _policy(max_batch=2, kv_bits=(8,)))
    outs_no = no.run(reqs)
    assert no.stats["preemptions"] == 0
    match = total = 0
    for r in reqs:
        S = len(r.prompt)
        a, b = outs_no[r.rid][S:], outs_pre[r.rid][S:]
        assert a.shape == b.shape == (44,)
        match += int(np.sum(a == b))
        total += len(a)
    assert match / total >= PREEMPT_MATCH_TOL, (match, total)


class _FloatShapeLog(TorchDispatchMode):
    """Records the shape of every floating-point tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("kv_bits", [(8,), (4, 8)])
def test_quant_decode_never_builds_dense_fp_kv(models, kv_bits):
    """Quantized decode builds neither the chronological dense fp KV view
    nor a whole-pool fp dequantization — only per-block (B, page, K, hd)
    tiles; dequantizing a whole pool trips the same scan (positive
    control)."""
    _, tm, params = models
    cfg = tm.cfg
    B, maxp, page, P = 4, 4, 16, 9
    K, hd, G = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers // 2
    banned = {(B, maxp * page, K, hd), (B, maxp, page, K, hd),
              (P, page, K, hd), (G, P, page, K, hd)}
    pool = tm.init_pool(P, page, kv_bits=kv_bits, device="cpu")
    i32 = torch.int32
    pt = torch.zeros((B, maxp), dtype=i32)
    with _FloatShapeLog() as log:
        tm.decode_step_paged(params["bf16"][1], pool, pt,
                             torch.zeros((B, 1), dtype=i32),
                             torch.zeros((B,), dtype=i32))
    assert not (log.shapes & banned), log.shapes & banned
    leaf = pool["sub1"]["k"]
    with _FloatShapeLog() as ctl:
        tref.dequantize_kv(leaf["q"][0], leaf["scale"][0], 8)
    assert ctl.shapes & banned, "shape scan lost its teeth"


# --------------------------------------------------------------- launcher --
def test_serve_kv_flags_on_cpu(tmp_path, capsys):
    """--kv-policy (json) and --kv-bits serve the trace on the CPU, and the
    admission line names the policy as derive_policy keeps it; 'haq'
    searches the bits and serves on them; both flags are refused with
    --sequential."""
    from repro_torch.launch import serve
    policy = tmp_path / "kv.json"
    policy.write_text(json.dumps({"sub0": 4, "sub1": 8}))
    base = ["--arch", "gemma2-2b", "--tiny", "--device", "cpu",
            "--requests", "3", "--prompt-len", "12", "--gen", "4",
            "--max-batch", "2", "--prefill-chunk", "8"]
    for flags, want in ((["--kv-policy", str(policy)], "kv=(4, 8)"),
                        (["--kv-bits", "8"], "kv=(8,)")):
        serve.main(base + flags)
        out = capsys.readouterr().out
        assert want in out and "served 3 requests, 12 tokens" in out
    serve.main(base + ["--kv-policy", "haq"])
    out = capsys.readouterr().out
    assert "kvquant[haq]: {'kv_sub0': 4, 'kv_sub1': 8}" in out
    assert "kv=(4, 8)" in out and "served 3 requests, 12 tokens" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--sequential", "--kv-bits", "8"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--kv-bits", "5"])
