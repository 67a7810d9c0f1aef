"""HAQ weight-quantized serving in the port against the reference, on the
same numpy inputs: the weight/activation quantizers and the plain
quantized matmuls (kernels/ref.py), their dispatch (kernels/ops.py), the
quantizers and the ``dot`` hook of core/quantization.py, stored weights
and ``dequant_dot`` (serving/quant.py), tiny gemma2-2b through the hook,
the engine at ``quant_bits`` 8 and 4, and the ``--quant-policy`` CLI.

Tolerances:
  * codes and scales against the reference's eager functions: bit for bit
    (the same fp32 operations in the same order, rounding half to even);
  * plain products against ``repro.kernels.ref`` and against the Pallas
    kernels in interpret mode: 1e-5 of max |ref| in fp32 (the same fp32
    arithmetic in other summation orders); W8A8 int32 accumulators exact;
  * model logits as tests/test_torch_models.py holds them: fp32 parameters
    to FP32_LOGIT_TOL; bf16 parameters to twice the reference's own
    bf16-vs-fp32 gap on the same inputs, floored at 2e-2. The fp32
    parameters are the bf16 ones cast up, so both quantize to the same
    codes and scales.
  * the engine against the port's own generate, greedy: the same tokens
    up to a near tie, where the teacher-forced top-2 margin must be within
    ROW_TOL.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving import quant as jsq  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_matmul as tqmm  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving import quant as tsq  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine, \
    Request  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-5
FP32_LOGIT_TOL = 2e-4
BF16_FLOOR = 2e-2
ROW_TOL = 0.25


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or \
        a.dtype.name == "bfloat16" else a


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------ quantizers --
@pytest.mark.parametrize("K,N", [(64, 32), (256, 128), (96, 384)])
def test_weight_and_act_quantizers_bit_identical(K, N):
    w = _rand((K, N), 0)
    for name in ("quantize_w8", "quantize_w4_packed"):
        jcodes, jscale = getattr(jref, name)(jnp.asarray(w))
        tcodes, tscale = getattr(tref, name)(torch.from_numpy(w))
        assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
        assert np.array_equal(tcodes.numpy(), np.asarray(jcodes)), name
        assert np.array_equal(tscale.numpy(), np.asarray(jscale)), name
    packed = jref.quantize_w4_packed(jnp.asarray(w))[0]
    assert np.array_equal(
        tref.unpack_w4(torch.from_numpy(np.asarray(packed))).numpy(),
        np.asarray(jref.unpack_w4(packed)))
    x = _rand((7, K), 1, scale=3.0)
    jxq, jxs = jref.quantize_a8(jnp.asarray(x))
    txq, txs = tref.quantize_a8(torch.from_numpy(x))
    assert np.array_equal(txq.numpy(), np.asarray(jxq))
    assert txs.shape == () and float(txs) == float(jxs)


def test_int4_packing_runs_along_k():
    """Row 2i rides the low nibble and 2i+1 the high one, both negative
    codes included (a byte whose two nibbles are negative)."""
    w = torch.tensor([[-1.0, 7.0], [-7.0, -3.0], [0.0, 1.0], [7.0, -7.0]])
    packed, scale = tref.quantize_w4_packed(w)
    assert packed.shape == (2, 2)
    codes = torch.round(w / scale).to(torch.int8)
    assert torch.equal(tref.unpack_w4(packed), codes)
    assert int(packed[0, 0]) & 0x0F == int(codes[0, 0]) & 0x0F
    assert (int(packed[0, 0]) >> 4) & 0x0F == int(codes[1, 0]) & 0x0F


def _products(M, K, N, seed):
    x = _rand((M, K), seed)
    w = _rand((K, N), seed + 1)
    q8, s8 = jref.quantize_w8(jnp.asarray(w))
    q4, s4 = jref.quantize_w4_packed(jnp.asarray(w))
    xq, xs = jref.quantize_a8(jnp.asarray(x))
    return x, [np.asarray(a) for a in (q8, s8, q4, s4, xq, xs)]


@pytest.mark.parametrize("M,K,N", [(8, 128, 64), (24, 512, 256)])
def test_plain_products_match_reference_and_pallas(M, K, N):
    """The port's plain W8A16/W4A16/W8A8 against repro.kernels.ref and the
    Pallas kernels in interpret mode (fp32 x); the W8A8 int32 accumulator
    exactly."""
    x, (q8, s8, q4, s4, xq, xs) = _products(M, K, N, seed=M)
    J = {k: jnp.asarray(v) for k, v in dict(x=x, q8=q8, s8=s8, q4=q4,
                                            s4=s4, xq=xq, xs=xs).items()}
    T = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(x=x, q8=q8, s8=s8, q4=q4, s4=s4, xq=xq, xs=xs).items()}
    cases = [
        (tref.quant_matmul_w8a16(T["x"], T["q8"], T["s8"]),
         jref.quant_matmul_w8a16(J["x"], J["q8"], J["s8"]),
         jqmm.quant_matmul_w8a16(J["x"], J["q8"], J["s8"], interpret=True)),
        (tref.quant_matmul_w4a16(T["x"], T["q4"], T["s4"]),
         jref.quant_matmul_w4a16(J["x"], J["q4"], J["s4"]),
         jqmm.quant_matmul_w4a16(J["x"], J["q4"], J["s4"], interpret=True)),
        (tref.quant_matmul_w8a8(T["xq"], T["xs"], T["q8"], T["s8"],
                                torch.float32),
         jref.quant_matmul_w8a8(J["xq"], J["xs"], J["q8"], J["s8"],
                                jnp.float32),
         jqmm.quant_matmul_w8a8(J["xq"], J["xs"], J["q8"], J["s8"],
                                out_dtype=jnp.float32, interpret=True)),
    ]
    for got, want_ref, want_pallas in cases:
        assert got.dtype == torch.float32 and got.shape == (M, N)
        assert _rel(got, want_ref) < TOL
        assert _rel(got, want_pallas) < TOL
    acc = jnp.einsum("mk,kn->mn", J["xq"].astype(jnp.int32),
                     J["q8"].astype(jnp.int32))
    assert np.array_equal(tref.w8a8_accumulator(T["xq"], T["q8"]).numpy(),
                          np.asarray(acc))


@pytest.mark.parametrize("w_bits,a_bits", [(4, 16), (8, 16), (8, 8)])
@pytest.mark.parametrize("lead", [(5,), (2, 13)])
def test_ops_quant_matmul_matches_reference(w_bits, a_bits, lead):
    """ops.quant_matmul (on-the-fly quantization, kernel choice, ragged
    rows) against the reference's, whose Pallas kernels run in interpret
    mode on padded rows."""
    x = _rand(lead + (128,), 3)
    w = _rand((128, 192), 4, scale=0.05)
    want = jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), w_bits=w_bits,
                             a_bits=a_bits, bn=64, bk=64)
    for mode in ("auto", "ref"):
        got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                w_bits=w_bits, a_bits=a_bits, mode=mode)
        assert got.shape == lead + (192,)
        assert _rel(got, want) < TOL
    with pytest.raises(ValueError):
        tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          mode="cuda")


def test_prepared_weights_match_reference():
    x = _rand((3, 128), 5)
    w = _rand((128, 64), 6)
    for w_bits, a_bits in ((4, 16), (8, 16), (8, 8)):
        jw = jops.prepare_quantized(jnp.asarray(w), w_bits)
        tw = tops.prepare_quantized(torch.from_numpy(w), w_bits)
        assert np.array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
        assert int(tw["bits"]) == int(jw["bits"])
        want = jops.quant_matmul_prepared(jnp.asarray(x), jw, a_bits=a_bits)
        got = tops.quant_matmul_prepared(torch.from_numpy(x), tw,
                                         a_bits=a_bits)
        assert _rel(got, want) < TOL


def test_cpu_wrappers_take_the_plain_version():
    """On CPU tensors the kernel wrappers return their plain versions and
    launch nothing."""
    x, (q8, s8, q4, s4, xq, xs) = _products(5, 64, 64, seed=9)
    before = dict(tqmm.LAUNCHES)
    T = [torch.from_numpy(np.array(a)) for a in (q8, s8, q4, s4, xq, xs)]
    xt = torch.from_numpy(x)
    assert torch.equal(tqmm.quant_matmul_w8a16(xt, T[0], T[1]),
                       tref.quant_matmul_w8a16(xt, T[0], T[1]))
    assert torch.equal(tqmm.quant_matmul_w4a16(xt, T[2], T[3]),
                       tref.quant_matmul_w4a16(xt, T[2], T[3]))
    assert torch.equal(tqmm.quant_matmul_w8a8(T[4], T[5], T[0], T[1]),
                       tref.quant_matmul_w8a8(T[4], T[5], T[0], T[1]))
    assert tqmm.LAUNCHES == before == {"quant_matmul_w8a16": 0,
                                       "quant_matmul_w4a16": 0,
                                       "quant_matmul_w8a8": 0}


# ------------------------------------------------------ core.quantization --
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("axis", [-1, 0])
def test_core_quantizers_match_reference(bits, axis):
    w = _rand((48, 32), 7, scale=0.1)
    x = _rand((6, 32), 8, scale=4.0)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    assert float(tq.qmax(bits)) == float(jq.qmax(bits))
    (jqv, jsc), (tqv, tsc) = (jq.quantize_weight(jw, bits, axis=axis),
                              tq.quantize_weight(tw, bits, axis=axis))
    assert np.array_equal(tqv.numpy(), np.asarray(jqv))
    assert np.array_equal(tsc.numpy(), np.asarray(jsc))
    assert np.array_equal(tq.fake_quant_weight(tw, bits, axis=axis).numpy(),
                          np.asarray(jq.fake_quant_weight(jw, bits,
                                                          axis=axis)))
    assert np.array_equal(
        tq.fake_quant_act(torch.from_numpy(x), bits).numpy(),
        np.asarray(jq.fake_quant_act(jnp.asarray(x), bits)))
    assert abs(float(tq.quant_error(tw, bits, axis=axis))
               - float(jq.quant_error(jw, bits, axis=axis))) < 1e-6


@pytest.fixture(scope="module")
def models():
    """Tiny gemma2-2b in both packages: the reference's parameters in bf16
    and cast up to fp32 (the same values, so the same codes)."""
    jm = j_build(j_tiny("gemma2-2b"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = t_build(t_tiny("gemma2-2b"))
    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jpd = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.bfloat16
                           else a, jp)
        out[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
    return jm, tm, out


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


def test_site_matching_and_weight_policy_match_reference(models):
    jm, tm, params = models
    jp, tp = params["fp32"]
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = list(_paths(tp))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [tq.keystr(p) for p, _ in tflat]
    for (p, _), _ in zip(tflat, jflat):
        ks = tq.keystr(p)
        assert tq.default_site_of(ks, None) == jq.default_site_of(ks, None)
    policy = {"ffn_in": 4, "attn_q": 8, "lm_head": 2}
    jout = jq.apply_weight_policy(jp, policy, jq.default_site_of)
    tout = tq.apply_weight_policy(tp, policy, tq.default_site_of)
    for a, b in zip(tree_leaves(tout), jax.tree.leaves(jout)):
        assert np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("xs,ws", [((2, 3, 16), (16, 8)),
                                   ((2, 3, 4, 8), (4, 8, 16)),
                                   ((4, 5, 16), (4, 16, 8)),
                                   ((2, 3, 16), (16, 4, 8))])
def test_einsum_for_matches_reference(xs, ws):
    x, w = np.zeros(xs, np.float32), np.zeros(ws, np.float32)
    assert tq._einsum_for(torch.from_numpy(x), torch.from_numpy(w)) == \
        jq._einsum_for(jnp.asarray(x), jnp.asarray(w))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_make_quant_dot_matches_reference(use_kernel):
    """The hook site by site — unquantized, full precision, fake-quant,
    W8A16/W4A16/W8A8 kernels, and a 3-D projection (always fake-quant) —
    against the reference's hook on the same inputs; then the reference's
    own end-to-end check (tests/test_kernels.py), ported: W8A16 through
    the kernel stays within 1e-3 of fake-quant."""
    policy = {"a": (8, 16), "b": (4, 16), "c": (8, 8), "d": (16, 16),
              "e": (4, 4), "f": (8, 16)}
    jdot = jq.make_quant_dot(policy, use_kernel=use_kernel)
    tdot = tq.make_quant_dot(policy, use_kernel=use_kernel)
    x = _rand((2, 5, 64), 10)
    w = _rand((64, 128), 11, scale=0.05)
    w3 = _rand((64, 4, 16), 12, scale=0.05)
    for name in ("a", "b", "c", "d", "e", "zz"):
        want = jdot(jnp.asarray(x), jnp.asarray(w), name)
        got = tdot(torch.from_numpy(x), torch.from_numpy(w), name)
        assert _rel(got, want) < TOL, name
    want = jdot(jnp.asarray(x), jnp.asarray(w3), "f")
    got = tdot(torch.from_numpy(x), torch.from_numpy(w3), "f")
    assert got.shape == (2, 5, 4, 16) and _rel(got, want) < TOL
    # tests/test_kernels.py::test_quant_dot_hook_end_to_end, ported
    xk = torch.from_numpy(_rand((4, 16, 128), 0))
    wk = torch.from_numpy(_rand((128, 256), 1, scale=0.05))
    got = tq.make_quant_dot({"site": (8, 16)}, use_kernel=True)(xk, wk,
                                                                "site")
    want = tq.make_quant_dot({"site": (8, 16)})(xk, wk, "site")
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        < 1e-3


# ---------------------------------------------------------- serving.quant --
def _defs_leaves(tree, path=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_defs_leaves(tree[k], path + (k,)))
    else:
        out[path] = tree
    return out


@pytest.mark.parametrize("bits,policy", [(8, None), (4, None),
                                         (8, {"ffn_in": 4, "lm_head": 16}),
                                         (4, {"attn_q": 4, "ffn_out": 8})])
def test_quantize_defs_and_avg_bits_match_reference(models, bits, policy):
    jm, tm, _ = models
    jd = jsq.quantize_defs(jm.defs, policy=policy, default_bits=bits)
    td = tsq.quantize_defs(tm.defs, policy=policy, default_bits=bits)
    jl = {tuple(str(getattr(k, "key", k)) for k in p): v
          for p, v in jax.tree_util.tree_flatten_with_path(
              jd, is_leaf=lambda x: hasattr(x, "shape"))[0]}
    tl = _defs_leaves(td)
    assert set(jl) == set(tl)
    for k, jv in jl.items():
        assert tuple(tl[k].shape) == tuple(jv.shape), k
        assert str(tl[k].dtype).split(".")[-1] == \
            jnp.dtype(jv.dtype).name, k
    assert abs(tsq.avg_weight_bits(td) - jsq.avg_weight_bits(jd)) < 1e-9


@pytest.mark.parametrize("bits,policy", [(8, None), (4, None),
                                         (4, {"ffn_in": 8, "attn_o": 4})])
def test_quantize_params_bit_identical(models, bits, policy):
    """Stored codes (int8, or int4 packed along the contracting dim) and
    per-layer / per-tensor scales, leaf for leaf."""
    jm, tm, params = models
    jp, tp = params["bf16"]
    jout = jsq.quantize_params(jp, policy=policy, default_bits=bits)
    tout = tsq.quantize_params(tp, policy=policy, default_bits=bits)
    jflat = jax.tree_util.tree_flatten_with_path(jout)[0]
    tflat = list(_paths(tout))
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [tq.keystr(p) for p, _ in tflat]
    n_quant = 0
    for (_, a), (_, b) in zip(tflat, jflat):
        assert tuple(a.shape) == b.shape
        assert np.array_equal(_np(a), _np(b))
        n_quant += a.dtype == torch.int8
    assert n_quant > 0
    wq = tout["blocks"]["sub0"]["attn"]["wq"]
    assert "q" in wq and wq["scale"].shape == (tp["blocks"]["sub0"]["attn"]
                                               ["wq"].shape[0], 1)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_dot_matches_reference(models, bits):
    """dequant_dot (CPU: the reference's dequantize-then-einsum) on every
    kind of site: 2-D (int8 or packed int4), qkv and output projections
    (int8), and a non-dict weight; "ref" and "auto" agree on the CPU."""
    jm, tm, params = models
    jp, tp = params["fp32"]
    jqp = jsq.quantize_params(jp, default_bits=bits)
    tqp = tsq.quantize_params(tp, default_bits=bits)
    cfg = jm.cfg
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    x = _rand((2, 3, d), 13)
    o = _rand((2, 3, H, hd), 14)
    blk_j = jax.tree.map(lambda a: a[1], jqp["blocks"]["sub0"])
    blk_t = jax.tree.map(lambda a: a[1], tqp["blocks"]["sub0"])
    cases = [(x, ("ffn", "w_in")), (x, ("attn", "wq")), (o, ("attn", "wo")),
             (_rand((2, 3, cfg.d_ff), 15), ("ffn", "w_out"))]
    for xx, (a, b) in cases:
        want = jsq.dequant_dot(jnp.asarray(xx), blk_j[a][b], "s")
        for dot in (tsq.dequant_dot, tsq.make_dequant_dot("ref")):
            got = dot(torch.from_numpy(xx), blk_t[a][b], "s")
            assert got.shape == want.shape and _rel(got, want) < TOL, (a, b)
    emb = tp["embed"].T
    assert torch.equal(tsq.dequant_dot(torch.from_numpy(x), emb, "lm_head"),
                       torch.einsum("...d,df->...f", torch.from_numpy(x),
                                    emb))
    with pytest.raises(ValueError):
        tsq.make_dequant_dot("cuda")(torch.from_numpy(x),
                                     blk_t["ffn"]["w_in"], "s")


# ------------------------------------------------------------------ model --
def _check_logits(got, want, dtype, want_fp32=None):
    """``want_fp32`` (the reference in fp32 parameters) is needed for
    bf16 only."""
    err = np.abs(_np(got) - _np(want)).max()
    if dtype == "fp32":
        assert err < FP32_LOGIT_TOL, err
    else:
        noise = np.abs(_np(want) - _np(want_fp32)).max()
        assert err <= max(2 * noise, BF16_FLOOR), (err, noise)


def _quantized(params, bits):
    jp, tp = params
    return (jsq.quantize_params(jp, default_bits=bits),
            tsq.quantize_params(tp, default_bits=bits))


def _bf16_pool(cfg, num_pages, page, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers // 2, num_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {f"sub{j}": {kv: np.asarray(
        jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        for kv in ("k", "v")} for j in range(2)}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_with_dequant_dot_matches(models, bits, dtype):
    jm, tm, params = models
    toks = np.random.default_rng(20).integers(
        2, jm.cfg.vocab_size, (2, 24)).astype(np.int32)
    jqp, tqp = _quantized(params[dtype], bits)

    def jax_logits(p):
        return jm.forward(p, {"tokens": jnp.asarray(toks)},
                          cache_layout="full", dot=jsq.dequant_dot)[0]

    want = jax_logits(jqp)
    got = tm.forward(tqp, {"tokens": torch.from_numpy(toks)},
                     dot=tsq.dequant_dot)[0]
    assert got.dtype == torch.float32 and got.shape == want.shape
    _check_logits(got, want, dtype,
                  jax_logits(_quantized(params["fp32"], bits)[0])
                  if dtype == "bf16" else None)


@pytest.mark.parametrize("dtype,bits", [("fp32", 8), ("fp32", 4),
                                        ("bf16", 4)])
def test_paged_calls_with_dequant_dot_match(models, bits, dtype):
    """decode_step_paged at positions before, at and past the tiny window,
    and two prefill_chunk_paged chunks, through dequant_dot on quantized
    parameters, against the reference's calls with its hook."""
    jm, tm, params = models
    cfg = jm.cfg
    page, n_blocks, B = 8, 10, 4
    num_pages = B * n_blocks + 1
    pool = _bf16_pool(cfg, num_pages, page, seed=21)
    positions = np.array([5, 31, 33, 70], np.int32)
    rng = np.random.default_rng(22)
    pt = np.zeros((B, n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    for b in range(B):
        pt[b, :positions[b] // page + 1] = \
            perm[b * n_blocks:b * n_blocks + positions[b] // page + 1]
    tok = rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32)
    chunk = rng.integers(2, cfg.vocab_size, (1, 8)).astype(np.int32)
    cpt = np.array([[3, 1, 6, 2, 5]], np.int32)

    def jax_calls(p):
        logits, _ = jm.decode_step_paged(
            p, jax.tree.map(jnp.asarray, pool), jnp.asarray(pt),
            jnp.asarray(tok), jnp.asarray(positions), kernel="ref",
            dot=jsq.dequant_dot)
        jpool = jax.tree.map(jnp.asarray, pool)
        rows = []
        for start in (0, 8):
            h, jpool = jm.prefill_chunk_paged(
                p, jpool, jnp.asarray(cpt), jnp.asarray(chunk),
                jnp.asarray([start], jnp.int32), kernel="ref",
                dot=jsq.dequant_dot)
            rows.append(jm.unembed(p, h[:, -1:], dot=jsq.dequant_dot))
        return logits, jnp.stack(rows)

    jqp, tqp = _quantized(params[dtype], bits)
    want_dec, want_chunk = jax_calls(jqp)
    got_dec, _ = tm.decode_step_paged(
        tqp, from_jax_params(pool), torch.from_numpy(pt),
        torch.from_numpy(tok), torch.from_numpy(positions),
        dot=tsq.dequant_dot)
    tpool = from_jax_params(pool)
    rows = []
    for start in (0, 8):
        h, tpool = tm.prefill_chunk_paged(
            tqp, tpool, torch.from_numpy(cpt), torch.from_numpy(chunk),
            torch.tensor([start], dtype=torch.int32), dot=tsq.dequant_dot)
        rows.append(tm.unembed(tqp, h[:, -1:], dot=tsq.dequant_dot))
    fp_dec = fp_chunk = None
    if dtype == "bf16":
        fp_dec, fp_chunk = jax_calls(_quantized(params["fp32"], bits)[0])
    _check_logits(got_dec, want_dec, dtype, fp_dec)
    _check_logits(torch.stack(rows), want_chunk, dtype, fp_chunk)


# ----------------------------------------------------------------- engine --
def _policy(**kw):
    base = dict(hw_name="test", max_model_len=64, page_size=8,
                num_pages=10_000, max_batch=3, prefill_chunk=8,
                quant_bits=16, decode_slo_s=0.03, est_decode_s=0.0,
                est_prefill_s=0.0)
    base.update(kw)
    return AdmissionPolicy(**base)


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_quantized_weights_match_generate(models, bits):
    """Engine(quant_bits 8 or 4) stores int weights (int4 FFN, int8
    attention projections at 4 bits) and serves through dequant_dot: its
    greedy tokens equal the port's own generate with the same stored
    weights and hook, up to a near tie."""
    jm, tm, params = models
    tp = params["fp32"][1]
    rng = np.random.default_rng(30)
    reqs = [Request(rid=i, prompt=rng.integers(2, 512, int(n))
                    .astype(np.int32), max_new=5)
            for i, n in enumerate((6, 19, 11, 27))]
    engine = Engine(tm, tp, _policy(quant_bits=bits))
    ffn = engine.params["blocks"]["sub0"]["ffn"]["w_in"]
    assert ("q4" if bits == 4 else "q") in ffn
    assert "q" in engine.params["blocks"]["sub0"]["attn"]["wq"]
    outs = engine.run(reqs)
    assert engine.kv.allocator.num_allocated == 0
    for r in reqs:
        want = generate(tm, engine.params, torch.from_numpy(r.prompt[None]),
                        r.max_new, page_size=8,
                        dot=tsq.dequant_dot)[0].numpy()
        got = outs[r.rid]
        assert got.shape == want.shape
        diff = np.nonzero(want != got)[0]
        if diff.size:
            i = int(diff[0])
            assert i >= len(r.prompt)
            logits = tm.forward(engine.params, {"tokens": torch.from_numpy(
                got[None, :i])}, dot=tsq.dequant_dot)[0][0, -1].numpy()
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] <= ROW_TOL, (r.rid, i)


def test_engine_quantized_first_tokens_match_reference(models):
    """The engine's whole-prompt and chunked prefill at quant_bits 4 pick
    the reference's first token: the reference forward with its hook on
    its own stored weights, up to a near tie."""
    jm, tm, params = models
    jp, tp = params["fp32"]
    jqp = jsq.quantize_params(jp, default_bits=4)
    prompts = [np.random.default_rng(40 + i).integers(2, 512, n)
               .astype(np.int32) for i, n in enumerate((9, 21))]
    for chunked in (True, False):
        engine = Engine(tm, tp, _policy(quant_bits=4),
                        chunked_prefill=chunked)
        outs = engine.run([Request(rid=i, prompt=p, max_new=1)
                           for i, p in enumerate(prompts)])
        for i, p in enumerate(prompts):
            want = np.asarray(jm.forward(jqp, {"tokens": jnp.asarray(
                p[None])}, cache_layout="full", dot=jsq.dequant_dot)[0][0, -1])
            top2 = np.sort(want)[-2:]
            assert outs[i][-1] == want.argmax() \
                or top2[1] - top2[0] <= ROW_TOL


def test_engine_mesh_still_raises_with_quantized_weights(models):
    _, tm, params = models
    with pytest.raises(NotImplementedError, match="quantized"):
        Engine(tm, params["fp32"][1], _policy(quant_bits=8), mesh=object())


# -------------------------------------------------------------------- CLI --
def test_serve_quant_policy_cli_on_cpu(tmp_path, capsys):
    """--sequential --quant-policy serves through make_quant_dot on the
    CPU; without --sequential it is refused, as in the reference."""
    from repro_torch.launch import serve
    policy = tmp_path / "quant.json"
    policy.write_text(json.dumps({"ffn_in": [4, 16], "ffn_out": [8, 8],
                                  "attn_q": [8, 16]}))
    base = ["--arch", "gemma2-2b", "--tiny", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "3"]
    serve.main(base + ["--sequential", "--quant-policy", str(policy)])
    out = capsys.readouterr().out
    assert "quantization policy over 3 sites" in out
    assert "generated 3 tokens x batch 2" in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--quant-policy", str(policy)])
