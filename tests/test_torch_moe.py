"""The port's MoE family (src/repro_torch/models/moe.py and the moe layers
of models/transformer.py, the engine and the launcher) against the
reference, on the same numpy-seeded inputs and the reference's own
parameters (models/convert.py).

Routing is discrete, so it is held exactly: the experts each token picks
(``lax.top_k``'s order, ties to the lower expert), which routed pairs
find a slot within capacity, and the dropped ones.

Tolerances. ``moe_apply`` in fp32 parameters: the same fp32 arithmetic in
other orders, 1e-5 of the largest |y|. In bf16: the expert matmuls agree
bit for bit, but the reference's CPU compiler evaluates the activation
chain (sigmoid, silu, the product with the up projection) with its own
sigmoid and its own rounding points, so activations differ by a bf16 ulp
(2**-8 relative) in about half the elements (measured); through the
output projection and the gated sum an element of y moves by up to
0.0066 of the largest |y| (measured): held to 4 bf16 ulps of it,
4 * 2**-8. The aux loss is fp32 arithmetic on identical routing: 1e-6.
Whole-model logits in bf16 are held as tests/test_torch_models.py holds
them: twice the reference's own bf16-vs-fp32 gap, floored at 2e-2. In
fp32 this tiny model (no logit softcap, 4 layers of 2-of-4 experts)
amplifies summation order: the reference's own compiled and eager
(``jax.disable_jit``) logits differ by 9.5e-4 on the forward test's
inputs (measured), and the port lands within that distance of either.
fp32 logits are held to three times the reference's own compiled-vs-eager
gap on the same inputs, floored at tests/test_torch_models.py's 2e-4; a
chunked prefill reads back the k/v it wrote to the bf16 pool, where an
fp32 difference may round to the neighbouring bf16 value, so its rows are
floored at that file's POOL_READBACK_TOL, 5e-3 (1.7e-3 measured here).
The summed aux loss takes the logits' rule, floored at 1e-6 per layer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_batch  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.api import Model, build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine, \
    Request  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
FP32_Y_TOL = 1e-5
BF16_Y_TOL = 4 * 2.0 ** -8
AUX_TOL = 1e-6
FP32_LOGIT_TOL = 2e-4
POOL_READBACK_TOL = 5e-3
BF16_FLOOR = 2e-2


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ref_routing(p, x, moe):
    """The reference's routing of x (B, S, D), step by step as its
    moe_apply takes it: (idx (T, k), keep (T*k,) in sorted-pair order)."""
    T = x.shape[0] * x.shape[1]
    E, k = moe.num_experts, moe.experts_per_token
    xf = x.reshape(T, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32),
                                      p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    e_flat = idx.reshape(T * k)
    e_sorted = e_flat[jnp.argsort(e_flat)]
    counts = jnp.bincount(e_flat, length=E)
    seg = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                           jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(T * k) - seg[e_sorted]
    return np.asarray(idx), np.asarray(pos < j_moe.capacity(T, moe))


def _moe_case(capacity_factor, overflow, seed=0):
    """Reference moe params at tiny granite-moe width and x (2, 32, D):
    as drawn, or (``overflow``) with every token leaning on expert 0, so
    that at capacity 1.25 its queue overflows."""
    cfg = j_configs.tiny_config(ARCH)
    moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    jp = j_init(j_moe.moe_defs(cfg.d_model, moe), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    if overflow:
        x = x + 2.0
        router = np.array(jp["router"])
        router[:, 0] = 0.05
        jp = dict(jp, router=jnp.asarray(router))
    return moe, jp, x


def _as(jp, x, dtype):
    """(reference params, reference x, port params, port x) with the
    bf16 leaves and x in ``dtype`` (the router stays fp32)."""
    jd = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jp = jax.tree.map(lambda a: a.astype(jd) if a.dtype == jnp.bfloat16
                      else a, jp)
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    return jp, jx, from_jax_params(jax.tree.map(np.asarray, jp)), \
        tx.to(torch.float32 if dtype == "fp32" else torch.bfloat16)


# ------------------------------------------------------------- moe_apply --
@pytest.mark.parametrize("tokens", [1, 2, 8, 64, 4096, 5000])
def test_capacity_matches_reference(tokens):
    for arch in (ARCH, "llama4-maverick-400b-a17b"):
        for cfg in (j_configs.get_config(arch), j_configs.tiny_config(arch)):
            assert t_moe.capacity(tokens, cfg.moe) == \
                j_moe.capacity(tokens, cfg.moe)
    full = t_configs.get_config(ARCH).moe
    assert t_moe.capacity(8, full) == 8          # decode, B <= 8: C = 8
    assert t_moe.capacity(4096, full) == 1024    # a 4096-row chunk


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("capacity_factor,overflow",
                         [(4.0, False), (1.25, True)],
                         ids=["drop-free", "overflow"])
def test_moe_apply_matches_reference(capacity_factor, overflow, activation,
                                     dtype):
    moe, jp0, x = _moe_case(capacity_factor, overflow)
    jp, jx, tp, tx = _as(jp0, x, dtype)
    want_y, want_aux = j_moe.moe_apply(jp, jx, moe, activation)
    got_y, got_aux = t_moe.moe_apply(tp, tx, moe, activation)
    assert got_y.dtype == tx.dtype and got_y.shape == tx.shape
    assert got_aux.dtype == torch.float32 and got_aux.dim() == 0

    idx, keep = _ref_routing(jp, jx, moe)
    T = x.shape[0] * x.shape[1]
    _, _, t_idx = t_moe.route(tp, tx.reshape(T, -1), moe)
    _, t_keep, t_dest = t_moe.dispatch(
        t_idx, t_moe.capacity(T, moe), moe.num_experts)
    assert np.array_equal(t_idx.numpy(), idx)
    assert np.array_equal(t_keep.numpy(), keep)
    C = t_moe.capacity(T, moe)
    assert bool((t_dest[~t_keep] == moe.num_experts * C).all())
    assert (int((~t_keep).sum()) > 0) == overflow

    y, w = _np(got_y), _np(want_y)
    tol = FP32_Y_TOL if dtype == "fp32" else BF16_Y_TOL
    assert np.abs(y - w).max() <= tol * np.abs(w).max()
    assert abs(float(got_aux) - float(want_aux)) <= AUX_TOL


def test_routing_ties_take_the_lower_expert():
    """Experts pruned by ``mask_experts`` get probability exactly 0, so
    with fewer live experts than k the last picks tie: both packages pick
    the lowest dead expert ids, and route and drop identically."""
    moe, jp0, x = _moe_case(4.0, False)
    imp = j_pruning.expert_importance(jp0)
    jp0 = j_pruning.mask_experts(jp0, j_pruning.keep_mask(imp, 0.25))
    jp, jx, tp, tx = _as(jp0, x, "fp32")
    idx, keep = _ref_routing(jp, jx, moe)
    _, _, t_idx = t_moe.route(tp, tx.reshape(-1, tx.shape[-1]), moe)
    live = int(np.asarray(j_pruning.keep_mask(imp, 0.25)).sum())
    assert live < moe.experts_per_token
    assert np.array_equal(t_idx.numpy(), idx)
    got, _ = t_moe.moe_apply(tp, tx, moe)
    want, _ = j_moe.moe_apply(jp, jx, moe)
    assert np.abs(_np(got) - _np(want)).max() \
        <= FP32_Y_TOL * np.abs(_np(want)).max()


def test_moe_apply_dot_hook_sites():
    """The ``dot`` hook sees the reference's three site names, on the
    (E, C, .) dispatch buffers, and replaces the expert matmuls."""
    moe, jp0, x = _moe_case(4.0, False)
    _, _, tp, tx = _as(jp0, x, "fp32")
    seen = []

    def dot(a, w, name):
        seen.append((name, tuple(a.shape)))
        return torch.einsum("ecd,edf->ecf", a, w)

    got, _ = t_moe.moe_apply(tp, tx, moe, dot=dot)
    want, _ = t_moe.moe_apply(tp, tx, moe)
    E, C = moe.num_experts, t_moe.capacity(64, moe)
    assert [s[0] for s in seen] == ["moe_in", "moe_gate", "moe_out"]
    assert seen[0][1][:2] == (E, C)
    assert np.abs(_np(got) - _np(want)).max() < 1e-5


def test_moe_apply_reads_nothing_back():
    """No step of a call reads a value back to the host: the dispatch runs
    with the tensors' data hidden behind a dispatch mode that fails any
    ``item``/``tolist``/data-dependent shape."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoHostRead(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            assert "_local_scalar_dense" not in name, name
            assert "nonzero" not in name and "masked_select" not in name, \
                name
            return func(*args, **(kwargs or {}))

    moe, jp0, x = _moe_case(1.25, True)
    _, _, tp, tx = _as(jp0, x, "bf16")
    want = t_moe.moe_apply(tp, tx, moe)[0]
    with NoHostRead():
        got = t_moe.moe_apply(tp, tx, moe)[0]
    assert torch.equal(got, want)


# ------------------------------------------------------------ parameters --
def test_from_jax_params_carries_the_moe_tree():
    """A reference granite-moe tree (bf16 experts, fp32 router) becomes
    the port's tree under the same keys, dtypes, shapes and values; the
    port's own defs declare the same tree."""
    jm = j_build(j_configs.tiny_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    tm = t_build(t_configs.tiny_config(ARCH))
    mine = tm.init(torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(mine))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        got, ours = tp, mine
        for k in keys:
            got, ours = got[k], ours[k]
        want_dt = torch.float32 if leaf.dtype == jnp.float32 \
            else torch.bfloat16
        assert got.dtype == ours.dtype == want_dt, keys
        assert tuple(got.shape) == tuple(ours.shape) == leaf.shape, keys
        assert np.array_equal(_np(got), _np(leaf)), keys
    router = tp["blocks"]["sub0"]["moe"]["router"]
    assert router.dtype == torch.float32


def test_param_count_and_bytes_match_reference():
    for get in ("get_config", "tiny_config"):
        jc, tc = getattr(j_configs, get)(ARCH), getattr(t_configs, get)(ARCH)
        assert t_build(tc).param_count() == j_build(jc).param_count()
        assert t_build(tc).param_bytes() == j_build(jc).param_bytes()


# ---------------------------------------------------------- model calls --
@pytest.fixture(scope="module")
def models():
    jm = j_build(j_configs.tiny_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = t_build(t_configs.tiny_config(ARCH))
    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jpd = jax.tree.map(lambda a: a.astype(dt) if a.dtype == jnp.bfloat16
                           else a, jp)
        out[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
    return jm, tm, out


def _check_logits(got, ref_fn, params, dtype, fp32_floor=FP32_LOGIT_TOL,
                  bf16_floor=BF16_FLOOR):
    """``got`` against ``ref_fn(reference params)`` (lists of tensors):
    fp32 within 3x the reference's compiled-vs-eager gap (floor
    ``fp32_floor``), bf16 within 2x its bf16-vs-fp32 gap (floor
    ``bf16_floor``)."""
    want = ref_fn(params[dtype][0])
    if dtype == "fp32":
        with jax.disable_jit():
            other = ref_fn(params["fp32"][0])
        floor, factor = fp32_floor, 3
    else:
        other, floor, factor = ref_fn(params["fp32"][0]), bf16_floor, 2
    for g, w, o in zip(got, want, other):
        err = np.abs(_np(g) - _np(w)).max()
        noise = np.abs(_np(w) - _np(o)).max()
        assert err <= max(factor * noise, floor), (err, noise)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_and_loss_match(models, dtype):
    """Whole-sequence logits, the summed aux loss, and ``Model.loss`` =
    CE + 0.01 aux (the reference's loss run eagerly, its own definition
    of each op)."""
    jm, tm, params = models
    rng = np.random.default_rng(0)
    toks = rng.integers(2, jm.cfg.vocab_size, (2, 40)).astype(np.int32)

    def jax_fwd(p):
        return jm.forward(p, {"tokens": jnp.asarray(toks)},
                          cache_layout="full")

    got = tm.forward(params[dtype][1], {"tokens": torch.from_numpy(toks)})
    _check_logits([got[0]], lambda p: [jax_fwd(p)[0]], params, dtype)
    assert got[2].dtype == torch.float32 and float(got[2]) > 0
    floor = AUX_TOL * jm.cfg.num_layers
    _check_logits([got[2]], lambda p: [jax_fwd(p)[2]], params, dtype,
                  fp32_floor=floor, bf16_floor=floor)

    batch = tiny_batch(jm.cfg)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with jax.disable_jit():
        want_loss = float(jm.loss(params[dtype][0], batch))
        want32 = float(jm.loss(params["fp32"][0], batch))
    got_loss = float(tm.loss(params[dtype][1], tbatch))
    gap = abs(want_loss - want32)
    assert abs(got_loss - want_loss) <= (
        1e-5 if dtype == "fp32" else max(2 * gap, BF16_FLOOR))


def _pool_state(cfg, num_pages, page, seed):
    """A random bf16-representable pool (numpy) for the one sub-layer slot
    of granite-moe (period 1)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, num_pages, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"sub0": {kv: np.asarray(
        jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
        for kv in ("k", "v")}}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_step_paged_matches(models, dtype):
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
        return [jm.decode_step_paged(p, jax.tree.map(jnp.asarray, pool),
                                     jnp.asarray(pt), jnp.asarray(tok),
                                     jnp.asarray(positions),
                                     kernel="ref")[0]]

    got, _ = tm.decode_step_paged(
        params[dtype][1], from_jax_params(pool), torch.from_numpy(pt),
        torch.from_numpy(tok), torch.from_numpy(positions))
    _check_logits([got], jax_step, params, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_prefill_chunks_match(models, dtype):
    """A 20-token prompt in chunks of 8 over a 5-page table (the third
    chunk padded past it): every chunk's last real row. The padding rows
    are routed too and take expert capacity, as in the reference."""
    jm, tm, params = models
    cfg = jm.cfg
    page, C, S = 4, 8, 20
    pt = np.array([[3, 1, 6, 2, 5]], np.int32)
    pool = _pool_state(cfg, 8, page, seed=3)
    prompt = np.random.default_rng(4).integers(2, cfg.vocab_size, S) \
        .astype(np.int32)

    def chunks():
        for start in range(0, S, C):
            toks = np.zeros((1, C), np.int32)
            toks[0, :min(C, S - start)] = prompt[start:start + C]
            yield start, toks, min(C, S - start) - 1

    def run_jax(p):
        jpool, rows = jax.tree.map(jnp.asarray, pool), []
        for start, toks, last in chunks():
            h, jpool = jm.prefill_chunk_paged(
                p, jpool, jnp.asarray(pt), jnp.asarray(toks),
                jnp.asarray([start], jnp.int32), kernel="ref")
            rows.append(jm.unembed(p, h[:, last:last + 1]))
        return rows

    tpool, got = from_jax_params(pool), []
    for start, toks, last in chunks():
        h, tpool = tm.prefill_chunk_paged(
            params[dtype][1], tpool, torch.from_numpy(pt),
            torch.from_numpy(toks), torch.tensor([start], dtype=torch.int32))
        got.append(tm.unembed(params[dtype][1], h[:, last:last + 1]))
    _check_logits(got, run_jax, params, dtype, fp32_floor=POOL_READBACK_TOL)


# --------------------------------------------------------------- engine --
def _policy(**kw):
    base = dict(hw_name="test", max_model_len=64, page_size=8,
                num_pages=10_000, max_batch=4, prefill_chunk=8,
                quant_bits=16, decode_slo_s=0.03, est_decode_s=0.0,
                est_prefill_s=0.0)
    base.update(kw)
    return AdmissionPolicy(**base)


def test_engine_moe_routing_smoke(models):
    """The reference's test on the port: tiny granite-moe (capacity 4.0,
    drop-free) decodes on the same paged path, and the engine's tokens
    equal the port's ``generate``, request by request."""
    _, tm, params = models
    tp = params["bf16"][1]
    engine = Engine(tm, tp, _policy(max_batch=2))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(2, tm.cfg.vocab_size, 10)
                    .astype(np.int32), max_new=4) for i in range(3)]
    outs = engine.run(reqs)
    for r in reqs:
        want = generate(tm, tp, torch.from_numpy(r.prompt[None]),
                        r.max_new)[0].numpy()
        assert np.array_equal(want, outs[r.rid]), r.rid


@pytest.mark.parametrize("chunked,page", [(True, 16), (True, 48),
                                          (False, 16)])
def test_engine_matches_generate(models, chunked, page):
    """Prompts of 4-44 tokens, 4-15 new tokens, served 3 at a time: the
    engine equals ``generate`` prefilling as it does (its chunks through
    the paged walk, or the whole prompt)."""
    _, tm, params = models
    tp = params["bf16"][1]
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rng.integers(
        2, tm.cfg.vocab_size, int(rng.integers(4, 45))).astype(np.int32),
        max_new=int(rng.integers(4, 16))) for i in range(4)]
    outs = Engine(tm, tp, _policy(max_batch=3, page_size=page),
                  chunked_prefill=chunked).run(reqs)
    for r in reqs:
        want = generate(tm, tp, torch.from_numpy(r.prompt[None]),
                        r.max_new, page_size=page,
                        prefill_chunk=8 if chunked else 0)[0].numpy()
        assert np.array_equal(outs[r.rid], want), r.rid


def test_engine_quantized_weights_match_generate(models):
    """``quant_bits=8`` stores the expert weights int8 too (the moe sites
    through ``dequant_dot``): the engine equals ``generate`` on the same
    stored weights and hook."""
    from repro_torch.serving.quant import dequant_dot, quantize_params
    _, tm, params = models
    tp = params["bf16"][1]
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(2, tm.cfg.vocab_size, 12)
                    .astype(np.int32), max_new=4) for i in range(2)]
    engine = Engine(tm, tp, _policy(max_batch=2, quant_bits=8))
    assert "q" in engine.params["blocks"]["sub0"]["moe"]["w_in"]
    outs = engine.run(reqs)
    qp = quantize_params(tp, default_bits=8)
    for r in reqs:
        want = generate(tm, qp, torch.from_numpy(r.prompt[None]),
                        r.max_new, prefill_chunk=8, dot=dequant_dot)
        assert np.array_equal(outs[r.rid], want[0].numpy()), r.rid


def test_serve_cli_moe_on_cpu(capsys):
    """``--arch granite-moe-3b --tiny --device cpu`` serves through the
    launcher, engine and sequential modes."""
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-moe-3b", "--tiny", "--device", "cpu",
                "--requests", "3", "--prompt-len", "12", "--gen", "4",
                "--max-batch", "2", "--prefill-chunk", "8"])
    out = capsys.readouterr().out
    assert "granite-moe-3b-a800m-tiny: served 3 requests, 12 tokens" in out
    serve.main(["--arch", "granite-moe-3b-a800m", "--tiny", "--device",
                "cpu", "--sequential", "--batch", "2", "--prompt-len", "6",
                "--gen", "3"])
    assert "generated 3 tokens x batch 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b",
                                  "whisper-large-v3",
                                  "llava-next-mistral-7b"])
def test_other_families_still_refused(arch):
    """The engine serves the dense and moe families: ssm, hybrid, encdec
    and vlm build (they decode over dense caches, or through
    make_prefill_step/make_serve_step: tests/test_torch_ssm.py,
    tests/test_torch_encdec.py, tests/test_torch_vlm.py), with the
    reference's parameter shapes, but the engine refuses them, as the
    reference's does."""
    cfg = t_configs.tiny_config(arch)
    tm = t_build(cfg)
    jm = j_build(j_configs.tiny_config(arch))
    assert [tuple(d.shape) for d in jax.tree.leaves(jm.defs)] == \
        [tuple(d.shape) for d in tree_leaves(tm.defs)]
    with pytest.raises(NotImplementedError, match="waits for its slice"):
        Engine(Model(cfg=cfg, defs=None), {}, _policy())