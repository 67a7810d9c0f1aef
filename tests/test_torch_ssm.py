"""The port's SSM family (src/repro_torch/models/ssm.py, the ssm and hybrid
branches of models/transformer.py, the dense-cache ``generate``) against
the reference, on the same numpy-seeded inputs and the reference's own
parameters (models/convert.py).

Tolerances. ``causal_conv`` and ``ssd_chunked`` in fp32: the same fp32
arithmetic in other summation orders, 1e-5 of the largest |value|. The
mamba block and the tiny models in fp32 parameters: 1e-4 of the largest
|value| (measured 1e-6 to 2e-5: a 4-6 layer stack carries the ordering
noise on). In bf16 parameters the tiny models amplify rounding, and the
two compilers round the activation chain (silu, sigmoid) at other points,
so logits (and each decode cache leaf, relative to its max) are held as
tests/test_torch_models.py holds them: twice the reference's own
bf16-vs-fp32 gap on the same inputs, floored at 2e-2.
The reference's own contract, prefill(S) + decode_step == forward(S+1)
at the last position, is held to its tolerance
(tests/test_decode_equivalence.py): 5e-2 in bf16, 2e-3 in fp32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.api import Model, build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("mamba2-370m", "zamba2-1.2b")
SCAN_TOL = 1e-5
FP32_TOL = 1e-4
BF16_FLOOR = 2e-2
CONTRACT_TOL = {"bf16": 5e-2, "fp32": 2e-3}
B, S = 2, 48


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# the reference's functions compiled once each (its eager op-by-op
# dispatch compiles every primitive and costs seconds a call)
_j_conv = jax.jit(j_ssm.causal_conv)
_j_ssd = jax.jit(j_ssm.ssd_chunked, static_argnums=5)
_j_block_fwd = jax.jit(j_ssm.mamba_block_fwd, static_argnums=2)
_j_block_decode = jax.jit(j_ssm.mamba_block_decode, static_argnums=3)


def _cast(jp, dtype):
    return jax.tree.map(lambda a: a.astype(dtype)
                        if a.dtype == jnp.bfloat16 else a, jp)


# ------------------------------------------------------------ the SSD ----
@pytest.mark.parametrize("S_", [37, 48])
def test_causal_conv_matches(S_):
    rng = np.random.default_rng(S_)
    x = rng.normal(size=(2, S_, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    want = _j_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = t_ssm.causal_conv(*map(torch.from_numpy, (x, w, b)))
    assert _rel(got, want) < SCAN_TOL


def _ssd_inputs(S_, H=4, P=8, G=2, N=6, seed=0):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(2, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, S_, H)))).astype(np.float32)
    a_log = rng.normal(size=(H,)).astype(np.float32) * 0.5
    Bm = rng.normal(size=(2, S_, G, N)).astype(np.float32)
    Cm = rng.normal(size=(2, S_, G, N)).astype(np.float32)
    return xh, dt, a_log, Bm, Cm


@pytest.mark.parametrize("S_,chunk", [(64, 16), (50, 16), (5, 16),
                                      (33, 32)])
def test_ssd_chunked_matches(S_, chunk):
    """S % Q == 0 and S % Q != 0 (the state-neutral padding), and S < Q
    (one chunk): y and the final state."""
    args = _ssd_inputs(S_, seed=S_)
    wy, ws = _j_ssd(*map(jnp.asarray, args), chunk)
    gy, gs = t_ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    assert gy.dtype == gs.dtype == torch.float32
    assert _rel(gy, wy) < SCAN_TOL
    assert _rel(gs, ws) < SCAN_TOL


def test_ssd_padding_is_state_neutral():
    """The port's own check of the reference's padding claim: a padded
    chunk leaves the state what the unpadded sequence gives."""
    args = _ssd_inputs(48)
    y1, s1 = t_ssm.ssd_chunked(*map(torch.from_numpy, args), 48)
    y2, s2 = t_ssm.ssd_chunked(*map(torch.from_numpy, args), 32)
    assert _rel(y2, y1) < SCAN_TOL and _rel(s2, s1) < SCAN_TOL


def test_ssd_gradient_finite_where_the_references_overflows():
    """A chunk whose decay sums past ~88 (dt 3 over 128 tokens) overflows
    the exp of the masked upper triangle: the reference's gradient in dt
    is NaN there, the port's finite; at dt 0.5 both are finite and
    equal."""
    xh, _, a_log, Bm, Cm = _ssd_inputs(128, H=2, G=1, seed=9)
    for dt_value, overflow in ((3.0, True), (0.5, False)):
        dt = np.full((2, 128, 2), dt_value, np.float32)
        want = jax.grad(lambda d: _j_ssd(
            jnp.asarray(xh), d, jnp.asarray(a_log), jnp.asarray(Bm),
            jnp.asarray(Cm), 128)[0].sum())(jnp.asarray(dt))
        d = torch.from_numpy(dt).requires_grad_(True)
        y, _ = t_ssm.ssd_chunked(torch.from_numpy(xh), d,
                                 torch.from_numpy(a_log),
                                 torch.from_numpy(Bm), torch.from_numpy(Cm),
                                 128)
        (got,) = torch.autograd.grad(y.sum(), [d])
        assert bool(torch.isfinite(got).all())
        assert bool(jnp.isfinite(want).all()) != overflow
        if not overflow:
            assert _rel(got, want) < SCAN_TOL


def test_softplus_is_the_references_above_the_threshold():
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = t_ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ------------------------------------------------------ the mamba block ----
@pytest.fixture(scope="module")
def block():
    cfg = j_tiny("mamba2-370m")
    jp = jax.tree.map(lambda a: a[0], j_build(cfg).init(
        jax.random.PRNGKey(1))["mamba"])
    jp = _cast(jp, jnp.float32)
    rng = np.random.default_rng(2)
    # a_log and dt_bias away from their zero init, so decay varies
    jp = dict(jp, a_log=jnp.asarray(rng.normal(size=jp["a_log"].shape)
                                    .astype(np.float32) * 0.5),
              dt_bias=jnp.asarray(rng.normal(size=jp["dt_bias"].shape)
                                  .astype(np.float32)))
    return cfg, t_tiny("mamba2-370m"), jp, from_jax_params(
        jax.tree.map(np.asarray, jp))


def test_mamba_block_fwd_and_decode_match(block):
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(3).normal(size=(B, S + 1, jcfg.d_model)) \
        .astype(np.float32)
    wy, wc = _j_block_fwd(jp, jnp.asarray(x[:, :S]), jcfg)
    gy, gc = t_ssm.mamba_block_fwd(tp, torch.from_numpy(x[:, :S]), tcfg)
    assert _rel(gy, wy) < FP32_TOL
    for k in ("conv", "state"):
        assert _rel(gc[k], wc[k]) < FP32_TOL
    # decode one token from each package's own cache
    wd, wn = _j_block_decode(jp, jnp.asarray(x[:, S:]), wc, jcfg)
    gd, gn = t_ssm.mamba_block_decode(tp, torch.from_numpy(x[:, S:]), gc,
                                      tcfg)
    assert _rel(gd, wd) < FP32_TOL
    for k in ("conv", "state"):
        assert gn[k].shape == tuple(wn[k].shape)
        assert _rel(gn[k], wn[k]) < FP32_TOL
    # and the recurrence equals the chunked forward over S + 1
    wf, _ = _j_block_fwd(jp, jnp.asarray(x), jcfg)
    assert _rel(gd[:, 0], _np(wf)[:, -1]) < 1e-3


def test_mamba_cache_spec_matches(block):
    jcfg, tcfg, _, _ = block
    want = j_ssm.mamba_cache_spec(jcfg, 3)
    got = t_ssm.mamba_cache_spec(tcfg, 3)
    for k in ("conv", "state"):
        assert got[k][0] == want[k].shape
        assert str(got[k][1]).split(".")[-1] == want[k].dtype.name


def test_short_prompt_conv_tail_is_the_references(block):
    """A prompt shorter than conv_width - 1 tokens leaves a short conv
    tail in both packages, which neither decode takes (a known caveat of
    the reference, kept)."""
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(4).normal(size=(1, 2, jcfg.d_model)) \
        .astype(np.float32)
    _, wc = _j_block_fwd(jp, jnp.asarray(x), jcfg)
    _, gc = t_ssm.mamba_block_fwd(tp, torch.from_numpy(x), tcfg)
    assert gc["conv"].shape == tuple(wc["conv"].shape) \
        == (1, 2, wc["conv"].shape[-1])
    with pytest.raises(RuntimeError):
        t_ssm.mamba_block_decode(tp, torch.from_numpy(x[:, :1]), gc, tcfg)


# ---------------------------------------------------------- tiny models ----
class _JModel:
    """The reference's Model with its entry points compiled."""

    def __init__(self, m):
        self.m, self.cfg = m, m.cfg
        self.forward = jax.jit(lambda p, t: m.forward(p, {"tokens": t})[0])
        self.prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}))
        self.decode_step = jax.jit(m.decode_step)
        self.loss = jax.jit(jax.value_and_grad(
            lambda p, t, lab: m.loss(p, {"tokens": t, "labels": lab})))

    def __getattr__(self, name):
        return getattr(self.m, name)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = _JModel(j_build(j_tiny(arch)))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
        tm = t_build(t_tiny(arch))
        per = {}
        for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
            jpd = _cast(jp, dt)
            per[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
        out[arch] = (jm, tm, per)
    return out


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _check_logits(got, want, want_fp32, dtype):
    err = float(np.abs(_np(got) - _np(want)).max())
    if dtype == "fp32":
        assert err < FP32_TOL * float(np.abs(_np(want)).max()), err
    else:
        noise = float(np.abs(_np(want) - _np(want_fp32)).max())
        assert err <= max(2 * noise, BF16_FLOOR), (err, noise)


def _jforward(jm, jp, toks):
    return jm.forward(jp, jnp.asarray(toks))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(models, arch, dtype):
    jm, tm, per = models[arch]
    toks = _tokens(jm.cfg, (B, S))
    want = _jforward(jm, per[dtype][0], toks)
    want32 = _jforward(jm, per["fp32"][0], toks)
    got = tm.forward(per[dtype][1], {"tokens": torch.from_numpy(toks)})[0]
    assert got.shape == want.shape
    _check_logits(got, want, want32, dtype)


def _jgrow(cache, S_):
    def grow(path, a):
        if a.ndim == 5 and a.shape[2] == S_ and "mamba" not in \
                jtu.keystr(path):
            return jnp.pad(a, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
        return a
    return jtu.tree_map_with_path(grow, cache)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_logits_and_caches_match(models, arch, dtype):
    """prefill(S) then decode_step at S, in both packages from their own
    prefill's caches: logits and every cache leaf (the hybrid's shared
    k/v stacked over its applications, the mamba leaves over layers)."""
    jm, tm, per = models[arch]
    jp, tp = per[dtype]
    toks = _tokens(jm.cfg, (B, S + 1), seed=1)
    _, jc = jm.prefill(jp, jnp.asarray(toks[:, :S]))
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    jc, tc = _jgrow(jc, S), t_serve._grow_cache(tc, S, S + 1)
    jl, jn = jm.decode_step(jp, jc, jnp.asarray(toks[:, S:]),
                            jnp.asarray(S, jnp.int32))
    tl, tn = tm.decode_step(tp, tc, torch.from_numpy(toks[:, S:]),
                            torch.tensor(S))
    j32, jn32 = jm.decode_step(per["fp32"][0], _jgrow(jm.prefill(
        per["fp32"][0], jnp.asarray(toks[:, :S]))[1], S),
        jnp.asarray(toks[:, S:]), jnp.asarray(S, jnp.int32))
    _check_logits(tl, jl, j32, dtype)
    jleaves = jax.tree.leaves(jn)
    tleaves = tree_leaves(tn)
    assert [tuple(a.shape) for a in tleaves] == \
        [tuple(a.shape) for a in jleaves]
    for a, b, a32 in zip(jleaves, tleaves, jax.tree.leaves(jn32)):
        if dtype == "fp32":
            assert _rel(b, a) < FP32_TOL
        else:   # the logits' rule, per leaf
            assert _rel(b, a) <= max(2 * _rel(a32, a), BF16_FLOOR)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_plus_decode_equals_forward(models, arch, dtype):
    """The reference's contract on the port: prefill(S) + decode_step ==
    forward(S+1) at the last position (tests/test_decode_equivalence.py),
    the caches from init_cache's layout and the launcher's _grow_cache."""
    jm, tm, per = models[arch]
    tp = per[dtype][1]
    toks = torch.from_numpy(_tokens(jm.cfg, (B, S + 1)))
    full = tm.forward(tp, {"tokens": toks})[0][:, -1]
    _, cache = tm.prefill(tp, {"tokens": toks[:, :S]})
    spec = tm.cache_specs(B, S + 1)
    cache = t_serve._grow_cache(cache, S, S + 1)
    assert [tuple(a.shape) for a in tree_leaves(cache)] == \
        [s for s, _ in tree_leaves(spec)]
    got, _ = tm.decode_step(tp, cache, toks[:, S:], torch.tensor(S))
    assert _rel(got[:, 0], full) < CONTRACT_TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_init_cache_match(models, arch):
    jm, tm, _ = models[arch]
    want = jm.cache_specs(3, 40)
    got = tm.cache_specs(3, 40)
    jl = jax.tree.leaves(want)
    tl = tree_leaves(got)
    assert [s for s, _ in tl] == [tuple(a.shape) for a in jl]
    assert [str(d).split(".")[-1] for _, d in tl] == \
        [a.dtype.name for a in jl]
    zeros = tm.init_cache(3, 40, device="cpu")
    assert all(not bool(a.any()) for a in tree_leaves(zeros))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_tree_match(models, arch):
    jm, tm, per = models[arch]
    assert tm.param_count() == jm.param_count()
    assert tm.param_bytes() == jm.param_bytes()
    jp, tp = per["bf16"]
    assert [tuple(a.shape) for a in tree_leaves(tp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    init = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(a.shape) for a in tree_leaves(init)] == \
        [tuple(a.shape) for a in tree_leaves(tp)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(models, arch):
    """Model.loss and every gradient leaf against jax.value_and_grad, fp32
    parameters, with remat off and on: 1e-4 of each leaf's max |g| (remat
    recomputes, the same arithmetic)."""
    jm, tm, per = models[arch]
    jp, tp = per["fp32"]
    toks = _tokens(jm.cfg, (B, 32), seed=5)
    labels = _tokens(jm.cfg, (B, 32), seed=6)
    wl, wg = jm.loss(jp, jnp.asarray(toks), jnp.asarray(labels))
    leaves = tree_leaves(tp)
    for remat in (False, True):
        for p in leaves:
            p.requires_grad_(True)
        loss = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)}, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        assert abs(float(loss) - float(wl)) < 1e-5 * abs(float(wl))
        for g, w in zip(grads, jax.tree.leaves(wg)):
            assert _rel(g, w) < FP32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(models, arch):
    """Greedy generate through the dense-cache branch: the reference's
    tokens, fp32 parameters (prompt 20 tokens, 6 new)."""
    jm, tm, per = models[arch]
    jp, tp = per["fp32"]
    prompt = _tokens(jm.cfg, (2, 20), seed=7)
    want = np.asarray(j_serve.generate(jm.m, jp, jnp.asarray(prompt), 6))
    got = t_serve.generate(tm, tp, torch.from_numpy(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_refuses_engine_knobs(models):
    jm, tm, per = models["mamba2-370m"]
    prompt = torch.from_numpy(_tokens(jm.cfg, (1, 8)))
    with pytest.raises(ValueError, match="paged-pool knobs"):
        t_serve.generate(tm, per["bf16"][1], prompt, 2, kv_bits=8)
    with pytest.raises(ValueError, match="paged-pool knobs"):
        t_serve.generate(tm, per["bf16"][1], prompt, 2, prefill_chunk=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_sequential(arch, capsys):
    t_serve.main(["--arch", arch, "--tiny", "--device", "cpu",
                  "--sequential", "--batch", "2", "--prompt-len", "12",
                  "--gen", "3"])
    assert "generated 3 tokens x batch 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_and_paged_paths_refuse(models, arch):
    """The engine keeps refusing these families with its message, and the
    paged calls theirs: they decode over dense caches."""
    _, tm, _ = models[arch]
    policy = AdmissionPolicy(
        hw_name="test", max_model_len=64, page_size=8, num_pages=32,
        max_batch=2, prefill_chunk=8, quant_bits=16, decode_slo_s=0.03,
        est_decode_s=0.0, est_prefill_s=0.0)
    with pytest.raises(NotImplementedError, match="waits for its slice"):
        Engine(Model(cfg=tm.cfg, defs=None), {}, policy)
    with pytest.raises(NotImplementedError, match="attention-cache"):
        tm.init_pool(4, 4, device="cpu")


def test_train_step_on_tiny_zamba2():
    """One train step (training/steps.py, unchanged) through the hybrid:
    the loss finite, the parameters moved."""
    from repro_torch.configs import OptimConfig, ShapeConfig, TrainConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.training import steps
    tm = t_build(t_tiny("zamba2-1.2b"))
    tcfg = TrainConfig(optim=OptimConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=4))
    state = steps.init_train_state(tm, tcfg, torch.Generator().manual_seed(0),
                                   "cpu")
    before = [a.clone() for a in tree_leaves(state["params"])]
    batch = dp.batch_for_model(tm, ShapeConfig("t", 32, 2, "train"), None, 0)
    state, metrics = steps.make_train_step(tm, tcfg)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(state["params"])))


def test_tiny_configs_are_the_references():
    for arch in ARCHS:
        j, t = dataclasses.asdict(j_tiny(arch)), dataclasses.asdict(
            t_tiny(arch))
        assert j == t
