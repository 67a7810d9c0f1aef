"""The port's dense-cache decode (models/attention.py ``attention_decode``
and its ring helpers, models/transformer.py ``decode_step``,
``cache_specs``, ``init_cache`` and the ring layout of ``forward``,
training/steps.py ``make_serve_step``) against the reference, for the
attention families: tiny gemma2-2b (local window 32, so S = 48 fills and
wraps the ring), llama-style dense (granite-3-8b) and granite-moe, on the
same numpy-seeded inputs and the reference's own parameters.

Tolerances. The ring helpers move values: exact. One attention layer's
decode in fp32: 1e-4 of the largest |value| (the same arithmetic in other
orders). The tiny models: the reference's own initialisation draws the
attention projections with fan-in H, so their softmax is saturated and
a rounding moves logits far (its own compiled and eager fp32 logits
differ by up to 3.7e-4 of their max on tiny granite-3-8b at 48 tokens).
So the fp32 cases scale wq and wk by 1/8 in both packages (the same
numbers), as tests/test_torch_train.py does: logits and cache leaves
agree to 1e-5 of their largest |value| (measured 1.1e-6 at most). The
bf16 cases run at the reference's init and are held as
tests/test_torch_models.py holds logits: twice the reference's own
bf16-vs-fp32 gap there on the same inputs, floored at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.training import steps as t_steps  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("gemma2-2b", "granite-3-8b", "granite-moe-3b-a800m")
LAYER_TOL = 1e-4
FP32_TOL = 1e-5
QK_SCALE = 0.125
BF16_FLOOR = 2e-2
B, S, STEPS = 2, 48, 6       # past the tiny window of 32: the ring wraps


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


# ---------------------------------------------------------- ring helpers ----
@pytest.mark.parametrize("S_", [32, 33, 48, 70, 96])
def test_last_window_ring_matches(S_):
    k = np.random.default_rng(S_).normal(size=(2, S_, 3, 4)) \
        .astype(np.float32)
    want = j_attn._last_window_ring(jnp.asarray(k), 32)
    got = t_attn._last_window_ring(torch.from_numpy(k), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # slot s holds the position p of the last 32 with p % 32 == s
    for s in range(32):
        p = max(q for q in range(S_) if q % 32 == s)
        np.testing.assert_array_equal(got.numpy()[:, s], k[:, p])


@pytest.mark.parametrize("S_", [5, 31, 32, 48])
def test_to_ring_matches(S_):
    k = np.random.default_rng(S_).normal(size=(2, S_, 3, 4)) \
        .astype(np.float32)
    want = j_tf._to_ring(jnp.asarray(k), 32)
    got = t_tf._to_ring(torch.from_numpy(k), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,S_", [("global", 40), ("local", 40),
                                     ("local", 10)])
def test_cache_len_for_matches(kind, S_):
    cfg = j_tiny("gemma2-2b")
    assert t_attn.cache_len_for(kind, t_tiny("gemma2-2b"), S_) == \
        j_attn.cache_len_for(kind, cfg, S_)


# ----------------------------------------------------- attention_decode ----
_j_attn_decode = jax.jit(j_attn.attention_decode, static_argnums=(5, 6))


@pytest.fixture(scope="module")
def attn_params():
    """One attention layer's fp32 weights from a seed, as both packages
    hold them."""
    rng = np.random.default_rng(1)
    shapes = {"wq": (128, 4, 32), "wk": (128, 2, 32), "wv": (128, 2, 32),
              "wo": (4, 32, 128)}
    jp = {k: jnp.asarray(rng.normal(size=v).astype(np.float32) / 11.3)
          for k, v in shapes.items()}
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("kind,T,pos", [
    ("local", 32, 5), ("local", 32, 47), ("local", 32, 70),
    ("local", 64, 50), ("global", 64, 50), ("global", 64, 0)])
def test_attention_decode_matches(attn_params, kind, T, pos):
    """One layer's decode over a ring (local, T == window) or a full
    chronological cache: the output and the caches it writes."""
    jcfg, tcfg = j_tiny("gemma2-2b"), t_tiny("gemma2-2b")
    jp, tp = attn_params
    rng = np.random.default_rng(pos)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(B, T, 2, 32)).astype(np.float32)
    cv = rng.normal(size=(B, T, 2, 32)).astype(np.float32)
    wo, wk, wv = _j_attn_decode(jp, jnp.asarray(x), jnp.asarray(ck),
                                jnp.asarray(cv), jnp.asarray(pos, jnp.int32),
                                kind, jcfg)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    go, gk, gv = t_attn.attention_decode(tp, torch.from_numpy(x), tk, tv,
                                         torch.tensor(pos), kind, tcfg)
    assert gk is tk and gv is tv          # written in place
    assert _rel(go, wo) < LAYER_TOL
    assert _rel(gk, wk) < LAYER_TOL and _rel(gv, wv) < LAYER_TOL


# ------------------------------------------------------------ the models ----
class _JModel:
    """The reference's Model with its entry points compiled."""

    def __init__(self, m):
        self.m, self.cfg = m, m.cfg
        self.forward = jax.jit(lambda p, t: m.forward(
            p, {"tokens": t}, want_cache=True))
        self.prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}))
        self.decode_step = jax.jit(m.decode_step)


def _scaled_qk(params, f):
    """wq and wk of every layer times f (the same numbers in both
    packages: the reference's parameters are converted afterwards)."""
    out = jax.tree.map(lambda a: a, params)
    for sub in out["blocks"].values():
        for n in ("wq", "wk"):
            a = sub["attn"][n]
            sub["attn"][n] = (a.astype(jnp.float32) * f).astype(a.dtype)
    return out


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = j_build(j_tiny(arch))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
        per = {}
        # bf16 at the reference's init; fp32 with wq, wk scaled, and at
        # the init too as the bf16 cases' yardstick (the reference only)
        for name, dt, f in (("bf16", jnp.bfloat16, 1.0),
                            ("fp32", jnp.float32, QK_SCALE),
                            ("fp32 init", jnp.float32, 1.0)):
            jpd = jax.tree.map(lambda a: a.astype(dt)
                               if a.dtype == jnp.bfloat16 else a,
                               _scaled_qk(jp, f))
            per[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
        out[arch] = (_JModel(jm), t_build(t_tiny(arch)), per)
    return out


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, shape).astype(np.int32)


def _grower(cur, new):
    """Both packages' caches padded from ``cur`` to ``new`` positions on
    their full-length (5-D, sequence axis 2) leaves; rings stay."""
    def grow(a):
        if a.shape[2] != cur:
            return a
        pad = [(0, 0)] * 5
        pad[2] = (0, new - cur)
        return jnp.pad(a, pad) if isinstance(a, jax.Array) else \
            torch.nn.functional.pad(a, (0, 0, 0, 0, 0, new - cur))
    return grow


def _check(got, want, want32, dtype):
    if dtype == "fp32":
        assert _rel(got, want) < FP32_TOL
    else:
        assert _rel(got, want) <= max(2 * _rel(want32, want), BF16_FLOOR)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(models, arch, dtype):
    """prefill(S) in the ring layout, then STEPS decode_steps (positions
    48-53, the ring of gemma2's local layers (window 32) wrapping):
    logits every step and every cache leaf after the last, against the
    reference from its own caches."""
    jm, tm, per = models[arch]
    toks = _tokens(jm.cfg, (B, S + STEPS), seed=1)

    def run_j(jp):
        logits, cache = jm.prefill(jp, jnp.asarray(toks[:, :S]))
        cache = jax.tree.map(_grower(S, S + STEPS), cache)
        outs = []
        for i in range(STEPS):
            logits, cache = jm.decode_step(
                jp, cache, jnp.asarray(toks[:, S + i:S + i + 1]),
                jnp.asarray(S + i, jnp.int32))
            outs.append(logits)
        return outs, cache

    want, wcache = run_j(per[dtype][0])
    want32, wcache32 = run_j(per["fp32" if dtype == "fp32"
                                 else "fp32 init"][0])
    tp = per[dtype][1]
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])})
    grow = _grower(S, S + STEPS)
    cache = {s: {kv: grow(a) for kv, a in c.items()}
             for s, c in cache.items()}
    for i in range(STEPS):
        logits, cache = tm.decode_step(
            tp, cache, torch.from_numpy(toks[:, S + i:S + i + 1]),
            torch.tensor(S + i))
        _check(logits, want[i], want32[i], dtype)
    for g, w, w32 in zip(tree_leaves(cache), jax.tree.leaves(wcache),
                         jax.tree.leaves(wcache32)):
        _check(g, w, w32, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_ring_caches_match(models, arch):
    """forward's default ring layout: local layers' caches hold the
    window in ring slots, global ones the whole prompt (fp32)."""
    jm, tm, per = models[arch]
    jp, tp = per["fp32"]
    toks = _tokens(jm.cfg, (B, S), seed=2)
    _, wcache, _, _ = jm.forward(jp, jnp.asarray(toks))
    _, gcache, _, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                                 want_cache=True)
    for g, w in zip(tree_leaves(gcache), jax.tree.leaves(wcache)):
        assert _rel(g, w) < FP32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_init_cache_match(models, arch):
    jm, tm, _ = models[arch]
    for T in (20, 40):
        want = jax.tree.leaves(jm.m.cache_specs(3, T))
        got = tree_leaves(tm.cache_specs(3, T))
        assert [s for s, _ in got] == [tuple(a.shape) for a in want]
        assert all(d == torch.bfloat16 for _, d in got)
    zeros = tm.init_cache(3, 40, device="cpu")
    assert [tuple(a.shape) for a in tree_leaves(zeros)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jm.m.init_cache(3, 40))]
    assert all(not bool(a.any()) for a in tree_leaves(zeros))


def test_decode_from_init_cache_matches(models):
    """decode_step from zeros (a first token at position 0) on every
    family's cache layout, against the reference's (fp32)."""
    for arch in ARCHS:
        jm, tm, per = models[arch]
        jp, tp = per["fp32"]
        tok = _tokens(jm.cfg, (B, 1), seed=3)
        # the decode length of test_decode_steps_match: one compilation
        want, _ = jm.decode_step(jp, jm.m.init_cache(B, S + STEPS),
                                 jnp.asarray(tok), jnp.asarray(0, jnp.int32))
        got, _ = tm.decode_step(tp, tm.init_cache(B, S + STEPS,
                                                  device="cpu"),
                                torch.from_numpy(tok), 0)
        assert _rel(got, want) < FP32_TOL


def test_serve_step_is_decode_step(models):
    """make_prefill_step gives ring caches, make_serve_step decodes over
    them as Model.decode_step does."""
    jm, tm, per = models["gemma2-2b"]
    tp = per["fp32"][1]
    toks = torch.from_numpy(_tokens(jm.cfg, (B, S + 1), seed=4))
    _, cache = t_steps.make_prefill_step(tm)(tp, {"tokens": toks[:, :S]})
    assert cache["sub0"]["k"].shape[2] == tm.cfg.window_size   # local ring
    assert cache["sub1"]["k"].shape[2] == S                    # global
    cache = {s: {kv: _grower(S, S + 1)(a) for kv, a in c.items()}
             for s, c in cache.items()}
    clone = {s: {kv: a.clone() for kv, a in c.items()}
             for s, c in cache.items()}
    got, _ = t_steps.make_serve_step(tm)(tp, cache, toks[:, S:],
                                         torch.tensor(S))
    want, _ = tm.decode_step(tp, clone, toks[:, S:], torch.tensor(S))
    assert torch.equal(got, want)
    full = tm.forward(tp, {"tokens": toks})[0][:, -1]
    assert _rel(got[:, 0], full) < 2e-3
