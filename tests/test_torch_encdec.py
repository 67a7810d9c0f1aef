"""The port's encoder-decoder family (models/encdec.py, the cross
attention of models/attention.py, Model's encdec dispatch, the batch, the
train step and its checkpoints) against the reference on tiny
whisper-large-v3 (4 encoder and 4 decoder layers, d 128, 4/4 heads of
32), on the same numpy-seeded inputs and the reference's own parameters
(models/convert.py).

Tolerances, and why:
  * the sinusoid: inverse frequencies and angles bit for bit (the port
    evaluates the exp polynomial of the reference's CPU backend); sin and
    cos within one fp32 ulp (that backend calls the C library's sinf and
    cosf, the port rounds the fp64 value once: equal on ~98.7% of the
    elements), and the bf16-rounded tables the encoder and the decoder
    add bit for bit at these widths;
  * cross attention in fp32: 1e-5 of outputs of size ~1, as
    tests/test_torch_flash.py (flash and the dense branch differ only in
    summation order);
  * model calls as tests/test_torch_dense_decode.py: the reference's init
    draws the attention projections with fan-in H, which saturates the
    softmax, so the fp32 cases scale wq and wk (self and cross attention)
    by 1/8 in both packages and hold logits and caches to 1e-5 of their
    largest |value|; the bf16 cases run at the init and are held to twice
    the reference's own bf16-vs-fp32 gap on the same inputs, floored at
    2e-2. Losses 1e-5 (fp32) and 1e-2 (bf16), gradients 2e-5 per leaf
    (relative L2), as tests/test_torch_train.py, except the cross
    attention's wq, wk and its norm ln_x: cross attention over random
    memory is near uniform, so their gradients are small differences of
    large terms, and each package's fp32 value sits 1.3e-4 to 2.2e-4 from
    a float64 run of the same function; they are held to 1e-3.

The reference's encoder scans its layers with a bf16 carry, which fp32
weights break (the first layer's residual add promotes to fp32), so its
fp32 encoder is its own layer body unrolled here (``_j_encode``, held to
``encode`` within the bf16 floor in bf16 with wq, wk scaled, where the
reference's own compiled and eager encoders sit 8.6e-3 apart); its
decoder scans in fp32 as it is.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import encdec as j_enc  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.models.layers import ffn_apply as j_ffn  # noqa: E402
from repro.models.layers import rms_norm as j_norm  # noqa: E402
from repro.models.transformer import chunked_ce as j_ce  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig)
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_enc  # noqa: E402
from repro_torch.models import flash as t_flash  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        from_jax_state, to_tensor)
from repro_torch.models.params import (tree_leaves,  # noqa: E402
                                       tree_unflatten)
from repro_torch.training import steps as tsteps  # noqa: E402

torch.set_num_threads(2)

ARCH = "whisper-large-v3"
TOL = 1e-5                  # fp32 outputs and logits, of their max
QK_SCALE = 0.125
BF16_FLOOR = 2e-2
LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-2}
GRAD_TOL = 2e-5
XATTN_GRAD_TOL = 1e-3       # the cancelling leaves (docstring)
XATTN_LEAVES = ("['xattn']['wq']", "['xattn']['wk']", "['ln_x']")
B, S_ENC, S_DEC, STEPS = 2, 64, 8, 4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _rel_l2(want, got):
    w, g = _np(want), _np(got)
    return float(np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-30))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _bf16_bits(a):
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                      ).view(np.uint16)


# ------------------------------------------------------------- sinusoid ----
@pytest.mark.parametrize("S,d", [(1, 128), (64, 128), (2048, 128),
                                 (300, 1280)])
def test_sinusoidal_matches(S, d):
    want = np.asarray(j_enc.sinusoidal(S, d))
    got = t_enc.sinusoidal(S, d).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    inv = np.asarray(jnp.exp(-np.log(10000.0).astype(np.float64)
                             * jnp.arange(d // 2, dtype=jnp.float32)
                             / max(d // 2 - 1, 1)))
    np.testing.assert_array_equal(t_enc._inv_freq(d, "cpu").numpy(), inv)
    u = _ulps(got, want)
    assert u.max() <= 1 and np.mean(u == 0) > 0.97
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("pos", [0, 1, 7, 63, 2047, 8191])
def test_sinusoidal_at_matches(pos):
    d = 128
    want = np.asarray(j_enc.sinusoidal_at(jnp.asarray(pos, jnp.int32), d))
    got = t_enc.sinusoidal_at(torch.tensor(pos), d).numpy()
    assert _ulps(got, want).max() <= 1
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    # the port's row and its table agree exactly
    np.testing.assert_array_equal(got, t_enc.sinusoidal(pos + 1, d)[pos])


# ------------------------------------------------------- cross attention ----
@pytest.fixture(scope="module")
def xattn_params():
    rng = np.random.default_rng(1)
    shapes = {"wq": (128, 4, 32), "wk": (128, 4, 32), "wv": (128, 4, 32),
              "wo": (4, 32, 128)}
    jp = {k: jnp.asarray(rng.normal(size=v).astype(np.float32) / 11.3)
          for k, v in shapes.items()}
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _count_flash(monkeypatch):
    calls = []
    real = t_flash.flash_attention

    def counting(q, k, v, *a, **kw):
        calls.append((q.shape[1], k.shape[1]))
        return real(q, k, v, *a, **kw)
    monkeypatch.setattr(t_flash, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("S,T,flash", [(2048, 2560, True),
                                       (1, 8192, True),
                                       (16, 256, False),
                                       (1, 6144, False)])
def test_cross_attention_matches(xattn_params, monkeypatch, S, T, flash):
    """Both sides of the threshold (S >= 2048 or T >= 8192 goes to flash):
    against the reference, and each flash case against the einsum
    branch on the same inputs."""
    jp, tp = xattn_params
    cfg, tcfg = j_tiny(ARCH), t_tiny(ARCH)
    rng = np.random.default_rng(S + T)
    x = rng.normal(size=(1, S, 128)).astype(np.float32)
    mem = rng.normal(size=(1, T, 128)).astype(np.float32)
    mk, mv = j_attn.cross_kv(jp, jnp.asarray(mem))
    want = j_attn.cross_attention(jp, jnp.asarray(x), mk, mv, cfg)
    calls = _count_flash(monkeypatch)
    tk, tv = t_attn.cross_kv(tp, torch.from_numpy(mem))
    assert _rel(tk, mk) < TOL and _rel(tv, mv) < TOL
    got = t_attn.cross_attention(tp, torch.from_numpy(x), tk, tv, tcfg)
    assert calls == ([(S, T)] if flash else [])
    assert _rel(got, want) < TOL
    if flash:
        dense = t_attn._attend(
            t_attn._proj_in(torch.from_numpy(x), tp["wq"], "q"), tk, tv,
            torch.ones((1, 1, S, T), dtype=torch.bool), 0.0)
        assert _rel(got, t_attn._proj_out(dense, tp["wo"], "o")) < TOL


def test_cross_attention_dot_sites(xattn_params):
    """The ``dot`` hook reaches xattn_q, xattn_k and xattn_v and never
    the output projection, in both packages."""
    jp, tp = xattn_params
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 128)).astype(np.float32)
    mem = rng.normal(size=(1, 16, 128)).astype(np.float32)
    seen = {"j": [], "t": []}

    def jdot(a, w, name):
        seen["j"].append(name)
        return jnp.einsum("bsd,dnh->bsnh", a, w)

    def tdot(a, w, name):
        seen["t"].append(name)
        return torch.einsum("bsd,dnh->bsnh", a, w)
    mk, mv = j_attn.cross_kv(jp, jnp.asarray(mem), dot=jdot)
    want = j_attn.cross_attention(jp, jnp.asarray(x), mk, mv, j_tiny(ARCH),
                                  dot=jdot)
    tk, tv = t_attn.cross_kv(tp, torch.from_numpy(mem), dot=tdot)
    got = t_attn.cross_attention(tp, torch.from_numpy(x), tk, tv,
                                 t_tiny(ARCH), dot=tdot)
    assert seen["t"] == seen["j"] == ["xattn_k", "xattn_v", "xattn_q"]
    assert _rel(got, want) < TOL


# ----------------------------------------------------------------- model ----
def _scaled_qk(params, f):
    out = jax.tree.map(lambda a: a, params)
    for stack, sites in (("enc", ("attn",)), ("dec", ("attn", "xattn"))):
        for site in sites:
            for n in ("wq", "wk"):
                a = out[stack][site][n]
                out[stack][site][n] = (a.astype(jnp.float32) * f) \
                    .astype(a.dtype)
    return out


def _j_encode(params, frames, cfg):
    """The reference's ``encode``, its layer body unrolled."""
    S, D = frames.shape[1:]
    x = frames.astype(jnp.bfloat16) + \
        j_enc.sinusoidal(S, D).astype(jnp.bfloat16)
    for i in range(cfg.num_layers):
        p = jax.tree.map(lambda a: a[i], params["enc"])
        a, _ = j_attn.attention_fwd(p["attn"],
                                    j_norm(x, p["ln1"], cfg.norm_eps),
                                    "bidir", cfg, None)
        x = x + a
        x = x + j_ffn(p["ffn"], j_norm(x, p["ln2"], cfg.norm_eps),
                      cfg.activation)
    return j_norm(x, params["enc_norm"], cfg.norm_eps)


class _JRef:
    """The reference's entry points, run eagerly (``jax.disable_jit``), with
    the encoder unrolled: compiled, its bf16 first layer fuses into the
    fp32 rest and rounds elsewhere than its own definition (7.5e-4 of the
    largest value apart at fp32 here), while eagerly it follows it op by
    op, as the port does."""

    def __init__(self, m):
        self.m, self.cfg = m, m.cfg

    def encode(self, p, frames):
        with jax.disable_jit():
            return _j_encode(p, frames, self.cfg)

    def decode_fwd(self, p, mem, tokens):
        with jax.disable_jit():
            return j_enc.decode_fwd(p, mem, tokens, self.cfg,
                                    want_cache=True)

    def decode_step(self, *args):
        with jax.disable_jit():
            return self.m.decode_step(*args)

    def _loss(self, p, batch):
        mem = _j_encode(p, batch["frames"], self.cfg)
        hidden, _ = j_enc.decode_fwd(p, mem, batch["tokens"], self.cfg,
                                     want_cache=False, unembed_mode="none")
        return j_ce(p, hidden, batch["labels"], self.cfg)

    def loss(self, p, batch):
        with jax.disable_jit():
            return self._loss(p, batch)


@pytest.fixture(scope="module")
def models():
    jm = j_build(j_tiny(ARCH))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    per = {}
    for name, dt, f in (("bf16", jnp.bfloat16, 1.0),
                        ("bf16 scaled", jnp.bfloat16, QK_SCALE),
                        ("fp32", jnp.float32, QK_SCALE),
                        ("fp32 init", jnp.float32, 1.0)):
        jpd = jax.tree.map(lambda a: a.astype(dt)
                           if a.dtype == jnp.bfloat16 else a,
                           _scaled_qk(jp, f))
        per[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
    return _JRef(jm), t_build(t_tiny(ARCH)), per


def _batch(cfg, S_enc=S_ENC, S_dec=S_DEC, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_enc, cfg.d_model)).astype(np.float32)
    toks = rng.integers(2, cfg.vocab_size, (B, S_dec)).astype(np.int32)
    return {"frames": frames, "tokens": toks, "labels": toks}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check(got, want, want32, dtype):
    if dtype == "fp32":
        assert _rel(got, want) < TOL
    else:
        assert _rel(got, want) <= max(2 * _rel(want32, want), BF16_FLOOR)


def test_param_defs_match_reference(models):
    jr, tm, _ = models
    want = jax.tree.leaves(jr.m.defs)
    got = tree_leaves(tm.defs)
    assert [(tuple(d.shape), tuple(d.axes), d.init) for d in want] == \
        [(d.shape, d.axes, d.init) for d in got]
    assert set(tm.defs) == {"embed", "enc", "dec", "enc_norm",
                            "final_norm", "lm_head"}
    assert {"ln_x", "xattn"} <= set(tm.defs["dec"])
    assert tm.param_count() == jr.m.param_count()


def test_unrolled_encoder_is_the_references(models):
    jr, _, per = models
    frames = jnp.asarray(_batch(jr.cfg)["frames"])
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 and a.ndim > 1 else a,
                      per["fp32"][0])
    want = jax.jit(lambda p, f: j_enc.encode(p, f, jr.cfg))(jp, frames)
    assert _rel(jr.encode(jp, frames), want) < BF16_FLOOR


@pytest.mark.parametrize("S_enc", [S_ENC, 2048])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_encode_matches(models, dtype, S_enc):
    """The encoder (dense bidirectional at 64 frames, flash at 2048)."""
    jr, tm, per = models
    frames = _batch(jr.cfg, S_enc=S_enc)["frames"]
    want = jr.encode(per[dtype][0], jnp.asarray(frames))
    want32 = jr.encode(per["fp32 init"][0], jnp.asarray(frames))
    got = t_enc.encode(per[dtype][1], torch.from_numpy(frames), tm.cfg)
    assert got.dtype == (torch.float32 if dtype == "fp32"
                         else torch.bfloat16)
    _check(got, want, want32, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_fwd_and_forward_match(models, dtype):
    """decode_fwd on the reference's own encoder memory (logits and every
    cache leaf), then the whole Model.forward: (logits, caches, aux 0,
    no loss mask)."""
    jr, tm, per = models
    batch = _batch(jr.cfg)
    jp, tp = per[dtype]
    mem = jr.encode(jp, jnp.asarray(batch["frames"]))
    want, wc = jr.decode_fwd(jp, mem, jnp.asarray(batch["tokens"]))
    want32, wc32 = jr.decode_fwd(per["fp32 init"][0],
                                 jr.encode(per["fp32 init"][0],
                                           jnp.asarray(batch["frames"])),
                                 jnp.asarray(batch["tokens"]))
    got, gc = t_enc.decode_fwd(tp, to_tensor(np.asarray(mem)),
                               torch.from_numpy(batch["tokens"]), tm.cfg,
                               want_cache=True)
    _check(got, want, want32, dtype)
    assert sorted(gc) == ["k", "mk", "mv", "v"]
    for k in gc:
        _check(gc[k], wc[k], wc32[k], dtype)
    logits, caches, aux, mask = tm.forward(tp, _tb(batch), want_cache=True)
    assert mask is None and float(aux) == 0.0
    _check(logits, want, want32, dtype)
    for k in caches:
        _check(caches[k], wc[k], wc32[k], dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loss_matches(models, dtype):
    """Model.loss, with wq, wk scaled in both dtypes (the bf16 one
    against the reference's own Model.loss)."""
    jr, tm, per = models
    batch = _batch(jr.cfg, seed=5)
    jp, tp = per["fp32" if dtype == "fp32" else "bf16 scaled"]
    with jax.disable_jit():
        want = float(jr._loss(jp, _jb(batch)) if dtype == "fp32"
                     else jr.m.loss(jp, _jb(batch)))
    got = float(tm.loss(tp, _tb(batch)))
    assert abs(got - want) <= LOSS_TOL[dtype] * (abs(want)
                                                 if dtype == "fp32" else 1)


@pytest.mark.parametrize("S_enc,remat", [(S_ENC, False), (S_ENC, True),
                                         (2048, True)])
def test_loss_gradients_match(models, S_enc, remat):
    """Every gradient leaf (fp32; the encoder's flash at 2048 frames,
    whose backward is models/flash.py's)."""
    jr, tm, per = models
    batch = _batch(jr.cfg, S_enc=S_enc, seed=6)
    if S_enc > S_ENC:
        batch = {k: v[:1] for k, v in batch.items()}
    jp, tp = per["fp32"]
    with jax.disable_jit():
        lj, gj = jax.value_and_grad(jr._loss)(jp, _jb(batch))
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    params = tree_unflatten(tp, leaves)
    lt = tm.loss(params, _tb(batch), remat=remat)
    gt = torch.autograd.grad(lt, leaves)
    lt = lt.detach()
    assert abs(float(lj) - float(lt)) <= LOSS_TOL["fp32"] * abs(float(lj))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    for path, a, b in zip(paths, jax.tree.leaves(gj), gt):
        tol = XATTN_GRAD_TOL if path.endswith(XATTN_LEAVES) else GRAD_TOL
        assert _rel_l2(a, b) <= tol, path


def _grow_j(cache, new):
    return {k: (jnp.pad(a, ((0, 0), (0, 0), (0, new - a.shape[2]), (0, 0),
                            (0, 0))) if k in ("k", "v") else a)
            for k, a in cache.items()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_steps_match(models, dtype):
    """prefill (64 frames, 8 tokens), the self-attention caches grown,
    then STEPS decode_steps against the reference's from its own caches:
    logits each step and every cache leaf after the last."""
    jr, tm, per = models
    batch = _batch(jr.cfg, seed=7)
    toks = np.random.default_rng(8).integers(
        2, jr.cfg.vocab_size, (B, STEPS)).astype(np.int32)

    def run_j(jp):
        mem = jr.encode(jp, jnp.asarray(batch["frames"]))
        _, cache = jr.decode_fwd(jp, mem, jnp.asarray(batch["tokens"]))
        cache = _grow_j(cache, S_DEC + STEPS)
        outs = []
        for i in range(STEPS):
            lg, cache = jr.decode_step(jp, cache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(S_DEC + i, jnp.int32))
            outs.append(lg)
        return outs, cache

    want, wcache = run_j(per[dtype][0])
    want32, wcache32 = run_j(per["fp32" if dtype == "fp32"
                                 else "fp32 init"][0])
    tp = per[dtype][1]
    _, cache = tsteps.make_prefill_step(tm)(tp, _tb(batch))
    cache = t_enc.grow_cache(cache, S_DEC + STEPS)
    serve = tsteps.make_serve_step(tm)
    for i in range(STEPS):
        lg, cache = serve(tp, cache, torch.from_numpy(toks[:, i:i + 1]),
                          torch.tensor(S_DEC + i))
        _check(lg, want[i], want32[i], dtype)
    for k in ("k", "v", "mk", "mv"):
        _check(cache[k], wcache[k], wcache32[k], dtype)


def test_decode_step_cross_flash_at_long_memory(models, monkeypatch):
    """One decode step over an 8192-frame memory: each layer's cross
    attention is flash at S = 1 (fp32, against the reference)."""
    jr, tm, per = models
    jp, tp = per["fp32"]
    cfg = jr.cfg
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(9)
    cache = {"k": rng.normal(size=(L, 1, 16, K, hd)),
             "v": rng.normal(size=(L, 1, 16, K, hd)),
             "mk": rng.normal(size=(L, 1, 8192, K, hd)),
             "mv": rng.normal(size=(L, 1, 8192, K, hd))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    tok = np.array([[7]], np.int32)
    want, _ = jr.decode_step(jp, {k: jnp.asarray(v) for k, v in
                                  cache.items()}, jnp.asarray(tok),
                             jnp.asarray(11, jnp.int32))
    calls = _count_flash(monkeypatch)
    got, _ = tm.decode_step(tp, {k: torch.from_numpy(v.copy())
                                 for k, v in cache.items()},
                            torch.from_numpy(tok), torch.tensor(11))
    assert calls == [(1, 8192)] * L
    assert _rel(got, want) < TOL


def test_decode_follows_teacher_forced_forward(models):
    """The port on its own: prefill + decode steps over the generated
    positions equal its teacher-forced forward's rows (fp32)."""
    _, tm, per = models
    tp = per["fp32"][1]
    batch = _tb(_batch(tm.cfg, seed=10))
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        2, tm.cfg.vocab_size, (B, STEPS)).astype(np.int32))
    full = torch.cat([batch["tokens"], toks], dim=1)
    want = tm.forward(tp, {"frames": batch["frames"], "tokens": full})[0]
    logits, cache = tm.prefill(tp, batch)
    assert _rel(logits[:, 0], want[:, S_DEC - 1]) < TOL
    cache = t_enc.grow_cache(cache, S_DEC + STEPS)
    for i in range(STEPS - 1):
        logits, cache = tm.decode_step(tp, cache, toks[:, i:i + 1],
                                       torch.tensor(S_DEC + i))
        assert _rel(logits[:, 0], want[:, S_DEC + i]) < TOL


@pytest.mark.parametrize("seq", [64, 200])
def test_cache_specs_match(models, seq):
    jr, tm, _ = models
    want = jr.m.cache_specs(3, seq)
    got = tm.cache_specs(3, seq)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == (tuple(want[k].shape), torch.bfloat16)
    zeros = tm.init_cache(3, seq, device="cpu")
    assert all(not bool(a.any()) and a.shape == want[k].shape
               for k, a in zeros.items())


def test_grow_cache_pads_self_attention_only():
    """With the encoder as long as the decoder prompt, only k and v
    grow."""
    c = {k: torch.ones((2, 1, 8, 2, 4)) for k in ("k", "v", "mk", "mv")}
    g = t_enc.grow_cache(c, 12)
    assert g["k"].shape[2] == g["v"].shape[2] == 12
    assert g["mk"] is c["mk"] and g["mv"] is c["mv"]
    assert not bool(g["k"][:, :, 8:].any())


def test_convert_carries_params_and_caches(models):
    """from_jax_params leaves the reference's trees as they are: every
    key, shape, dtype and value, parameters and dense caches."""
    jr, tm, per = models
    jp = per["bf16"][0]
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(
             jax.tree.map(lambda t: 0, tp))[0]]
    for (_, a), b in zip(jl, tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    batch = _batch(jr.cfg)
    _, jc = jr.decode_fwd(jp, jr.encode(jp, jnp.asarray(batch["frames"])),
                          jnp.asarray(batch["tokens"]))
    tc = from_jax_params(jax.tree.map(np.asarray, jc))
    for k in jc:
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(jc[k], np.float32),
                                      tc[k].float().numpy())


# ------------------------------------------------------- data and train ----
@pytest.mark.parametrize("step", [0, 3])
def test_batch_for_model_bit_identical(step):
    jm, tm = j_build(j_tiny(ARCH)), t_build(t_tiny(ARCH))
    for S, Bg in ((64, 2), (8, 3)):
        shape_j, shape_t = JShape("t", S, Bg, "train"), \
            ShapeConfig("t", S, Bg, "train")
        a = jdp.batch_for_model(jm, shape_j, None, step)
        b = tdp.batch_for_model(tm, shape_t, None, step)
        assert sorted(a) == sorted(b) == ["frames", "labels", "tokens"]
        assert b["frames"].dtype == torch.bfloat16
        assert b["tokens"].shape == (Bg, max(S // 8, 2))
        for k in a:
            want = np.asarray(a[k])
            got = b[k].view(torch.int16).numpy().view(np.uint16) \
                if b[k].dtype == torch.bfloat16 else b[k].numpy()
            np.testing.assert_array_equal(
                got, want.view(np.uint16) if k == "frames" else want)


def test_train_step_matches_reference(models):
    """One make_train_step (remat on) from the reference's state carried
    across, fp32 with wq, wk scaled: loss, lr, grad norm and the new
    master against the reference's step (its loss with the encoder
    unrolled), as tests/test_torch_train.py holds granite-moe's: every
    element within 2 lr, and within 1e-3 lr on 99.9% of the elements of
    the leaves whose gradients are not the cancelling ones."""
    jr, tm, per = models
    jo = JOptim(lr=1e-3, warmup_steps=1, total_steps=10)
    tt = TrainConfig(optim=OptimConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10), remat=True)

    class _Loss:
        def loss(self, p, batch, **kw):
            return jr._loss(p, batch)

    params = per["fp32"][0]
    jstate = {"params": params, "opt": jadam.adamw_init(params, jo)}
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    batch = _batch(jr.cfg, seed=12)
    with jax.disable_jit():
        jnew, jmet = jsteps.make_train_step(
            _Loss(), JTrain(optim=jo, remat=True))(jstate, _jb(batch))
    tnew, tmet = tsteps.make_train_step(tm, tt)(tstate, _tb(batch))
    assert abs(float(jmet["loss"]) - float(tmet["loss"])) \
        <= LOSS_TOL["fp32"] * abs(float(jmet["loss"]))
    for k in ("lr", "grad_norm"):
        assert abs(float(jmet[k]) - float(tmet[k])) \
            <= 1e-4 * abs(float(jmet[k]))
    lr = float(jmet["lr"])
    masters = jax.tree_util.tree_flatten_with_path(jnew["opt"]["master"])[0]
    diffs = {jax.tree_util.keystr(path): np.abs(_np(a) - _np(b)).ravel()
             for (path, a), b in zip(masters,
                                     tree_leaves(tnew["opt"]["master"]))}
    assert max(d.max() for d in diffs.values()) <= 2 * lr * (1 + 1e-3)
    rest = np.concatenate([d for k, d in diffs.items()
                           if not k.endswith(XATTN_LEAVES)])
    assert np.mean(rest > 1e-3 * lr) <= 1e-3


def test_launch_train_checkpoints_in_the_reference_layout(tmp_path):
    """launch.train on tiny whisper (2 steps, a checkpoint each): finite
    losses, and the reference restores the port's checkpoint into its
    own train state, enc/dec trees included, with the same tree record
    its own writer gives."""
    out = train_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", "64",
                          "--ckpt-every", "1", "--log-every", "1",
                          "--ckpt-dir", str(tmp_path)])
    assert all(np.isfinite(r["loss"]) for r in out["history"])
    jm = j_build(j_tiny(ARCH))
    jo = JOptim(lr=3e-4, total_steps=2, warmup_steps=1)
    params = jm.init(jax.random.PRNGKey(0))
    like = {"params": params, "opt": jadam.adamw_init(params, jo)}
    root = tmp_path / (ARCH + "-tiny")
    back, step = jckpt.restore(str(root), like)
    assert step == 1
    tl = tree_leaves(out["state"])
    jl = jax.tree.leaves(back)
    assert len(tl) == len(jl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(
            np.reshape(np.asarray(a, np.float32), tuple(b.shape)),
            b.float().numpy())
    jckpt.save(str(tmp_path / "ref"), 1, back)
    ours = json.loads((root / "step_1" / "tree.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_1" / "tree.json")
                     .read_text())
    assert ours["treedef"] == ref["treedef"]
    assert "'enc'" in ours["treedef"] and "'xattn'" in ours["treedef"]


def test_generate_refuses_and_names_the_serve_steps(models):
    _, tm, per = models
    with pytest.raises(NotImplementedError, match="make_prefill_step"):
        t_serve.generate(tm, per["bf16"][1],
                         torch.zeros((1, 4), dtype=torch.int32), 2)
