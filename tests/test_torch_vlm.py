"""The port's vision-stub frontend (the vlm family: models/transformer.py's
``frontend_proj`` and ``_assemble_input``, the loss over the text rows,
the dense and paged decodes, the batch and the train step) against the
reference on tiny llava-next-mistral-7b (4 layers, d 128, 4/2 heads of
32), on the same numpy-seeded inputs and the reference's own parameters
(models/convert.py).

Tolerances are tests/test_torch_dense_decode.py's and
tests/test_torch_train.py's: the reference's init saturates attention, so
fp32 cases scale wq and wk by 1/8 in both packages and hold logits, caches
and hidden states to 1e-5 of their largest |value|, losses to 1e-5 and
gradients to 2e-5 per leaf (relative L2); bf16 cases run at the init and
are held to twice the reference's own bf16-vs-fp32 gap on the same inputs,
floored at 2e-2 (losses: 1e-2 with wq, wk scaled). The paged calls
follow tests/test_torch_models.py: their pools round fp32 k/v to bf16,
where a difference of an fp32 rounding can move a value by one bf16 ulp,
so pool pages are held to one bf16 ulp of each value plus the fp32
bound (1e-5 of the largest), and the logits and hidden states read
through them to 2e-4 of their largest |value|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig)
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        from_jax_state)
from repro_torch.models.params import (tree_leaves,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.transformer import chunked_ce  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

torch.set_num_threads(2)

ARCH = "llava-next-mistral-7b"
TOL = 1e-5
QK_SCALE = 0.125
BF16_FLOOR = 2e-2
LOSS_TOL = {"fp32": 1e-5, "bf16": 1e-2}
GRAD_TOL = 2e-5
PAGED_TOL = 2e-4
BF16_ULP = 2.0 ** -7          # one bf16 ulp is at most this of |x|
B, S_P, S_T, STEPS, PAGE = 2, 16, 48, 4, 16


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


def _scaled_qk(params, f):
    out = jax.tree.map(lambda a: a, params)
    for sub in out["blocks"].values():
        for n in ("wq", "wk"):
            a = sub["attn"][n]
            sub["attn"][n] = (a.astype(jnp.float32) * f).astype(a.dtype)
    return out


class _JModel:
    """The reference's Model with its entry points compiled."""

    def __init__(self, m):
        self.m, self.cfg = m, m.cfg
        self.forward = jax.jit(lambda p, b: m.forward(p, b, want_cache=True))
        self.hidden = jax.jit(lambda p, b: m.forward(
            p, b, unembed_mode="none")[0])
        self.prefill = jax.jit(lambda p, b: m.prefill(p, b,
                                                      cache_layout="full"))
        self.loss = jax.jit(m.loss)
        self.decode_step = jax.jit(m.decode_step)
        self.decode_paged = jax.jit(m.decode_step_paged)


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
    return _JModel(jm), t_build(t_tiny(ARCH)), per


def _batch(cfg, S_p=S_P, S_t=S_T, seed=0):
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((B, S_p, cfg.d_model)).astype(np.float32)
    toks = rng.integers(2, cfg.vocab_size, (B, S_t)).astype(np.int32)
    return {"patches": patches, "tokens": toks, "labels": toks}


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
    jm, tm, _ = models
    want = jax.tree.leaves(jm.m.defs)
    got = tree_leaves(tm.defs)
    assert [(tuple(d.shape), tuple(d.axes), d.init) for d in want] == \
        [(d.shape, d.axes, d.init) for d in got]
    assert tm.defs["frontend_proj"].shape == (128, 128)
    assert tm.param_count() == jm.m.param_count()


@pytest.mark.parametrize("S_p,S_t", [(S_P, S_T), (512, 1536)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_matches(models, dtype, S_p, S_t):
    """Logits, every cache leaf and the loss mask (0 on the patch rows,
    1 on the text); at 512 + 1536 rows the causal attention over
    [patches; tokens] is flash."""
    jm, tm, per = models
    batch = _batch(jm.cfg, S_p, S_t)
    jp, tp = per[dtype]
    want, wc, _, wmask = jm.forward(jp, _jb(batch))
    want32, wc32, _, _ = jm.forward(per["fp32 init"][0], _jb(batch))
    got, gc, aux, mask = tm.forward(tp, _tb(batch), want_cache=True)
    assert float(aux) == 0.0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    assert float(mask[:, :S_p].sum()) == 0 and bool((mask[:, S_p:] == 1)
                                                    .all())
    _check(got, want, want32, dtype)
    for g, w, w32 in zip(tree_leaves(gc), jax.tree.leaves(wc),
                         jax.tree.leaves(wc32)):
        _check(g, w, w32, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loss_matches(models, dtype):
    """Model.loss over the text rows only, wq, wk scaled in both
    dtypes."""
    jm, tm, per = models
    batch = _batch(jm.cfg, seed=5)
    jp, tp = per["fp32" if dtype == "fp32" else "bf16 scaled"]
    want = float(jm.loss(jp, _jb(batch)))
    got = float(tm.loss(tp, _tb(batch)))
    assert abs(got - want) <= LOSS_TOL[dtype] * (abs(want)
                                                 if dtype == "fp32" else 1)
    # the text rows alone, from the hidden states: the patch rows score
    # nothing
    hidden = tm.forward(tp, _tb(batch), unembed_mode="none")[0]
    alone = chunked_ce(tp, hidden[:, S_P:], torch.from_numpy(
        batch["labels"]), tm.cfg)
    assert float(alone) == got


@pytest.mark.parametrize("remat", [False, True])
def test_loss_gradients_match(models, remat):
    """Every gradient leaf in fp32, frontend_proj's included."""
    jm, tm, per = models
    batch = _batch(jm.cfg, seed=6)
    jp, tp = per["fp32"]
    lj, gj = jax.value_and_grad(lambda p: jm.m.loss(p, _jb(batch),
                                                    remat=remat))(jp)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(tp)]
    lt = tm.loss(tree_unflatten(tp, leaves), _tb(batch), remat=remat)
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lj) - float(lt.detach())) \
        <= LOSS_TOL["fp32"] * abs(float(lj))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    assert "['frontend_proj']" in paths
    for path, a, b in zip(paths, jax.tree.leaves(gj), gt):
        assert _rel_l2(a, b) <= GRAD_TOL, path


def _grower(cur, new):
    def grow(a):
        if a.shape[2] != cur:
            return a
        if isinstance(a, jax.Array):
            return jnp.pad(a, ((0, 0), (0, 0), (0, new - cur), (0, 0),
                               (0, 0)))
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, new - cur))
    return grow


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_steps_match(models, dtype):
    """make_prefill_step over [patches; tokens], the caches grown, then
    STEPS make_serve_step decodes, against the reference's decode_step
    from its own caches: logits each step, every cache leaf after."""
    jm, tm, per = models
    batch = _batch(jm.cfg, seed=7)
    S = S_P + S_T
    toks = np.random.default_rng(8).integers(
        2, jm.cfg.vocab_size, (B, STEPS)).astype(np.int32)

    def run_j(jp):
        _, cache = jm.prefill(jp, _jb(batch))
        cache = jax.tree.map(_grower(S, S + STEPS), cache)
        outs = []
        for i in range(STEPS):
            lg, cache = jm.decode_step(jp, cache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(S + i, jnp.int32))
            outs.append(lg)
        return outs, cache

    want, wcache = run_j(per[dtype][0])
    want32, wcache32 = run_j(per["fp32" if dtype == "fp32"
                                 else "fp32 init"][0])
    tp = per[dtype][1]
    _, cache = tsteps.make_prefill_step(tm)(tp, _tb(batch))
    grow = _grower(S, S + STEPS)
    cache = {s: {kv: grow(a) for kv, a in c.items()}
             for s, c in cache.items()}
    serve = tsteps.make_serve_step(tm)
    for i in range(STEPS):
        lg, cache = serve(tp, cache, torch.from_numpy(toks[:, i:i + 1]),
                          torch.tensor(S + i))
        _check(lg, want[i], want32[i], dtype)
    for g, w, w32 in zip(tree_leaves(cache), jax.tree.leaves(wcache),
                         jax.tree.leaves(wcache32)):
        _check(g, w, w32, dtype)


def test_decode_step_paged_matches(models):
    """decode_step_paged over the identity page pool of the prefill's
    caches (as the reference's generate builds it), against the
    reference's, fp32 parameters (the pools hold bf16 k/v in both)."""
    jm, tm, per = models
    jp, tp = per["fp32"]
    batch = _batch(jm.cfg, seed=9)
    S = S_P + S_T
    toks = np.random.default_rng(10).integers(
        2, jm.cfg.vocab_size, (B, STEPS)).astype(np.int32)
    _, jc = jm.prefill(jp, _jb(batch))
    jpool, jpt = j_serve._identity_paged_pool(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jc), B, S + STEPS,
        PAGE)
    _, tc = tm.prefill(tp, _tb(batch), cache_layout="full")
    tpool, tpt = t_serve._identity_paged_pool(
        {s: {kv: a.to(torch.bfloat16) for kv, a in c.items()}
         for s, c in tc.items()}, B, S + STEPS, PAGE)
    np.testing.assert_array_equal(tpt.numpy(), np.asarray(jpt))
    for i in range(STEPS):
        pos = np.full((B,), S + i, np.int32)
        want, jpool = jm.decode_paged(jp, jpool, jpt,
                                      jnp.asarray(toks[:, i:i + 1]),
                                      jnp.asarray(pos))
        got, tpool = tm.decode_step_paged(tp, tpool, tpt,
                                          torch.from_numpy(toks[:, i:i + 1]),
                                          torch.from_numpy(pos))
        assert _rel(got, want) < PAGED_TOL
    for g, w in zip(tree_leaves(tpool), jax.tree.leaves(jpool)):
        g, w = _np(g), _np(w)
        assert np.all(np.abs(g - w)
                      <= BF16_ULP * np.abs(w) + TOL * np.abs(w).max())


def test_paged_gates_are_the_references(models):
    """pool_specs and prefill_chunk_paged take vlm, as the reference's
    do (a chunk of tokens over a fresh pool, fp32 hidden states)."""
    jm, tm, per = models
    jp, tp = per["fp32"]
    jspec = jax.tree.leaves(jm.m.pool_specs(9, PAGE))
    tspec = tree_leaves(tm.pool_specs(9, PAGE))
    assert [tuple(s.shape) for s in jspec] == [s for s, _ in tspec]
    toks = np.random.default_rng(11).integers(
        2, jm.cfg.vocab_size, (B, 8)).astype(np.int32)
    pt = np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4)
    pos = np.zeros((B,), np.int32)
    want, _ = jm.m.prefill_chunk_paged(jp, jm.m.init_pool(9, PAGE),
                                       jnp.asarray(pt), jnp.asarray(toks),
                                       jnp.asarray(pos))
    got, _ = tm.prefill_chunk_paged(tp, tm.init_pool(9, PAGE, device="cpu"),
                                    torch.from_numpy(pt),
                                    torch.from_numpy(toks),
                                    torch.from_numpy(pos))
    assert _rel(got, want) < PAGED_TOL


def test_decode_follows_teacher_forced_forward(models):
    """The port on its own: prefill + decode steps equal its
    teacher-forced forward's rows (fp32)."""
    _, tm, per = models
    tp = per["fp32"][1]
    batch = _tb(_batch(tm.cfg, seed=12))
    S = S_P + S_T
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        2, tm.cfg.vocab_size, (B, STEPS)).astype(np.int32))
    want = tm.forward(tp, {"patches": batch["patches"],
                           "tokens": torch.cat([batch["tokens"], toks],
                                               dim=1)})[0]
    logits, cache = tm.prefill(tp, batch)
    assert _rel(logits[:, 0], want[:, S - 1]) < TOL
    cache = {s: {kv: _grower(S, S + STEPS)(a) for kv, a in c.items()}
             for s, c in cache.items()}
    for i in range(STEPS - 1):
        logits, cache = tm.decode_step(tp, cache, toks[:, i:i + 1],
                                       torch.tensor(S + i))
        assert _rel(logits[:, 0], want[:, S + i]) < TOL


def test_convert_carries_params_and_caches(models):
    """from_jax_params leaves the reference's trees as they are:
    frontend_proj and every other parameter, and the dense caches of a
    prefill over [patches; tokens] (keys, shapes, dtypes, values)."""
    jm, _, per = models
    jp = per["bf16"][0]
    for tree in (jp, jm.prefill(jp, _jb(_batch(jm.cfg)))[1]):
        t = from_jax_params(jax.tree.map(np.asarray, tree))
        jl = jax.tree_util.tree_flatten_with_path(tree)[0]
        tl = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: 0, t))[0]
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (_, a), b in zip(jl, tree_leaves(t)):
            assert str(np.asarray(a).dtype) == str(b.dtype).split(".")[-1]
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())


# ------------------------------------------------------- data and train ----
@pytest.mark.parametrize("step", [0, 3])
def test_batch_for_model_bit_identical(step):
    jm, tm = j_build(j_tiny(ARCH)), t_build(t_tiny(ARCH))
    for S, Bg in ((64, 2), (30, 3)):
        a = jdp.batch_for_model(jm, JShape("t", S, Bg, "train"), None, step)
        b = tdp.batch_for_model(tm, ShapeConfig("t", S, Bg, "train"), None,
                                step)
        assert sorted(a) == sorted(b) == ["labels", "patches", "tokens"]
        assert b["patches"].shape == (Bg, int(S * 0.25), 128)
        assert b["tokens"].shape == (Bg, S - int(S * 0.25))
        for k in a:
            want = np.asarray(a[k])
            got = b[k].view(torch.int16).numpy().view(np.uint16) \
                if b[k].dtype == torch.bfloat16 else b[k].numpy()
            np.testing.assert_array_equal(
                got, want.view(np.uint16) if k == "patches" else want)


def test_train_step_matches_reference(models):
    """One make_train_step (remat on) from the reference's state carried
    across, fp32 with wq, wk scaled, against the reference's compiled
    step, as tests/test_torch_train.py holds granite-moe's: loss, lr and
    grad norm, the masters within 2 lr everywhere and within 1e-3 lr on
    99.9% of the elements."""
    jm, tm, per = models
    jo = JOptim(lr=1e-3, warmup_steps=1, total_steps=10)
    tt = TrainConfig(optim=OptimConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10), remat=True)
    params = per["fp32"][0]
    jstate = {"params": params, "opt": jadam.adamw_init(params, jo)}
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    batch = _batch(jm.cfg, seed=14)
    jnew, jmet = jax.jit(jsteps.make_train_step(
        jm.m, JTrain(optim=jo, remat=True)))(jstate, _jb(batch))
    tnew, tmet = tsteps.make_train_step(tm, tt)(tstate, _tb(batch))
    assert abs(float(jmet["loss"]) - float(tmet["loss"])) \
        <= LOSS_TOL["fp32"] * abs(float(jmet["loss"]))
    for k in ("lr", "grad_norm"):
        assert abs(float(jmet[k]) - float(tmet[k])) \
            <= 1e-4 * abs(float(jmet[k]))
    lr = float(jmet["lr"])
    diffs = np.concatenate([
        np.abs(_np(a) - _np(b)).ravel() for a, b in zip(
            jax.tree.leaves(jnew["opt"]["master"]),
            tree_leaves(tnew["opt"]["master"]))])
    assert diffs.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(diffs > 1e-3 * lr) <= 1e-3
    moved = tnew["opt"]["master"]["frontend_proj"] - torch.from_numpy(
        np.array(params["frontend_proj"]))
    assert float(moved.abs().max()) > 0


def test_launch_train_runs(tmp_path):
    out = train_cli.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                          "--steps", "3", "--batch", "2", "--seq", "64",
                          "--ckpt-every", "0", "--log-every", "1",
                          "--lr", "3e-3", "--ckpt-dir", str(tmp_path)])
    losses = [r["loss"] for r in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert not any(tmp_path.iterdir())


def test_generate_refuses_and_names_the_serve_steps(models):
    _, tm, per = models
    with pytest.raises(NotImplementedError, match="make_serve_step"):
        t_serve.generate(tm, per["bf16"][1],
                         torch.zeros((1, 4), dtype=torch.int32), 2)
