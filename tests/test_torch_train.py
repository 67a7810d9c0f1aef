"""The port's training path against the reference, on the CPU: the data
pipeline, AdamW, the loss and every gradient of tiny gemma2-2b (S 64
dense; S 2048 through flash, whose backward tests/test_torch_flash_bwd.py
checks alone; remat on and off), one train step of tiny granite-moe (aux
loss included), the trainer loop, its restart and ``launch.train``. Each
package gets the same numpy inputs; the reference's parameters are
carried across (models/convert.py).

Tolerances, and why:
  * data: bit-identical (both draw the same numpy generators);
  * AdamW on shared gradients: fp32 state within 2**-20 of each value
    and of one update (lr) (the arithmetic is the reference's elementwise
    fp32; only pow, cos and the global norm's summation order may round
    differently); moment codes and scales bit for bit with the clip
    inactive (scale exactly 1);
  * the model: the reference's own initialisation draws the attention
    projections with fan-in H (their (d, H, hd) shape), so the tiny
    models' scores are O(100) and the softmax saturated: a gradient is
    then a difference of nearly equal terms. The reference's own jit and
    eager gradients differ by 7.3e-5 (per-leaf relative L2) at fp32 there,
    and its bf16 gradients by 1.00 from its fp32 ones. So the exact check
    scales wq and wk by 1/8 in both packages (the same numbers): fp32
    gradients within 2e-5 per leaf (relative L2; measured <= 2.1e-6), bf16
    within 0.05 (the reference's own bf16 gradients sit 0.018 from its
    fp32 ones there). At the reference's init, fp32 gradients within 1e-3
    (measured 1.3e-4). Losses within 1e-5 (fp32) and 1e-2 (bf16).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig)
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    StragglerConfig, StragglerMonitor)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        from_jax_state)
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.training.loop import train  # noqa: E402

torch.set_num_threads(2)

F32_STATE_RTOL = 2.0 ** -20
GRAD_TOL = {"f32": 2e-5, "bf16": 0.05}
SATURATED_F32_TOL = 1e-3
LOSS_TOL = {"f32": 1e-5, "bf16": 1e-2}
QK_SCALE = 0.125


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel_l2(want, got):
    w, g = _np(want), _np(got)
    return float(np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-30))


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_batches_bit_identical(seed):
    dcfg = jdp.DataConfig(vocab_size=512, seq_len=48, global_batch=4,
                          seed=seed)
    tcfg = tdp.DataConfig(vocab_size=512, seq_len=48, global_batch=4,
                          seed=seed)
    cfg = j_tiny("gemma2-2b")
    shape = ShapeConfig("t", 48, 4, "train")
    jm, tm = j_build(cfg), t_build(t_tiny("gemma2-2b"))
    for step in (0, 1, 7, 100):
        a, b = jdp.batch_at(dcfg, step), tdp.batch_at(tcfg, step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        a = jdp.batch_for_model(jm, shape, dcfg, step)
        b = tdp.batch_for_model(tm, shape, tcfg, step)
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32
            np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())
    assert not np.array_equal(tdp.batch_at(tcfg, 7)["tokens"],
                              tdp.batch_at(tcfg, 8)["tokens"])


def test_batch_for_model_refuses_other_families():
    """The stub-frontend families, which the port refused before it ran
    them, now take the reference's batches bit for bit: whisper's frames
    and decoder tokens, llava's patches and text."""
    for arch, stub in (("whisper-large-v3", "frames"),
                       ("llava-next-mistral-7b", "patches")):
        jm, tm = j_build(j_tiny(arch)), t_build(t_tiny(arch))
        a = jdp.batch_for_model(jm, ShapeConfig("t", 16, 2, "train"), None,
                                0)
        b = tdp.batch_for_model(tm, ShapeConfig("t", 16, 2, "train"), None,
                                0)
        assert sorted(a) == sorted(b) == sorted(["labels", "tokens", stub])
        assert b[stub].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            b[stub].view(torch.int16).numpy().view(np.uint16),
            np.asarray(a[stub]).view(np.uint16))
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


# ----------------------------------------------------------------- AdamW --
def _adam_case(seed, quantized, clip):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 256), "b": {"c": (3, 100), "d": (7,)}}
    params = jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: rng.standard_normal(s).astype(
        np.float32) * 0.3, shapes, is_leaf=lambda x: isinstance(x, tuple))
        for _ in range(3)]
    kw = dict(lr=0.01, warmup_steps=2, total_steps=10, grad_clip=clip,
              quantized_moments=quantized)
    return params, grads, JOptim(**kw), OptimConfig(**kw)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("clip", [1e9, 1.0])
def test_adamw_update_matches_reference(quantized, clip):
    """Three steps on the same numpy gradients; the reference run eagerly
    (jax.disable_jit), op by op as its definition reads."""
    params, grads, jo, to = _adam_case(7, quantized, clip)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = tree_map(lambda a: torch.from_numpy(a).bfloat16(), params)
    with jax.disable_jit():
        js = jadam.adamw_init(jp, jo)
        ts = tadam.adamw_init(tp, to)
        for g in grads:
            jp, js, jmet = jadam.adamw_update(
                jax.tree.map(jnp.asarray, g), js, jo)
            tp, ts, tmet = tadam.adamw_update(
                tree_map(torch.from_numpy, g), ts, to)
            assert int(ts["count"]) == int(js["count"])
            for k in ("lr", "grad_norm"):
                assert abs(float(tmet[k]) - float(jmet[k])) \
                    <= F32_STATE_RTOL * abs(float(jmet[k]))
    for a, b in zip(jax.tree.leaves(js["master"]),
                    tree_leaves(ts["master"])):
        # and 2**-20 of one update's size (lr): the clip scale may differ
        # by an ulp with the global norm's summation order
        np.testing.assert_allclose(_np(b), _np(a), rtol=F32_STATE_RTOL,
                                   atol=F32_STATE_RTOL * to.lr)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert b.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(b), _np(a), rtol=2.0 ** -8)
    for mom in ("m", "v"):
        ja, ta = jax.tree.leaves(js[mom]), tree_leaves(ts[mom])
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            if quantized and clip > 1e6:     # scale exactly 1: bit for bit
                assert b.dtype == (torch.int8 if a.dtype == jnp.int8
                                   else torch.float32)
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
            else:
                np.testing.assert_allclose(
                    _np(b), _np(a), rtol=F32_STATE_RTOL,
                    atol=F32_STATE_RTOL * float(np.abs(_np(a)).max())
                    if not quantized else 1.0)


def test_quantize_moment_codes_bit_identical():
    rng = np.random.default_rng(5)
    for shape, block in (((4, 256), 128), ((3, 100), 128), ((7,), 128),
                         ((2, 3, 64), 32)):
        x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(
            -4, 1, shape)).astype(np.float32)
        x.flat[0] = 0.5 * 127      # a half-way code
        with jax.disable_jit():
            a = jadam.quantize_moment(jnp.asarray(x), block)
        b = tadam.quantize_moment(torch.from_numpy(x), block)
        np.testing.assert_array_equal(np.asarray(a["q"]), b["q"].numpy())
        np.testing.assert_array_equal(np.asarray(a["scale"]),
                                      b["scale"].numpy())
        np.testing.assert_array_equal(
            np.asarray(jadam.dequantize_moment(a, shape)),
            tadam.dequantize_moment(b, shape).numpy())
        assert tadam.moment_block_for(shape, block) == \
            jadam.moment_block_for(shape, block)


def test_cosine_lr_across_warmup_and_decay():
    for jo, to in ((JOptim(lr=3e-4, warmup_steps=10, total_steps=50),
                    OptimConfig(lr=3e-4, warmup_steps=10, total_steps=50)),
                   (JOptim(lr=1.0, warmup_steps=0, total_steps=1),
                    OptimConfig(lr=1.0, warmup_steps=0, total_steps=1))):
        for step in range(0, 56):
            a = float(jadam.cosine_lr(jnp.asarray(step, jnp.int32), jo))
            b = float(tadam.cosine_lr(torch.tensor(step, dtype=torch.int32),
                                      to))
            # an ulp of cos (6e-8 of 1) moves 1 + cos by that much, which
            # is relative to lr, not to the small lr near the end
            assert abs(a - b) <= 2.0 ** -22 * abs(a) + 2.0 ** -23 * to.lr, \
                (step, a, b)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = {"a": rng.standard_normal((10, 30)).astype(np.float32) * 50,
         "b": {"c": rng.standard_normal((17,)).astype(np.float32)}}
    for max_norm in (1.0, 1e6):
        ja, jn = jadam.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                           max_norm)
        ta, tn = tadam.clip_by_global_norm(tree_map(torch.from_numpy, g),
                                           max_norm)
        assert abs(float(jn) - float(tn)) <= 1e-6 * float(jn)
        for a, b in zip(jax.tree.leaves(ja), tree_leaves(ta)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=0)
    clipped, _ = tadam.clip_by_global_norm(
        {"a": torch.full((10,), 100.0)}, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5


def test_adamw_converges_quadratic():
    """The reference's substrate test, on the port."""
    ocfg = OptimConfig(lr=0.05, warmup_steps=1, total_steps=400,
                       weight_decay=0.0, grad_clip=10.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    state = tadam.adamw_init({"w": torch.zeros(3, dtype=torch.bfloat16)},
                             ocfg)
    for _ in range(300):
        grads = {"w": state["master"]["w"] - target}
        _, state, _ = tadam.adamw_update(grads, state, ocfg)
    assert float((state["master"]["w"] - target).abs().max()) < 0.05


def test_quantized_moments_track_fp32():
    finals = {}
    for qm in (False, True):
        ocfg = OptimConfig(lr=0.01, warmup_steps=1, total_steps=100,
                           quantized_moments=qm)
        state = tadam.adamw_init(
            {"w": torch.ones((4, 256), dtype=torch.bfloat16)}, ocfg)
        g = {"w": torch.full((4, 256), 0.1)}
        for _ in range(10):
            _, state, _ = tadam.adamw_update(g, state, ocfg)
        finals[qm] = state["master"]["w"]
    assert float((finals[True] - finals[False]).abs().max()) < 1e-3


# ----------------------------------------------------------------- model --
def _scaled_qk(params, f):
    """wq and wk of every layer times f (the same numbers in both
    packages: the reference's params are converted afterwards)."""
    out = jax.tree.map(lambda a: a, params)
    for sub in out["blocks"].values():
        for n in ("wq", "wk"):
            a = sub["attn"][n]
            sub["attn"][n] = (a.astype(jnp.float32) * f).astype(a.dtype)
    return out


def _jax_params(arch, dtype, qk_scale):
    p = j_build(j_tiny(arch)).init(jax.random.PRNGKey(0))
    if qk_scale != 1.0:
        p = _scaled_qk(p, qk_scale)
    if dtype == "f32":
        p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    return p


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _loss_and_grads(arch, S, B, dtype, remat, qk_scale):
    jm, tm = j_build(j_tiny(arch)), t_build(t_tiny(arch))
    pj = _jax_params(arch, dtype, qk_scale)
    toks = _tokens(jm.cfg, B, S)
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    lj, gj = jax.value_and_grad(lambda p: jm.loss(p, bj, remat=remat))(pj)
    pt = from_jax_params(jax.tree.map(np.asarray, pj))
    leaves = tree_leaves(pt)
    for p in leaves:
        p.requires_grad_(True)
    bt = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)}
    lt = tm.loss(pt, bt, remat=remat)
    gt = torch.autograd.grad(lt, leaves)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gj)[0]]
    return float(lj), float(lt.detach()), paths, jax.tree.leaves(gj), gt, \
        leaves


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("S,B", [(64, 2), (2048, 1)])
def test_tiny_gemma_loss_and_grads_match_reference(S, B, remat):
    """Every gradient leaf of tiny gemma2-2b at fp32 (S 64: dense
    attention; S 2048: flash, its backward included)."""
    lj, lt, paths, gj, gt, leaves = _loss_and_grads(
        "gemma2-2b", S, B, "f32", remat, QK_SCALE)
    assert abs(lj - lt) <= LOSS_TOL["f32"] * abs(lj)
    assert len(gj) == len(gt)
    for path, a, b, p in zip(paths, gj, gt, leaves):
        assert b.dtype == p.dtype and b.shape == p.shape
        assert _rel_l2(a, b) <= GRAD_TOL["f32"], path


@pytest.mark.parametrize("S,B", [(64, 2), (2048, 1)])
def test_tiny_gemma_bf16_grads_match_reference(S, B):
    lj, lt, paths, gj, gt, leaves = _loss_and_grads(
        "gemma2-2b", S, B, "bf16", False, QK_SCALE)
    assert abs(lj - lt) <= LOSS_TOL["bf16"]
    for path, a, b, p in zip(paths, gj, gt, leaves):
        assert b.dtype == p.dtype
        assert _rel_l2(a, b) <= GRAD_TOL["bf16"], path


def test_embedding_lookup_gradient_is_the_references_bf16_sum():
    """The gradient a bf16 table gets from a lookup that repeats one row
    1806 times (token 2's count in tiny gemma2-2b's first S 2048 x B 2
    batch): the reference's transpose of the gather and the port's
    autograd both add the rows in bf16, to the same bits, and both fall
    short of the fp32 sum (scripts/microbatch_grad_gap.py shows this sum
    carries the gap between a whole-batch and a microbatched bf16
    gradient)."""
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((1806, 4)) * 0.01 + 0.003).astype(np.float32)
    idx = np.zeros(1806, np.int32)
    jg = jax.grad(lambda t: jnp.sum(t[idx].astype(jnp.float32) * rows))(
        jnp.zeros((2, 4), jnp.bfloat16))
    table = torch.zeros(2, 4, dtype=torch.bfloat16, requires_grad=True)
    torch.sum(table[torch.from_numpy(idx).long()].float()
              * torch.from_numpy(rows)).backward()
    got = table.grad.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(jg, np.float32))
    exact = rows.sum(0)
    assert np.linalg.norm(got[0] - exact) > 0.05 * np.linalg.norm(exact)


def test_tiny_gemma_grads_at_reference_init():
    """The reference's own initialisation (saturated attention): fp32
    gradients within 1e-3 per leaf."""
    lj, lt, paths, gj, gt, _ = _loss_and_grads("gemma2-2b", 64, 2, "f32",
                                               False, 1.0)
    assert abs(lj - lt) <= LOSS_TOL["f32"] * abs(lj)
    for path, a, b in zip(paths, gj, gt):
        assert _rel_l2(a, b) <= SATURATED_F32_TOL, path


@pytest.mark.parametrize("S", [64, 2048])
def test_remat_gives_the_same_gradients(S):
    """remat on and off: bit for bit on the CPU (bf16 parameters)."""
    tm = t_build(t_tiny("gemma2-2b"))
    toks = torch.from_numpy(_tokens(tm.cfg, 1, S, seed=4))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for remat in (False, True):
        params = tm.init(torch.Generator().manual_seed(0), "cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tm.loss(params, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_tiny_granite_moe_train_step_matches_reference():
    """One make_train_step of tiny granite-moe (its aux loss carries a
    gradient to the routers) from the reference's state carried across,
    fp32 parameters with wq, wk scaled as above: loss, grad norm, lr and
    the new master against the reference's jitted step. Adam's first step
    is lr * g / (|g| + eps) per element, so an element whose gradient sits
    at rounding noise may move by up to 2 lr the other way: the masters
    are held to 2 lr everywhere and to 1e-3 lr on 99.9% of elements."""
    arch = "granite-moe-3b-a800m"
    jm, tm = j_build(j_tiny(arch)), t_build(t_tiny(arch))
    jo = JOptim(lr=1e-3, warmup_steps=1, total_steps=10)
    jt = JTrain(optim=jo, remat=True)
    tt = TrainConfig(optim=OptimConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10), remat=True)
    params = _jax_params(arch, "f32", QK_SCALE)
    jstate = {"params": params, "opt": jadam.adamw_init(params, jo)}
    tstate = from_jax_state(jax.tree.map(np.asarray, jstate))
    assert tstate["opt"]["count"].dtype == torch.int32
    toks = _tokens(jm.cfg, 2, 64, seed=9)
    jnew, jmet = jax.jit(jsteps.make_train_step(jm, jt))(
        jstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    tnew, tmet = tsteps.make_train_step(tm, tt)(
        tstate, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(toks)})
    assert abs(float(jmet["loss"]) - float(tmet["loss"])) \
        <= LOSS_TOL["f32"] * abs(float(jmet["loss"]))
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
    router = tnew["opt"]["master"]["blocks"]["sub0"]["moe"]["router"]
    moved = router - torch.from_numpy(
        np.array(params["blocks"]["sub0"]["moe"]["router"]))
    assert float(moved.abs().max()) > 0
    for leaf in tree_leaves(tnew["params"]):
        assert leaf.dtype == torch.bfloat16


def test_moe_aux_loss_carries_gradient():
    """The load-balance loss alone moves the routers, as in the
    reference: its gradient against jax.grad of the same term."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = j_tiny("granite-moe-3b-a800m")
    p = _jax_params("granite-moe-3b-a800m", "f32", 1.0)
    pm = jax.tree.map(lambda a: a[0], p["blocks"]["sub0"]["moe"])
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)) \
        .astype(np.float32)
    gj = jax.grad(lambda r: jmoe.moe_apply({**pm, "router": r},
                                           jnp.asarray(x), cfg.moe)[1])(
        pm["router"])
    tp = from_jax_params(jax.tree.map(np.asarray, pm))
    r = tp["router"].requires_grad_(True)
    aux = tmoe.moe_apply({**tp, "router": r}, torch.from_numpy(x),
                         t_tiny("granite-moe-3b-a800m").moe)[1]
    gt, = torch.autograd.grad(aux, r)
    assert float(gt.abs().max()) > 0
    assert _rel_l2(gj, gt) <= 1e-5


# ------------------------------------------------------------ train step --
def test_microbatched_train_step_matches_full():
    """The reference's substrate test, on the port."""
    tm = t_build(t_tiny("granite-3-8b"))
    toks = torch.from_numpy(_tokens(tm.cfg, 4, 32, seed=1))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for M in (1, 2):
        tcfg = TrainConfig(optim=OptimConfig(lr=1e-2, grad_clip=1e9),
                           microbatches=M)
        state = tsteps.init_train_state(
            tm, tcfg, torch.Generator().manual_seed(0), "cpu")
        out.append(tsteps.make_train_step(tm, tcfg)(state, batch))
    (s1, m1), (s2, m2) = out
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    for a, b in zip(tree_leaves(s1["opt"]["master"]),
                    tree_leaves(s2["opt"]["master"])):
        assert float((a - b).abs().max()) < 5e-3


def test_prefill_step_and_serve_step():
    """The prefill step gives the reference's default ring layout (the
    local sub0's 16 positions in a 32-slot ring, global sub1's 16), and
    the serve step decodes over it as Model.decode_step does
    (tests/test_torch_dense_decode.py holds both against the
    reference)."""
    tm = t_build(t_tiny("gemma2-2b"))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 17))
    logits, cache = tsteps.make_prefill_step(tm)(params,
                                                 {"tokens": toks[:, :16]})
    want, _ = tm.prefill(params, {"tokens": toks[:, :16]})
    assert torch.equal(logits, want)
    assert cache["sub0"]["k"].shape[2] == tm.cfg.window_size
    assert cache["sub1"]["k"].shape[2] == 16
    cache["sub1"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                     for k, v in cache["sub1"].items()}
    got, _ = tsteps.make_serve_step(tm)(params, cache, toks[:, 16:],
                                        torch.tensor(16))
    full = tm.forward(params, {"tokens": toks})[0][:, -1]
    # the reference's own bound for it (tests/test_decode_equivalence.py)
    assert float((got[:, 0] - full).abs().max()) < 2e-2 * float(
        full.abs().max())


def test_straggler_monitor_flags_slow_steps():
    fired = []
    mon = StragglerMonitor(StragglerConfig(window=8, multiplier=2.0,
                                           strikes=2),
                           on_straggler=fired.append)
    for step in range(8):
        mon.record(step, 0.1)
    assert not mon.record(8, 0.15)
    assert mon.record(9, 0.5)       # breach 1
    assert mon.record(10, 0.5)      # breach 2 -> eviction callback
    assert fired and fired[0]["strikes"] == 2


# ------------------------------------------------------------------- loop --
def _tcfg(tmp_path, every, total=20):
    return TrainConfig(optim=OptimConfig(lr=1e-3, total_steps=total),
                       checkpoint_dir=str(tmp_path), checkpoint_every=every,
                       log_every=1)


def test_train_restart_exact(tmp_path):
    """The reference's substrate test (10 steps, then 14 resumed from the
    checkpoint), and resume exactness: 3 + 3 resumed steps equal 6 in one
    run bit for bit, losses and parameters."""
    tm = t_build(t_tiny("granite-3-8b"))
    shape = ShapeConfig("t", 32, 4, "train")
    quiet = dict(device="cpu", log=lambda r: None)
    train(tm, shape, _tcfg(tmp_path / "a", 5), num_steps=10, **quiet)
    out2 = train(tm, shape, _tcfg(tmp_path / "a", 5), num_steps=14,
                 **quiet)
    assert out2["history"][0]["step"] >= 10

    whole = train(tm, shape, _tcfg(tmp_path / "b", 0), num_steps=6, **quiet)
    train(tm, shape, _tcfg(tmp_path / "c", 3), num_steps=3, **quiet)
    rest = train(tm, shape, _tcfg(tmp_path / "c", 3), num_steps=6, **quiet)
    assert [r["step"] for r in rest["history"]] == [3, 4, 5]
    assert [r["loss"] for r in rest["history"]] == \
        [r["loss"] for r in whole["history"][3:]]
    for a, b in zip(tree_leaves(whole["state"]), tree_leaves(rest["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_cpu_loss_falls(tmp_path, capsys):
    out = train_cli.main(["--arch", "gemma2-2b", "--tiny", "--device", "cpu",
                          "--steps", "30", "--batch", "4", "--seq", "64",
                          "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "0"])
    hist = out["history"]
    assert hist[0]["step"] == 0 and hist[-1]["step"] == 29
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in hist)
    assert hist[-1]["loss"] < 0.7 * hist[0]["loss"]
    assert not os.listdir(tmp_path)          # --ckpt-every 0: none written
    assert "loss" in capsys.readouterr().out


def test_launch_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--arch", "gemma2-2b", "--tiny", "--steps", "1"])
