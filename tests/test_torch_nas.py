"""The port's NAS (src/repro_torch/core/{latency_table,supernet,nas}.py and
hardware_model.ssd_cost) against the reference, on the same numpy-seeded
inputs and the reference's own supernet parameters (models/convert.py,
its per-block ``blocks`` list included).

Tolerances. The roofline costs and the LUT: the reference evaluates each
term in fp32 steps, the port in float64 rounded once to the fp32 table,
so they agree to a few fp32 ulps: 1e-6 relative (6e-8 measured); the
ordering of ops is exact. Expected latency, its gradient and Eq. 3's
loss: fp32 arithmetic, 1e-6. The supernet in fp32 parameters: loss to
1e-5 relative and the alpha gradient to 1e-3 of its largest |value| (the
same arithmetic in other orders through the blocks; measured 2.6e-4 at
most over three). One weight step and one alpha step under the same
gates: the updated weights to 1e-3 of each leaf's largest |value| (a
leaf that starts at zero holds only its step, whose gradient agrees to
that) and alpha to 1e-6 absolute (steps of 3e-2 times a gradient of
~1e-2). In bf16
parameters the port keeps the residual stream in bf16 where the
reference's straight-through product promotes it to fp32 (see
core/supernet.py), so the loss is held to 1e-2 relative. The tiny
backbone is the reference test's at two blocks.

The search's trajectory cannot match the reference's: its paths are
drawn from a torch.Generator, the reference's from jax.random keys (the
same distribution, other draws). A tiny search is checked for what it
must give: finite losses, a valid architecture, latencies consistent
with the table.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.supernet_lm import BACKBONE as J_BACKBONE  # noqa: E402
from repro.core import hardware_model as j_hwm  # noqa: E402
from repro.core import latency_table as j_lt  # noqa: E402
from repro.core import nas as j_nas  # noqa: E402
from repro.core import supernet as j_sn  # noqa: E402
from repro_torch.configs.supernet_lm import (BACKBONE,  # noqa: E402
                                             CANDIDATE_OPS)
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.core import latency_table as t_lt  # noqa: E402
from repro_torch.core import nas as t_nas  # noqa: E402
from repro_torch.core import supernet as t_sn  # noqa: E402
from repro_torch.models import params as t_params  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

COST_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
HWS = ("v5e-1chip", "v5e-pod256", "h100-sxm")


def _tiny(cfg):
    """The reference test's tiny backbone (tests/test_core_nas.py), at two
    blocks."""
    cfg = cfg.replace(num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
    return cfg.replace(ssm=cfg.ssm.__class__(d_state=16, expand=2,
                                             head_dim=16, n_groups=1,
                                             chunk=32))


J_TINY, T_TINY = _tiny(J_BACKBONE), _tiny(BACKBONE)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---------------------------------------------------------- costs, LUT ----
@pytest.mark.parametrize("args", [(8, 2048, 1024, 64, 128),
                                  (1, 1, 4096, 64, 256),
                                  (4, 64, 128, 16, 32)])
def test_ssd_cost_matches(args):
    w = j_hwm.ssd_cost(*args)
    t = t_hwm.ssd_cost(*args)
    for f in ("flops", "weight_bytes", "act_bytes", "coll_bytes"):
        assert abs(getattr(t, f) - float(getattr(w, f))) <= \
            COST_TOL * abs(float(getattr(w, f)))
    hw = j_hwm.V5E_POD
    assert abs(t.latency(t_hwm.V5E_POD) - float(w.latency(hw))) <= \
        COST_TOL * float(w.latency(hw))


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("hw", ["v5e-pod256", "v5e-1chip"])
@pytest.mark.parametrize("cfg", ["backbone", "tiny"])
def test_lut_matches(hw, decode, cfg):
    jc, tc = (J_BACKBONE, BACKBONE) if cfg == "backbone" \
        else (J_TINY, T_TINY)
    batch, seq = (8, 2048) if cfg == "backbone" else (4, 64)
    want = np.asarray(j_lt.build_lut(jc, batch, seq, j_hwm.HARDWARES[hw],
                                     decode=decode))
    got = t_lt.build_lut(tc, batch, seq, t_hwm.HARDWARES[hw], decode=decode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=COST_TOL, atol=0)
    np.testing.assert_array_equal(np.argsort(got.numpy()[0], kind="stable"),
                                  np.argsort(want[0], kind="stable"))


def test_lut_on_h100_orders_ops_as_the_references_test_asks():
    """The reference's LUT test (tests/test_core_nas.py) on the card's
    target: the zero op free, local no slower than full, e2 no slower
    than e4."""
    lut = t_lt.build_lut(BACKBONE, 8, 2048, t_hwm.H100_SXM).numpy()
    ops = list(CANDIDATE_OPS)
    row = lut[0]
    assert lut.shape == (BACKBONE.num_layers, len(ops))
    assert row[ops.index("zero")] == 0.0
    assert row[ops.index("attn_local1k_e4")] <= row[ops.index("attn_full_e4")]
    assert row[ops.index("attn_full_e2")] <= row[ops.index("attn_full_e4")]


def test_expected_and_sampled_latency_match():
    lut_np = np.asarray(j_lt.build_lut(J_BACKBONE, 8, 2048, j_hwm.V5E_POD))
    alpha = np.random.default_rng(0).normal(
        size=lut_np.shape).astype(np.float32)
    want, wg = jax.value_and_grad(j_lt.expected_latency)(
        jnp.asarray(alpha), jnp.asarray(lut_np))
    a = torch.from_numpy(alpha).requires_grad_(True)
    got = t_lt.expected_latency(a, torch.from_numpy(lut_np))
    (g,) = torch.autograd.grad(got, [a])
    assert abs(float(got) - float(want)) <= COST_TOL * float(want)
    assert _rel(g, wg) < COST_TOL
    one_hot = np.eye(len(CANDIDATE_OPS), dtype=np.float32)[
        np.argmax(alpha, -1)]
    assert abs(float(t_lt.sampled_latency(torch.from_numpy(one_hot),
                                          torch.from_numpy(lut_np)))
               - float(j_lt.sampled_latency(jnp.asarray(one_hot),
                                            jnp.asarray(lut_np)))) \
        <= COST_TOL * float(want)


@pytest.mark.parametrize("form", ["mul", "add"])
@pytest.mark.parametrize("e_lat", [1.0, 3.0, 4.0])
def test_combined_loss_matches(form, e_lat):
    """Eq. 3 with the clamp at the target, values and gradients (in ce and
    e_lat), and the reference test's numbers."""
    jcfg = j_nas.NASConfig(latency_loss=form, beta=0.5)
    tcfg = t_nas.NASConfig(latency_loss=form, beta=0.5)
    wv, wg = jax.value_and_grad(
        lambda c, e: j_nas.combined_loss(c, e, 2.0, jcfg), argnums=(0, 1))(
        jnp.float32(2.0), jnp.float32(e_lat))
    c = torch.tensor(2.0, requires_grad=True)
    e = torch.tensor(e_lat, requires_grad=True)
    tv = t_nas.combined_loss(c, e, 2.0, tcfg)
    tg = torch.autograd.grad(tv, [c, e])
    assert abs(float(tv) - float(wv)) <= COST_TOL * abs(float(wv))
    for a, b in zip(tg, wg):
        assert abs(float(a) - float(b)) <= COST_TOL * max(abs(float(b)), 1)
    assert float(t_nas.combined_loss(2.0, 1.0, 2.0, tcfg)) == 2.0


# ------------------------------------------------------------ supernet ----
def _np_params(defs, rng):
    """The reference's parameter tree (dicts, the blocks list) filled from
    numpy with its init's distributions: faster than its compiled init."""
    if isinstance(defs, dict):
        return {k: _np_params(defs[k], rng) for k in sorted(defs)}
    if isinstance(defs, list):
        return [_np_params(d, rng) for d in defs]
    if defs.init in ("zeros", "ones"):
        a = np.full(defs.shape, 0.0 if defs.init == "zeros" else 1.0)
    else:
        fan_in = defs.shape[-2] if len(defs.shape) >= 2 else defs.shape[-1]
        std = defs.scale / np.sqrt(fan_in) if defs.init == "scaled" \
            else defs.scale * 0.02
        a = rng.normal(size=defs.shape) * std
    return jnp.asarray(a.astype(np.float32)).astype(defs.dtype)


@pytest.fixture(scope="module")
def supernet():
    jp = _np_params(j_sn.supernet_defs(J_TINY), np.random.default_rng(0))
    out = {}
    for name, dt in (("bf16", jnp.bfloat16), ("fp32", jnp.float32)):
        jpd = jax.tree.map(lambda a: a.astype(dt)
                           if a.dtype == jnp.bfloat16 else a, jp)
        out[name] = (jpd, from_jax_params(jax.tree.map(np.asarray, jpd)))
    return out


def _batch(seed=0, B=2, S=40):
    toks = np.random.default_rng(seed).integers(
        0, J_TINY.vocab_size, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


_ALPHA = np.random.default_rng(1).normal(size=(2, 7)).astype(np.float32)
# the reference's loss with its gradients in the parameters and in alpha,
# compiled once (gates are traced: one program for every path)
_j_loss_grads = jax.jit(jax.value_and_grad(
    lambda p, a, g, b: j_sn.supernet_loss(p, a, g, b, J_TINY),
    argnums=(0, 1)))
_j_loss = jax.jit(lambda p, a, g, b: j_sn.supernet_loss(p, a, g, b, J_TINY))
_j_forward = jax.jit(
    lambda p, a, g, b: j_sn.supernet_forward(p, a, g, b, J_TINY))


def test_params_tree_and_counts_match(supernet):
    jp, tp = supernet["bf16"]
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    assert [tuple(a.shape) for a in t_params.tree_leaves(tp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    init, alpha = t_sn.init_supernet(torch.Generator().manual_seed(0), "cpu",
                                     T_TINY)
    assert [tuple(a.shape) for a in t_params.tree_leaves(init)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert alpha.shape == (2, 7) and not bool(alpha.any())
    assert t_params.param_count(t_sn.supernet_defs(T_TINY)) == \
        sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    arch = ["mamba2_e2", "zero", "attn_local4k_e4"]
    assert t_sn.child_param_count(arch, T_TINY) == \
        j_sn.child_param_count(arch, J_TINY)


@pytest.mark.parametrize("op", CANDIDATE_OPS)
def test_supernet_loss_and_alpha_grad_match_per_op(supernet, op):
    """Block 0 runs ``op``, block 1 an attention or mamba op, fp32
    parameters: the final hidden states, the loss and d loss / d alpha.
    (Block 1 is never the zero op: the final norm is scale-invariant, so
    through a zero op block 0's alpha would get only rounding noise.)"""
    jp, tp = supernet["fp32"]
    g0 = CANDIDATE_OPS.index(op)
    gates = [g0, 5 if g0 == 0 else 0]
    jb, tb = _batch()
    wl, (_, wg) = _j_loss_grads(jp, jnp.asarray(_ALPHA), jnp.asarray(gates),
                                jb)
    wh = _j_forward(jp, jnp.asarray(_ALPHA), jnp.asarray(gates), jb)
    a = torch.from_numpy(_ALPHA).requires_grad_(True)
    th = t_sn.supernet_forward(tp, a, torch.tensor(gates), tb, T_TINY)
    tl = t_sn.supernet_loss(tp, a, gates, tb, T_TINY)
    (tg,) = torch.autograd.grad(tl, [a])
    assert _rel(th, wh) < GRAD_TOL
    assert abs(float(tl) - float(wl)) < LOSS_TOL * float(wl)
    assert _rel(tg, wg) < GRAD_TOL
    # the CE reaches alpha through softmax(alpha_i)[g_i] only, whose
    # gradient sums to zero along each block's row
    assert np.abs(tg.numpy().sum(-1)).max() < 1e-6 * np.abs(tg.numpy()).max()


def test_supernet_loss_bf16_near_the_reference(supernet):
    jp, tp = supernet["bf16"]
    gates = [0, 5]
    jb, tb = _batch(seed=2)
    wl = _j_loss(jp, jnp.asarray(_ALPHA), jnp.asarray(gates), jb)
    tl = t_sn.supernet_loss(tp, torch.from_numpy(_ALPHA), gates, tb, T_TINY)
    assert abs(float(tl) - float(wl)) < 1e-2 * float(wl)


def test_all_zero_arch_is_the_embedding(supernet):
    """The reference test's binarization check: zero-gated blocks leave x
    unchanged, so the output is the normed embedding."""
    _, tp = supernet["fp32"]
    zero = CANDIDATE_OPS.index("zero")
    _, tb = _batch()
    h = t_sn.supernet_forward(tp, torch.zeros(2, 7), [zero] * 2, tb, T_TINY)
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import embed_tokens
    want = rms_norm(embed_tokens(tp, tb["tokens"], T_TINY), tp["final_norm"],
                    T_TINY.norm_eps)
    assert torch.equal(h, want)


def test_sample_gates_and_derive_arch():
    alpha = torch.full((3, 7), -50.0)
    alpha[0, 2] = alpha[1, 5] = alpha[2, 6] = 50.0
    g = t_sn.sample_gates(torch.Generator().manual_seed(0), alpha)
    assert g.tolist() == [2, 5, 6]
    assert t_sn.derive_arch(alpha) == [CANDIDATE_OPS[i] for i in (2, 5, 6)]
    assert t_sn.derive_arch(torch.zeros(3, 7)) == j_sn.derive_arch(
        jnp.zeros((3, 7)))
    counts = np.bincount(t_sn.sample_gates(
        torch.Generator().manual_seed(1), torch.zeros(4000, 7)).numpy(),
        minlength=7)
    assert counts.min() > 450 and counts.max() < 700      # uniform: 571


def test_synthetic_data_matches():
    w = j_nas.synthetic_lm_data(J_TINY, batch=3, seq=20, seed=4)
    t = t_nas.synthetic_lm_data(T_TINY, batch=3, seq=20, seed=4)
    for step in (0, 5):
        for k in ("tokens", "labels"):
            assert t(step)[k].dtype == torch.int32
            np.testing.assert_array_equal(t(step)[k].numpy(),
                                          np.asarray(w(step)[k]))


# -------------------------------------------------------------- search ----
def test_one_weight_and_alpha_step_match(supernet):
    """One weight step and one alpha step of the port (core/nas.py) under
    gates sampled by the reference's sampler, against the reference's
    update rules (nas.search's weight_step and alpha_step bodies) applied
    to its own loss and gradients: the weights after the clipped SGD step
    (ops not sampled unchanged) and alpha after the step on Eq. 3."""
    jp, tp = supernet["fp32"]
    tp = t_params.tree_map(lambda a: a.clone(), tp)
    key = jax.random.PRNGKey(7)
    alpha = jnp.asarray(_ALPHA)
    w_gates = np.array(j_sn.sample_gates(key, alpha))
    a_gates = np.array(j_sn.sample_gates(jax.random.fold_in(key, 1), alpha))
    w_gates[0] = CANDIDATE_OPS.index("attn_local1k_e2")
    a_gates[1] = CANDIDATE_OPS.index("mamba2_e2")
    ncfg = j_nas.NASConfig()
    jdata = j_nas.synthetic_lm_data(J_TINY, batch=2, seq=40, seed=3)
    tdata = t_nas.synthetic_lm_data(T_TINY, batch=2, seq=40, seed=3)
    lut = j_lt.build_lut(J_TINY, 2, 40, j_hwm.V5E_EDGE)
    ref = 0.6 * float(j_lt.expected_latency(jnp.zeros((2, 7)), lut))

    # the reference's weight step
    wl, (gp, _) = _j_loss_grads(jp, alpha, jnp.asarray(w_gates), jdata(0))
    gn = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                      for g in jax.tree.leaves(gp)))
    scale = jnp.minimum(1.0, 1.0 / (gn + 1e-9))
    jp1 = jax.tree.map(
        lambda p, g: p - (ncfg.weight_lr * scale * g).astype(p.dtype), jp, gp)
    # its alpha step: d combined_loss / d alpha by the chain rule through
    # the reference's own CE and expected-latency gradients
    ce, (_, ga_ce) = _j_loss_grads(jp1, alpha, jnp.asarray(a_gates),
                                   jdata(1))
    e_lat, ga_lat = jax.value_and_grad(j_lt.expected_latency)(alpha, lut)
    dl_dce, dl_de = jax.grad(j_nas.combined_loss, argnums=(0, 1))(
        ce, e_lat, ref, ncfg)
    want_alpha = alpha - ncfg.alpha_lr * (dl_dce * ga_ce + dl_de * ga_lat)

    tncfg = t_nas.NASConfig()
    tl = t_nas.weight_step(tp, torch.from_numpy(_ALPHA), tdata(0),
                           torch.from_numpy(w_gates), tncfg, T_TINY)
    assert abs(float(tl) - float(wl)) < LOSS_TOL * float(wl)
    moved = 0
    for a, b, b0 in zip(t_params.tree_leaves(tp), jax.tree.leaves(jp1),
                        jax.tree.leaves(jp)):
        assert _rel(a, b) < GRAD_TOL
        same = np.array_equal(np.asarray(b), np.asarray(b0))
        assert same == np.array_equal(_np(a), np.asarray(b0))
        moved += not same
    assert moved > 0
    got_alpha, _, tce, te = t_nas.alpha_step(
        tp, torch.from_numpy(_ALPHA), tdata(1), a_gates.tolist(),
        t_lt.build_lut(T_TINY, 2, 40, t_hwm.V5E_EDGE), ref, tncfg, T_TINY)
    assert abs(float(tce) - float(ce)) < LOSS_TOL * float(ce)
    assert abs(float(te) - float(e_lat)) <= COST_TOL * float(e_lat)
    np.testing.assert_allclose(got_alpha.numpy(), np.asarray(want_alpha),
                               rtol=0, atol=1e-6)


def test_tiny_search_runs():
    """A few warmup and search steps on the tiny backbone on the CPU:
    finite losses and alpha, a valid arch, latencies from the table. Its
    trajectory is not compared with the reference's: the paths are drawn
    from a torch.Generator there and from jax.random keys in the
    reference."""
    recs = []
    res = t_nas.search(
        t_nas.synthetic_lm_data(T_TINY, batch=2, seq=48),
        hw=t_hwm.V5E_EDGE, cfg=T_TINY, progress=recs.append, device="cpu",
        ncfg=t_nas.NASConfig(steps=4, warmup_steps=2, batch=2, seq=48,
                             log_every=2, alpha_lr=0.08))
    assert len(res["arch"]) == T_TINY.num_layers
    assert set(res["arch"]) <= set(CANDIDATE_OPS)
    assert np.isfinite(res["alpha"]).all()
    assert [r["step"] for r in recs] == [0, 2, 3]
    assert all(np.isfinite([r["weight_loss"], r["arch_loss"], r["val_ce"]])
               .all() for r in res["history"])
    lut = t_lt.build_lut(T_TINY, 2, 48, t_hwm.V5E_EDGE).numpy()
    idx = [CANDIDATE_OPS.index(op) for op in res["arch"]]
    assert abs(res["sampled_lat_us"] - 1e6 * lut[np.arange(2), idx].sum()) \
        <= 1e-3 * max(res["sampled_lat_us"], 1e-9)
    assert res["lat_ref_us"] > 0 and res["e_lat_us"] > 0


def test_param_tree_helpers_take_lists():
    tree = {"b": [{"x": torch.ones(2)}, {"x": torch.zeros(3)}],
            "a": torch.full((1,), 5.0)}
    leaves = t_params.tree_leaves(tree)
    assert [tuple(a.shape) for a in leaves] == [(1,), (2,), (3,)]
    back = t_params.tree_unflatten(tree, [a + 1 for a in leaves])
    assert isinstance(back["b"], list) and float(back["b"][1]["x"][0]) == 1.0
    mapped = t_params.tree_map(lambda a: a * 2, tree)
    assert float(mapped["b"][0]["x"][0]) == 2.0
    conv = from_jax_params({"l": [np.ones(2, np.float32)]})
    assert isinstance(conv["l"], list) and conv["l"][0].dtype == torch.float32
