"""The port's AMC (src/repro_torch/core/{pruning,amc}.py) against the
reference, on the same numpy inputs and the reference's own parameters.

Masks, keep counts and sliced tensors are discrete or exact (products by
0 and 1), so they are held bit for bit, including tied importances and
keep ratios whose count lands on a .5 boundary. Importances are fp32 sums
of squares over up to 10^5 terms in other orders: the reference's own
head-group and expert importances sit 2.1e-6 (relative) from the exact
float64 value on these parameters (measured), so the port is held to a
relative 1e-5 of them. The env's state and feasible interval are the same
float64/float32 arithmetic: 1e-6.

Searches: the reference draws its agent's initial weights from
``jax.random``, so the port's agent gets the reference's initial actor
and critic (``DDPG.set_weights``) through the port module's ``DDPG`` name,
as tests/test_torch_haq.py does; exploration and replay draw from the same
``np.random.default_rng(seed)``. Each package scores policies with its own
``Model.loss`` in fp32 parameters, the reference's run eagerly under
``jax.disable_jit`` (its own definition of each op), which agree to about
1e-5; the agents train from episode 32 (two transitions an episode fill
the 64-row replay batch), so a reward that differs by 1e-5 moves an
action by far less than the 1e-5 the ratios are held to.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_batch  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.core import amc as j_amc  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro.core.rl import ddpg as j_ddpg  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import amc as t_amc  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.core.rl import ddpg as t_ddpg  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402

torch.set_num_threads(1)

REL = 1e-6
IMPORTANCE_REL = 1e-5
RATIO_TOL = 1e-5
DENSE, MOE = "granite-3-8b", "granite-moe-3b-a800m"
# prunable-layer archs: gated FFN and GQA (gemma2-2b, period 2), a
# non-gated FFN (nemotron: squared ReLU), dense granite, and MoE
ARCHS = ("gemma2-2b", "nemotron-4-15b", DENSE, MOE)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    return np.all(np.abs(got - want) <= rel * np.abs(want).max())


@pytest.fixture(scope="module", params=ARCHS)
def tiny(request):
    """(arch, reference model, its params, port model, port params):
    tiny, the reference's bf16 initialisation carried across."""
    arch = request.param
    jm = j_build(j_configs.tiny_config(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = t_build(t_configs.tiny_config(arch))
    return arch, jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


def _sites(p):
    """(kind, subtree) of every prunable layer-stacked subtree."""
    for slot, block in sorted(p["blocks"].items()):
        for kind in ("attn", "ffn", "moe"):
            if kind in block:
                yield f"{slot}/{kind}", kind, block[kind]


# ------------------------------------------------------------ importance --
IMPORTANCE = {"attn": "head_group_importance", "ffn": "ffn_importance",
              "moe": "expert_importance"}
MASK = {"attn": "mask_attn", "ffn": "mask_ffn", "moe": "mask_experts"}


def test_importances_match_reference(tiny):
    _, _, jp, _, tp = tiny
    for (name, kind, jsub), (_, _, tsub) in zip(_sites(jp), _sites(tp)):
        want = getattr(j_pruning, IMPORTANCE[kind])(jsub)
        got = getattr(t_pruning, IMPORTANCE[kind])(tsub)
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert _rel_close(got, want, IMPORTANCE_REL), name


# ratios whose count round(r * n) lands on or next to .5 for the unit
# counts below, others off it, and the clip at both ends
RATIOS = (0.0, 0.05, 0.1, 0.125, 0.15, 0.2, 0.25, 0.3, 0.35, 0.375, 0.45,
          0.5, 0.55, 0.625, 0.65, 0.7, 0.75, 0.85, 0.875, 0.95, 1.0, 1.2)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 10, 40, 256])
def test_keep_mask_bit_equal_with_ties_and_half_boundaries(n):
    rng = np.random.default_rng(n)
    tied = rng.integers(0, 3, n).astype(np.float32)   # many exact ties
    for imp in (tied, rng.random(n, dtype=np.float32),
                np.zeros(n, np.float32)):
        for r in RATIOS + tuple(rng.random(8)):
            want = np.asarray(j_pruning.keep_mask(jnp.asarray(imp), r))
            got = t_pruning.keep_mask(torch.from_numpy(imp), r)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want), (imp, r)
        # a traced (array) ratio multiplies in float32 on both sides
        for r in (0.15, 0.35, 0.625):
            want = np.asarray(j_pruning.keep_mask(
                jnp.asarray(imp), jnp.float32(r)))
            got = t_pruning.keep_mask(torch.from_numpy(imp),
                                      torch.tensor(r, dtype=torch.float32))
            assert np.array_equal(got.numpy(), want), (imp, r)


def test_masks_bit_equal(tiny):
    """Each mask at keep ratios 0.5 and 0.2 on the layer-stacked subtree:
    every leaf equal bit for bit (pruned experts' router columns at
    -1e9 in fp32)."""
    _, _, jp, _, tp = tiny
    for (name, kind, jsub), (_, _, tsub) in zip(_sites(jp), _sites(tp)):
        for r in (0.5, 0.2):
            jmask = j_pruning.keep_mask(
                getattr(j_pruning, IMPORTANCE[kind])(jsub), r)
            tmask = t_pruning.keep_mask(
                getattr(t_pruning, IMPORTANCE[kind])(tsub), r)
            assert np.array_equal(tmask.numpy(), np.asarray(jmask)), name
            want = getattr(j_pruning, MASK[kind])(jsub, jmask)
            got = getattr(t_pruning, MASK[kind])(tsub, tmask)
            assert sorted(got) == sorted(want), name
            for leaf in want:
                assert got[leaf].dtype == from_jax_params(
                    np.asarray(want[leaf])).dtype, (name, leaf)
                assert np.array_equal(_np(got[leaf]), _np(want[leaf])), \
                    (name, leaf)


def test_slices_match_reference(tiny):
    """slice_ffn / slice_attn on one (unstacked) layer: the same tensors."""
    _, _, jp, _, tp = tiny
    jb, tb = jp["blocks"]["sub0"], tp["blocks"]["sub0"]
    jattn = jax.tree.map(lambda a: a[0], jb["attn"])
    tattn = {k: v[0] for k, v in tb["attn"].items()}
    groups = np.array([1]) if jattn["wk"].shape[1] > 1 else np.array([0])
    want = j_pruning.slice_attn(jattn, groups)
    got = t_pruning.slice_attn(tattn, groups)
    for k in want:
        assert np.array_equal(_np(got[k]), _np(want[k])), k
    if "ffn" in jb:
        jffn = jax.tree.map(lambda a: a[0], jb["ffn"])
        tffn = {k: v[0] for k, v in tb["ffn"].items()}
        keep = np.sort(np.random.default_rng(0).choice(
            jffn["w_in"].shape[-1], 100, replace=False))
        want = j_pruning.slice_ffn(jffn, keep)
        got = t_pruning.slice_ffn(tffn, keep)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(_np(got[k]), _np(want[k])), k


@pytest.mark.parametrize("arch", sorted(j_configs.ARCHS))
def test_block_flops_match_reference(arch):
    for get in ("get_config", "tiny_config"):
        jc, tc = getattr(j_configs, get)(arch), getattr(t_configs, get)(arch)
        if not jc.num_heads:
            continue
        for tokens in (1, 4096):
            assert t_pruning.block_flops(tc, tokens) == \
                j_pruning.block_flops(jc, tokens)


# ------------------------------------------------------------ mechanics --
@pytest.mark.parametrize("arch", ARCHS + ("llama4-maverick-400b-a17b",))
@pytest.mark.parametrize("tiny_cfg", [True, False], ids=["tiny", "full"])
def test_enumerate_layers_matches_reference(arch, tiny_cfg):
    get = "tiny_config" if tiny_cfg else "get_config"
    want = j_amc.enumerate_layers(j_build(getattr(j_configs, get)(arch)),
                                  4096)
    got = t_amc.enumerate_layers(t_build(getattr(t_configs, get)(arch)),
                                 4096)
    assert [(l.name, l.kind, l.path, l.n_units, l.flops) for l in got] == \
        [(l.name, l.kind, l.path, l.n_units, l.flops) for l in want]


def test_env_state_and_feasible_interval_match_reference(tiny):
    """AMCEnv.state over every layer at several (reduced, prev_a) and
    feasible_interval over the FLOPs used so far; the stored-never-read
    ``mode`` and ``hw`` kept as the reference keeps them."""
    _, jm, jp, tm, tp = tiny
    for target, a_min in ((0.5, 0.2), (0.3, 0.1), (0.8, 0.5)):
        acfg = dict(target=target, a_min=a_min, episodes=1)
        jenv = j_amc.AMCEnv(jm, jp, lambda p: 1.0, j_amc.AMCConfig(**acfg))
        tenv = t_amc.AMCEnv(tm, tp, lambda p: 1.0, t_amc.AMCConfig(**acfg))
        assert tenv.total_flops == jenv.total_flops
        assert tenv.hw is t_hwm.V5E_POD and tenv.acfg.mode == "flops"
        for t in range(len(jenv.layers)):
            for reduced, prev_a in ((0.0, 1.0), (0.13, 0.4), (0.6, 0.2)):
                want = jenv.state(t, reduced, prev_a)
                got = tenv.state(t, reduced, prev_a)
                assert got.dtype == want.dtype == np.float32
                assert np.allclose(got, want, rtol=REL, atol=0.0)
            for frac in (0.0, 0.1, 0.3, 0.45):
                used = frac * jenv.total_flops
                lo, hi = tenv.feasible_interval(t, used)
                jlo, jhi = jenv.feasible_interval(t, used)
                assert abs(lo - jlo) <= REL and abs(hi - jhi) <= REL * jhi


def test_apply_ratios_bit_equal(tiny):
    _, jm, jp, tm, tp = tiny
    layers = j_amc.enumerate_layers(jm, 4096)
    ratios = np.random.default_rng(1).uniform(0.2, 1.0, len(layers))
    want = j_amc.apply_ratios(jp, layers, list(ratios))
    got = t_amc.apply_ratios(tp, t_amc.enumerate_layers(tm, 4096),
                             list(ratios))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        assert np.array_equal(_np(node), _np(leaf)), path
    # untouched subtrees are shared, not copied
    assert got["embed"] is tp["embed"]


def test_moe_expert_pruning():
    """The reference's test on the port: pruned experts are routed around
    (-1e9 logits on the layer-stacked router)."""
    tm = t_build(t_configs.tiny_config(MOE))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    layers = t_amc.enumerate_layers(tm, tokens=4096)
    assert any(l.kind == "moe" for l in layers)
    masked = t_amc.apply_ratios(tp, layers, [0.5] * len(layers))
    router = masked["blocks"]["sub0"]["moe"]["router"]
    lead = tuple(range(router.dim() - 1))
    assert int(torch.all(router < -1e8, dim=lead).sum()) == 2
    # every other router column, and the unmasked tree, unchanged
    assert torch.equal(tp["blocks"]["sub0"]["moe"]["router"],
                       tm.init(torch.Generator().manual_seed(0),
                               "cpu")["blocks"]["sub0"]["moe"]["router"])


# ------------------------------------------------------------- searches --
def _carried_ddpg(cfg, seed=0, **kw):
    ref = j_ddpg.DDPG(j_ddpg.DDPGConfig(**dataclasses.asdict(cfg)),
                      seed=seed)
    agent = t_ddpg.DDPG(cfg, seed=seed, **kw)
    agent.set_weights(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in ref.actor],
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in ref.critic])
    return agent


def _record(monkeypatch, amc_mod, pruning_mod, log):
    """Log every episode's ratios (apply_ratios) and the units each mask
    keeps (keep_mask) through the module names the env calls."""
    apply_ratios, keep_mask = amc_mod.apply_ratios, pruning_mod.keep_mask

    def rec_apply(params, layers, ratios):
        log.append({"ratios": list(ratios), "units": []})
        return apply_ratios(params, layers, ratios)

    def rec_keep(importance, ratio):
        m = keep_mask(importance, ratio)
        log[-1]["units"].append(int(np.asarray(_np(m)).sum()))
        return m

    monkeypatch.setattr(amc_mod, "apply_ratios", rec_apply)
    monkeypatch.setattr(pruning_mod, "keep_mask", rec_keep)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_amc_search_matches_reference(arch, monkeypatch):
    """34 episodes (the agents train in the last two) and the greedy
    rollout, on tiny granite-3-8b and tiny granite-moe in fp32, each
    package scoring with its own Model.loss: the same keep ratios (1e-5)
    and unit counts every episode, the same best, and the reference
    test's budget check."""
    monkeypatch.setattr(t_amc, "DDPG", _carried_ddpg)
    jm = j_build(j_configs.tiny_config(arch))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(0)))
    tm = t_build(t_configs.tiny_config(arch))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    batch = tiny_batch(jm.cfg)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    def j_loss(p):
        with jax.disable_jit():
            return float(jm.loss(p, batch))

    acfg = dict(target=0.5, episodes=34, seed=0)
    jlog, tlog = [], []
    _record(monkeypatch, j_amc, j_pruning, jlog)
    _record(monkeypatch, t_amc, t_pruning, tlog)
    want = j_amc.search(jm, jp, j_loss, j_amc.AMCConfig(**acfg))
    got = t_amc.search(tm, tp, lambda p: tm.loss(p, tbatch),
                       t_amc.AMCConfig(**acfg))
    assert len(tlog) == len(jlog) == acfg["episodes"] + 1
    for ep, (t, j) in enumerate(zip(tlog, jlog)):
        assert np.allclose(t["ratios"], j["ratios"], rtol=0,
                           atol=RATIO_TOL), ep
        assert t["units"] == j["units"], ep
    assert got["layers"] == want["layers"]
    assert np.allclose(got["best"]["ratios"], want["best"]["ratios"],
                       rtol=0, atol=RATIO_TOL)
    assert abs(got["base_loss"] - want["base_loss"]) <= 1e-4
    for h, hj in zip(got["history"], want["history"]):
        assert h["flops_frac"] <= acfg["target"] + 1e-6
        assert abs(h["flops_frac"] - hj["flops_frac"]) <= RATIO_TOL
        assert np.isfinite(h["loss"]) and abs(h["loss"] - hj["loss"]) <= 1e-4


def test_budget_always_met():
    """The reference test on the port: five exploring rollouts on tiny
    granite-3-8b never exceed the FLOPs target."""
    tm = t_build(t_configs.tiny_config(DENSE))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, 512, (2, 32),
                                     generator=torch.Generator()
                                     .manual_seed(1))}
    batch["labels"] = batch["tokens"]
    acfg = t_amc.AMCConfig(target=0.5, episodes=1)
    env = t_amc.AMCEnv(tm, tp, lambda p: tm.loss(p, batch), acfg)
    agent = t_ddpg.DDPG(t_ddpg.DDPGConfig(state_dim=t_amc.STATE_DIM), seed=0)
    for _ in range(5):
        rec = env.rollout(agent, explore=True)
        assert rec["flops_frac"] <= acfg.target + 1e-6
        assert math.isfinite(rec["loss"])


def test_uniform_baseline_matches_reference(tiny):
    _, jm, jp, tm, tp = tiny
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    batch = tiny_batch(jm.cfg)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with jax.disable_jit():
        want = j_amc.uniform_baseline(jm, jp, lambda p: jm.loss(p, batch),
                                      0.5)
    got = t_amc.uniform_baseline(tm, tp, lambda p: tm.loss(p, tbatch), 0.5)
    assert got["keep"] == want["keep"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4


def test_magnitude_criterion_finds_planted_redundancy():
    """The reference's test on parameters trained in JAX (30 steps) and
    carried across: half the FFN units scaled to ~0; the port's criterion
    keeps the live half, and pruning by it hurts the port's loss less than
    pruning the important half."""
    from repro.configs.base import OptimConfig, TrainConfig
    from repro.training import steps as steps_lib
    jm = j_build(j_configs.tiny_config(DENSE))
    tcfg = TrainConfig(optim=OptimConfig(lr=5e-3, warmup_steps=2,
                                         total_steps=30))
    state = steps_lib.init_train_state(jm, tcfg, jax.random.PRNGKey(0))
    step = jax.jit(steps_lib.make_train_step(jm, tcfg))
    batch = tiny_batch(jm.cfg, B=2, S=32)
    for _ in range(30):
        state, _ = step(state, batch)
    p = from_jax_params(jax.tree.map(np.asarray, state["params"]))
    tm = t_build(t_configs.tiny_config(DENSE))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}

    ffn = dict(p["blocks"]["sub0"]["ffn"])
    dff = ffn["w_in"].shape[-1]
    kill = torch.arange(dff) < dff // 2
    scale = torch.where(kill, 1e-3, 1.0)
    for k in ("w_in", "w_gate"):
        ffn[k] = ffn[k] * scale.to(ffn[k].dtype)
    ffn["w_out"] = ffn["w_out"] * scale[:, None].to(ffn["w_out"].dtype)

    def with_ffn(f):
        return dict(p, blocks={**p["blocks"], "sub0": {
            **p["blocks"]["sub0"], "ffn": f}})

    imp = t_pruning.ffn_importance(ffn)
    keep = t_pruning.keep_mask(imp, 0.5)
    l_smart = float(tm.loss(with_ffn(t_pruning.mask_ffn(ffn, keep)), tbatch))
    l_adv = float(tm.loss(with_ffn(t_pruning.mask_ffn(ffn, 1.0 - keep)),
                          tbatch))
    assert l_smart < l_adv, (l_smart, l_adv)
    assert bool(torch.all(keep[dff // 2:] == 1.0))
