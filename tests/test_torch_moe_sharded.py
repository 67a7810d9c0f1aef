"""The moe family over ranks that split the batch (ROADMAP item 11e):
models/moe.py's ``ranks`` hook (distributed/sharding.py::BatchRanks),
the sharded trainer's ``rows`` in microbatches, and the sharded prefill
and serve steps, on the CPU in gloo worlds.

The reference runs one program over the global batch, so the capacity,
the stable sort of the routed pairs by expert, each pair's slot and the
aux loss's ``me`` and ``ce`` are functions of every rank's tokens. Held
against it, on the same numpy-seeded inputs and the reference's own
parameters (models/convert.py):

  * ``moe_apply`` at data=2 and at pod=2 x data=2 (world 4), each rank on
    its rows, against the reference's ``moe_apply`` on the global batch,
    in fp32 and bf16, drop-free (capacity 4.0) and overflowing (capacity
    1.25, every token leaning on expert 0: the first ranks fill its slots
    and a later rank's pairs are dropped). The plan is discrete and held
    exactly: the experts each pair picks, which pairs keep a slot and
    each kept pair's global slot. y within tests/test_torch_moe.py's
    rules (fp32 1e-5, bf16 4 ulps of max |y|), aux within 1e-6 on every
    rank. The control, each rank's plan at its own capacity (what the
    port computed before the hook), differs from the reference's plan.
  * Tiny granite-moe at the production capacity factor 1.25, where the
    tiny batch drops pairs (4 x 64 tokens: 0, 4, 0 and 44 of 512 routed
    pairs in its four layers; each 2-row half drops others), trained by
    the sharded trainer (``train(mesh=)``'s step) at data=2, at data=2 x
    model=2, and at data=2 in 2 microbatches, each rank its block of the
    reference's global microbatch. Against the reference's jitted
    ``make_train_step`` under the fp32 rules of
    tests/test_torch_train_sharded.py (``_check_fp32``): losses and grad
    norms 1e-6, first gradients 1e-5 of each leaf's max, masters within
    2 lr and 1e-3 lr on 99.9%.
  * At pod=2 x data=2 on 2 rows (over data alone, whole over pod): each
    pod replica's data ranks route the 2 rows as one device does (the
    experts, keeps and global slots as integers), both replicas compute
    the same y and aux bits, and one fp32 training step holds to the
    reference's jitted step (the aux loss's gradient counted once).
  * The sharded prefill and 4 decode steps at data=2 (one row a rank) on
    the reference's fp32 parameters (wq, wk x 1/8) against the
    reference's ``make_prefill_step``/``make_serve_step`` jitted with its
    dry-run's shardings on 2 forced host devices: every rank's logits
    within 1e-5 of max |logit|. The prompt's 80 tokens drop pairs at the
    global capacity 40 (at a rank's own, 24, others).

Each world is spawned once (a module fixture) and returns all its cases.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import TrainConfig as TConfig  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.training import sharded as tsh  # noqa: E402
from repro_torch.training.sharded_serve import serve_steps  # noqa: E402
from test_torch_moe import (AUX_TOL, BF16_Y_TOL, FP32_Y_TOL,  # noqa: E402
                            _as, _moe_case, _ref_routing)
from test_torch_train_sharded import (SHAPE, SHAPE_B2,  # noqa: E402
                                      STEPS, _case, _check_fp32, _ref_state)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m"
CF = 1.25                  # the production capacity factor
WORLD_S = 240.0
REF_RTOL = 1e-5
# the worlds' meshes, one after the other in a world: {label: (pod, data,
# model, cases)}
WORLDS = ({"data2": (1, 2, 1, ("train", "train_mb2", "serve"))},
          {"pod2": (2, 2, 1, ("train_b2",)), "2x2": (1, 2, 2, ("train",))})
REF_B, REF_S, REF_STEPS, QK_SCALE = 2, 40, 4, 0.125


def _cfgs(cf=CF):
    """(reference, port) tiny granite-moe at capacity factor ``cf``."""
    j, t = j_tiny(ARCH), t_tiny(ARCH)
    return (dataclasses.replace(j, moe=dataclasses.replace(
        j.moe, capacity_factor=cf)),
        dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=cf)))


def _moe_inputs():
    """{(case, dtype): (reference params, reference x, port params, port
    x, moe)} at B = 4 rows of 32 tokens."""
    out = {}
    for case, cf, overflow in (("drop-free", 4.0, False),
                               ("overflow", 1.25, True)):
        moe, jp0, x = _moe_case(cf, overflow)
        x = np.concatenate([x, 0.5 * x[::-1] + 0.3])
        for dtype in ("fp32", "bf16"):
            out[(case, dtype)] = _as(jp0, x, dtype) + (moe,)
    return out


# ------------------------------------------------------------- the worlds --
def _plan(tp, x, moe, ranks):
    """(idx (T, k), keep per flat pair, global slot per flat pair (-1
    where dropped)) of this rank's rows through the port's routing and
    ``dispatch`` with ``ranks``."""
    T, k = x.shape[0] * x.shape[1], moe.experts_per_token
    _, _, idx = t_moe.route(tp, x.reshape(T, -1), moe)
    C = t_moe.capacity(T if ranks is None else ranks.total(T), moe)
    R = C if ranks is None else min(C, T)
    order, keep, dest = t_moe.dispatch(idx, C, moe.num_experts, ranks=ranks,
                                       rows=R)
    e_flat = idx.reshape(-1)
    counts = torch.bincount(e_flat, minlength=moe.num_experts)
    below = torch.zeros_like(counts) if ranks is None \
        else ranks.prefix(counts)
    e_sorted = e_flat[order]
    slot = torch.where(keep, below[e_sorted] + dest - e_sorted * R, -1)
    flat_keep = torch.empty_like(keep)
    flat_keep[order] = keep
    flat_slot = torch.empty_like(slot)
    flat_slot[order] = slot
    return idx, flat_keep, flat_slot


def _moe_cases(ac, groups, inputs):
    out = {}
    for key, (_, _, tp, tx, moe) in inputs.items():
        B = tx.shape[0]
        ranks = shlib.batch_ranks(ac, B, groups)
        x = ac(tx, "batch")
        y, aux = t_moe.moe_apply(tp, x, moe, ranks=ranks)
        out[key] = {"y": y, "aux": aux, "plan": _plan(tp, x, moe, ranks),
                    "local": _plan(tp, x, moe, None)[1:]}
    return out


def _held_cases(ac, inputs):
    """The first 2 rows of each fp32 input at pod=2 x data=2: the rows
    split over data alone and held whole over pod (training/sharded.py),
    each rank's routed over the ranks the sharded trainer gives that
    layout; and the one-device plan of the 2 rows."""
    tr = tsh.ShardedTrainer(t_build(_cfgs()[1]), TConfig(), ac)
    out = {}
    for key, (_, _, tp, tx, moe) in inputs.items():
        if key[1] != "fp32":
            continue
        x = tx[:2]
        held = ac.replicated_axes(*x.shape[:2])
        ranks = tr.batch_ranks(held)
        mine = ac(x, "batch")
        y, aux = t_moe.moe_apply(tp, mine, moe, ranks=ranks)
        out[key] = {"held": held, "y": y, "aux": aux,
                    "plan": _plan(tp, mine, moe, ranks),
                    "whole": _plan(tp, x, moe, None)}
    return out


def _serve_case(mesh, ref_file):
    """The reference's parameters and prompt through the port's sharded
    steps: every step's logits rows against the reference's jitted
    sharded run and against the port's unsharded steps on the global
    batch."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models.convert import from_jax_params
    from repro_torch.training import steps as st
    with open(ref_file, "rb") as f:
        ref = pickle.load(f)
    model = t_build(_cfgs()[1])
    params = from_jax_params(ref["params"])
    ac = shlib.make_ac(mesh)
    sv = serve_steps(model, ac)
    local = sv.shard_params(params)
    tokens, feed = torch.from_numpy(ref["tokens"]), torch.from_numpy(
        ref["feed"])
    errs, own = [], []
    logits, blocks = st.make_prefill_step(model, ac=ac)(local,
                                                        {"tokens": tokens})
    wl, wc = st.make_prefill_step(model)(params, {"tokens": tokens})
    for got, want, into in ((logits, ref["prefill"], errs),
                            (logits, wl, own)):
        w = ac(torch.as_tensor(want), "batch")
        into.append(float((got - w).abs().max() / w.abs().max()))
    T = REF_S + REF_STEPS
    blocks = sv.place_cache(_grow_cache(sv.whole_cache(blocks), REF_S, T))
    wc = _grow_cache(wc, REF_S, T)
    serve, plain = st.make_serve_step(model, ac=ac), st.make_serve_step(model)
    for i in range(REF_STEPS):
        pos = torch.tensor(REF_S + i)
        logits, blocks = serve(local, blocks, feed[:, i:i + 1], pos)
        wl, wc = plain(params, wc, feed[:, i:i + 1], pos)
        for want, into in ((torch.from_numpy(ref["decode"][i]), errs),
                           (wl, own)):
            w = ac(want, "batch")
            into.append(float((logits - w).abs().max() / w.abs().max()))
    return {"ref": errs, "port": own}


def _mesh_cases(rank, pod, data, tp, cases, inputs, ref_file):
    from repro_torch.launch.mesh import _mesh
    mesh = _mesh(data, tp, "cpu", WORLD_S, pod=pod)
    ac = shlib.make_ac(mesh)
    groups = {a: mesh.get_group(a) for a in shlib.axis_sizes(mesh)}
    out = {"moe": _moe_cases(ac, groups, inputs)} if tp == 1 else {}
    if pod > 1:
        out["held"] = _held_cases(ac, inputs)
    model = t_build(_cfgs()[1])
    for case in cases:
        if case.startswith("train"):
            mb = 2 if case == "train_mb2" else 1

            def trainer_of(tcfg, mb=mb):
                return tsh.ShardedTrainer(model, dataclasses.replace(
                    tcfg, microbatches=mb), ac)
            if case == "train_b2":
                out[case] = _case(trainer_of, model, "fp32", rank, SHAPE_B2,
                                  steps=1)
                continue
            out[case] = _case(trainer_of, model, "fp32", rank)
        elif case == "serve":
            out[case] = _serve_case(mesh, ref_file)
    return out


def _world(rank, world, device, meshes, inputs, ref_file):
    """A rank of a test world: each of ``meshes`` in turn."""
    return {label: _mesh_cases(rank, *mesh, inputs, ref_file)
            for label, mesh in meshes.items()}


REF_SCRIPT = """
import dataclasses, pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
jax.devices()                     # 2 forced host devices, before the
from jax.sharding import Mesh     # dry-run module's own device flag
import repro.launch.dryrun as rd
from repro.configs import tiny_config
from repro.configs.base import ShapeConfig, TrainConfig
from repro.models.api import build_model
B, S, STEPS, QK, CF = {B}, {S}, {STEPS}, {QK}, {CF}
cfg = tiny_config("granite-moe-3b-a800m")
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
    cfg.moe, capacity_factor=CF))
model = build_model(cfg)
rng = np.random.default_rng(5)
out = {{"tokens": rng.integers(2, 500, (B, S)).astype(np.int32),
        "feed": rng.integers(2, 500, (B, STEPS)).astype(np.int32)}}
p = jax.tree.map(lambda a: a.astype(jnp.float32),
                 model.init(jax.random.PRNGKey(0)))
for sub in p["blocks"].values():
    for n in ("wq", "wk"):
        sub["attn"][n] = sub["attn"][n] * QK
out["params"] = jax.tree.map(np.asarray, p)
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
T = S + STEPS
step, args, ins, outs, don, _ = rd.build_step(
    model, ShapeConfig("p", S, B, "prefill"), mesh, TrainConfig())
dstep, dargs, dins, douts, ddon, _ = rd.build_step(
    model, ShapeConfig("d", T, B, "decode"), mesh, TrainConfig())
with mesh:
    logits, cache = jax.jit(step, in_shardings=ins, out_shardings=outs)(
        p, {{"tokens": jnp.asarray(out["tokens"])}})
    cache = jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, T - S), (0, 0), (0, 0)))
        if a.shape[2] == S else a, cache)
    f = jax.jit(dstep, in_shardings=dins, out_shardings=douts)
    dec = []
    for i in range(STEPS):
        lg, cache = f(p, cache, jnp.asarray(out["feed"][:, i:i + 1]),
                      jnp.int32(S + i))
        dec.append(np.asarray(lg, np.float32))
out["prefill"] = np.asarray(logits, np.float32)
out["decode"] = dec
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_serving(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=2", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF_SCRIPT.format(B=REF_B, S=REF_S, STEPS=REF_STEPS,
                               QK=QK_SCALE, CF=CF)
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return str(path)


@pytest.fixture(scope="module")
def inputs():
    return _moe_inputs()


@pytest.fixture(scope="module")
def worlds(inputs, reference_serving):
    """{label: every rank's results} of each mesh."""
    out = {}
    for meshes in WORLDS:
        pod, data, tp, _ = next(iter(meshes.values()))
        ranks = spawn(_world, pod * data * tp, backend="gloo",
                      timeout_s=WORLD_S,
                      args=(meshes, inputs, reference_serving))
        out.update({label: [r[label] for r in ranks] for label in meshes})
    return out


def _reference_train(microbatches, shape=SHAPE, steps=STEPS):
    """The reference's jitted make_train_step at capacity factor CF,
    ``steps`` fp32 steps at ``shape`` from ``_ref_state``'s state, and its
    first gradients (tests/test_torch_train_sharded.py::_reference_run)."""
    jm = j_build(_cfgs()[0])
    np_state, jo = _ref_state(ARCH)
    state = jax.tree.map(jnp.asarray, np_state)
    step = jax.jit(jsteps.make_train_step(
        jm, JTrain(optim=jo, microbatches=microbatches)))
    b0 = jdp.batch_for_model(jm, shape, None, 0)
    _, g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b0, remat=True)))(state["params"])
    out = {"grads": [np.asarray(x, np.float32) for x in jax.tree.leaves(g)],
           "steps": []}
    for k in range(steps):
        state, met = step(state, jdp.batch_for_model(jm, shape, None, k))
        state = {"params": state["opt"]["master"], "opt": state["opt"]}
        out["steps"].append(({n: float(v) for n, v in met.items()}, [
            np.asarray(x, np.float32)
            for x in jax.tree.leaves(state["opt"]["master"])]))
    return out


@pytest.fixture(scope="module")
def reference_training():
    return {1: _reference_train(1), 2: _reference_train(2),
            "b2": _reference_train(1, SHAPE_B2, 1)}


# ------------------------------------------------------------- moe_apply --
def _ref_plan(jp, jx, moe):
    """The reference's global plan per flat pair: (idx, keep, global
    slot or -1)."""
    idx, keep_sorted = _ref_routing(jp, jx, moe)
    e_flat = idx.reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    counts = np.bincount(e_flat, minlength=moe.num_experts)
    seg = np.cumsum(counts) - counts
    pos = np.arange(e_flat.size) - seg[e_flat[order]]
    keep, slot = np.empty_like(keep_sorted), np.empty(e_flat.size, np.int64)
    keep[order] = keep_sorted
    slot[order] = np.where(keep_sorted, pos, -1)
    return idx, keep, slot


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", ["drop-free", "overflow"])
@pytest.mark.parametrize("label", ["data2", "pod2"])
def test_moe_apply_is_the_references_global_moe(label, case, dtype, worlds,
                                                inputs):
    """Every rank's plan, concatenated in row order, is the reference's
    global plan bit for bit; y within the moe rules and aux the global
    scalar on every rank."""
    jp, jx, _, _, moe = inputs[(case, dtype)]
    ranks = [r["moe"][(case, dtype)] for r in worlds[label]]
    idx, keep, slot = _ref_plan(jp, jx, moe)
    assert np.array_equal(np.concatenate([r["plan"][0].numpy()
                                          for r in ranks]), idx)
    assert np.array_equal(np.concatenate([r["plan"][1].numpy()
                                          for r in ranks]), keep)
    assert np.array_equal(np.concatenate([r["plan"][2].numpy()
                                          for r in ranks]), slot)
    assert (int((~keep).sum()) > 0) == (case == "overflow")
    want_y, want_aux = j_moe.moe_apply(jp, jx, moe)
    w = np.asarray(jnp.asarray(want_y, jnp.float32))
    y = np.concatenate([r["y"].float().numpy() for r in ranks])
    tol = FP32_Y_TOL if dtype == "fp32" else BF16_Y_TOL
    assert np.abs(y - w).max() <= tol * np.abs(w).max()
    for r in ranks:
        assert abs(float(r["aux"]) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("label", ["data2", "pod2"])
def test_local_capacity_plan_differs(label, worlds, inputs):
    """The control: each rank's plan at its own capacity and slots (the
    port without the hook) is not the reference's where pairs drop, and
    is where none do."""
    for case in ("drop-free", "overflow"):
        jp, jx, _, _, moe = inputs[(case, "fp32")]
        _, keep, slot = _ref_plan(jp, jx, moe)
        ranks = [r["moe"][(case, "fp32")] for r in worlds[label]]
        lkeep = np.concatenate([r["local"][0].numpy() for r in ranks])
        same = np.array_equal(lkeep, keep)
        assert same == (case == "drop-free"), case


def test_a_later_rank_gets_the_slots_the_first_left(worlds, inputs):
    """In the overflow case every token routes a pair to expert 0: rank
    0's pairs take its first slots, and rank 1 keeps only the C - n0
    left of the global capacity C, fewer than its own capacity would
    have kept."""
    _, _, _, tx, moe = inputs[("overflow", "fp32")]
    r0, r1 = (r["moe"][("overflow", "fp32")] for r in worlds["data2"])
    T = tx.shape[0] * tx.shape[1]
    C, C1 = t_moe.capacity(T, moe), t_moe.capacity(T // 2, moe)
    n0, n1 = (int((r["plan"][0] == 0).sum()) for r in (r0, r1))
    kept1 = int(r1["plan"][1][r1["plan"][0].reshape(-1) == 0].sum())
    local1 = int(r1["local"][0][r1["plan"][0].reshape(-1) == 0].sum())
    assert n0 == n1 == T // 2
    assert kept1 == max(min(n1, C - n0), 0) < local1 == min(n1, C1)


# -------------------------------------------------------------- training --
@pytest.mark.parametrize("label,case", [("data2", "train"),
                                        ("2x2", "train"),
                                        ("data2", "train_mb2")])
def test_training_matches_the_reference(label, case, worlds,
                                        reference_training):
    """Three fp32 steps of tiny granite-moe at capacity 1.25 on the mesh
    (in 2 microbatches: each rank its block of the reference's global
    microbatch) against the reference's jitted step; every rank's first
    gradients alike."""
    got = worlds[label][0][case]
    _check_fp32(got, reference_training[2 if case == "train_mb2" else 1])
    for r in worlds[label]:
        assert r[case]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(r[case]["grads"],
                                                        got["grads"]))


def test_training_held_over_pod_matches_the_reference(worlds,
                                                      reference_training):
    """Two rows at pod=2 x data=2: the rows split over data alone, the
    batch whole over pod, so the moe layers route over the data ranks
    (the global microbatch's capacity and slots) and nothing sums over
    pod, the aux loss's gradient included (each pod replica's first data
    rank counts it once). One fp32 step against the reference's jitted
    step under the fp32 rules; every rank's first gradients and step
    metrics alike."""
    ranks = worlds["pod2"]
    got = ranks[0]["train_b2"]
    _check_fp32(got, reference_training["b2"], steps=1)
    for r in ranks:
        assert r["train_b2"]["shapes_ok"]
        assert r["train_b2"]["metrics"] == got["metrics"]
        assert all(np.array_equal(a, b) for a, b in zip(
            r["train_b2"]["grads"], got["grads"]))


@pytest.mark.parametrize("case", ["drop-free", "overflow"])
def test_moe_held_over_pod_routes_as_one_device(case, worlds):
    """The same 2 rows through ``moe_apply`` on each rank, routed over the
    trainer's ranks of that layout (data alone): in each pod replica the
    data ranks' experts, keeps and global slots, in row order, are the
    one-device plan of the 2 rows as integers, and both replicas compute
    the same y and aux bits."""
    ranks = [r["held"][(case, "fp32")] for r in worlds["pod2"]]
    for p in range(2):
        mine = ranks[2 * p:2 * p + 2]
        assert all(r["held"] == ("pod",) for r in mine)
        for i in range(3):
            assert torch.equal(torch.cat([r["plan"][i].reshape(-1)
                                          for r in mine]),
                               mine[0]["whole"][i].reshape(-1))
    for d in range(2):
        a, b = ranks[d], ranks[2 + d]
        assert torch.equal(a["y"], b["y"]) and torch.equal(a["aux"],
                                                           b["aux"])


def test_microbatch_rows_are_the_references_blocks():
    """``rows`` in M microbatches: rank r's microbatch m is its block of
    the reference's global rows [m B/M, (m+1) B/M)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import _mesh, dry_world
    model = t_build(_cfgs()[1])
    x = torch.arange(8)[:, None].expand(8, 3)
    with dry_world(2):
        ac = shlib.make_ac(_mesh(2, 1, "cpu", 60.0))
        for M in (1, 2, 4):
            tr = tsh.ShardedTrainer(model, TrainConfig(microbatches=M), ac)
            for coord in (0, 1):
                ac.coords = {"data": coord, "model": 0}
                got = tr.rows({"tokens": x})[0]["tokens"][:, 0]
                want = torch.cat([torch.arange(8).reshape(M, -1)[m].reshape(
                    2, -1)[coord] for m in range(M)])
                assert torch.equal(got, want), (M, coord)


# --------------------------------------------------------------- serving --
def test_serving_at_data2_matches_the_reference(worlds):
    """Prefill and 4 decode steps at data=2 against the reference's jitted
    sharded steps and the port's unsharded steps on the global batch."""
    for r in worlds["data2"]:
        errs = r["serve"]
        assert len(errs["ref"]) == REF_STEPS + 1
        assert max(errs["ref"]) <= REF_RTOL, errs["ref"]
        assert max(errs["port"]) <= REF_RTOL, errs["port"]


def test_a_bf16_router_routes_as_the_reference():
    """After a training step every parameter is its master cast to bf16,
    the router included (as the reference's): routing upcasts it, as the
    reference's einsum promotes it, and a second step trains."""
    from repro_torch.training import steps as tsteps
    moe, jp0, x = _moe_case(CF, True)
    jp0 = dict(jp0, router=jp0["router"].astype(jnp.bfloat16))
    jp, jx, tp, tx = _as(jp0, x, "bf16")
    assert tp["router"].dtype == torch.bfloat16
    idx, keep = _ref_routing(jp, jx, moe)
    T = x.shape[0] * x.shape[1]
    probs, _, t_idx = t_moe.route(tp, tx.reshape(T, -1), moe)
    assert np.array_equal(t_idx.numpy(), idx)
    want = jax.nn.softmax(jnp.einsum("td,de->te", jx.reshape(T, -1).astype(
        jnp.float32), jp["router"]), axis=-1)
    assert np.abs(probs.numpy() - np.asarray(want)).max() <= 1e-6
    model = t_build(_cfgs()[1])
    from repro_torch.configs import TrainConfig
    from repro_torch.data import pipeline as tdp
    tcfg = TrainConfig()
    state = tsteps.init_train_state(model, tcfg, torch.Generator()
                                    .manual_seed(0), "cpu")
    step = tsteps.make_train_step(model, tcfg)
    for k in range(2):
        state, met = step(state, tdp.batch_for_model(model, SHAPE, None, k,
                                                     full=True))
        assert state["params"]["blocks"]["sub0"]["moe"]["router"].dtype \
            == torch.bfloat16 and bool(torch.isfinite(met["loss"]))
