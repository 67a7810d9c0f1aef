"""Quantized weights under a model split (ROADMAP item 11g): stored
int8/int4 weights through the sharded prefill and serve steps
(training/sharded_serve.py, ``dequant_dot`` inside
distributed/sharding.py::tp_dot's sites, ``kv_slice`` of codes), and the
HAQ fake-quant hook in the sharded trainer (``group_amax``: a weight's
per-channel scale taken over the whole weight), on the CPU in gloo
worlds.

Serving: tiny gemma2-2b (4 query heads, 2 kv heads) at model=2 and at
data=2 x model=2, and tiny granite-3-8b at model=4, where each rank
projects its query head's kv head from a slice of the whole ``wk``/``wv``
codes. The reference's fp32 parameters (wq, wk x 1/8) stored by the
reference's ``quantize_params`` at w8, w4 and its dry-run's HAQ policy
for the config (``quant_policy_for`` at V5E_POD: 2 bits a 2-D weight,
stored as int4; the attention projections clamp to int8), carried in by
``from_jax_params``. Held against the reference's ``make_prefill_step``
and ``make_serve_step`` with ``dequant_dot``, jitted with its dry-run's
shardings for ``--quant`` on 8 forced host devices: prefill and 4 decode
steps, every rank's logits within 1e-5 of max |logit| (XLA's and torch's
fp32 sums in their own orders). Against the port's unsharded steps with
``dequant_dot`` on the rank's rows: the prefill's logits bit for bit
(only output dims split; the sharded engine's condition), decode within
1e-5 (the combine of the ranks' softmaxes over a split cache).

Training: tiny gemma2-2b at model=2, its attention heads and d_ff split,
with ``make_quant_dot`` over a mixed (w_bits, a_bits) policy, from the
reference's fp32 state, where two elements of one ``wq`` channel in heads
on different ranks, and two in one rank's heads, are set to the channel's
max |w| (a tie: the reference's max splits its gradient evenly among
them). The reference has no straight-through estimator, so a fake-quant
weight's gradient is its scale's: nonzero only at each channel's maxima.
Held against the port's one-device step under
tests/test_torch_train_sharded.py's fp32 rules (first gradients 1e-5 of
each leaf's max, losses and grad norms 1e-6, masters) for 2 steps, and
against the reference's ``make_train_step(dot=)`` run eagerly (compiled,
its quantizer is one ulp off its own definition, which the port follows:
tests/test_torch_haq.py) under the same rules but losses and grad norms
within HAQ_REF_RTOL. Controls: the scale from the rank's slice
alone (no max over the group), and the tie count of the rank's own
elements, miss the gradient tolerance.

Each world is spawned once (a module fixture) and returns all its cases.
"""
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
from repro.core.quantization import make_quant_dot as j_quant_dot  # noqa
from repro.data import pipeline as jdp  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.core.quantization import make_quant_dot  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.convert import from_jax_params, \
    from_jax_state  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving.quant import dequant_dot  # noqa: E402
from repro_torch.training import sharded as tsh  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.training.sharded_serve import serve_steps  # noqa: E402
from test_torch_train_sharded import (GRAD_TOL, LR, SHAPE,  # noqa: E402
                                      _check_fp32, _grad_err, _ref_state,
                                      _run_steps, _tcfg)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD_S = 240.0
REF_RTOL = 1e-5
DECODE_RTOL = 1e-5
MODES = ("w8", "w4", "haq")
REF_B, REF_S, REF_STEPS, QK_SCALE = 2, 40, 4, 0.125
# the reference's meshes (data, model) per arch
REF_MESHES = {"gemma2-2b": ((1, 2), (2, 2)), "granite-3-8b": ((1, 4),)}
# (w_bits, a_bits) a site; sites not listed run unquantized
POLICY = {"attn_q": (4, 16), "attn_k": (6, 16), "attn_v": (5, 8),
          "attn_o": (4, 16), "ffn_in": (3, 16), "ffn_gate": (6, 8),
          "ffn_out": (5, 16)}
TRAIN_STEPS = 2
# the port's losses and grad norms against the reference's eager steps:
# a fake-quant weight's gradient is its scale's alone, a sum over every
# element of a channel (D x H terms) that the two packages add in their
# own fp32 orders, so the grad norm moves by about sqrt(n) fp32 ulps
# (measured 1.1e-6 relative), past the 1e-6 of the unquantized steps
HAQ_REF_RTOL = 1e-5
# wq elements (layer slot, d, head, channel) set to the channel's max:
# heads 0 and 2 sit on different ranks at model=2, heads 0 and 1 on one
TIES = (("sub0", ((3, 0, 5), (70, 2, 5))), ("sub1", ((9, 0, 11),
                                                     (40, 1, 11))))


# ------------------------------------------------------------- serving --
REF_SCRIPT = """
import pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
jax.devices()                     # 8 forced host devices, before the
from jax.sharding import Mesh     # dry-run module's own device flag
import repro.launch.dryrun as rd
from repro.configs import tiny_config
from repro.configs.base import ShapeConfig, TrainConfig
from repro.models.api import build_model
from repro.serving import quant as sq
B, S, STEPS, QK = {B}, {S}, {STEPS}, {QK}
MESHES, MODES = {MESHES}, {MODES}
rng = np.random.default_rng(7)
out = {{"tokens": rng.integers(2, 500, (B, S)).astype(np.int32),
        "feed": rng.integers(2, 500, (B, STEPS)).astype(np.int32),
        "params": {{}}, "logits": {{}}}}
T = S + STEPS
for arch, meshes in MESHES.items():
    model = build_model(tiny_config(arch))
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     model.init(jax.random.PRNGKey(0)))
    for sub in p["blocks"].values():
        for n in ("wq", "wk"):
            sub["attn"][n] = sub["attn"][n] * QK
    for mode in MODES:
        policy, bits = rd.quant_policy_for(model.cfg, mode)
        qp = sq.quantize_params(p, policy=policy, default_bits=bits)
        out["params"][arch, mode] = jax.tree.map(np.asarray, qp)
        for data, tp in meshes:
            mesh = Mesh(np.asarray(jax.devices()[:data * tp]).reshape(
                data, tp), ("data", "model"))
            step, args, ins, outs, don, _ = rd.build_step(
                model, ShapeConfig("p", S, B, "prefill"), mesh,
                TrainConfig(), quant=mode)
            dstep, dargs, dins, douts, ddon, _ = rd.build_step(
                model, ShapeConfig("d", T, B, "decode"), mesh, TrainConfig(),
                quant=mode)
            with mesh:
                logits, cache = jax.jit(step, in_shardings=ins,
                                        out_shardings=outs)(
                    qp, {{"tokens": jnp.asarray(out["tokens"])}})
                cache = jax.tree.map(
                    lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, T - S), (0, 0),
                                          (0, 0))) if a.shape[2] == S else a,
                    cache)
                f = jax.jit(dstep, in_shardings=dins, out_shardings=douts)
                dec = []
                for i in range(STEPS):
                    lg, cache = f(qp, cache,
                                  jnp.asarray(out["feed"][:, i:i + 1]),
                                  jnp.int32(S + i))
                    dec.append(np.asarray(lg, np.float32))
            out["logits"][arch, mode, data, tp] = {{
                "prefill": np.asarray(logits, np.float32), "decode": dec}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def _serve_case(mesh, arch, mode, ref, data, tp):
    """The reference's stored weights and prompt through the port's
    sharded steps: (errors against the reference's jitted sharded run,
    against the port's unsharded steps, the prefill's logits bit for bit
    against the unsharded rows', W8A16/W4A16 sites' weight slices)."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.training import steps as st
    model = build_model(tiny_config(arch))
    params = from_jax_params(ref["params"][arch, mode])
    ac = shlib.make_ac(mesh)
    sv = serve_steps(model, ac, dot=dequant_dot)
    local = sv.shard_params(params)
    tokens, feed = torch.from_numpy(ref["tokens"]), torch.from_numpy(
        ref["feed"])
    want = ref["logits"][arch, mode, data, tp]
    prefill = st.make_prefill_step(model, ac=ac, dot=dequant_dot)
    serve = st.make_serve_step(model, ac=ac, dot=dequant_dot)
    plain = st.make_serve_step(model, dot=dequant_dot)
    logits, blocks = prefill(local, {"tokens": tokens})
    unsharded = st.make_prefill_step(model, dot=dequant_dot)
    rows, _ = unsharded(params, {"tokens": ac(tokens, "batch")})
    _, wc = unsharded(params, {"tokens": tokens})
    out = {"exact": torch.equal(logits, rows), "ref": [],
           "port": [], "stored": sorted({
               "q4" if "q4" in w else "q" for w in _stored(local)})}

    def err(got, w):
        w = ac(torch.as_tensor(w), "batch")
        return float((got - w).abs().max() / w.abs().max())
    out["ref"].append(err(logits, want["prefill"]))
    T = REF_S + REF_STEPS
    blocks = sv.place_cache(_grow_cache(sv.whole_cache(blocks), REF_S, T))
    wc = _grow_cache(wc, REF_S, T)
    for i in range(REF_STEPS):
        pos = torch.tensor(REF_S + i)
        logits, blocks = serve(local, blocks, feed[:, i:i + 1], pos)
        wl, wc = plain(params, wc, feed[:, i:i + 1], pos)
        out["ref"].append(err(logits, want["decode"][i]))
        out["port"].append(err(logits, wl))
    return out


def _stored(tree):
    """The stored weights ({"q" | "q4", "scale"}) of a parameter tree."""
    if isinstance(tree, dict):
        if "scale" in tree:
            return [tree]
        return [w for v in tree.values() for w in _stored(v)]
    return []


def _serve_world(rank, world, device, ref_file):
    from repro_torch.launch.mesh import make_serving_mesh, make_sub_mesh
    with open(ref_file, "rb") as f:
        ref = pickle.load(f)
    out = {}
    for arch, meshes in REF_MESHES.items():
        for data, tp in meshes:
            if data * tp == world:
                mesh = make_serving_mesh(model=tp, data=data,
                                         device_type="cpu", backend="gloo")
            else:
                mesh = make_sub_mesh(data, tp, device_type="cpu")
            if mesh is None:
                continue
            for mode in MODES:
                out[arch, mode, data, tp] = _serve_case(mesh, arch, mode, ref,
                                                        data, tp)
    return out


@pytest.fixture(scope="module")
def reference_serving(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF_SCRIPT.format(B=REF_B, S=REF_S, STEPS=REF_STEPS,
                               QK=QK_SCALE, MESHES=repr(REF_MESHES),
                               MODES=repr(MODES))
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return str(path)


@pytest.fixture(scope="module")
def serve_world4(reference_serving):
    """A world of 4: data=2 x model=2 and model=4, and model=2 on its
    first two ranks."""
    return spawn(_serve_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(reference_serving,))


SERVE_CASES = [(a, m, d, t) for a, ms in REF_MESHES.items()
               for d, t in ms for m in MODES]


@pytest.mark.parametrize("arch,mode,data,tp", SERVE_CASES,
                         ids=[f"{a}-{m}-{d}x{t}"
                              for a, m, d, t in SERVE_CASES])
def test_stored_weights_serve_as_the_reference(arch, mode, data, tp,
                                               serve_world4):
    """Prefill and 4 decode steps on stored weights at a model split:
    within 1e-5 of the reference's jitted sharded steps; the prefill bit
    for bit and the decode within 1e-5 of the port's unsharded steps;
    int4 codes at w4 and HAQ (whose 2-D weights take 2 bits), int8
    only at w8."""
    got = [r[arch, mode, data, tp] for r in serve_world4
           if (arch, mode, data, tp) in r]
    assert len(got) == data * tp
    for res in got:
        assert len(res["ref"]) == REF_STEPS + 1
        assert max(res["ref"]) <= REF_RTOL, res["ref"]
        assert res["exact"]
        assert max(res["port"]) <= DECODE_RTOL, res["port"]
        assert res["stored"] == (["q"] if mode == "w8" else ["q", "q4"])


def test_stored_layout_keeps_scales_whole():
    """``param_layout`` of a stored tree: the codes split as their weight
    (heads, kv heads and d_ff over model; embed over data), every scale
    whole on every rank, as the reference's dry-run places them."""
    from repro_torch.launch.mesh import _mesh, dry_world
    from repro_torch.serving.quant import quantize_params
    model = build_model(tiny_config("gemma2-2b"))
    params = quantize_params(model.init(torch.Generator().manual_seed(0),
                                        "cpu"), default_bits=4)
    with dry_world(4):
        sv = serve_steps(model, shlib.make_ac(_mesh(2, 2, "cpu", 60.0)),
                         dot=dequant_dot)
        specs = sv.param_layout(params)[0]
    ffn = specs["blocks"]["sub0"]["ffn"]
    assert ffn["w_in"]["q4"] == (None, "data", "model")
    assert ffn["w_in"]["scale"] == (None, None)
    assert specs["blocks"]["sub0"]["attn"]["wq"]["q"] == (None, "data",
                                                          "model", None)
    plain = sv.param_layout(model.abstract_params())[0]
    assert plain["blocks"]["sub0"]["ffn"]["w_in"] == (None, "data",
                                                      "model")


def test_kv_slice_of_codes_is_contiguous():
    """A stored wk's kv-head slice: its codes in storage of their own (the
    W8A16 kernel reads contiguous codes) and its whole scale."""
    w = {"q": torch.arange(4 * 3 * 8, dtype=torch.int8).reshape(4, 3, 8),
         "scale": torch.tensor([0.5])}
    s = shlib.kv_slice(w, None, 1, 2)
    assert s["q"].is_contiguous() and torch.equal(s["q"], w["q"][:, 1:2])
    assert s["scale"] is w["scale"]


# ------------------------------------------------------------- training --
def _tied(np_state):
    """The reference's state with TIES set to each channel's max |w| (the
    masters too)."""
    for tree in (np_state["params"], np_state["opt"]["master"]):
        for slot, elems in TIES:
            attn = tree["blocks"][slot]["attn"]
            wq = attn["wq"] = np.array(attn["wq"])
            for layer in range(wq.shape[0]):
                top = np.abs(wq[layer][..., elems[0][2]]).max() + 0.25
                for d, h, c in elems:
                    wq[layer, d, h, c] = top
    return np_state


def _haq_state():
    np_state, jo = _ref_state("gemma2-2b")
    return _tied(np_state), jo


def _reference_haq():
    """The reference's make_train_step with the fake-quant hook, run
    eagerly (``jax.disable_jit``: compiled, its weight quantizer takes
    amax / qmax as amax * (1 / qmax), one fp32 ulp off its own definition,
    which moves 2- to 6-bit codes; the port follows the definition, as
    tests/test_torch_haq.py holds it): TRAIN_STEPS fp32 steps and the
    first gradients."""
    jm = j_build(j_tiny("gemma2-2b"))
    np_state, jo = _haq_state()
    jdot = j_quant_dot(POLICY)
    state = jax.tree.map(jnp.asarray, np_state)
    b0 = jdp.batch_for_model(jm, SHAPE, None, 0)
    with jax.disable_jit():
        step = jsteps.make_train_step(jm, JTrain(optim=jo), dot=jdot)
        _, g = jax.value_and_grad(
            lambda p: jm.loss(p, b0, remat=True, dot=jdot))(state["params"])
        out = {"grads": [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(g)], "steps": []}
        for k in range(TRAIN_STEPS):
            state, met = step(state, jdp.batch_for_model(jm, SHAPE, None,
                                                         k))
            state = {"params": state["opt"]["master"], "opt": state["opt"]}
            out["steps"].append(({n: float(v) for n, v in met.items()}, [
                np.asarray(x, np.float32)
                for x in jax.tree.leaves(state["opt"]["master"])]))
    return out


def _batch(model, k):
    return tdp.batch_for_model(model, SHAPE, None, k, full=True)


def _haq_case(step_fn, model, state, whole_of, grads_of):
    grads = grads_of(state["params"])
    steps, _ = _run_steps(step_fn, state, True, lambda k: _batch(model, k),
                          whole_of, steps=TRAIN_STEPS)
    return {"grads": grads, "steps": steps}


def _train_world(rank, world, device):
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(model=2, data=1, device_type="cpu",
                             backend="gloo")
    ac = shlib.make_ac(mesh)
    model = build_model(tiny_config("gemma2-2b"))
    out = {}
    for case in ("haq", "local_amax", "local_ties"):
        saved = shlib.group_amax
        if case == "local_amax":
            shlib.group_amax = lambda a, dims, group: a.amax(
                dim=dims, keepdim=True)
        tr = tsh.ShardedTrainer(model, _tcfg(), ac, dot=make_quant_dot(POLICY))
        state = from_jax_state(_haq_state()[0])
        st = tr.shard(state, tr.specs)

        def grads_of(params, tr=tr):
            _, g = tr.grads(params, _batch(model, 0), tr.ac)
            return [tr.whole(x, s).float().numpy()
                    for x, s in zip(tree_leaves(g), tr.param_specs)]
        try:
            if case == "local_ties":
                _own_ties()
            if case == "haq":
                out[case] = _haq_case(tr.step, model, st, tr.host_state,
                                      grads_of)
            else:
                out[case] = grads_of(st["params"])
        finally:
            shlib.group_amax = saved
            shlib._GroupAmax.forward = _FORWARD
    return out


_FORWARD = shlib._GroupAmax.forward


def _own_ties():
    """The control: ``_GroupAmax`` counting only this rank's tied
    elements."""
    def forward(ctx, a, dims, group):
        whole = shlib.all_gather_dim(a.amax(dim=dims, keepdim=True)
                                     .unsqueeze(0), 0, group).amax(dim=0)
        hit = a == whole
        ctx.save_for_backward(hit, hit.sum(dim=dims, keepdim=True)
                              .clamp(min=1).float())
        ctx.group = group
        return whole
    shlib._GroupAmax.forward = staticmethod(forward)


@pytest.fixture(scope="module")
def train_world2():
    return spawn(_train_world, 2, backend="gloo", timeout_s=WORLD_S)


@pytest.fixture(scope="module")
def haq_runs():
    """The reference's run and the port's one-device run."""
    model = build_model(tiny_config("gemma2-2b"))
    dot = make_quant_dot(POLICY)
    tcfg = _tcfg()
    state = from_jax_state(_haq_state()[0])

    def grads_of(params):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(params, _batch(model, 0), remat=True, dot=dot)
        g = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        return [x.float().numpy() for x in g]
    grads = grads_of(state["params"])
    steps, _ = _run_steps(tsteps.make_train_step(model, tcfg, dot=dot),
                          state, True, lambda k: _batch(model, k),
                          steps=TRAIN_STEPS)
    return {"reference": _reference_haq(),
            "one_device": {"grads": grads, "steps": steps}}


def test_haq_training_at_model2_matches_reference(train_world2, haq_runs):
    """The fake-quant hook inside the tensor-parallel sites, ties
    included: against the one-device port under the fp32 rules, and
    against the reference (eager) with its losses and grad norms within
    HAQ_REF_RTOL."""
    got = train_world2[0]["haq"]
    _check_fp32(got, haq_runs["one_device"], steps=TRAIN_STEPS)
    want = haq_runs["reference"]
    assert _grad_err(want["grads"], got["grads"]) <= GRAD_TOL
    for (gm, gmast), (wm, wmast) in zip(got["steps"], want["steps"]):
        for k in ("loss", "grad_norm"):
            assert abs(gm[k] - wm[k]) <= HAQ_REF_RTOL * abs(wm[k]), k
        d = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(gmast, wmast)])
        assert d.max() <= 2 * LR * (1 + 1e-3)
        assert np.mean(d > 1e-3 * LR) <= 1e-3
    assert all(np.array_equal(a, b) for a, b in zip(
        train_world2[1]["haq"]["grads"], got["grads"]))


def test_tied_maxima_take_the_references_share(haq_runs):
    """The tied wq elements get the reference's gradient, split evenly:
    each tied pair equal, and nonzero (the scale's gradient)."""
    model = build_model(tiny_config("gemma2-2b"))
    paths = shlib.leaf_paths(model.abstract_params())
    ref = haq_runs["reference"]["grads"]
    for slot, elems in TIES:
        g = ref[paths.index(("blocks", slot, "attn", "wq"))]
        vals = [g[0, d, h, c] for d, h, c in elems]
        assert vals[0] == vals[1] != 0.0


@pytest.mark.parametrize("control", ["local_amax", "local_ties"])
def test_controls_miss(control, train_world2, haq_runs):
    """The scale from the rank's slice alone, or the ties of the rank's
    own elements, move the first gradients past the tolerance."""
    want = haq_runs["one_device"]["grads"]
    assert _grad_err(want, train_world2[0]["haq"]["grads"]) <= GRAD_TOL
    assert _grad_err(want, train_world2[0][control]) > 100 * GRAD_TOL



def _dequantized(tree):
    """A stored tree with every stored weight replaced by its fp32
    dequantized value (per-layer scales over the stacked dim)."""
    from repro_torch.kernels import ref as kref
    if isinstance(tree, dict) and "scale" in tree:
        q = kref.unpack_w4(tree["q4"]) if "q4" in tree else tree["q"]
        s = tree["scale"]
        if s.dim() == 2:                      # (L, 1): one scale a layer
            s = s.reshape((s.shape[0],) + (1,) * (q.dim() - 1))
        return q.float() * s
    if isinstance(tree, dict):
        return {k: _dequantized(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("arch,site", [("whisper-large-v3", "xattn_o"),
                                       ("zamba2-1.2b", "fuse")])
def test_stored_weights_reach_every_site(arch, site):
    """Stored weights the reference's plain products cannot take (its
    einsum fails on them): whisper's cross-attention out projection and
    zamba2's fuse projections go through the hook, in the prefill and a
    decode step on int4-stored fp32 weights. zamba2's steps (fp32
    throughout) equal the plain steps on the dequantized weights;
    whisper's encoder carries bf16 activations (as the reference's
    does), where the hook takes the dequantized weight in bf16, so its
    logits are held finite."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import encdec
    from repro_torch.models.params import tree_map
    from repro_torch.serving.quant import quantize_params
    model = build_model(tiny_config(arch))
    params = tree_map(lambda a: a.float(), model.init(
        torch.Generator().manual_seed(0), "cpu"))
    stored = quantize_params(params, default_bits=4)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    S = 12
    batch = {"tokens": torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (2, S)).astype(np.int32))}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 16, cfg.d_model)).astype(np.float32))
    seen = set()

    def hook(x, w, name, amax=None):
        if isinstance(w, dict):
            seen.add(name)
        return dequant_dot(x, w, name)
    outs = []
    for p, dot in ((stored, hook), (_dequantized(stored), None)):
        logits, cache = model.prefill(p, batch, dot=dot)
        cache = encdec.grow_cache(cache, S + 1) if cfg.is_encdec \
            else _grow_cache(cache, S, S + 1)
        step, _ = model.decode_step(p, cache, batch["tokens"][:, :1],
                                    torch.tensor(S), dot=dot)
        outs.append((logits, step))
    assert site in seen
    for got, want in zip(*outs):
        assert bool(torch.isfinite(got).all())
        if not cfg.is_encdec:
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
