"""The port's sharded prefill and serve steps (training/sharded_serve.py,
distributed/sharding.py's ``CacheBlock`` and ``softmax_combine``,
models/attention.py's decode over a cache block, ``make_prefill_step`` /
``make_serve_step`` with ``ac``) on the CPU, in gloo worlds.

Tiny gemma2-2b (window 32, caps) and tiny granite-3-8b (4 query heads, 2
kv heads) on numpy-seeded prompts, in a world of 2 ranks (a sub-mesh of
one rank, model=2, data=2) and one of 4 (data=2 x model=2, and model=4,
where each rank projects its query head's kv head, ``kv_span``). The
prompt is 28 tokens and the decode cache grown to 36, so that 8 decode
steps cross the ring's wrap at 32; or 33 and 41, a length no axis divides:
the cache splits on kv heads at model=2 and is whole at model=4 (2 kv
heads). The local layers' 32-slot rings split on their slots everywhere.
B=3 at data=2 is a batch data does not divide: every rank takes all rows.

Held, per rank, against the unsharded steps on the rank's rows (a split
batch is the one-device run with the rows cut alike: a product over fewer
rows may round bf16 differently on this CPU, which is the batch split,
not the mesh):
  * a world of one rank: prefill, 8 decode steps and every cache leaf bit
    for bit;
  * the prefill's last-row logits and every cache block equal bit for bit
    to the unsharded prefill's rows and the block's slice of its caches,
    fp32 and bf16, at every mesh;
  * decode: fp32 logits within DECODE_RTOL of max |logit| (wq and wk
    scaled by 1/8, as tests/test_torch_dense_decode.py scales them: the
    init saturates the tiny models' softmax); the only reordered sum is
    the combine of the ranks' softmaxes (measured at most 8.9e-7 over every
    case and step, the blocks' written slots 7.0e-7); a control without
    the combine's e^(m_r - M) rescale misses it by over 100x (measured
    0.17-0.43); bf16 at the port's init within BF16_RTOL (measured 0: the
    combine's fp32 rounding vanished in the bf16 cast at every step);
  * after every step, each block equals its slice of the unsharded cache:
    bit for bit at every slot the decode did not write, and within the
    decode tolerance at the written slots of layers past the first (their
    k/v come from activations the combine rounded);
  * each rank's blocks hold 1/model of a split cache's bytes.

Held against the reference: its ``make_prefill_step`` and
``make_serve_step`` jitted with ``repro.launch.dryrun.build_step``'s
shardings on 8 forced host devices (data=2 x model=2, and model=4 for
gemma2-2b), in a subprocess, on its own fp32 parameters (wq, wk x 1/8)
carried in by ``from_jax_params``: prefill and 8 teacher-forced decode
steps at 40 -> 48 tokens, every rank's logits rows within REF_RTOL of max
|logit| (measured 1.2e-6; XLA's and torch's fp32 sums in their own
orders).

``make_ac(mesh, "seq_tp")``'s prefill (the residual's rows split over
model between sub-layers) at every mesh with model > 1: logits and every
block bit-identical to the dp prefill's.

A cache whose sequence falls through to data (ROADMAP item 11i), in a
world of 6 at data=3 x model=2: tiny gemma2-2b, zamba2 and whisper at B
1 with a self-attention length of 33 (39 after 4 decode steps), which 2
does not divide and 3 does, split (None, None, 'data', 'model'): the
prefill's logits and blocks bit-identical to the one-device cache's, the
decode within DECODE_RTOL of one device (measured 5.2e-7 at most) and
within REF_RTOL of the reference's jitted steps on 6 forced devices
(measured 7.3e-7; whisper, bf16 there, within REF_BF16_RTOL: 6.3e-3).

Each world is spawned once (a module fixture) and returns all its cases.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")


from repro.distributed import sharding as j_sh  # noqa: E402
from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.training import sharded_serve as ssv  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma2-2b", "granite-3-8b")
QK_SCALE = 0.125
STEPS = 8
WORLD_S = 240.0
DECODE_RTOL = 1e-5
BF16_RTOL = 2e-2
REF_RTOL = 1e-5
# (label, data, model, B, prompt, decode cache length)
CASES2 = [("world1", 1, 1, 2, 28, 36), ("model2", 1, 2, 2, 28, 36),
          ("model2-kv", 1, 2, 2, 33, 41), ("data2", 2, 1, 2, 28, 36),
          ("data2-B3", 2, 1, 3, 28, 36)]
CASES4 = [("2x2", 2, 2, 2, 28, 36), ("2x2-B3-kv", 2, 2, 3, 33, 41),
          ("model4", 1, 4, 2, 28, 36), ("model4-whole", 1, 4, 2, 33, 41)]
REF_B, REF_S, REF_T = 2, 40, 48
REF_MESHES = {"gemma2-2b": ((2, 2), (1, 4)), "granite-3-8b": ((2, 2),)}


# ------------------------------------------------------------------ pure --
class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes


@pytest.mark.parametrize("shape,sizes,want", [
    ((20, 128, 32768, 16, 128), dict(data=16, model=16),
     (None, "data", "model")),
    ((13, 1, 524288, 4, 256), dict(data=16, model=16),
     (None, None, "model")),
    ((2, 4, 33, 2, 32), dict(data=2, model=2),
     (None, "data", None, "model")),
    ((2, 3, 36, 2, 32), dict(data=2, model=2),
     (None, None, "model")),
    ((2, 1, 34, 2, 32), dict(data=2, model=4), (None, None, "data"))],
    ids=["granite-decode", "gemma-long", "kv-fallthrough", "B3", "seq-data"])
def test_cache_specs_are_the_reference_rule(shape, sizes, want):
    """The sequence takes ``model`` where it divides T, kv heads only
    where it does not; the reference's choose_spec agrees."""
    axes = ("layer", "batch", "cache_seq", "kv_heads", "head_dim")
    assert shlib.choose_spec(shape, axes, sizes) == want
    assert tuple(j_sh.choose_spec(shape, axes, FakeMesh(**sizes))) == want


def test_cache_split_over_data_is_refused_by_name():
    """A cache whose sequence falls through to ``data`` (B not split over
    it) is taken, as the reference's rule gives it, beside its kv heads
    over ``model`` where the sequence leaves it (the world of 6 below
    runs it)."""
    cfg = tiny_config("gemma2-2b")
    assert ssv.cache_spec(cfg, 2, 36, {"data": 2, "model": 2})[2] == "model"
    assert ssv.cache_spec(cfg, 1, 34, {"data": 2, "model": 4}) == (
        None, None, "data", None, None)
    assert ssv.cache_spec(cfg, 1, 9, {"data": 3, "model": 2}) == (
        None, None, "data", "model", None)


@pytest.mark.parametrize("arch,sizes,dot", [
    ("granite-moe-3b-a800m", dict(data=2, model=1), None),
    ("gemma2-2b", dict(data=1, model=2), "dot")],
    ids=["moe-data2", "dot"])
def test_serving_steps_take_moe_and_a_dot_hook(arch, sizes, dot):
    """Items 11e and 11g: moe over data ranks, a dot hook under a model
    split (tests/test_torch_moe_sharded.py and
    tests/test_torch_quant_sharded.py run them); the hook runs inside
    ``tp_dot``'s sites."""
    from repro_torch.launch.mesh import _mesh, dry_world
    model = build_model(get_config(arch))
    hook = (lambda a, w, n: a @ w) if dot else None
    with dry_world(sizes["data"] * sizes["model"]):
        steps = ssv.ShardedServeSteps(model, shlib.make_ac(
            _mesh(sizes["data"], sizes["model"], "cpu", 60.0)), dot=hook)
        assert steps.hook is hook
        assert (steps.dot is hook) == (sizes["model"] == 1)


@pytest.mark.parametrize("arch,data,tp", [
    ("mamba2-370m", 1, 2), ("zamba2-1.2b", 2, 1),
    ("whisper-large-v3", 1, 2), ("llava-next-mistral-7b", 2, 1)],
    ids=["mamba2", "zamba2", "whisper", "llava"])
def test_serving_steps_take_the_families(arch, data, tp):
    """The families item 11d refused: the steps are made over a mesh of
    ``fake``-backend ranks, their parameters placed per ``specs_for``
    (tests/test_torch_serve_sharded_families.py runs them)."""
    from repro_torch.launch.mesh import _mesh, dry_world
    model = build_model(get_config(arch))
    with dry_world(data * tp):
        steps = ssv.ShardedServeSteps(model, shlib.make_ac(
            _mesh(data, tp, "cpu", 60.0)))
        assert steps.sizes == {"data": data, "model": tp}


def test_decode_without_a_placed_cache_is_refused():
    from repro_torch.launch.mesh import dry_world, _mesh
    model = build_model(tiny_config("gemma2-2b"))
    with dry_world(1):
        steps = ssv.ShardedServeSteps(model, shlib.make_ac(
            _mesh(1, 1, "cpu", 60.0)))
        cache = model.init_cache(2, 36, device="cpu")
        with pytest.raises(ValueError, match="placed"):
            steps.decode(None, cache, torch.zeros(2, 1, dtype=torch.int32),
                         torch.tensor(28))
        steps.place_cache(cache)
        bad = {j: {n: x[:, :, :-2] for n, x in c.items()}
               for j, c in cache.items()}
        with pytest.raises(ValueError, match="not this rank's block"):
            steps.decode(None, bad, torch.zeros(2, 1, dtype=torch.int32),
                         torch.tensor(28))


@pytest.mark.parametrize("arch", ["mamba2-370m", "gemma2-2b"])
def test_world_of_one_is_the_unsharded_steps(arch):
    """On a one-rank mesh (a ``fake``-backend world of one, whose
    collectives are identities) the steps are the unsharded ones bit for
    bit, for the families without the hooks too."""
    from repro_torch.launch.mesh import _mesh, dry_world
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.training import steps as st
    model = build_model(tiny_config(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(2, 500, (2, 20)).astype(np.int32))
    with dry_world(1):
        ac = shlib.make_ac(_mesh(1, 1, "cpu", 60.0))
        steps = ssv.serve_steps(model, ac)
        local = steps.shard_params(params)
        got = st.make_prefill_step(model, ac=ac)(local, {"tokens": tokens})
        want = st.make_prefill_step(model)(params, {"tokens": tokens})
        assert torch.equal(got[0], want[0])
        got_c = steps.place_cache(_grow_cache(steps.whole_cache(got[1]), 20,
                                              23))
        want_c = _grow_cache(want[1], 20, 23)
        serve = st.make_serve_step(model, ac=ac)
        for i in range(3):
            tok = tokens[:, i:i + 1]
            a, got_c = serve(local, got_c, tok, torch.tensor(20 + i))
            b, want_c = st.make_serve_step(model)(params, want_c, tok,
                                                  torch.tensor(20 + i))
            assert torch.equal(a, b)
    for x, y in zip(tree_leaves(got_c), tree_leaves(want_c)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_tied_embedding_is_gathered_once_a_step(kind):
    """The lookup and the unembedding share one gather of a tied table
    (model=2 on a ``fake``-backend world, meta tensors)."""
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import _mesh, dry_world
    model = build_model(tiny_config("gemma2-2b"))
    a = model.abstract_params()["embed"]
    whole = a.numel() * a.element_size()
    with dry_world(2):
        fn, args, _, _ = dryrun.build_step(
            model, ShapeConfig(kind[0], 64, 2, kind), _mesh(1, 2, "cpu", 60.0),
            TrainConfig())
        sizes = []
        with shlib.collective_log(lambda k, n: sizes.append(n)):
            fn(*args)
            fn(*args)
    assert sizes.count(whole) == 2         # once a step


# ------------------------------------------------------------- the worlds --
def _params(model, fp32):
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    if not fp32:
        return p
    from repro_torch.models.params import tree_map
    p = tree_map(lambda a: a.float(), p)
    for sub in p["blocks"].values():
        for n in ("wq", "wk"):
            sub["attn"][n] = sub["attn"][n] * QK_SCALE
    return p


def _rows_block(x, spec, steps):
    """The block of a (L, B_rows, T, K, hd) leaf of this rank's rows under
    a cache ``spec`` (its batch dim already cut)."""
    return shlib.local_block(x, (None, None) + tuple(spec[2:]), steps.sizes,
                             steps.coords)


def _written(place, T, S, steps_n):
    """The global slots the decode wrote in one slot's cache."""
    W = place.length
    return {(S + i) % W if W != T else S + i for i in range(steps_n)}


def _cache_check(steps, blocks, want, S, T, tol_of):
    """(prefill slots bit for bit, layer 0 bit for bit, worst relative
    error at the written slots) of the blocks against the unsharded rows'
    caches."""
    place = steps.layout(blocks)
    exact, first, worst = True, True, 0.0
    for j, c in blocks.items():
        p = place[j]
        local = torch.arange(p.local_len) + p.offset
        wrote = torch.tensor([int(g) in _written(p, T, S, STEPS)
                              for g in local])
        for n, got in c.items():
            ref = _rows_block(want[j][n], p.spec, steps)
            same = got == ref
            exact &= bool(same[:, :, ~wrote].all())
            if j == "sub0":           # the first layer's k/v: exact
                first &= bool(same[0].all())
            err = (got.float() - ref.float()).abs().max()
            worst = max(worst, float(err) / tol_of(ref))
    return exact, first, worst


def _run(mesh, arch, fp32, B, S, T, control=False):
    """Prefill + STEPS decode steps through the sharded steps on ``mesh``,
    against the unsharded steps on this rank's rows."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.training import steps as st
    model = build_model(tiny_config(arch))
    params = _params(model, fp32)
    ac = shlib.make_ac(mesh)
    steps = ssv.serve_steps(model, ac)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(2, 500, (B, S)).astype(np.int32))
    feed = torch.from_numpy(rng.integers(2, 500, (B, STEPS))
                            .astype(np.int32))
    local = steps.shard_params(params)
    lw, cw = st.make_prefill_step(model)(params, {"tokens": ac(tokens,
                                                               "batch")})
    ls, blocks = st.make_prefill_step(model, ac=ac)(local,
                                                    {"tokens": tokens})
    place = steps.layout(blocks)
    # make_ac's seq_tp: the residual's rows split over model between
    # sub-layers; its prefill is dp's, logits and blocks
    seq = shlib.make_ac(mesh, "seq_tp")
    lq, bq = st.make_prefill_step(model, ac=seq)(local, {"tokens": tokens})
    out = {"pre_logits": torch.equal(lw, ls), "pre_blocks": all(
        torch.equal(blocks[j][n], _rows_block(cw[j][n], place[j].spec,
                                              steps))
        for j in cw for n in ("k", "v")),
        "seq_tp": torch.equal(lq, ls) and all(
            torch.equal(bq[j][n], blocks[j][n]) for j in cw
            for n in ("k", "v")),
        "split": {j: (p.split, p.heads_split, p.local_len)
                  for j, p in place.items()}}
    _, whole = st.make_prefill_step(model)(params, {"tokens": tokens})
    whole = _grow_cache(whole, S, T)
    cw = _grow_cache(cw, S, T)
    blocks = steps.place_cache(whole)
    out["bytes"] = [sum(x.numel() * x.element_size() for c in t.values()
                        for x in c.values()) for t in (blocks, whole)]
    serve = st.make_serve_step(model, ac=ac)
    unsharded = st.make_serve_step(model)
    if control:
        combine = shlib.softmax_combine
        shlib.softmax_combine = lambda *a, **k: combine(*a, rescale=False)
    try:
        decode, cache = [], []
        for i in range(STEPS):
            pos = torch.tensor(S + i)
            want, cw = unsharded(params, cw, ac(feed[:, i:i + 1], "batch"),
                                 pos)
            got, blocks = serve(local, blocks, feed[:, i:i + 1], pos)
            decode.append(float((got - want).abs().max()
                                / want.abs().max()))
            if not control:
                cache.append(_cache_check(
                    steps, blocks, cw, S, T,
                    lambda r: max(float(r.float().abs().max()), 1e-30)))
    finally:
        if control:
            shlib.softmax_combine = combine
    out.update(decode=decode, cache=cache)
    return out


def _reference_case(mesh, arch, ref_file, data, tp):
    """The reference's parameters and inputs through the port's sharded
    steps on ``mesh``: every step's logits rows against the reference's
    jitted sharded run."""
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models.convert import from_jax_params
    from repro_torch.training import steps as st
    with open(ref_file, "rb") as f:
        ref = pickle.load(f)
    model = build_model(tiny_config(arch))
    params = from_jax_params(ref["params"][arch])
    ac = shlib.make_ac(mesh)
    steps = ssv.serve_steps(model, ac)
    local = steps.shard_params(params)
    tokens = torch.from_numpy(ref["tokens"])
    feed = torch.from_numpy(ref["feed"])
    want = ref["logits"][f"{arch}|{data}|{tp}"]
    errs = []
    logits, blocks = st.make_prefill_step(model, ac=ac)(local,
                                                        {"tokens": tokens})
    w = ac(torch.from_numpy(want["prefill"]), "batch")
    errs.append(float((logits - w).abs().max() / w.abs().max()))
    whole = _grow_cache(steps.whole_cache(blocks), REF_S, REF_T)
    blocks = steps.place_cache(whole)
    serve = st.make_serve_step(model, ac=ac)
    for i in range(STEPS):
        logits, blocks = serve(local, blocks, feed[:, i:i + 1],
                               torch.tensor(REF_S + i))
        w = ac(torch.from_numpy(want["decode"][i]), "batch")
        errs.append(float((logits - w).abs().max() / w.abs().max()))
    return errs


def _world(rank, world, device, cases, ref_file=None):
    from repro_torch.launch.mesh import make_serving_mesh, make_sub_mesh
    out = {}
    for label, data, tp, B, S, T in cases:
        if data * tp == world:
            mesh = make_serving_mesh(model=tp, data=data, device_type="cpu",
                                     backend="gloo")
        else:
            mesh = make_sub_mesh(data, tp, device_type="cpu")
        if mesh is None:
            continue
        for arch in ARCHS:
            for fp32 in (True, False):
                out[(label, arch, fp32)] = _run(mesh, arch, fp32, B, S, T)
        if label in ("model2", "2x2"):
            out[(label, "control")] = _run(mesh, "gemma2-2b", True, B, S, T,
                                           control=True)
        if ref_file and label in ("2x2", "model4"):
            for arch, meshes in REF_MESHES.items():
                if (data, tp) in meshes:
                    out[(label, arch, "ref")] = _reference_case(
                        mesh, arch, ref_file, data, tp)
    return out


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
B, S, T, STEPS, QK = {B}, {S}, {T}, {STEPS}, {QK}
MESHES = {MESHES}
rng = np.random.default_rng(5)
out = {{"tokens": rng.integers(2, 500, (B, S)).astype(np.int32),
        "feed": rng.integers(2, 500, (B, STEPS)).astype(np.int32),
        "params": {{}}, "logits": {{}}}}
for arch, meshes in MESHES.items():
    model = build_model(tiny_config(arch))
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     model.init(jax.random.PRNGKey(0)))
    for sub in p["blocks"].values():
        for n in ("wq", "wk"):
            sub["attn"][n] = sub["attn"][n] * QK
    out["params"][arch] = jax.tree.map(np.asarray, p)
    for data, tp in meshes:
        mesh = Mesh(np.asarray(jax.devices()[:data * tp]).reshape(data, tp),
                    ("data", "model"))
        step, args, ins, outs, don, _ = rd.build_step(
            model, ShapeConfig("p", S, B, "prefill"), mesh, TrainConfig())
        dstep, dargs, dins, douts, ddon, _ = rd.build_step(
            model, ShapeConfig("d", T, B, "decode"), mesh, TrainConfig())
        with mesh:
            logits, cache = jax.jit(step, in_shardings=ins,
                                    out_shardings=outs)(
                p, {{"tokens": jnp.asarray(out["tokens"])}})
            cache = jax.tree.map(
                lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, T - S), (0, 0),
                                      (0, 0))) if a.shape[2] == S else a,
                cache)
            f = jax.jit(dstep, in_shardings=dins, out_shardings=douts)
            dec = []
            for i in range(STEPS):
                lg, cache = f(p, cache, jnp.asarray(out["feed"][:, i:i + 1]),
                              jnp.int32(S + i))
                dec.append(np.asarray(lg, np.float32))
        out["logits"][f"{{arch}}|{{data}}|{{tp}}"] = {{
            "prefill": np.asarray(logits, np.float32), "decode": dec}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF_SCRIPT.format(B=REF_B, S=REF_S, T=REF_T, STEPS=STEPS,
                               QK=QK_SCALE, MESHES=repr(REF_MESHES))
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return str(path)


@pytest.fixture(scope="module")
def world2():
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(CASES2,))


@pytest.fixture(scope="module")
def world4(reference):
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(CASES4, reference))


def _results(request, label):
    world = request.getfixturevalue(
        "world2" if label in [c[0] for c in CASES2] else "world4")
    return world


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [c[0] for c in CASES2 + CASES4])
def test_prefill_is_bit_identical(label, arch, fp32, request):
    for r in _results(request, label):
        if (label, arch, fp32) not in r:
            continue                  # a rank outside the sub-mesh
        res = r[(label, arch, fp32)]
        assert res["pre_logits"] and res["pre_blocks"], label


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [c[0] for c in CASES2 + CASES4
                                   if c[2] > 1])
def test_seq_tp_prefill_is_the_dp_prefill(label, arch, fp32, request):
    """The prefill under make_ac(mesh, "seq_tp"): logits and every cache
    block bit-identical to the dp prefill's on the same mesh (a prompt of
    28 splits its rows over model; one of 33 does not)."""
    for r in _results(request, label):
        if (label, arch, fp32) in r:
            assert r[(label, arch, fp32)]["seq_tp"], label


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [c[0] for c in CASES2 + CASES4])
def test_decode_within_tolerance_and_blocks_follow(label, arch, fp32,
                                                   request):
    tol = DECODE_RTOL if fp32 else BF16_RTOL
    for r in _results(request, label):
        if (label, arch, fp32) not in r:
            continue
        res = r[(label, arch, fp32)]
        if label == "world1":
            assert max(res["decode"]) == 0.0
            assert all(e and f and w == 0.0 for e, f, w in res["cache"])
            continue
        assert max(res["decode"]) <= tol, res["decode"]
        for exact, first, worst in res["cache"]:
            assert exact and first and worst <= tol, res["cache"]


def test_the_layouts_each_case_takes(world2, world4):
    """Which dim each slot's cache splits on, and each rank's bytes."""
    def get(world, label, arch="gemma2-2b"):
        return world[0][(label, arch, True)]
    assert get(world2, "world1")["split"] == {"sub0": (False, False, 32),
                                              "sub1": (False, False, 28)}
    # the ring's 32 slots split over model=2; the prompt's 33 slots do not
    # divide: the global layer's cache splits on its 2 kv heads
    assert get(world2, "model2-kv")["split"] == {"sub0": (True, False, 16),
                                                 "sub1": (False, True, 33)}
    assert get(world4, "model4")["split"]["sub1"] == (True, False, 7)
    # 33 slots and 2 kv heads over model=4: the global cache whole
    assert get(world4, "model4-whole")["split"]["sub1"] == (False, False,
                                                            33)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_rank_holds_its_share_of_the_cache(arch, world2, world4):
    """A cache split on its sequence (or kv heads): each rank's blocks
    hold 1/model of the whole's bytes; 1/data more where data splits the
    batch."""
    for world, label, n in ((world2, "model2", 2), (world2, "model2-kv", 2),
                            (world2, "data2", 2), (world4, "model4", 4),
                            (world4, "2x2", 4)):
        for r in world:
            mine, whole = r[(label, arch, False)]["bytes"]
            assert mine * n == whole, label


def test_the_control_misses_by_100x(world2, world4):
    """The combine without its e^(m_r - M) rescale misses the tolerance by
    over 100x."""
    for world, label in ((world2, "model2"), (world4, "2x2")):
        for r in world:
            assert max(r[(label, "control")]["decode"]) > 100 * DECODE_RTOL


@pytest.mark.parametrize("arch,mesh", [
    (a, m) for a, ms in REF_MESHES.items() for m in ms],
    ids=lambda x: x if isinstance(x, str) else "x".join(map(str, x)))
def test_matches_the_reference_jitted_sharded_steps(arch, mesh, world4):
    label = {(2, 2): "2x2", (1, 4): "model4"}[mesh]
    for r in world4:
        errs = r[(label, arch, "ref")]
        assert len(errs) == STEPS + 1
        assert max(errs) <= REF_RTOL, errs


def test_measured_gaps_are_recorded(world2, world4):
    """The worst fp32 decode gap over every case and step, for the record
    (printed with -s)."""
    worst = max(max(res["decode"]) for world in (world2, world4)
                for r in world for k, res in r.items()
                if len(k) == 3 and k[2] is True)
    print(json.dumps({"worst_fp32_decode_gap": worst}))
    assert worst <= DECODE_RTOL


# ------------------------------------------ a cache split over data (11i) --
# B = 1 at data=3 x model=2: the batch takes no axis, and a
# self-attention length that 2 does not divide and 3 does falls through
# to data, its kv heads over model: (None, None, 'data', 'model'). 33
# prompt tokens (whisper: its decoder's, over 264 frames) and 4 decode
# steps in 39 slots; gemma2-2b's 32-slot rings split over model.
ARCHS6 = ("gemma2-2b", "zamba2-1.2b", "whisper-large-v3")
S6, T6, STEPS6 = 33, 39, 4
BF16_REF6 = ("whisper-large-v3",)    # the reference's encoder takes bf16
REF_BF16_RTOL = 2e-2                 # tests/test_torch_serve_sharded_families


def _inputs6(cfg, seed=7):
    """(prefill batch, decode feed, first decode position), numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, 500, (1, S6)).astype(np.int32)}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (1, S6 * cfg.dec_ratio, cfg.d_model)).astype(np.float32)
    return batch, rng.integers(2, 500, (1, STEPS6)).astype(np.int32), S6


def _attn_trees(p):
    out = []
    for key in ("blocks", "shared", "enc", "dec"):
        sub = p.get(key)
        if sub is None:
            continue
        for s in (sub.values() if key == "blocks" else [sub]):
            out += [s[n] for n in ("attn", "xattn") if n in s]
    return out


def _grow6(model, cache):
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import encdec
    if model.cfg.is_encdec:
        return encdec.grow_cache(cache, T6)
    return _grow_cache(cache, S6, T6)


def _run6(mesh, arch, params=None, ref=None):
    """Prefill + STEPS6 decode steps on ``mesh`` against the unsharded
    steps (fp32, wq and wk x 1/8), or with ``ref`` the reference's
    parameters and inputs: every step's logits against its."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.models.params import tree_map
    from repro_torch.training import steps as st
    model = build_model(tiny_config(arch))
    if ref is None:
        params = tree_map(lambda a: a.float(), model.init(
            torch.Generator().manual_seed(0), "cpu"))
        for a in _attn_trees(params):
            for n in ("wq", "wk"):
                a[n] = a[n] * QK_SCALE
        batch, feed, n0 = _inputs6(model.cfg)
    else:
        params = from_jax_params(ref["params"])
        batch, feed, n0 = ref["batch"], ref["feed"], S6
    dtype = next(iter(tree_leaves(params))).dtype
    batch = {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
             else torch.from_numpy(v) for k, v in batch.items()}
    feed = torch.from_numpy(feed)
    ac = shlib.make_ac(mesh)
    steps = ssv.serve_steps(model, ac)
    local = steps.shard_params(params)
    logits, blocks = st.make_prefill_step(model, ac=ac)(local, batch)
    place = steps.layout(blocks)
    out = {"specs": {j: getattr(p, "spec", None) for j, p in place.items()}}
    serve = st.make_serve_step(model, ac=ac)
    if ref is not None:
        errs = [rel(logits, torch.from_numpy(ref["prefill"]))]
        blocks = steps.place_cache(_grow6(model, steps.whole_cache(blocks)))
        for i in range(STEPS6):
            lg, blocks = serve(local, blocks, feed[:, i:i + 1],
                               torch.tensor(n0 + i))
            errs.append(rel(lg, torch.from_numpy(ref["decode"][i])))
        return errs
    lw, cw = st.make_prefill_step(model)(params, batch)
    groups = ssv.cache_groups(model.cfg, cw)
    out["pre_logits"] = torch.equal(logits, lw)
    out["pre_blocks"] = all(
        torch.equal(b, shlib.local_block(groups[j][n],
                                         place[j].leaf_spec(n), steps.sizes,
                                         steps.coords))
        for j, c in ssv.cache_groups(model.cfg, blocks).items()
        for n, b in c.items())
    cw = _grow6(model, cw)
    blocks = steps.place_cache(cw)
    out["decode"] = []
    for i in range(STEPS6):
        pos = torch.tensor(n0 + i)
        want, cw = st.make_serve_step(model)(params, cw, feed[:, i:i + 1],
                                             pos)
        got, blocks = serve(local, blocks, feed[:, i:i + 1], pos)
        out["decode"].append(rel(got, want))
    return out


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / max(float(b.float().abs().max()), 1e-30))


def _world6(rank, world, device, ref_file):
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(model=2, data=3, device_type="cpu",
                             backend="gloo")
    with open(ref_file, "rb") as f:
        ref = pickle.load(f)
    return {arch: (_run6(mesh, arch), _run6(mesh, arch, ref=ref[arch]))
            for arch in ARCHS6}


REF6_SCRIPT = """
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
STEPS, QK, BF16 = {STEPS}, {QK}, {BF16!r}
with open(sys.argv[2], "rb") as f:
    inputs = pickle.load(f)


def attn_trees(p):
    out = []
    for key in ("blocks", "shared", "enc", "dec"):
        sub = p.get(key)
        if sub is None:
            continue
        for s in (sub.values() if key == "blocks" else [sub]):
            out += [s[n] for n in ("attn", "xattn") if n in s]
    return out


def grow(tree, n, key=""):
    if isinstance(tree, dict):
        return {{k: grow(v, n, k if key == "" else key)
                for k, v in tree.items()}}
    if tree.ndim == 5 and key not in ("mamba", "mk", "mv") \\
            and tree.shape[2] == n:
        return jnp.pad(tree, ((0, 0), (0, 0), (0, {T} - n), (0, 0), (0, 0)))
    return tree


mesh = Mesh(np.asarray(jax.devices()[:6]).reshape(3, 2), ("data", "model"))
out = {{}}
for arch, (batch, feed, n0) in inputs.items():
    model = build_model(tiny_config(arch))
    r = model.cfg.dec_ratio if model.cfg.is_encdec else 1
    dtype = jnp.bfloat16 if arch in BF16 else jnp.float32
    p = jax.tree.map(lambda a: a.astype(dtype),
                     model.init(jax.random.PRNGKey(0)))
    for a in attn_trees(p):
        for n in ("wq", "wk"):
            a[n] = (a[n].astype(jnp.float32) * QK).astype(dtype)
    step, args, ins, outs, don, _ = rd.build_step(
        model, ShapeConfig("p", n0 * r, 1, "prefill"), mesh, TrainConfig())
    dstep, dargs, dins, douts, ddon, _ = rd.build_step(
        model, ShapeConfig("d", {T} * r, 1, "decode"), mesh, TrainConfig())
    with mesh:
        logits, cache = jax.jit(step, in_shardings=ins, out_shardings=outs)(
            p, {{k: jnp.asarray(v) for k, v in batch.items()}})
        cache = grow(cache, n0)
        f = jax.jit(dstep, in_shardings=dins, out_shardings=douts)
        dec = []
        for i in range(STEPS):
            lg, cache = f(p, cache, jnp.asarray(feed[:, i:i + 1]),
                          jnp.int32(n0 + i))
            dec.append(np.asarray(lg, np.float32))
    out[arch] = {{"params": jax.tree.map(np.asarray, p), "batch": batch,
                 "feed": feed, "prefill": np.asarray(logits, np.float32),
                 "decode": dec}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def world6(tmp_path_factory):
    """The reference's jitted sharded steps on 6 of 8 forced host devices
    at data=3 x model=2 (a subprocess), then the world of 6 gloo ranks,
    which runs every case of item 11i."""
    tmp = tmp_path_factory.mktemp("ref6")
    path, inputs = tmp / "ref.pkl", tmp / "in.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({arch: _inputs6(tiny_config(arch)) for arch in ARCHS6},
                    f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF6_SCRIPT.format(STEPS=STEPS6, QK=QK_SCALE, BF16=BF16_REF6,
                                T=T6)
    r = subprocess.run([sys.executable, "-c", script, str(path),
                        str(inputs)], env=env, capture_output=True,
                       text=True, timeout=400, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return spawn(_world6, 6, backend="gloo", timeout_s=WORLD_S,
                 args=(str(path),))


@pytest.mark.parametrize("arch", ARCHS6)
def test_cache_over_data_prefill_blocks_and_decode(arch, world6):
    """Item 11i: the self-attention cache (gemma2-2b's global layer,
    zamba2's shared block, whisper's decoder slots) splits its 33 slots
    over data and its kv heads over model; each rank's prefill blocks are
    the one-device cache's blocks bit for bit, its logits too, and 4
    decode steps (only the rank whose slots hold pos writes it; the
    softmaxes combined over data) within DECODE_RTOL of the one-device
    steps."""
    want = {"gemma2-2b": "sub1", "zamba2-1.2b": "shared",
            "whisper-large-v3": "self"}[arch]
    for r in world6:
        res = r[arch][0]
        assert res["specs"][want] == (None, None, "data", "model", None)
        assert res["pre_logits"] and res["pre_blocks"]
        assert max(res["decode"]) <= DECODE_RTOL, res["decode"]


@pytest.mark.parametrize("arch", ARCHS6)
def test_cache_over_data_matches_the_reference(arch, world6):
    """The prefill's and every decode step's logits against the
    reference's jitted sharded steps at data=3 x model=2, within REF_RTOL
    (whisper, which the reference runs in bf16, within REF_BF16_RTOL)."""
    tol = REF_BF16_RTOL if arch in BF16_REF6 else REF_RTOL
    for r in world6:
        errs = r[arch][1]
        assert len(errs) == STEPS6 + 1 and max(errs) <= tol, errs
