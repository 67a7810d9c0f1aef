"""The sharded prefill and serve steps (training/sharded_serve.py) for the
ssm, hybrid, encoder-decoder and vision-stub families on the CPU, in gloo
worlds: tiny mamba2-370m, zamba2-1.2b, whisper-large-v3 and
llava-next-mistral-7b.

Each family takes a prompt of S = 32 (mamba2 and zamba2: 32 tokens;
llava: 8 patch rows and 24 tokens; whisper: 32 frames and 4 decoder
tokens) and 8 teacher-forced decode steps over caches grown by 8 slots,
at B = 2, in a world of 2 ranks (a sub-mesh of one rank, model=2, data=2)
and one of 4 (data=2 x model=2, model=4). What the layouts exercise:

  * mamba2 and zamba2: ``in_proj``'s [z | xs | B | C | dt] columns (552 at
    the tiny width, 276 a rank at model=2 against z's 256) rest split on
    ``ssm_inner`` and are gathered whole at use; the decode cache's conv
    window splits on its 288 channels and the state on its 8 heads
    (``MambaBlock``): the window is gathered each step, the recurrence
    runs on the rank's heads, y is gathered over them;
  * zamba2's shared block's k/v cache (40 slots) splits on its sequence,
    attended through the combine of the ranks' softmaxes (``CacheBlock``);
  * whisper's self-attention cache (12 decoder slots) and its encoder
    memory (32 frames) split on their sequences: the cross attention
    attends over the rank's frames and combines;
  * llava at model=4: one query head a rank over its kv head sliced from
    the whole wk/wv (``kv_span``).

Held, per rank, against the unsharded steps on the rank's rows (fp32
parameters, wq and wk x 1/8 in every attention, as
tests/test_torch_serve_sharded.py holds the dense families):
  * a world of one rank: prefill, every decode step and every cache leaf
    bit for bit, bf16 at the port's init and fp32;
  * the prefill's last-row logits and every cache block bit for bit to
    the unsharded prefill's rows and the block's slice of its caches;
  * decode logits within DECODE_RTOL of max |logit| (the only reordered
    sums: the combine of the ranks' softmaxes), and the whole cache after
    the last step within DECODE_RTOL of each leaf's max |value|;
  * each rank's blocks hold 1/model of a split cache's bytes (1/data
    more where data splits the batch).
A cross attention over 16384 frames split on model=2 reaches flash on
each rank's 8192 (``flash_partial``, its lse the partial's max): held to
the whole memory's flash within DECODE_RTOL.

Held against the reference: its ``make_prefill_step`` and
``make_serve_step`` jitted with ``repro.launch.dryrun.build_step``'s
shardings on 8 forced host devices at data=2 x model=2, in a subprocess,
on its own fp32 parameters (wq, wk x 1/8) carried in by
``from_jax_params``: the prefill's and each decode step's logits rows
within REF_RTOL of max |logit| (XLA's and torch's fp32 sums in their own
orders). Whisper runs in bf16 there (scaled in fp32, then rounded): the
reference's encoder scans its layers with a bf16 carry, which fp32
weights break (tests/test_torch_encdec.py), so it is held to
REF_BF16_RTOL, tests/test_torch_encdec.py's bf16 floor (the two packages
round their bf16 products at their own points).

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

from repro_torch.configs import get_config, tiny_config  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.training import sharded_serve as ssv  # noqa: E402
from repro_torch.training.sharded import validate_train_mesh  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-large-v3",
         "llava-next-mistral-7b")
QK_SCALE = 0.125
B, S, STEPS = 2, 32, 8
WORLD_S = 300.0
DECODE_RTOL = 1e-5
REF_RTOL = 1e-5
REF_BF16_RTOL = 2e-2
BF16_REF = ("whisper-large-v3",)     # the reference's encoder takes bf16
# (label, data, model)
CASES2 = [("world1", 1, 1), ("model2", 1, 2), ("data2", 2, 1)]
CASES4 = [("2x2", 2, 2), ("model4", 1, 4)]
FLASH_T = 16384


# ------------------------------------------------------------------ inputs --
def make_batch(cfg, seed=3):
    """The family's prefill batch at (B, S) and the tokens fed at each
    decode step, numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.is_encdec:
        batch = {"frames": rng.standard_normal((B, S, cfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(2, 500, (B, S // cfg.dec_ratio))
                 .astype(np.int32)}
    elif cfg.frontend == "vision_stub":
        sp = int(S * cfg.patch_frac)
        batch = {"patches": rng.standard_normal((B, sp, cfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(2, 500, (B, S - sp))
                 .astype(np.int32)}
    else:
        batch = {"tokens": rng.integers(2, 500, (B, S)).astype(np.int32)}
    feed = rng.integers(2, 500, (B, STEPS)).astype(np.int32)
    return batch, feed


def prompt_len(cfg) -> int:
    """The position of the first decode step (the decoder's for the
    encoder-decoder)."""
    return S // cfg.dec_ratio if cfg.is_encdec else S


def grow(model, cache):
    """The prefill's caches grown by STEPS slots (the memory stays)."""
    from repro_torch.launch.serve import _grow_cache
    n = prompt_len(model.cfg)
    if model.cfg.is_encdec:
        return encdec.grow_cache(cache, n + STEPS)
    return _grow_cache(cache, n, n + STEPS)


def attn_trees(params):
    """Every attention's parameter dict of a tree (stacked or not)."""
    out = []
    for key in ("blocks", "shared", "enc", "dec"):
        sub = params.get(key)
        if sub is None:
            continue
        for s in (sub.values() if key == "blocks" else [sub]):
            out += [s[n] for n in ("attn", "xattn") if n in s]
    return out


def fp32_params(model):
    p = tree_map(lambda a: a.float(),
                 model.init(torch.Generator().manual_seed(0), "cpu"))
    for a in attn_trees(p):
        for n in ("wq", "wk"):
            a[n] = a[n] * QK_SCALE
    return p


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / max(float(b.float().abs().max()), 1e-30))


# ------------------------------------------------------------------- pure --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes", [dict(data=2, model=1),
                                   dict(data=1, model=2),
                                   dict(data=2, model=2)],
                         ids=["data2", "model2", "2x2"])
def test_serving_steps_accept_the_families(arch, sizes):
    """The sharded serving steps take the four families on every mesh
    (the refusals of item 11d lifted)."""
    validate_train_mesh(get_config(arch), sizes, what="serving")


def test_in_proj_gathers_whole():
    """``in_proj``'s ssm_inner columns rest split over model and are
    gathered at use, every other mamba leaf too; the cross attention's
    q/k/v keep their head splits local and its wo is gathered."""
    model = build_model(tiny_config("zamba2-1.2b"))
    sizes = {"data": 2, "model": 2}
    specs = shlib.partition_specs(model.abstract_params(),
                                  model.logical_specs(), sizes)
    plans = shlib.gather_plans(model.abstract_params(),
                               model.logical_specs(), specs)
    assert specs["mamba"]["in_proj"] == (None, "data", "model")
    assert plans["mamba"]["in_proj"] == ((1, "data"), (2, "model"))
    assert plans["mamba"]["conv_w"] == ((2, "model"),)
    assert plans["shared"]["attn"]["wq"] == ((0, "data"),)
    w = build_model(tiny_config("whisper-large-v3"))
    wspecs = shlib.partition_specs(w.abstract_params(), w.logical_specs(),
                                   sizes)
    wplans = shlib.gather_plans(w.abstract_params(), w.logical_specs(),
                                wspecs)
    assert wplans["dec"]["xattn"]["wk"] == ((1, "data"),)
    assert wplans["dec"]["xattn"]["wo"] == ((1, "model"), (3, "data"))


def test_flash_partial_blockwise_is_the_plain_version():
    """The dry-run's blockwise forward gives the partial the plain flash
    version gives (lse as its max, the normalised output)."""
    from repro_torch.models import flash
    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, 1, 4, 32), generator=g)
    k, v = (torch.randn((2, 1024, 4, 32), generator=g) for _ in range(2))
    for a, b in zip(flash.flash_partial(q, k, v, 0.0,
                                        kernel=flash.BLOCKWISE),
                    flash.flash_partial(q, k, v, 0.0, kernel="ref")):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- the worlds --
def _rows(x, ac):
    return ac(torch.from_numpy(x) if isinstance(x, np.ndarray) else x,
              "batch")


def _block_of(x, spec, steps):
    """The block of a whole leaf of this rank's rows under a cache spec."""
    return shlib.local_block(x, (None, None) + tuple(spec[2:]), steps.sizes,
                             steps.coords)


def _run(mesh, arch, fp32):
    """Prefill + STEPS decode steps through the sharded steps on ``mesh``,
    against the unsharded steps on this rank's rows."""
    from repro_torch.training import steps as st
    model = build_model(tiny_config(arch))
    params = fp32_params(model) if fp32 else model.init(
        torch.Generator().manual_seed(0), "cpu")
    ac = shlib.make_ac(mesh)
    steps = ssv.serve_steps(model, ac)
    np_batch, np_feed = make_batch(model.cfg)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    feed = torch.from_numpy(np_feed)
    rows = {k: _rows(v, ac) for k, v in batch.items()}
    local = steps.shard_params(params)
    lw, cw = st.make_prefill_step(model)(params, rows)
    ls, blocks = st.make_prefill_step(model, ac=ac)(local, batch)
    place = steps.layout(blocks)
    groups = ssv.cache_groups(model.cfg, blocks)
    wgroups = ssv.cache_groups(model.cfg, cw)
    out = {"pre_logits": torch.equal(lw, ls), "pre_blocks": all(
        torch.equal(x, _block_of(wgroups[j][n], place[j].leaf_spec(n),
                                 steps))
        for j, c in groups.items() for n, x in c.items()),
        "split": {j: (getattr(p, "split", None),
                      {n: p.leaf_spec(n) for n in groups[j]})
                  for j, p in place.items()}}
    _, whole = st.make_prefill_step(model)(params, batch)
    whole = grow(model, whole)
    cw = grow(model, cw)
    blocks = steps.place_cache(whole)
    out["bytes"] = (nbytes(blocks), nbytes(whole))
    serve = st.make_serve_step(model, ac=ac)
    unsharded = st.make_serve_step(model)
    n0 = prompt_len(model.cfg)
    decode = []
    for i in range(STEPS):
        pos = torch.tensor(n0 + i)
        want, cw = unsharded(params, cw, _rows(feed[:, i:i + 1], ac), pos)
        got, blocks = serve(local, blocks, feed[:, i:i + 1], pos)
        decode.append(0.0 if torch.equal(got, want) else rel(got, want))
    out["decode"] = decode
    after = ssv.cache_groups(model.cfg, steps.whole_cache(blocks))
    wafter = ssv.cache_groups(model.cfg, cw)
    mine = [shlib.local_block(x, (None, ac.batch_axes(B)), ac.sizes,
                              ac.coords) for x in tree_leaves(after)]
    out["cache"] = [0.0 if torch.equal(a, b) else rel(a, b)
                    for a, b in zip(mine, tree_leaves(wafter))]
    return out


def _flash_cross(mesh):
    """A decode step's cross attention over FLASH_T frames split on
    model: each rank's flash over its block (``flash_partial``) and the
    combine, against the whole memory's flash on every rank."""
    from repro_torch.models import attention as attn
    cfg = tiny_config("whisper-large-v3")
    sizes, coords = shlib.axis_sizes(mesh), shlib.mesh_coords(mesh)
    groups = {a: mesh.get_group(a) for a in sizes}
    rng = np.random.default_rng(7)
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    p = {"wq": torch.from_numpy(rng.standard_normal((D, H, hd))
                                .astype(np.float32) * 0.02),
         "wo": torch.from_numpy(rng.standard_normal((H, hd, D))
                                .astype(np.float32) * 0.02)}
    x = torch.from_numpy(rng.standard_normal((1, 1, D)).astype(np.float32))
    mk, mv = (torch.from_numpy(rng.standard_normal((1, FLASH_T, H, hd))
                               .astype(np.float32)) for _ in range(2))
    spec = ssv.cache_spec(cfg, 1, FLASH_T, sizes)
    place = shlib.CacheBlock(spec, FLASH_T, sizes, coords, groups, cfg)
    blk = place.block(mk), place.block(mv)
    got = attn.cross_attention(p, x, *blk, cfg, kernel="ref", place=place)
    want = attn.cross_attention(p, x, mk, mv, cfg, kernel="ref")
    return {"split": place.split, "local": place.local_len,
            "err": rel(got, want)}


def _world(rank, world, device, cases, ref_file=None):
    from repro_torch.launch.mesh import make_serving_mesh, make_sub_mesh
    out = {}
    for label, data, tp in cases:
        if data * tp == world:
            mesh = make_serving_mesh(model=tp, data=data, device_type="cpu",
                                     backend="gloo")
        else:
            mesh = make_sub_mesh(data, tp, device_type="cpu")
        if mesh is None:
            continue
        for arch in ARCHS:
            out[(label, arch, True)] = _run(mesh, arch, True)
            if label == "world1":
                out[(label, arch, False)] = _run(mesh, arch, False)
        if label == "model2":
            out[(label, "flash")] = _flash_cross(mesh)
        if ref_file and label == "2x2":
            for arch in ARCHS:
                out[(label, arch, "ref")] = _reference_case(mesh, arch,
                                                            ref_file)
    return out


def _reference_case(mesh, arch, ref_file):
    """The reference's parameters and inputs through the port's sharded
    steps: every step's logits rows against the reference's jitted
    sharded run."""
    from repro_torch.models.convert import from_jax_params
    from repro_torch.training import steps as st
    with open(ref_file, "rb") as f:
        ref = pickle.load(f)[arch]
    model = build_model(tiny_config(arch))
    params = from_jax_params(ref["params"])
    ac = shlib.make_ac(mesh)
    steps = ssv.serve_steps(model, ac)
    local = steps.shard_params(params)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    feed = torch.from_numpy(ref["feed"])
    logits, blocks = st.make_prefill_step(model, ac=ac)(local, batch)
    w = _rows(ref["prefill"], ac)
    errs = [rel(logits, w)]
    blocks = steps.place_cache(grow(model, steps.whole_cache(blocks)))
    serve = st.make_serve_step(model, ac=ac)
    n0 = prompt_len(model.cfg)
    for i in range(STEPS):
        logits, blocks = serve(local, blocks, feed[:, i:i + 1],
                               torch.tensor(n0 + i))
        errs.append(rel(logits, _rows(ref["decode"][i], ac)))
    return errs


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
B, S, STEPS, QK_SCALE = {B}, {S}, {STEPS}, {QK}
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
        return jnp.pad(tree, ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)))
    return tree


mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {{}}
for arch, (batch, feed, n0) in inputs.items():
    model = build_model(tiny_config(arch))
    dtype = jnp.bfloat16 if arch in {BF16!r} else jnp.float32
    p = jax.tree.map(lambda a: a.astype(dtype),
                     model.init(jax.random.PRNGKey(0)))
    for a in attn_trees(p):
        for n in ("wq", "wk"):
            a[n] = (a[n].astype(jnp.float32) * QK_SCALE).astype(dtype)
    step, args, ins, outs, don, _ = rd.build_step(
        model, ShapeConfig("p", S, B, "prefill"), mesh, TrainConfig())
    dstep, dargs, dins, douts, ddon, _ = rd.build_step(
        model, ShapeConfig("d", (n0 + STEPS) * model.cfg.dec_ratio
                           if model.cfg.is_encdec else S + STEPS, B,
                           "decode"), mesh, TrainConfig())
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
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref")
    path, inputs = tmp / "ref.pkl", tmp / "in.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({arch: make_batch(tiny_config(arch)) + (
            prompt_len(tiny_config(arch)),) for arch in ARCHS}, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF_SCRIPT.format(B=B, S=S, STEPS=STEPS, QK=QK_SCALE,
                               BF16=BF16_REF)
    r = subprocess.run([sys.executable, "-c", script, str(path),
                        str(inputs)], env=env,
                       capture_output=True, text=True, timeout=400,
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


def _world_of(request, label):
    return request.getfixturevalue(
        "world2" if label in [c[0] for c in CASES2] else "world4")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [c[0] for c in CASES2 + CASES4])
def test_prefill_is_bit_identical(label, arch, request):
    for r in _world_of(request, label):
        for fp32 in (True, False):
            res = r.get((label, arch, fp32))
            if res is not None:
                assert res["pre_logits"] and res["pre_blocks"], label


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("label", [c[0] for c in CASES2 + CASES4])
def test_decode_within_tolerance_and_cache_follows(label, arch, request):
    for r in _world_of(request, label):
        for fp32 in (True, False):
            res = r.get((label, arch, fp32))
            if res is None:
                continue
            if label == "world1":
                assert max(res["decode"]) == 0.0
                assert max(res["cache"]) == 0.0
                continue
            assert max(res["decode"]) <= DECODE_RTOL, res["decode"]
            assert max(res["cache"]) <= DECODE_RTOL, res["cache"]


def test_the_layouts_each_family_takes(world2, world4):
    """Which dim each cache group splits on at model=2 and at 2 x 2."""
    def split(world, label, arch):
        return world[0][(label, arch, True)]["split"]
    kv = (None, "data", "model", None, None)         # rows, then slots
    for world, label in ((world2, "model2"), (world4, "2x2"),
                         (world4, "model4")):
        # the window on its channels, the state on its heads
        for arch in ("mamba2-370m", "zamba2-1.2b"):
            assert split(world, label, arch)["mamba"] == (None, {
                "conv": (None, "data", None, "model"),
                "state": (None, "data", "model", None, None)})
        assert split(world, label, "zamba2-1.2b")["shared"] == (
            True, {"k": kv, "v": kv})
        w = split(world, label, "whisper-large-v3")
        assert w == {"self": (True, {"k": kv, "v": kv}),
                     "cross": (True, {"mk": kv, "mv": kv})}
        assert split(world, label, "llava-next-mistral-7b")["sub0"] == (
            True, {"k": kv, "v": kv})


@pytest.mark.parametrize("arch", ARCHS)
def test_split_rank_holds_its_share_of_the_cache(arch, world2, world4):
    """Every cache leaf splits at these sizes: a rank's blocks hold
    1/model of the whole's bytes, 1/data more where data splits the
    batch."""
    for world, label, n in ((world2, "model2", 2), (world2, "data2", 2),
                            (world4, "2x2", 4), (world4, "model4", 4)):
        for r in world:
            mine, whole = r[(label, arch, True)]["bytes"]
            assert mine * n == whole, (label, mine, whole)


def test_cross_attention_flash_over_split_frames(world2):
    """16384 frames over model=2: each rank's flash over its 8192 and the
    combine of the ranks' lse-weighted outputs, against the whole
    memory's flash."""
    for r in world2:
        res = r[("model2", "flash")]
        assert res["split"] and res["local"] == FLASH_T // 2
        assert res["err"] <= DECODE_RTOL, res["err"]


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_the_reference_jitted_sharded_steps(arch, world4):
    for r in world4:
        errs = r[("2x2", arch, "ref")]
        assert len(errs) == STEPS + 1
        tol = REF_BF16_RTOL if arch in BF16_REF else REF_RTOL
        assert max(errs) <= tol, errs


def test_measured_gaps_are_recorded(world2, world4):
    """The worst decode and reference gaps, for the record (printed with
    -s)."""
    import json
    worst = max(max(res["decode"]) for world in (world2, world4)
                for r in world for k, res in r.items()
                if len(k) == 3 and k[2] is True)
    ref = {arch: max(max(r[("2x2", arch, "ref")]) for r in world4)
           for arch in ARCHS}
    print(json.dumps({"worst_decode_gap": worst, "reference": ref}))
    assert worst <= DECODE_RTOL
