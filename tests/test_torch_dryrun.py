"""The port's dry-run (launch/dryrun.py, launch/mesh.py's production mesh
and ``dry_world``) on the CPU, with no card and no process group of its
own.

Held against the reference on forced host devices (a subprocess: the
device-count flag must come before JAX's first import): per-device dot
FLOPs of tiny gemma2-2b and tiny granite-3-8b train steps, and of their
prefill (B 8 x S 64) and decode (B 8 over a 64-slot cache) steps, at
data-only meshes (4, 1) and (8, 1), the reference's ``analyze_hlo`` of
its compiled step against the port's count on a fake world of the mesh's
size, within 2% (measured: equal); tiny gemma2-2b's train step at pod=2 x
data=2 on batches of 2 and 1 rows (held whole over pod) counted as at
data=2, whose count at 2 rows is the reference's there; a step of M
microbatches counted at 3 and 4 and extended, equal to the whole count;
``sharded_bytes_per_device`` of the tiny train states at (2, 4), (4, 2), (8, 1) and (4, 1), fp32 and int8
moments, equal to the byte. Held against the reference's ``choose_spec``
arithmetic on a shape-only mesh: the per-device state bytes of the 54
full-width (cell, mesh) pairs the dry-run runs (the dense families' 8
train pairs; their 18 serving pairs' parameters, and their caches for
decode, from the dry-run's own ``build_step``; the 28 pairs of the ssm,
hybrid, encoder-decoder and vision-stub families, train state or
parameters and cache, from ``build_step``; each also against a table of
GiB computed beforehand from the rules; the 12 pairs of the moe family,
granite-moe-3b-a800m and llama4-maverick-400b-a17b, likewise). ``--quant``:
``quant_policy_for`` equal to the reference's at its ``V5E_POD``; the
average stored bits and the state of --quant cells (gemma2-2b's and
llama4's decode_32k at haq, granite-moe's prefill_32k at w4) the
reference's ``quantize_defs`` arithmetic, to the byte. The blockwise
flash forward the dry-run counts: FLOPs
equal to the dense plain version's, and a peak of about one 512-row
block's scores, no (B, H, S, T) tensor. The CLI in a subprocess: a
full-width gemma2-2b record with every key, its state bytes the
reference's arithmetic; whisper's prefill cell and mamba2-370m's train
cell recorded likewise, and a --quant decode cell; ``--ac-mode seq_tp``
running a decode cell, a --quant cell and ``--all`` over three moe
cells, its records named apart from dp's; gemma2-2b's ``train_4k`` at
seq_tp moving more collective bytes than dp's at no higher a live peak;
``--all`` counting refusals apart from failures.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig, get_config, tiny_config)
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (_mesh, dry_world,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.roofline import step_costs  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHAPE = ShapeConfig("t", 64, 8, "train")
RUNS = ["gemma2-2b", "granite-3-8b", "nemotron-4-15b", "mistral-large-123b"]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
STATE_MESHES = [(2, 4), (4, 2), (8, 1), (4, 1)]

REF_SCRIPT = """
import json, sys
import jax
import numpy as np
jax.devices()                     # 8 forced host devices, before the
from jax.sharding import Mesh     # dry-run module's own device flag
import repro.launch.dryrun as rd
from repro.configs import tiny_config
from repro.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro.models.api import build_model
from repro.roofline.hlo_costs import analyze_hlo
out = {"flops": {}, "state": {}, "quant_archs": sorted(rd.QUANT_MOMENT_ARCHS)}
shape = ShapeConfig("t", 64, 8, "train")
serving = {"prefill": ShapeConfig("p", 64, 8, "prefill"),
           "decode": ShapeConfig("d", 64, 8, "decode")}
for arch in ("gemma2-2b", "granite-3-8b"):
    model = build_model(tiny_config(arch))
    for data, tp in ((2, 4), (4, 2), (8, 1), (4, 1)):
        mesh = Mesh(np.asarray(jax.devices()[:data * tp]).reshape(data, tp),
                    ("data", "model"))
        for q in (0, 1):
            tcfg = TrainConfig(optim=OptimConfig(quantized_moments=bool(q)))
            step, args, in_sh, out_sh, donate, wb = rd.build_step(
                model, shape, mesh, tcfg)
            out["state"][f"{arch}|{data}|{tp}|{q}"] = \\
                rd.sharded_bytes_per_device(args[0], in_sh[0])
            if tp == 1 and not q:
                with mesh:
                    hlo = jax.jit(step, in_shardings=in_sh,
                                  out_shardings=out_sh,
                                  donate_argnums=donate).lower(
                                      *args).compile().as_text()
                out["flops"][f"{arch}|{data}"] = analyze_hlo(hlo)["dot_flops"]
        if tp == 1 and data in (4, 8):
            for kind, sh in serving.items():
                step, args, in_sh, out_sh, donate, wb = rd.build_step(
                    model, sh, mesh, TrainConfig())
                with mesh:
                    hlo = jax.jit(step, in_shardings=in_sh,
                                  out_shardings=out_sh,
                                  donate_argnums=donate).lower(
                                      *args).compile().as_text()
                out["flops"][f"{arch}|{data}|{kind}"] = \
                    analyze_hlo(hlo)["dot_flops"]
model = build_model(tiny_config("gemma2-2b"))
for pod in (1, 2):
    mesh = Mesh(np.asarray(jax.devices()[:2 * pod]).reshape(pod, 2, 1),
                ("pod", "data", "model"))
    for B in (2, 1):
        step, args, in_sh, out_sh, donate, wb = rd.build_step(
            model, ShapeConfig("t", 64, B, "train"), mesh, TrainConfig())
        with mesh:
            hlo = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh,
                          donate_argnums=donate).lower(
                              *args).compile().as_text()
        out["flops"][f"gemma2-2b|pod{pod}|{B}"] = \
            analyze_hlo(hlo)["dot_flops"]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)], env=env,
                       capture_output=True, text=True, timeout=300,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(out.read_text())


def _tcfg(quantized):
    return TrainConfig(optim=OptimConfig(quantized_moments=quantized))


# ----------------------------------------------------- per-device FLOPs --
@pytest.mark.parametrize("data", [4, 8])
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b"])
def test_per_device_flops_at_data_only_meshes(arch, data, reference):
    """The port's count on a fake world of ``data`` ranks against the
    reference's compiled step on ``data`` forced devices."""
    model = t_build(tiny_config(arch))
    with dry_world(data):
        mesh = _mesh(data, 1, "cpu", 60.0)
        fn, args, _, _ = dryrun.build_step(model, SHAPE, mesh, _tcfg(False))
        got = step_costs.count_step(fn, *args)["dot_flops"]
    want = reference["flops"][f"{arch}|{data}"]
    assert abs(got - want) <= 0.02 * want


@pytest.mark.parametrize("B", [2, 1])
def test_per_device_flops_held_whole_over_pod(B, reference):
    """Tiny gemma2-2b on a fake pod=2 x data=2 world at a batch of 2 rows
    (its rows over data alone) and of 1 row (its sequence over data),
    each held whole over pod: the port's count equal to its own count at
    data=2, as each pod rank repeats its data rank's work; at 2 rows that
    count within 2% of the reference's compiled step at pod=1 x data=2
    (measured: equal). The reference's compiled step at pod=2 x data=2
    counts less a device (measured 0.545x the port's at 2 rows, 0.327x
    at 1): its partitioner spreads the batch that pod holds whole over
    pod's devices, where the port's trainer repeats it on each (PERF.md
    section 7). Both ratios are printed with -s. At 1 row the port's
    data=2 count is the sequence split's (``DataSeqRows``: every
    sub-layer on the whole rows), not the reference's."""
    model = t_build(tiny_config("gemma2-2b"))
    shape = ShapeConfig("t", 64, B, "train")
    got = {}
    for pod in (2, 1):
        with dry_world(2 * pod):
            mesh = _mesh(2, 1, "cpu", 60.0, pod=pod)
            fn, args, _, _ = dryrun.build_step(model, shape, mesh,
                                               _tcfg(False))
            got[pod] = step_costs.count_step(fn, *args)["dot_flops"]
    want = {pod: reference["flops"][f"gemma2-2b|pod{pod}|{B}"]
            for pod in (1, 2)}
    assert got[2] == got[1]
    if B == 2:
        assert abs(got[1] - want[1]) <= 0.02 * want[1], (got, want)
    print(f"B {B}: the reference's count a device at pod=2 x data=2 "
          f"{want[2] / got[2]:.3f}x the port's, at data=2 "
          f"{want[1] / got[1]:.3f}x")


@pytest.mark.parametrize("M", [5, 6])
@pytest.mark.parametrize("pod", [1, 2])
def test_microbatched_step_counted_at_three_and_four(pod, M):
    """A train step of M microbatches of 2 rows, counted at 3 and 4 of
    them and extended to M (``count_repeated``, which the dry-run runs
    past 4 microbatches), equals the count of the whole step key for key
    (dot FLOPs, collective bytes and counts, the live peak, argument and
    output bytes): tiny gemma2-2b on fake worlds at data=2 and at pod=2 x
    data=2, where each microbatch is held whole over pod. ``alias_bytes``
    is left out: two counts of one step differ in it by a few hundred
    bytes (it matches the results' storages to the arguments' by
    address, and the step replaces entries of an argument's dicts, whose
    freed storages a result may reuse)."""
    import dataclasses
    model = t_build(tiny_config("gemma2-2b"))
    tcfg = TrainConfig(microbatches=M)
    with dry_world(2 * pod):
        mesh = _mesh(2, 1, "cpu", 60.0, pod=pod)

        def step_of(m):
            return dryrun.build_step(
                model, ShapeConfig("t", 64, 2 * m, "train"), mesh,
                dataclasses.replace(tcfg, microbatches=m))[:2]
        fn, args = step_of(M)
        whole = step_costs.count_step(fn, *args)
        got = step_costs.count_repeated(step_of, M)
    assert got.keys() == whole.keys()
    assert {k: v for k, v in got.items() if k != "alias_bytes"} == \
        {k: v for k, v in whole.items() if k != "alias_bytes"}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("data", [4, 8])
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b"])
def test_serving_flops_at_data_only_meshes(arch, data, kind, reference):
    """The sharded prefill and serve steps' count against the reference's
    compiled steps with its dry-run's shardings."""
    model = t_build(tiny_config(arch))
    shape = ShapeConfig(kind[0], 64, 8, kind)
    with dry_world(data):
        mesh = _mesh(data, 1, "cpu", 60.0)
        fn, args, _, _ = dryrun.build_step(model, shape, mesh, _tcfg(False))
        got = step_costs.count_step(fn, *args)["dot_flops"]
    want = reference["flops"][f"{arch}|{data}|{kind}"]
    assert abs(got - want) <= 0.02 * want, (got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1024),
                                           (False, 0)])
def test_blockwise_flash_counts_the_dense_products_in_one_block(causal,
                                                                window):
    """The dry-run's flash forward (models/flash.py::blockwise_forward) on
    meta tensors at S = T = 8192: the dense plain version's dot FLOPs,
    and a peak over its inputs of their fp32 copies and one 512-row
    block's scores and weights (measured 3.3 blocks' bytes): under 4
    blocks' and a quarter of the (B, H, S, T) fp32 scores the dense one
    holds. On the CPU its out and lse are the dense version's."""
    from repro_torch.kernels import ref as kref
    from repro_torch.models import flash
    B, S, H, K, hd = 1, 8192, 8, 4, 256

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    q, k, v = meta(B, S, H, hd), meta(B, S, K, hd), meta(B, S, K, hd)
    kw = dict(causal=causal, window=window, cap=50.0)
    blk = step_costs.count_step(
        lambda *a: flash.flash_attention(*a, "global" if window == 0 and
                                         causal else "local" if causal
                                         else "bidir", window, 50.0,
                                         kernel="blockwise"), q, k, v)
    dense = step_costs.count_step(
        lambda *a: kref.flash_attention_ref(*a, **kw), q, k, v)
    scores = B * H * S * S * 4
    assert blk["dot_flops"] == dense["dot_flops"] == 4 * B * H * S * S * hd
    assert dense["peak_bytes"] > scores
    block = B * H * flash.BLOCK * S * 4
    assert blk["peak_bytes"] - blk["arg_bytes"] < min(4 * block, scores / 4)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 1024, H, 32), generator=g) for _ in range(3))
    k, v = k[:, :, :K], v[:, :, :K]
    o, lse = flash.blockwise_forward(q, k, v, **kw)
    o2, lse2 = kref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    assert torch.allclose(o, o2, rtol=0, atol=1e-5)
    assert torch.allclose(lse, lse2, rtol=0, atol=1e-5)


# ------------------------------------------------------------ state bytes --
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("data,tp", STATE_MESHES)
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b"])
def test_state_bytes_match_reference_on_forced_devices(arch, data, tp,
                                                       quantized, reference):
    model = t_build(tiny_config(arch))
    tcfg = _tcfg(quantized)
    sizes = {"data": data, "model": tp}
    abstract = tsteps.abstract_train_state(model, tcfg)
    specs = shlib.specs_for(abstract,
                            tsteps.train_state_logical_specs(model, tcfg),
                            sizes)
    got = dryrun.sharded_bytes_per_device(abstract, specs, sizes)
    assert got == reference["state"][f"{arch}|{data}|{tp}|{int(quantized)}"]


class FakeMesh:
    """A mesh as the reference's rules read it: only its axis sizes."""

    def __init__(self, **axes):
        self.shape = axes


def _reference_state_bytes(arch, sizes, quantized):
    """The reference's choose_spec arithmetic over its abstract train
    state: each leaf's shard shape times its element size."""
    jm = j_build(j_get(arch))
    jt = JTrain(optim=JOptim(quantized_moments=quantized))
    abstract = jsteps.abstract_train_state(jm, jt)
    flat, tdef = jax.tree.flatten(abstract)
    logical = tdef.flatten_up_to(jsteps.train_state_logical_specs(jm, jt))
    total = 0
    for a, l in zip(flat, logical):
        shape = tuple(a.shape)
        spec = tuple(j_sh.choose_spec(shape, l or (None,) * len(shape),
                                      FakeMesh(**sizes)))
        spec = spec + (None,) * (len(shape) - len(spec))
        n = 1
        for d, ax in zip(shape, spec):
            axes = () if ax is None else (ax if isinstance(ax, tuple)
                                          else (ax,))
            n *= d // math.prod(sizes[x] for x in axes)
        total += n * jnp.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", RUNS)
def test_full_width_state_bytes_are_the_reference_arithmetic(arch,
                                                             mesh_kind,
                                                             reference):
    """The 8 (cell, mesh) pairs the dry-run runs, to the byte, under the
    moments each arch trains with (int8 for the reference's
    QUANT_MOMENT_ARCHS, which the port's list equals)."""
    assert sorted(dryrun.QUANT_MOMENT_ARCHS) == reference["quant_archs"]
    sizes = MESHES[mesh_kind]
    tcfg = dryrun.train_cfg_for(arch)
    model = t_build(get_config(arch))
    abstract = tsteps.abstract_train_state(model, tcfg)
    specs = shlib.specs_for(abstract,
                            tsteps.train_state_logical_specs(model, tcfg),
                            sizes)
    got = dryrun.sharded_bytes_per_device(abstract, specs, sizes)
    assert got == _reference_state_bytes(
        arch, sizes, tcfg.optim.quantized_moments)


def _reference_serving_bytes(arch, shape_name, sizes, quant=None):
    """The reference's arithmetic for a serving cell (its dry-run's
    ``state_bytes``): the parameters, and for decode the cache, each
    leaf's shard shape under choose_spec times its element size.
    ``quant``: (policy, default bits) of stored weights, the parameters
    then ``quantize_defs``' tree."""
    from repro.configs import SHAPES
    from repro.models import params as jparams
    from repro.serving import quant as jsq
    jm = j_build(j_get(arch))
    shape = SHAPES[shape_name]
    trees = [(jm.abstract_params(), jm.logical_specs())]
    if quant is not None:
        defs = jsq.quantize_defs(jm.defs, policy=quant[0],
                                 default_bits=quant[1])
        trees = [(jparams.abstract_params(defs), jparams.logical_specs(defs))]
    if shape.kind == "decode":
        trees.append((jm.input_specs(shape)["cache"],
                      jm.batch_logical_specs(shape)["cache"]))
    total = 0
    for abstract, logical in trees:
        flat, tdef = jax.tree.flatten(abstract)
        for a, l in zip(flat, tdef.flatten_up_to(logical)):
            shp = tuple(a.shape)
            spec = tuple(j_sh.choose_spec(shp, l or (None,) * len(shp),
                                          FakeMesh(**sizes)))
            spec = spec + (None,) * (len(shp) - len(spec))
            n = 1
            for d, ax in zip(shp, spec):
                axes = () if ax is None else (ax if isinstance(ax, tuple)
                                              else (ax,))
                n *= d // math.prod(sizes[x] for x in axes)
            total += n * jnp.dtype(a.dtype).itemsize
    return total


# the issue's spec arithmetic on data 16 x model 16: (cache, params) GiB
SERVING_GIB = {("gemma2-2b", "decode_32k"): (0.914, 0.059),
               ("gemma2-2b", "long_500k"): (1.638, 0.059),
               ("granite-3-8b", "decode_32k"): (2.500, 0.098),
               ("nemotron-4-15b", "decode_32k"): (2.000, 0.158),
               ("mistral-large-123b", "decode_32k"): (5.500, 1.134)}
SERVING = [(a, s) for a in RUNS for s in ("prefill_32k", "decode_32k")] + [
    ("gemma2-2b", "long_500k")]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", SERVING,
                         ids=[f"{a}-{s}" for a, s in SERVING])
def test_serving_state_bytes_are_the_reference_arithmetic(arch, shape_name,
                                                          mesh_kind):
    """The 18 serving (cell, mesh) pairs: the state the dry-run's
    ``build_step`` holds a device, to the byte."""
    from repro_torch.configs import get_shape
    multi = mesh_kind == "multi"
    model = t_build(get_config(arch))
    with dry_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        _, _, held, _ = dryrun.build_step(model, get_shape(shape_name), mesh,
                                          dryrun.train_cfg_for(arch))
        got = [dryrun.sharded_bytes_per_device(a, s, mesh) for a, s in held]
    assert sum(got) == _reference_serving_bytes(arch, shape_name,
                                                MESHES[mesh_kind])
    gib = SERVING_GIB.get((arch, shape_name))
    if gib and not multi:
        assert round(got[1] / 2**30, 3) == gib[0]
        assert round(got[0] / 2**30, 3) == gib[1]


# the sharding rules' arithmetic, done beforehand, for the ssm, hybrid,
# encdec and vlm families: GiB a device (data 16 x model 16, pod 2 x data
# 16 x model 16)
FAMILY_GIB = {
    ("mamba2-370m", "train_4k"): (0.0220, 0.0113),
    ("mamba2-370m", "prefill_32k"): (0.0032, 0.0016),
    ("mamba2-370m", "decode_32k"): (0.0269, 0.0135),
    ("mamba2-370m", "long_500k"): (0.0061, 0.0046),
    ("zamba2-1.2b", "train_4k"): (0.0699, 0.0354),
    ("zamba2-1.2b", "prefill_32k"): (0.0100, 0.0051),
    ("zamba2-1.2b", "decode_32k"): (0.9040, 0.4521),
    ("zamba2-1.2b", "long_500k"): (1.7624, 1.7575),
    ("whisper-large-v3", "train_4k"): (0.5624, 0.2812),
    ("whisper-large-v3", "prefill_32k"): (0.0804, 0.0402),
    ("whisper-large-v3", "decode_32k"): (2.8929, 1.4464),
    ("llava-next-mistral-7b", "train_4k"): (0.5878, 0.2939),
    ("llava-next-mistral-7b", "prefill_32k"): (0.0840, 0.0420),
    ("llava-next-mistral-7b", "decode_32k"): (2.0840, 1.0420)}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", list(FAMILY_GIB),
                         ids=[f"{a}-{s}" for a, s in FAMILY_GIB])
def test_family_state_bytes_are_the_reference_arithmetic(arch, shape_name,
                                                         mesh_kind):
    """The 28 (cell, mesh) pairs of the ssm, hybrid, encdec and vlm
    families: the state the dry-run's ``build_step`` holds a device (the
    parameters, and the optimizer for train, the cache for decode) equal
    to the reference's arithmetic to the byte, and FAMILY_GIB to its four
    decimals."""
    from repro_torch.configs import get_shape
    multi = mesh_kind == "multi"
    model = t_build(get_config(arch))
    shape = get_shape(shape_name)
    tcfg = dryrun.train_cfg_for(arch)
    with dry_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        _, _, held, _ = dryrun.build_step(model, shape, mesh, tcfg)
        got = sum(dryrun.sharded_bytes_per_device(a, s, mesh)
                  for a, s in held)
    want = _reference_state_bytes(arch, MESHES[mesh_kind], False) \
        if shape.kind == "train" else \
        _reference_serving_bytes(arch, shape_name, MESHES[mesh_kind])
    assert got == want
    assert round(got / 2**30, 4) == FAMILY_GIB[(arch, shape_name)][multi]


# the rules' arithmetic for the moe family (item 11e), GiB a device, as
# FAMILY_GIB
MOE_GIB = {
    ("granite-moe-3b-a800m", "train_4k"): (0.3275, 0.1638),
    ("granite-moe-3b-a800m", "prefill_32k"): (0.0470, 0.0235),
    ("granite-moe-3b-a800m", "decode_32k"): (1.0470, 0.5235),
    ("llama4-maverick-400b-a17b", "train_4k"): (13.4309, 6.9902),
    ("llama4-maverick-400b-a17b", "prefill_32k"): (3.2014, 1.6007),
    ("llama4-maverick-400b-a17b", "decode_32k"): (6.2014, 3.1007)}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", list(MOE_GIB),
                         ids=[f"{a}-{s}" for a, s in MOE_GIB])
def test_moe_state_bytes_are_the_reference_arithmetic(arch, shape_name,
                                                      mesh_kind):
    """The 12 (cell, mesh) pairs of the moe family (item 11e): the state
    ``build_step`` holds a device equal to the reference's arithmetic to
    the byte (the int8 moments of llama4's train state included), and
    MOE_GIB to its four decimals."""
    from repro_torch.configs import get_shape
    multi = mesh_kind == "multi"
    model = t_build(get_config(arch))
    shape = get_shape(shape_name)
    tcfg = dryrun.train_cfg_for(arch)
    with dry_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        _, _, held, _ = dryrun.build_step(model, shape, mesh, tcfg)
        got = sum(dryrun.sharded_bytes_per_device(a, s, mesh)
                  for a, s in held)
    want = _reference_state_bytes(arch, MESHES[mesh_kind],
                                  tcfg.optim.quantized_moments) \
        if shape.kind == "train" else \
        _reference_serving_bytes(arch, shape_name, MESHES[mesh_kind])
    assert got == want
    assert round(got / 2**30, 4) == MOE_GIB[(arch, shape_name)][multi]


# ---------------------------------------------------------------- --quant --
def _reference_dryrun():
    """The reference's dry-run module; its import sets XLA_FLAGS for the
    device count of its own runs, which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as rd
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return rd


@pytest.mark.parametrize("mode", ["w8", "w4", "haq"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_quant_policy_is_the_references_at_v5e_pod(arch, mode):
    """``quant_policy_for`` with the hardware a parameter: at the
    reference's V5E_POD, the reference's policy and default bits."""
    from repro_torch.core.hardware_model import V5E_POD
    rd = _reference_dryrun()
    want = rd.quant_policy_for(j_get(arch), mode)
    got = dryrun.quant_policy_for(get_config(arch), mode, hw=V5E_POD)
    assert got == want
    if mode == "haq":
        assert min(got[0].values()) < 8      # the back-off bit somewhere


QUANT_CELLS = [("gemma2-2b", "decode_32k", "haq"),
               ("llama4-maverick-400b-a17b", "decode_32k", "haq"),
               ("granite-moe-3b-a800m", "prefill_32k", "w4")]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape_name,mode", QUANT_CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in QUANT_CELLS])
def test_quant_cells_are_the_reference_arithmetic(arch, shape_name, mode,
                                                  mesh_kind, monkeypatch):
    """A --quant cell's average stored bits and its state a device (the
    stored tree's shards, and the cache for decode): ``build_step`` under
    the policy at the reference's V5E_POD against the reference's
    ``quantize_defs`` arithmetic under its own policy, to the byte."""
    import functools
    from repro.serving import quant as jsq
    from repro_torch.configs import get_shape
    from repro_torch.core.hardware_model import V5E_POD
    multi = mesh_kind == "multi"
    model = t_build(get_config(arch))
    policy, bits = _reference_dryrun().quant_policy_for(j_get(arch), mode)
    want_bits = jsq.avg_weight_bits(jsq.quantize_defs(
        j_build(j_get(arch)).defs, policy=policy, default_bits=bits))
    monkeypatch.setattr(dryrun, "quant_policy_for", functools.partial(
        dryrun.quant_policy_for, hw=V5E_POD))
    with dry_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        _, _, held, wb = dryrun.build_step(
            model, get_shape(shape_name), mesh, dryrun.train_cfg_for(arch),
            quant=mode)
        got = sum(dryrun.sharded_bytes_per_device(a, s, mesh)
                  for a, s in held)
    assert wb == want_bits and 4 <= wb < 16
    assert got == _reference_serving_bytes(arch, shape_name,
                                           MESHES[mesh_kind],
                                           quant=(policy, bits))


# -------------------------------------------------------------- the meshes --
def test_production_mesh_over_a_fake_world():
    """(data 16, model 16) and (pod 2, data 16, model 16): rank 0 at
    coordinate 0 of every axis, each axis's group of its size; refused
    over a world of another size."""
    for multi, n, names in ((False, 256, ("data", "model")),
                            (True, 512, ("pod", "data", "model"))):
        with dry_world(n):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert mesh.mesh_dim_names == names
            assert shlib.axis_sizes(mesh) == {**({"pod": 2} if multi else {}),
                                              "data": 16, "model": 16}
            assert shlib.mesh_coords(mesh) == dict.fromkeys(names, 0)
            for a in names:
                g = mesh.get_group(a)
                assert torch.distributed.get_world_size(g) == \
                    shlib.axis_sizes(mesh)[a]
        assert not torch.distributed.is_initialized()
    with dry_world(8):
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh()
    with dry_world(2):
        with pytest.raises(RuntimeError, match="without a process group"):
            with dry_world(2):
                pass


# ------------------------------------------------------------------ CLI --
KEYS = {"arch", "shape", "mesh", "chips", "params", "active_params",
        "trace_s", "memory", "live_bytes_per_device",
        "state_bytes_per_device", "weight_bits", "fits_hbm",
        "state_fits_hbm",
        "collectives_per_device", "dot_flops_per_device", "roofline"}
ROOF_KEYS = {"flops_global", "bytes_global", "coll_bytes_global", "chips",
             "model_flops", "t_compute_s", "t_memory_s", "t_collective_s",
             "bottleneck", "useful_flops_ratio", "mfu_bound"}


def _cli(*args, out_dir):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out-dir", str(out_dir), "--force"], env=env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)


def test_cli_writes_a_full_width_record(tmp_path):
    """gemma2-2b train_4k on the single-pod mesh: every key, the state
    bytes the reference's arithmetic, the roofline's terms consistent."""
    r = _cli("--arch", "gemma2-2b", "--shape", "train_4k", "--mesh",
             "single", out_dir=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "[ok" in r.stdout and "1 cells ran, 0 refused, 0 failed" \
        in r.stdout
    rec = json.loads((tmp_path / "gemma2-2b__train_4k__single.json")
                     .read_text())
    assert set(rec) == KEYS and set(rec["roofline"]) == ROOF_KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        ("gemma2-2b", "train_4k", "single", 256)
    assert rec["state_bytes_per_device"] == _reference_state_bytes(
        "gemma2-2b", MESHES["single"], False)
    roof = rec["roofline"]
    assert roof["flops_global"] == rec["dot_flops_per_device"] * 256
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < roof["useful_flops_ratio"] < 1
    mem = rec["memory"]
    assert rec["live_bytes_per_device"] == mem["peak_bytes"] == \
        mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["argument_bytes"] >= rec["state_bytes_per_device"]
    assert rec["fits_hbm"] == (rec["live_bytes_per_device"] <= 80 * 2**30)
    assert set(rec["collectives_per_device"]) <= {
        "all-gather", "all-to-all", "coll_count"}


@pytest.mark.parametrize("arch,shape_name", [
    ("whisper-large-v3", "prefill_32k"), ("mamba2-370m", "train_4k")],
    ids=["prefill", "mamba2"])
def test_cli_runs_the_families(arch, shape_name, tmp_path):
    """Cells item 11d refused: each writes its record, the state bytes the
    reference's arithmetic."""
    r = _cli("--arch", arch, "--shape", shape_name, "--mesh", "single",
             out_dir=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "1 cells ran, 0 refused, 0 failed" in r.stdout
    rec = json.loads((tmp_path / f"{arch}__{shape_name}__single.json")
                     .read_text())
    assert set(rec) == KEYS and rec["chips"] == 256
    want = _reference_state_bytes(arch, MESHES["single"], False) \
        if shape_name == "train_4k" else \
        _reference_serving_bytes(arch, shape_name, MESHES["single"])
    assert rec["state_bytes_per_device"] == want
    assert rec["dot_flops_per_device"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


@pytest.mark.parametrize("args,name", [
    (("--arch", "gemma2-2b", "--shape", "decode_32k", "--ac-mode", "seq_tp"),
     "gemma2-2b__decode_32k__single_seq_tp.json")],
    ids=["seq_tp"])
def test_cli_refusals_name_their_item(args, name, tmp_path):
    """What the port refused once it now runs (``--ac-mode seq_tp``, the
    refusal of ROADMAP item 11f lifted), its record named apart from the
    dp cell's."""
    r = _cli(*args, out_dir=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert not [x for x in r.stdout.splitlines()
                if x.startswith("[refused]")], r.stdout
    assert "1 cells ran, 0 refused, 0 failed" in r.stdout
    assert [p.name for p in tmp_path.iterdir()] == [name]
    assert set(json.loads((tmp_path / name).read_text())) == KEYS


def test_cells_runs_the_listed_cells(capsys, tmp_path):
    """--cells takes arch:shape pairs in place of --all; the moe family at
    data > 1 runs (item 11e)."""
    dryrun.main(["--cells", "granite-moe-3b-a800m:decode_32k,"
                 "mamba2-370m:long_500k", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2 cells ran, 0 refused, 0 failed" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "granite-moe-3b-a800m__decode_32k__single.json",
        "mamba2-370m__long_500k__single.json"]


def test_cli_quant_serves_stored_weights(tmp_path):
    """--quant haq on a decode cell and a train cell: the decode cell's
    record carries the stored tree's state, below the bf16 cell's, and a
    train cell ignores --quant, as the reference's does (item 11g)."""
    r = _cli("--cells", "gemma2-2b:decode_32k,gemma2-2b:train_4k",
             "--quant", "haq", "--tag", "_haq", out_dir=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "2 cells ran, 0 refused, 0 failed" in r.stdout
    rec = json.loads((tmp_path / "gemma2-2b__decode_32k__single_haq.json")
                     .read_text())
    assert set(rec) == KEYS and 4 <= rec["weight_bits"] < 16
    bf16 = _reference_serving_bytes("gemma2-2b", "decode_32k",
                                    MESHES["single"])
    assert rec["state_bytes_per_device"] < bf16
    train = json.loads((tmp_path / "gemma2-2b__train_4k__single_haq.json")
                       .read_text())
    assert train["weight_bits"] == 16.0
    assert train["state_bytes_per_device"] == _reference_state_bytes(
        "gemma2-2b", MESHES["single"], False)


def test_all_counts_refusals_apart_from_failures(monkeypatch, capsys,
                                                 tmp_path):
    """--all prints each refused cell and exits 0; a cell that fails
    otherwise makes it exit 1. --ac-mode seq_tp, which the port refused
    (item 11f), runs train and serving cells alike, moe and quantized
    weights included, each record named ``_seq_tp``."""
    monkeypatch.setattr(dryrun, "assigned_cells", lambda: [
        ("llama4-maverick-400b-a17b", "decode_32k"),
        ("granite-moe-3b-a800m", "train_4k"),
        ("granite-moe-3b-a800m", "prefill_32k")])
    dryrun.main(["--all", "--mesh", "both", "--ac-mode", "seq_tp",
                 "--jobs", "3", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert not [x for x in out.splitlines() if x.startswith("[refused]")]
    assert "6 cells ran, 0 refused, 0 failed" in out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 6 and all(n.endswith("_seq_tp.json")
                                   for n in names)
    dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k", "--quant",
                 "w8", "--ac-mode", "seq_tp", "--tag", "_w8", "--out-dir",
                 str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("[ok") and "1 cells ran, 0 refused" in out
    assert json.loads((tmp_path / "gemma2-2b__decode_32k__single_seq_tp_w8"
                       ".json").read_text())["weight_bits"] < 16

    def broken(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.count("[FAIL]") == 3 and "3 FAILURES" in out


def test_seq_tp_trades_collective_bytes_for_memory(tmp_path):
    """gemma2-2b train_4k on the single-pod mesh (16 rows a rank, remat
    on): under seq_tp each remat checkpoint saves the rank's 1/16 of the
    residual's rows, and every sub-layer gathers its input's rows and the
    backward gathers its output's gradient, so the record's collective
    bytes exceed dp's and its live peak is no higher. Both cells run at
    once, a CLI subprocess each."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         "gemma2-2b:train_4k", "--ac-mode", mode, "--out-dir",
         str(tmp_path), "--force"], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mode in ("dp", "seq_tp")]
    for r in runs:
        out, err = r.communicate(timeout=300)
        assert r.returncode == 0, out[-2000:] + err[-4000:]
    dp, seq = (json.loads((tmp_path / f"gemma2-2b__train_4k__single{t}"
                                      ".json").read_text())
               for t in ("", "_seq_tp"))

    def coll(rec):
        return sum(v for k, v in rec["collectives_per_device"].items()
                   if k != "coll_count")
    assert coll(seq) > coll(dp)
    assert seq["live_bytes_per_device"] <= dp["live_bytes_per_device"]
    assert seq["dot_flops_per_device"] == dp["dot_flops_per_device"]
    assert seq["state_bytes_per_device"] == dp["state_bytes_per_device"]
