"""The port's sharded serving engine (serving/engine/sharded.py,
distributed/sharding.py, launch/mesh.py, ``--mesh``) on the CPU.

Held against the reference's pure functions: ``choose_spec``,
``specs_for``, ``partition_specs`` and ``gather_plans`` for every config
of the registry at full and tiny shapes on ten meshes; ``validate_mesh``,
``_parse_mesh`` and ``shrink_mesh`` results and errors; ``pool_axes`` and
``logical_specs``. Held against the reference's sharded decode: one decode
tick and one chunk of its ``SpmdEngine`` on a forced 2-device CPU mesh (a
subprocess: the device-count flag must come before JAX's first import)
and the port's on a gloo world of 2 ranks, logits and pool under
tests/test_torch_models.py's rules. Held against the port's one-device
engine: tiny gemma2-2b's greedy tokens on the fp, int8 and mixed pools,
chunked and whole-prompt, with forced preemption, sampled at temperature
0.8, with rank 0's clock; tiny granite-moe; a world of 4 at model=2,
data=2; every rank's outputs equal, its pool K/2 heads, its parameter
bytes below the whole tree's. Also: the mesh refuses quantized weights,
the decode split plan reads the model's kv-head count, ``make_host_mesh``
gives the serving layout in both worlds, and ``--mesh`` serves under a
2-rank ``torchrun``.

Each gloo world is spawned once (a module fixture) and returns all of its
sub-cases. Workers run one intra-op thread, as does this process, so the
one-device baselines compute the same bits.
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

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.launch.serve import _parse_mesh as j_parse_mesh  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.serving.engine import sharded as j_sharded  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.distributed.fault_tolerance import shrink_mesh  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving.engine import AdmissionPolicy, Engine, \
    Request  # noqa: E402
from repro_torch.serving.engine import sharded as t_sharded  # noqa: E402
from test_torch_models import _check_logits, _check_pool  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# (data, model), and each transposed
MESHES = [(1, 2), (2, 2), (1, 4), (2, 4), (1, 8), (16, 16), (2, 1), (4, 1),
          (4, 2), (8, 1)]
WORLD_S = 240.0


class FakeMesh:
    """A mesh as the rules read it: only its axis sizes."""

    def __init__(self, **axes):
        self.shape = axes


# ------------------------------------------------------------ pure rules --
def _ref_leaves(model, mesh):
    abstract, logical = model.abstract_params(), model.logical_specs()
    flat_a, tdef = jax.tree.flatten(abstract)
    flat_l = tdef.flatten_up_to(logical)
    chosen = [tuple(j_sh.choose_spec(a.shape, l or (None,) * a.ndim, mesh))
              for a, l in zip(flat_a, flat_l)]
    pspecs = j_sharded.partition_specs(abstract, logical, mesh)
    plans = j_sharded.gather_plans(abstract, logical, pspecs)
    return ([a.shape for a in flat_a], chosen,
            [tuple(p) for p in tdef.flatten_up_to(pspecs)],
            [tuple(p) for p in tdef.flatten_up_to(plans)])


def _port_leaves(model, sizes):
    abstract, logical = model.abstract_params(), model.logical_specs()
    pspecs = t_sharded.partition_specs(abstract, logical, sizes)
    plans = t_sharded.gather_plans(abstract, logical, pspecs)
    return ([tuple(a.shape) for a in tree_leaves(abstract)],
            shlib.leaves_like(abstract,
                              shlib.specs_for(abstract, logical, sizes)),
            shlib.leaves_like(abstract, pspecs),
            shlib.leaves_like(abstract, plans))


@pytest.mark.parametrize("dm", MESHES, ids=[f"d{d}m{m}" for d, m in MESHES])
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_and_plans_match_reference(arch, size, dm):
    """choose_spec/specs_for, partition_specs and gather_plans give the
    reference's specs and plans, leaf for leaf."""
    data, model = dm
    jcfg = j_get(arch) if size == "full" else j_tiny(arch)
    tcfg = t_get(arch) if size == "full" else t_tiny(arch)
    want = _ref_leaves(j_build(jcfg), FakeMesh(data=data, model=model))
    got = _port_leaves(t_build(tcfg), {"data": data, "model": model})
    assert got[0] == want[0]
    for name, g, w in zip(("specs", "partition_specs", "plans"), got[1:],
                          want[1:]):
        assert g == w, name


def test_choose_spec_tuple_axes_match_reference():
    """A mesh with a pod axis gives the FSDP tuple ('pod', 'data') on one
    dim, in both packages, and the port's local shape divides by both."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    for shape, logical in (((4096, 1024), ("embed", "d_ff")),
                           ((24, 2048), ("vocab", "embed")),
                           ((6, 8), ("embed", "heads"))):
        want = tuple(j_sh.choose_spec(shape, logical, FakeMesh(**sizes)))
        got = shlib.choose_spec(shape, logical, sizes)
        assert got == want
    spec = shlib.choose_spec((4096, 1024), ("embed", "d_ff"), sizes)
    assert spec == (("pod", "data"), "model")
    assert shlib.local_shape((4096, 1024), spec, sizes) == (512, 512)


VALIDATE_CASES = [("gemma2-2b", dict(data=1, model=4)),
                  ("gemma2-2b", dict(rows=2)),
                  ("gemma2-2b", dict(data=4, model=2)),
                  ("granite-moe-3b-a800m", dict(data=1, model=2)),
                  ("mamba2-370m", dict(data=1, model=1)),
                  ("whisper-large-v3", dict(data=1, model=2)),
                  ("mistral-large-123b", dict(data=1, model=4)),
                  ("mistral-large-123b", dict(data=1, model=16))]


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch,axes", VALIDATE_CASES,
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in x.items())}"
                              for a, x in VALIDATE_CASES])
def test_validate_mesh_matches_reference(arch, axes, size):
    """The same (config, mesh) passes in both or raises the same error."""
    jcfg = j_get(arch) if size == "full" else j_tiny(arch)
    tcfg = t_get(arch) if size == "full" else t_tiny(arch)

    def outcome(fn, cfg):
        try:
            fn(cfg, FakeMesh(**axes))
        except (ValueError, NotImplementedError) as e:
            return type(e), str(e)
        return None

    assert outcome(t_sharded.validate_mesh, tcfg) == \
        outcome(j_sharded.validate_mesh, jcfg)


@pytest.mark.parametrize("spec", ["model=2", "model=2,data=4", "data=3",
                                  "", "model=2,", "rows=2", "model=x",
                                  "model=-1", " model = 2 "])
def test_parse_mesh_matches_reference(spec):
    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)
    assert outcome(tserve._parse_mesh) == outcome(j_parse_mesh)


@pytest.mark.parametrize("kv_bits", [None, 8, {"sub0": 4}, 4],
                         ids=["fp", "int8", "mixed", "int4"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m",
                                  "mistral-large-123b"])
def test_pool_axes_and_logical_specs_match_reference(arch, kv_bits):
    from repro.models import transformer as j_tr
    from repro_torch.models import transformer as t_tr
    jcfg, tcfg = j_get(arch), t_get(arch)
    want = j_tr.pool_axes(jcfg, j_tr.normalize_kv_bits(jcfg, kv_bits))
    got = t_tr.pool_axes(tcfg, t_tr.normalize_kv_bits(tcfg, kv_bits))
    assert got == want
    jm, tm = j_build(jcfg), t_build(tcfg)
    flat, tdef = jax.tree.flatten(jm.abstract_params())
    assert shlib.leaves_like(tm.abstract_params(), tm.logical_specs()) == \
        list(tdef.flatten_up_to(jm.logical_specs()))
    assert [tuple(a.shape) for a in tree_leaves(tm.abstract_params())] == \
        [a.shape for a in flat]
    assert all(a.device.type == "meta"
               for a in tree_leaves(tm.abstract_params()))


# --------------------------------------------------- the decode split plan --
def _smoke_decode_shapes(tmp_path):
    """(B, H, K, N, n_blocks, page) of every sharded decode chip_smoke.py's
    phase 17 runs, from its own run list."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    policy = tmp_path / "kv.json"
    policy.write_text('{"sub0": 4, "sub1": 8}')
    one, two = chip_smoke.mesh_runs(policy)
    out = []
    for run in one + two:
        cfg = t_tiny(run["arch"]) if run["tiny"] else t_get(run["arch"])
        p = run["policy"]
        out.append((p.max_batch, cfg.num_heads, cfg.num_kv_heads, run["tp"],
                    p.pages_per_seq, p.page_size))
    return out


def test_shard_decode_plan_is_the_unsharded_plan(tmp_path):
    """The split plan a shard launches over its K/N kv heads (the model's
    K passed as ``kv_heads``) equals the unsharded engine's at every
    decode shape phase 17 runs; the slice's own K would not give it."""
    shapes = _smoke_decode_shapes(tmp_path)
    assert len(shapes) == 6
    differs = 0
    for B, H, K, N, n_blocks, page in shapes:
        whole = tpa.decode_grid(B, H, K, n_blocks, page)
        shard = tpa.decode_grid(B, H // N, K // N, n_blocks, page,
                                kv_heads=K)
        assert shard[2] == whole[2] == tpa.decode_splits(B, K, n_blocks,
                                                         page)
        assert shard[1] * N == whole[1]
        differs += tpa.decode_splits(B, K // N, n_blocks, page) != whole[2]
    assert differs          # without kv_heads the shard's plan would differ


def test_decode_walk_passes_the_models_kv_heads(monkeypatch):
    """attention_decode_paged over a pool slice of K/2 heads hands the
    decode walk the model's K (the plan's input); the chunk walk takes
    none (its plan reads G only)."""
    cfg = t_tiny("gemma2-2b")
    seen = []

    def spy(name):
        real = getattr(kops, name)

        def call(*a, **kw):
            seen.append((name, kw.get("kv_heads")))
            return real(*a, **kw)
        return call

    for n in ("paged_attention", "paged_attention_prefill"):
        monkeypatch.setattr(kops, n, spy(n))
    hd, K, H = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    g = torch.Generator().manual_seed(0)
    p = {"wq": torch.randn(cfg.d_model, H // 2, hd, generator=g),
         "wk": torch.randn(cfg.d_model, K // 2, hd, generator=g),
         "wv": torch.randn(cfg.d_model, K // 2, hd, generator=g),
         "wo": torch.randn(H // 2, hd, cfg.d_model, generator=g)}
    pool = torch.zeros(5, 8, K // 2, hd, dtype=torch.bfloat16)
    pt = torch.tensor([[1, 2]], dtype=torch.int32)
    x = torch.randn(1, 1, cfg.d_model, generator=g).bfloat16()
    tattn.attention_decode_paged(p, x, pool, pool.clone(), pt,
                                 torch.tensor([3], dtype=torch.int32),
                                 "global", cfg)
    tattn.attention_prefill_paged(p, x.expand(1, 4, -1), pool, pool.clone(),
                                  pt, torch.tensor([4], dtype=torch.int32),
                                  "global", cfg)
    assert seen == [("paged_attention", K), ("paged_attention_prefill",
                                             None)]


def test_mesh_refuses_quantized_weights():
    cfg = t_tiny("gemma2-2b")
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="weight quant"):
        Engine(model, params, _policy(quant_bits=8),
               mesh={"data": 1, "model": 1})


def test_gathered_trees_are_freed_without_the_cycle_collector():
    """The gather hook rebuilds a layer's tree on every call
    (``gather_at_use``: ``tree_unflatten``, ``leaves_like``). A reference
    cycle there keeps each layer's gathered weights alive until the
    cyclic collector runs, which on the card raised a rank's peak by
    about 3 GB at full width; dropping the tree must free its leaves at
    once."""
    import gc
    import weakref
    from repro_torch.models.params import tree_unflatten
    like = {"a": [0, {"b": 0}], "c": 0}
    was = gc.isenabled()
    gc.disable()
    try:
        leaves = [torch.ones(2) for _ in range(3)]
        refs = [weakref.ref(x) for x in leaves]
        tree = tree_unflatten(like, leaves)
        plans = shlib.leaves_like(tree, {"a": [(), {"b": ()}], "c": ()})
        assert plans == [(), (), ()]
        del leaves, tree
        assert all(r() is None for r in refs)
    finally:
        if was:
            gc.enable()


def test_shrink_mesh_matches_reference(reference_sharded):
    for (n, tp), want in reference_sharded["shrink"].items():
        if want is None:
            with pytest.raises(ValueError):
                shrink_mesh(n, tp)
            continue
        (data, model), ranks = shrink_mesh(n, tp)
        assert {"data": data, "model": model} == want
        assert ranks == list(range(data * model))


# ------------------------------------------------------ the gloo worlds --
def _policy(**kw):
    base = dict(hw_name="test", max_model_len=64, page_size=16,
                num_pages=10_000, max_batch=4, prefill_chunk=16,
                quant_bits=16, decode_slo_s=0.03, est_decode_s=0.0,
                est_prefill_s=0.0)
    base.update(kw)
    return AdmissionPolicy(**base)


def _reqs(vocab, n=6, seed=0, gen_hi=16):
    """The reference test's trace: prompts of 4-43 tokens (across the tiny
    window of 32 and the chunk of 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        S = int(rng.integers(4, 44))
        gen = int(rng.integers(2, gen_hi))
        out.append(Request(rid=i, prompt=rng.integers(
            2, vocab, S).astype(np.int32), max_new=gen))
    return out


def _preempt_reqs():
    return [Request(rid=i, prompt=np.full(12, 7 + i, np.int32), max_new=44)
            for i in range(2)]


# label -> (arch, policy kwargs, engine kwargs, trace, realtime)
CASES = {
    "fp": ("gemma2-2b", {}, {}, "reqs", False),
    "int8": ("gemma2-2b", {"kv_bits": (8,)}, {}, "reqs", False),
    "mixed": ("gemma2-2b", {"kv_bits": (4, 8)}, {}, "reqs", False),
    "whole": ("gemma2-2b", {}, {"chunked_prefill": False}, "reqs", False),
    "whole-int8": ("gemma2-2b", {"kv_bits": (8,)},
                   {"chunked_prefill": False}, "reqs", False),
    "preempt": ("gemma2-2b", {"max_batch": 2, "num_pages": 7}, {},
                "preempt", False),
    "sampled": ("gemma2-2b", {}, {"temperature": 0.8, "seed": 3}, "reqs",
                False),
    "realtime": ("gemma2-2b", {}, {}, "reqs", True),
    "moe": ("granite-moe-3b-a800m", {"max_batch": 2}, {}, "moe", False),
}
WORLD4_CASES = ("fp", "int8")


def _trace(name, cfg):
    if name == "preempt":
        return _preempt_reqs()
    if name == "moe":
        return _reqs(cfg.vocab_size, n=3, seed=1)
    return _reqs(cfg.vocab_size)


def _serve(label, mesh=None):
    arch, pkw, ekw, trace, realtime = CASES[label]
    cfg = t_tiny(arch)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = Engine(model, params, _policy(**pkw), mesh=mesh, **ekw)
    outs = eng.run(_trace(trace, cfg), realtime=realtime)
    return {"outs": outs, "preemptions": eng.stats["preemptions"],
            "allocated": eng.kv.allocator.num_allocated,
            "pool_heads": sorted({x.shape[3]
                                  for x in tree_leaves(eng.kv.pool)}),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in tree_leaves(eng.params)),
            "full_bytes": model.param_bytes(),
            "tags": eng._tags}


def _ref_inputs(cfg, dtype):
    """The reference-decode cases' inputs (numpy), as the subprocess makes
    them: tiny gemma2-2b's parameters at PRNGKey(0) in ``dtype``; a decode
    tick and a 12-row chunk of 4 sequences over a bf16 pool of 41 pages of
    8 keys (positions across the window); and test_torch_models.py's
    three-chunk prompt (20 tokens in chunks of 8 over pages of 4, the last
    chunk padded past the table)."""
    jm = j_build(j_tiny("gemma2-2b"))
    jp = jm.init(jax.random.PRNGKey(0))
    dt = {"bf16": jnp.bfloat16, "fp32": jnp.float32}[dtype]
    params = jax.tree.map(lambda a: np.asarray(
        a.astype(dt) if a.dtype == jnp.bfloat16 else a), jp)
    return params, _decode_inputs(cfg)


def _bf16_pool(cfg, num_pages, page, seed):
    """test_torch_models.py's random pool, as fp32 numpy of bf16 values."""
    from test_torch_models import _pool_state
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        _pool_state(cfg, num_pages, page, seed))


def _decode_inputs(cfg):
    page, n_blocks, B = 8, 10, 4
    rng = np.random.default_rng(2)
    positions = np.array([5, 31, 33, 70], np.int32)
    pt = np.zeros((B, n_blocks), np.int32)
    perm = rng.permutation(np.arange(1, B * n_blocks + 1))
    for b in range(B):
        pt[b] = perm[b * n_blocks:(b + 1) * n_blocks]
    three = np.random.default_rng(4).integers(2, cfg.vocab_size, 20)
    return {"pool": _bf16_pool(cfg, B * n_blocks + 1, page, seed=1),
            "pt": pt, "positions": positions,
            "tok": rng.integers(2, cfg.vocab_size, (B, 1)).astype(np.int32),
            "chunk": rng.integers(2, cfg.vocab_size,
                                  (B, 12)).astype(np.int32),
            "chunk_pos": np.array([0, 8, 21, 60], np.int32),
            "three_pool": _bf16_pool(cfg, 8, 4, seed=3),
            "three_pt": np.array([[3, 1, 6, 2, 5]], np.int32),
            "three": three.astype(np.int32)}


def _three_chunks(prefill, unembed, pool, inp, as_array):
    """test_three_chunk_prefill_matches's protocol: each chunk's last real
    row unembedded, and the final pool."""
    prompt, C, rows = inp["three"], 8, []
    for start in range(0, len(prompt), C):
        toks = np.zeros((1, C), np.int32)
        n = min(C, len(prompt) - start)
        toks[0, :n] = prompt[start:start + n]
        h, pool = prefill(pool, as_array(inp["three_pt"]), as_array(toks),
                          as_array(np.array([start], np.int32)))
        rows.append(unembed(h[:, n - 1:n]))
    return rows, pool


def _port_ref_decode(mesh, ref):
    """The port's sharded decode tick, 4 x 12-row chunk and three chunks on
    ``ref``'s inputs (mesh=None: unsharded): logits and this rank's pool
    slices (fp32 numpy)."""
    from repro_torch.models.convert import from_jax_params
    model = t_build(t_tiny("gemma2-2b"))

    def np32(t):
        return {s: {kv: x.float().numpy() for kv, x in d.items()}
                for s, d in t.items()} if isinstance(t, dict) \
            else t.float().numpy()

    def pool_of(a):
        return {s: {kv: torch.from_numpy(x).bfloat16() for kv, x in d.items()}
                for s, d in a.items()}

    out = {}
    for dtype, (params, inp) in ref.items():
        eng = Engine(model, from_jax_params(params), _policy(),
                     paged_kernel="ref", mesh=mesh)
        p, decode, chunk = eng.params, eng._decode, eng._chunk_prefill
        unembed, shard = eng._unembed_row, (lambda t: t)
        if mesh is not None:      # this rank's kv-head slice of a whole pool
            spmd = eng.spmd
            shard = lambda t: spmd._map(spmd._shard, t, spmd.pool_specs)
        pt = torch.from_numpy(inp["pt"])
        logits, dpool = decode(p, shard(pool_of(inp["pool"])), pt,
                               torch.from_numpy(inp["tok"]),
                               torch.from_numpy(inp["positions"]))
        hidden, cpool = chunk(p, shard(pool_of(inp["pool"])), pt,
                              torch.from_numpy(inp["chunk"]),
                              torch.from_numpy(inp["chunk_pos"]))
        rows, tpool = _three_chunks(
            lambda pool, pt, toks, pos: chunk(p, pool, pt, toks, pos),
            lambda h: unembed(p, h), shard(pool_of(inp["three_pool"])), inp,
            torch.from_numpy)
        out[dtype] = {"logits": np32(logits), "pool": np32(dpool),
                      "chunk_logits": np32(unembed(p, hidden)),
                      "chunk_pool": np32(cpool),
                      "three": [np32(r) for r in rows],
                      "three_pool": np32(tpool)}
    return out


def _layout(mesh):
    """A mesh as a rank sees it: axis sizes, its coordinates, and the
    world ranks of its two groups."""
    import torch.distributed as dist
    axes = ("data", "model")
    return {"sizes": shlib.axis_sizes(mesh),
            "coords": {a: mesh.get_local_rank(a) for a in axes},
            "groups": {a: dist.get_process_group_ranks(mesh.get_group(a))
                       for a in axes}}


def _world(rank, world, device, tp, labels, ref):
    """A rank of a test world: the serving mesh, every case in ``labels``
    through the sharded engine, and (``ref``) the reference-decode case."""
    from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
    mesh = make_serving_mesh(model=tp, data=world // tp, device_type="cpu",
                             backend="gloo")
    out = {label: _serve(label, mesh) for label in labels}
    out["host_mesh"] = {"serving": _layout(mesh),
                        "host": _layout(make_host_mesh(model=tp))}
    try:
        make_host_mesh(model=world + 1)
    except ValueError as e:
        out["host_mesh"]["error"] = str(e)
    if ref is not None:
        out["ref_decode"] = _port_ref_decode(mesh, ref)
    return out


@pytest.fixture(scope="module")
def baseline():
    """The port's one-device engine on every case."""
    return {label: _serve(label) for label in CASES}


@pytest.fixture(scope="module")
def world2():
    cfg = t_tiny("gemma2-2b")
    ref = {d: _ref_inputs(cfg, d) for d in ("fp32", "bf16")}
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(2, tuple(CASES), ref))


@pytest.fixture(scope="module")
def world4():
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(2, WORLD4_CASES, None))


REF_SCRIPT = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[2])
from test_torch_sharded import _ref_inputs, _three_chunks
from repro.configs import tiny_config
from repro.distributed.fault_tolerance import shrink_mesh
from repro.launch.mesh import make_serving_mesh
from repro.models.api import build_model
from repro.serving.engine.sharded import SpmdEngine
assert jax.device_count() == 8, jax.device_count()
cfg = tiny_config("gemma2-2b")
model = build_model(cfg)
mesh = make_serving_mesh(model=2)
out = {"shrink": {}}
for n, tp in ((8, 2), (7, 2), (5, 4), (8, 8), (3, 4), (1, 1), (6, 1)):
    try:
        out["shrink"][(n, tp)] = dict(shrink_mesh(n, tp).shape)
    except AssertionError:
        out["shrink"][(n, tp)] = None
f32 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32), t)
for dtype in ("fp32", "bf16"):
    params, inp = _ref_inputs(cfg, dtype)
    spmd = SpmdEngine(model, mesh, kernel="ref")
    p = spmd.shard_params(jax.tree.map(jnp.asarray, params))
    def pool(a):
        return jax.device_put(
            jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), a),
            spmd.pool_shardings())
    decode, chunk = spmd.jit_decode(), spmd.jit_prefill_chunk()
    pt = jnp.asarray(inp["pt"])
    logits, dpool = decode(p, pool(inp["pool"]), pt, jnp.asarray(inp["tok"]),
                           jnp.asarray(inp["positions"]))
    hidden, cpool = chunk(p, pool(inp["pool"]), pt, jnp.asarray(inp["chunk"]),
                          jnp.asarray(inp["chunk_pos"]))
    unembed = lambda h: model.unembed(jax.tree.map(jnp.asarray, params), h)
    rows, tpool = _three_chunks(lambda pl, pt, toks, pos: chunk(
        p, pl, pt, toks, pos), unembed, pool(inp["three_pool"]), inp,
        jnp.asarray)
    out[dtype] = {"logits": f32(logits), "pool": f32(dpool),
                  "chunk_logits": f32(unembed(hidden)),
                  "chunk_pool": f32(cpool), "three": [f32(r) for r in rows],
                  "three_pool": f32(tpool)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's SpmdEngine on a forced 8-device CPU mesh (model=2):
    one decode tick and one chunk in fp32 and bf16 parameters, and its
    shrink_mesh."""
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out),
                        str(ROOT / "tests")], env=env, capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _same_outputs(got, want):
    assert set(got) == set(want)
    for rid in want:
        assert np.array_equal(got[rid], want[rid]), rid


@pytest.mark.parametrize("label", list(CASES))
def test_world2_matches_unsharded(world2, baseline, label):
    """Greedy (and seeded sampled) tokens on a model=2 mesh equal the
    one-device engine's, on every rank."""
    for rank in world2:
        _same_outputs(rank[label]["outs"], baseline[label]["outs"])


@pytest.mark.parametrize("label", WORLD4_CASES)
def test_world4_data_axis_matches_unsharded(world4, baseline, label):
    """model=2 x data=2: the data axis splits parameters at rest only."""
    for rank in world4:
        _same_outputs(rank[label]["outs"], baseline[label]["outs"])
        assert rank[label]["tags"] == {"mesh_model": 2, "mesh_data": 2,
                                       "mesh_devices": 4}
        assert rank[label]["param_bytes"] < world4[0][label]["full_bytes"]


@pytest.mark.parametrize("name", ["world2", "world4"])
def test_host_mesh_is_the_serving_layout(name, request):
    """``make_host_mesh(model=2)`` splits whatever world exists into
    world // 2 data rows of 2: the layout ``make_serving_mesh`` gives at
    those sizes (rank d * model + m at (d, m)); a model axis that does not
    divide the world is refused."""
    ranks = request.getfixturevalue(name)
    world = len(ranks)
    for rank, res in enumerate(ranks):
        got = res["host_mesh"]
        assert got["host"] == got["serving"]
        assert got["host"]["sizes"] == {"data": world // 2, "model": 2}
        d, m = divmod(rank, 2)
        assert got["host"]["coords"] == {"data": d, "model": m}
        assert got["host"]["groups"] == {
            "data": list(range(m, world, 2)), "model": [2 * d, 2 * d + 1]}
        assert "not a multiple of model" in got["error"]


def test_world2_preemption_roundtrip(world2, baseline):
    base = baseline["preempt"]
    assert base["preemptions"] >= 1
    for rank in world2:
        assert rank["preempt"]["preemptions"] == base["preemptions"]
        assert rank["preempt"]["allocated"] == 0


@pytest.mark.parametrize("label", ["fp", "int8", "mixed", "moe"])
def test_world2_pool_and_params_split(world2, baseline, label):
    """Every pool leaf (codes and scale tiles) holds K/2 kv heads a rank;
    a rank's parameter bytes at rest are below the whole tree's."""
    K = t_tiny(CASES[label][0]).num_kv_heads
    assert baseline[label]["pool_heads"] == [K]
    for rank in world2:
        assert rank[label]["pool_heads"] == [K // 2]
        assert rank[label]["param_bytes"] < rank[label]["full_bytes"]
        assert rank[label]["tags"] == {"mesh_model": 2, "mesh_data": 1,
                                       "mesh_devices": 2}


def _whole_pool(ranks, key):
    """The ranks' pool slices put together on the kv-head dim."""
    return {s: {kv: np.concatenate([r[key][s][kv] for r in ranks], axis=3)
                for kv in ("k", "v")} for s in ranks[0][key]}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("what", ["decode", "three"])
def test_world2_matches_reference_sharded(world2, reference_sharded, dtype,
                                          what):
    """The port's sharded decode tick (4 sequences across the window) and
    three chunks (test_three_chunk_prefill_matches's protocol: each
    chunk's last real row) against the reference's SpmdEngine on the same
    inputs: logits under test_torch_models's rule (fp32: 2e-4; bf16: twice
    the reference's own bf16-vs-fp32 gap), the ranks' pool slices, put
    together on the kv-head dim, to a bf16 ulp; every rank's logits
    equal."""
    want = reference_sharded[dtype]
    ranks = [r["ref_decode"][dtype] for r in world2]
    key, pkey = ("logits", "pool") if what == "decode" \
        else ("three", "three_pool")
    got = ranks[0][key] if what == "three" else [ranks[0][key]]
    ref = want[key] if what == "three" else [want[key]]
    ref32 = reference_sharded["fp32"][key]
    ref32 = ref32 if what == "three" else [ref32]
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(
            r[key] if what == "three" else [r[key]], got))
    for g, w, w32 in zip(got, ref, ref32):
        _check_logits(g, w, dtype, w32)
    if dtype == "fp32":
        _check_pool(_whole_pool(ranks, pkey), want[pkey])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_world2_chunk_equals_unsharded_port(world2, dtype):
    """A 12-row chunk of 4 sequences (every row unembedded) and the decode
    tick through the sharded engine equal the port's unsharded calls bit
    for bit, logits and pool."""
    cfg = t_tiny("gemma2-2b")
    ref = {dtype: _ref_inputs(cfg, dtype)}
    want = _port_ref_decode(None, ref)[dtype]
    ranks = [r["ref_decode"][dtype] for r in world2]
    for key, pkey in (("logits", "pool"), ("chunk_logits", "chunk_pool")):
        assert np.array_equal(ranks[0][key], want[key])
        whole = _whole_pool(ranks, pkey)
        for s in want[pkey]:
            for kv in ("k", "v"):
                assert np.array_equal(whole[s][kv], want[pkey][s][kv])


def test_launcher_mesh_under_torchrun():
    """``--mesh model=2`` under a 2-rank torchrun serves tokens equal to the
    one-process run; only rank 0 prints."""
    argv = ["--arch", "gemma2-2b", "--tiny", "--device", "cpu",
            "--requests", "4", "--prompt-len", "24", "--gen", "8",
            "--max-batch", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert one.returncode == 0, one.stderr[-3000:]
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", "-m",
                          "repro_torch.launch.serve", *argv, "--mesh",
                          "model=2"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert two.returncode == 0, two.stderr[-3000:]

    def lines(out, prefix):
        return [ln for ln in out.splitlines() if ln.startswith(prefix)]

    assert lines(two.stdout, "sample:") == lines(one.stdout, "sample:")
    assert len(lines(two.stdout, "sample:")) == 1        # rank 0 alone
    assert "mesh=model:2,data:1" in lines(two.stdout, "admission")[0]
    assert lines(two.stdout, "mesh[gloo]:")


@pytest.mark.parametrize("extra,msg", [
    (["--sequential", "--mesh", "model=2"], "engine mode only"),
    (["--serving-config", "x.json", "--mesh", "model=2"], "config owns"),
    (["--mesh", "rows=2"], "bad --mesh entry"),
    (["--mesh", "model=2"], "torchrun"),
])
def test_launcher_mesh_flag_errors(extra, msg, capsys, monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "gemma2-2b", "--tiny", "--device", "cpu",
                     "--requests", "1", "--prompt-len", "8", "--gen", "2",
                     *extra])
    assert msg in capsys.readouterr().err
