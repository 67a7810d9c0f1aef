"""The port's roofline (roofline/analysis.py) and its counted step costs
(roofline/step_costs.py) on the CPU.

Held against the reference's pure functions for every assigned cell:
``model_flops_for``, ``active_params``, ``analytic_memory_bytes`` (weight
bits 16, 8 and 4; fp32 and int8 moments) and ``_cache_bytes``, to 1e-12
relative; the three terms, bottleneck and MFU bound on the H100's
constants (the reference's ``test_roofline_terms_and_bottleneck`` with
989 TFLOP/s in place of v5e's 197).

Dot FLOPs of one train step, counted on meta tensors, against the
reference's ``hlo_costs.analyze_hlo`` of its jitted ``make_train_step``
compiled on the CPU: tiny gemma2-2b and tiny granite-3-8b at B 4 x S 64
on one device. The counts differ by one product, accounted exactly: the
port's chunked cross-entropy runs each chunk under a checkpoint, so its
backward makes the chunk's unembedding product again (forward, recompute
and two backward products: 4 x its forward), where XLA on one device
keeps the forward's logits for the backward (3 x). On a mesh of 4 or 8
devices XLA recomputes them too, and the counts are equal
(tests/test_torch_dryrun.py).

At model > 1 the count equals an analytic count of the port's own sites
(distributed/sharding.py::tp_dot), exactly: q, k and v column-split
(each rank its heads, its kv heads, or the one kv head its slice takes),
the attention on the rank's query heads, ``attn_o`` and ``ffn_out``
whole on their gathered activations, the FFN's up and gate split where
d_ff divides, the unembedding whole; every product four times under
remat (forward, recompute, two backward products), but for the
recompute's stop: torch's checkpoint recomputes a layer group only up to
the last tensor its backward saved, so without gemma2's sandwich norms
the group's last ``ffn_out`` product, whose result only the residual sum
reads, is not made again.

The collectives counted equal those reckoned from the trainer's gather
plans and the tensor-parallel sites' shapes: each leaf's all-gathers
(forward and remat recompute for a layer's leaves), the reduce-scatter
(an all-to-all) of its data-split gradient, the input all-reduces of the
split pairs (all-gathers of n copies), the gathered ``attn_o`` and
``ffn_out`` activations, the loss's two data sums, the post-backward sum
of the leaves not split over data, and the norm's sums.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import assigned_cells as j_cells  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro.roofline.hlo_costs import analyze_hlo  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.configs import SHAPES, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.core.hardware_model import H100_SXM  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import _mesh, dry_world  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.transformer import period_of  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline import step_costs  # noqa: E402
from repro_torch.training.sharded import ShardedTrainer  # noqa: E402

torch.set_num_threads(1)

B, S = 4, 64
TINY = ShapeConfig("t", S, B, "train")
CELLS = j_cells()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


# ----------------------------------------------------- analytic terms --
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_analytic_terms_match_reference(arch, shape):
    """model_flops_for, active_params, analytic_memory_bytes (weight bits
    16/8/4, fp32 and int8 moments) and _cache_bytes, to 1e-12."""
    jc, tc = j_get(arch), t_get(arch)
    js, ts = J_SHAPES[shape], SHAPES[shape]
    assert ra.active_params(tc) == jra.active_params(jc)
    assert _rel(ra.model_flops_for(tc, ts), jra.model_flops_for(jc, js)) \
        <= 1e-12
    for wb in (16.0, 8.0, 4.0):
        for qm in (False, True):
            got = ra.analytic_memory_bytes(tc, ts, weight_bits=wb,
                                           quantized_moments=qm)
            want = jra.analytic_memory_bytes(jc, js, weight_bits=wb,
                                             quantized_moments=qm)
            assert _rel(got, want) <= 1e-12, (wb, qm)
    assert _rel(ra._cache_bytes(tc, ts.global_batch, ts.seq_len),
                jra._cache_bytes(jc, js.global_batch, js.seq_len)) <= 1e-12


def test_assigned_cells_match_reference():
    from repro_torch.configs import assigned_cells
    assert assigned_cells() == CELLS and len(CELLS) == 33


def test_roofline_terms_and_bottleneck():
    """The reference's test on the H100's constants."""
    r = ra.Roofline(flops_global=989e12 * 256, bytes_global=1e9,
                    coll_bytes_global=1e9, chips=256,
                    model_flops=500e12 * 256)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert r.bottleneck == "compute"
    assert 0.50 < r.mfu_bound < 0.51
    m = ra.Roofline(flops_global=0.0, bytes_global=3.35e12 * 2,
                    coll_bytes_global=450e9, chips=2, model_flops=1.0)
    assert abs(m.t_memory - 1.0) < 1e-12 and m.bottleneck == "memory"
    c = ra.Roofline(flops_global=1.0, bytes_global=1.0,
                    coll_bytes_global=450e9 * 8 * 2, chips=8)
    assert abs(c.t_collective - 2.0) < 1e-12 and c.bottleneck == "collective"
    assert set(r.to_dict()) == set(jra.Roofline(1, 1, 1, 1).to_dict())


def test_constants_are_the_h100s():
    """Every rate and size is core/hardware_model.py's H100 SXM; no v5e
    number is carried over."""
    assert (ra.PEAK_FLOPS, ra.PEAK_FLOPS_INT8, ra.HBM_BW, ra.ICI_BW,
            ra.HBM_BYTES) == (989e12, 1979e12, 3.35e12, 450e9, 80 * 2**30)
    assert ra.PEAK_FLOPS == H100_SXM.peak_flops_bf16
    for v5e in (jra.PEAK_FLOPS, jra.PEAK_FLOPS_INT8, jra.HBM_BW, jra.ICI_BW):
        assert v5e not in (ra.PEAK_FLOPS, ra.PEAK_FLOPS_INT8, ra.HBM_BW,
                           ra.ICI_BW)
    assert ra.COLLECTIVES == jra.COLLECTIVES


def test_analyze_counted_scales_a_ranks_counts():
    cfg, shape = t_get("gemma2-2b"), SHAPES["train_4k"]
    r = ra.analyze_counted({"dot_flops": 3.0e12, "coll_bytes": 2.0e9}, 256,
                           cfg, shape, quantized_moments=True)
    assert r.flops_global == 3.0e12 * 256
    assert r.coll_bytes_global == 2.0e9 * 256
    assert r.bytes_global == ra.analytic_memory_bytes(
        cfg, shape, quantized_moments=True)
    assert r.model_flops == ra.model_flops_for(cfg, shape)


# ------------------------------------------------------- counted costs --
def _count(arch, sizes, shape=TINY):
    """A tiny train step's record on a fake world of the mesh's size, and
    the trainer that ran it (this process its rank 0)."""
    model = t_build(t_tiny(arch))
    data, tp = sizes.get("data", 1), sizes.get("model", 1)
    with dry_world(data * tp):
        mesh = _mesh(data, tp, "cpu", 60.0)
        fn, args, _, _ = dryrun.build_step(model, shape, mesh,
                                           TrainConfig())
        costs = step_costs.count_step(fn, *args)
        trainer = ShardedTrainer(model, TrainConfig(), shlib.make_ac(mesh),
                                 kernel="ref")
    return model, costs, trainer


@pytest.fixture(scope="module")
def reference_one_device():
    """The reference's analyze_hlo of its jitted train step, compiled on
    the CPU, per arch."""
    out = {}
    for arch in ("gemma2-2b", "granite-3-8b"):
        jm = j_build(j_tiny(arch))
        tcfg = JTrain()
        hlo = jax.jit(jsteps.make_train_step(jm, tcfg)).lower(
            jsteps.abstract_train_state(jm, tcfg),
            jm.input_specs(JShape("t", S, B, "train"))).compile().as_text()
        out[arch] = analyze_hlo(hlo)
    return out


def _ce_rows(b, s, chunk=256):
    n = s - 1
    c = min(chunk, n)
    return b * (n + (-n) % c)


def _unembed_fwd(cfg, b, s):
    return 2 * _ce_rows(b, s) * cfg.d_model * cfg.padded_vocab


@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b"])
def test_dot_flops_one_device_against_reference(arch, reference_one_device):
    """One device: the reference's count plus the one recomputed
    unembedding product (the module docstring), exactly: 2.3% and 2.4%
    above it."""
    model, costs, _ = _count(arch, {"data": 1, "model": 1})
    want = reference_one_device[arch]["dot_flops"]
    assert costs["dot_flops"] == want + _unembed_fwd(model.cfg, B, S)
    assert costs["dot_flops"] / want - 1 < 0.025
    assert costs["coll_count"] == 0 and costs["coll_bytes"] == 0
    assert reference_one_device[arch]["coll_bytes"] == 0


def _site_flops(cfg, b, s, tp):
    """The port's per-rank dot FLOPs of one train step at model=tp on b
    rows of s tokens (the module docstring), remat on."""
    D, hd, F = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    H, K = cfg.num_heads, cfg.num_kv_heads
    n = b * s
    hl = H // tp if H % tp == 0 else H
    kl = K // tp if K % tp == 0 else (1 if H % tp == 0 else K)
    fl = F // tp if F % tp == 0 else F
    layer = (2 * n * D * hd * (hl + 2 * kl)         # q, k, v
             + 2 * 2 * b * hl * s * s * hd          # scores and p @ v
             + 2 * n * H * hd * D                   # attn_o, gathered
             + 2 * 2 * n * D * fl                   # ffn_in, ffn_gate
             + 2 * n * F * D)                       # ffn_out, gathered
    fwd = cfg.num_layers * layer + _unembed_fwd(cfg, b, s)
    # remat recomputes each layer group up to the last product whose
    # result the backward keeps: without sandwich norms, the group's last
    # ffn_out feeds only the residual sum, so it is not made again
    skip = 0 if cfg.sandwich_norm else \
        cfg.num_layers // period_of(cfg) * 2 * n * F * D
    return 4 * fwd - skip


MODEL_MESHES = [{"data": 1, "model": 2}, {"data": 1, "model": 4},
                {"data": 1, "model": 8}, {"data": 2, "model": 2},
                {"data": 2, "model": 4}]


@pytest.mark.parametrize("sizes", MODEL_MESHES,
                         ids=lambda s: f"data{s['data']}-model{s['model']}")
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-3-8b"])
def test_dot_flops_at_model_gt_1_are_the_sites(arch, sizes):
    """Tiny configs have 4 query heads over 2 kv heads: model=2 splits
    both, model=4 splits the query heads and slices a kv head per rank,
    model=8 keeps both whole."""
    model, costs, _ = _count(arch, sizes)
    b = B // sizes["data"]
    assert costs["dot_flops"] == _site_flops(model.cfg, b, S,
                                             sizes["model"])


# ----------------------------------------------------------- collectives --
def _nbytes(shape, dtype):
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _reckoned(model, tr, b):
    """{kind: bytes} and the collective count rank 0 issues in one step,
    from the trainer's gather plans and the sites' shapes."""
    cfg = model.cfg
    sizes = tr.sizes
    dp, tp = sizes["data"], sizes["model"]
    out = {"all-gather": 0, "all-to-all": 0}
    count = [0]

    def gather(nbytes, k=1):
        out["all-gather"] += k * nbytes
        count[0] += k

    pa = tr.abstract["params"]
    paths = shlib.leaf_paths(pa)
    for path, a, spec, plan in zip(paths, tree_leaves(pa), tr.param_specs,
                                   shlib.leaves_like(pa, tr.plans)):
        block = path[0] == "blocks"
        shape = list(shlib.local_shape(tuple(a.shape), spec, sizes))
        if block:
            shape = shape[1:]
        uses = cfg.num_layers // len(pa["blocks"]) if block else 1
        if path == ("embed",) and cfg.tie_embeddings:
            uses = 2                        # the input and the unembedding
        passes = 2 if block else 1          # forward and remat recompute
        shift = 1 if block else 0
        for dim, ax in plan:
            if sizes[ax] > 1:
                shape[dim - shift] *= sizes[ax]
                gather(_nbytes(shape, a.dtype), uses * passes)
        split = sum((shlib._as_axes(e) for e in spec if e), ())
        for dim, ax in plan:             # the gradient reduce-scattered
            if ax == "data" and dp > 1:
                g = list(shlib.local_shape(tuple(a.shape), spec, sizes))
                if block:
                    g = g[1:]
                g[dim - shift] *= dp
                out["all-to-all"] += uses * _nbytes(g, a.dtype)
                count[0] += uses
        if dp > 1 and "data" not in split:  # post-backward sum over data
            gather(dp * _nbytes(shlib.local_shape(tuple(a.shape), spec,
                                                  sizes), a.dtype))
    act = b * S * cfg.d_model
    L = cfg.num_layers
    if tp > 1:
        H, K, F, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, \
            cfg.resolved_head_dim
        q_split = H % tp == 0
        if q_split or K % tp == 0:          # the q/k/v input's sum
            gather(tp * _nbytes((1, act), torch.bfloat16), L)
        if q_split:                         # attn_o's gathered heads
            gather(_nbytes((b, S, H, hd), torch.bfloat16), 2 * L)
        if q_split and K % tp:              # wk, wv slices' gradient sums
            gather(tp * _nbytes((1, cfg.d_model, K, hd), torch.bfloat16),
                   2 * L)
        if F % tp == 0:                     # the FFN input's sum; ffn_out
            gather(tp * _nbytes((1, act), torch.bfloat16), L)
            gather(_nbytes((b, S, F), torch.bfloat16), 2 * L)
        gather(tp * 4)                      # the norm over model
    if dp > 1:
        gather(dp * 4, 2)                   # the loss's sum and count
        gather(dp * 4)                      # the norm over data
    return out, count[0]


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 1},
                                   {"data": 1, "model": 2},
                                   {"data": 2, "model": 2},
                                   {"data": 1, "model": 4},
                                   {"data": 4, "model": 1}],
                         ids=lambda s: f"data{s['data']}-model{s['model']}")
def test_collective_bytes_are_the_plans(sizes):
    model, costs, tr = _count("gemma2-2b", sizes)
    want, n = _reckoned(model, tr, B // sizes["data"])
    got = {k: costs[k] for k in ra.COLLECTIVES if costs[k]}
    assert got == {k: float(v) for k, v in want.items() if v}
    assert costs["coll_count"] == n
    assert costs["coll_bytes"] == sum(want.values())


def test_live_bytes_tracks_storage():
    """The dispatch mode's live count: the arguments, then each new
    storage until it is freed; views and in-place results add nothing."""
    a = torch.empty(1000, device="meta")

    def fn(x):
        y = x * 2                     # 4000 new
        z = y[:10]                    # a view
        z.add_(1)                     # in place
        w = torch.empty(500, device="meta")    # 2000 new
        del w
        return y

    costs = step_costs.count_step(fn, a)
    assert costs["arg_bytes"] == 4000
    assert costs["peak_bytes"] == 4000 + 4000 + 2000
    assert costs["out_bytes"] == 4000 and costs["alias_bytes"] == 0
    assert costs["dot_flops"] == 0
    costs = step_costs.count_step(lambda x: x.mul_(2), a)
    assert costs["peak_bytes"] == 4000 and costs["alias_bytes"] == 4000
    m = torch.empty(8, 16, device="meta")
    costs = step_costs.count_step(lambda x: x @ x.T, m)
    assert costs["dot_flops"] == 2 * 8 * 8 * 16
