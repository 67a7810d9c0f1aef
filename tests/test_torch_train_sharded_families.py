"""Sharded training (training/sharded.py) of the ssm, hybrid,
encoder-decoder and vision-stub families on the CPU, in gloo worlds:
tiny mamba2-370m, zamba2-1.2b, whisper-large-v3 and llava-next-mistral-7b
at data=2, model=2 (worlds of 2) and data=2 x model=2 (a world of 4), on
a global batch of B 4 x S 64 (whisper: 64 frames, 8 decoder tokens;
llava: 16 patch rows, 48 tokens).

Every rank of a ``model`` group computes each mamba layer whole on its
rows (``in_proj``'s 552 columns rest split, 276 a rank at model=2
against z's 256, and are gathered at use), and keeps its block of the
gathered leaves' gradients without a sum; zamba2's shared block and
whisper's attentions split their heads as the dense families do, and
whisper's cross attention gathers its heads before the out-projection.

Tolerances, and why (tests/test_torch_train_sharded.py's rules):
  * fp32 (the port's init cast to fp32, wq and wk x 1/8 in every
    attention: the init saturates the tiny models' softmax): the first
    step's loss and grad norm within LOSS_RTOL and its gradients within
    GRAD_TOL of each leaf's max |g|, against the plain one-device step;
    the runs differ only in summation order. Whisper's cross attention
    over random memory is near uniform, so the gradients of its wq, wk and
    ln_x, and of the encoder's ln1 that feeds its memory, are small
    differences of large terms (tests/test_torch_encdec.py, where each
    package sits 1.3e-4 to 2.2e-4 from a float64 run): those four leaves
    are held to XATTN_GRAD_TOL, as there (measured 4.5e-5 at most when the
    batch's rows split over data).
  * bf16 (the trainer as ``train`` runs it, at the port's init with wq
    and wk scaled): two steps' losses within 2**-10 and grad norms within
    2**-7 of the one-device run with the rows cut as the mesh cuts them
    (microbatches = the data size): a data split rounds each rank's bf16
    gradient before the fp32 sum, which is what microbatches do.
  * llava at data=2 with the patch embeddings of the second data rank's
    rows zeroed (every row carries its patch rows: the input has no
    ragged patches), so the ranks' text losses differ: the loss is the
    global batch's mean, its token count summed over data, under the fp32
    rule.
  * A world of one rank: ``train(mesh=)`` equals ``train()`` bit for bit,
    losses, grad norms and every leaf.
  * seq_tp (``make_ac(mesh, "seq_tp")``) at model=2, the four families
    and tiny granite-moe, one fp32 step against dp in the same world
    (tests/test_torch_train_sharded.py's seq_tp rules): the first loss
    and every gradient leaf but the norm scales bit-identical (the
    mamba layers, zamba2's shared block and fuse products, whisper's
    encoder and cross attention, llava's patch rows and the experts on
    whole rows), the norm scales within GRAD_TOL.
  * Against the reference: its ``make_train_step`` jitted with
    ``repro.launch.dryrun.build_step``'s shardings on 8 forced host
    devices at data=2 x model=2, in a subprocess, from its own initial
    state (wq, wk x 1/8) carried in by ``from_jax_state``: one step's loss
    and grad norm within REF_RTOL for the fp32 families (XLA's and
    torch's fp32 sums in their own orders: tests/test_torch_train_sharded
    .py measured 3.1e-7 for the dense family). Whisper runs in bf16 there
    (the reference's encoder scans with a bf16 carry, which fp32 weights
    break): its loss and grad norm under the bf16 rules above, 2**-10 and
    2**-7, which bound the two packages' bf16 rounding at their own
    points (measured 1.1e-4 and 1.4e-4; the fp32 families 4.6e-7 at
    most).

  * One row at data=2, its sequence split over data (``DataSeqRows``):
    the four families and granite-moe under the fp32 rules against the
    one-device step (whisper's XATTN leaves within the rule or twice the
    one-device sequence-block control's distance, ``_block_grads``),
    and one step against the reference's jitted step with its own
    in_shardings under the reference rules above; granite-moe's plan
    (experts, keep, buffer rows) equal to one device's as integers and
    its aux loss's gradient, alone, under the fp32 rule, while the
    control that takes it on every rank counts it twice and misses.
  * One row at data=2 that data divides in no dim (S 63; whisper's 7
    decoder tokens), held whole over data, and whisper's 56 frames (which
    data divides) beside 7 tokens: every family's first loss and
    gradients the one-device step's, bit for bit.

Each gloo world is spawned once (a module fixture) and returns all of its
cases. Workers run one intra-op thread, as does this process.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig, get_config, tiny_config)
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import sharded as tsh  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-370m", "zamba2-1.2b", "whisper-large-v3",
         "llava-next-mistral-7b")
SHAPE = ShapeConfig("t", 64, 4, "train")
# one row at data=2: no batch axis divides it, so the rules split its
# sequence over data (DataSeqRows; whisper's frames and tokens each)
SHAPE_B1 = ShapeConfig("t", 64, 1, "train")
# one row that data=2 divides in no dim (mamba2 and zamba2: 63 tokens;
# whisper: 63 frames and 7 decoder tokens; llava: 15 patch rows and 48
# tokens, 63 rows): every data rank holds it whole (training/sharded.py)
SHAPE_ODD = ShapeConfig("t", 63, 1, "train")
# whisper's 56 frames, which data=2 divides, beside 7 decoder tokens,
# which it does not: the rules split the frames' sequence over data and
# leave the tokens whole, and the step holds the row whole over data
SHAPE_MIXED = ShapeConfig("t", 56, 1, "train")
WHISPER = "whisper-large-v3"
QK_SCALE = 0.125
LR = 1e-3
STEPS = 2
WORLD_S = 300.0
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BF16_LOSS_RTOL = 2.0 ** -10
BF16_NORM_RTOL = 2.0 ** -7
REF_RTOL = 1e-5
BF16_REF = ("whisper-large-v3",)     # the reference's encoder takes bf16
# whisper's leaves whose fp32 gradients are small differences of large
# terms (tests/test_torch_encdec.py): held there to 1e-3
XATTN_LEAVES = {("dec", "xattn", "wq"), ("dec", "xattn", "wk"),
                ("dec", "ln_x"), ("enc", "ln1")}
XATTN_GRAD_TOL = 1e-3
# (label, data, model)
MESHES = {"data2": (2, 1), "model2": (1, 2), "2x2": (2, 2)}
# trained at model=2 under make_ac(mesh, "seq_tp") beside dp
MOE = "granite-moe-3b-a800m"
SEQ_TP_ARCHS = ARCHS + (MOE,)
# the norm scales: the one gradient seq_tp sums in another order
NORM_KEYS = ("ln1", "ln2", "ln1_post", "ln2_post", "ln_x", "mamba_ln",
             "final_norm", "enc_norm")


def _tcfg(microbatches=1, ckpt_dir=""):
    return TrainConfig(optim=OptimConfig(lr=LR, warmup_steps=1,
                                         total_steps=10),
                       microbatches=microbatches, log_every=1,
                       checkpoint_every=0, checkpoint_dir=ckpt_dir)


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


def _state(model, fp32):
    """The case's whole initial state: the port's init (fp32 or as it
    is), wq and wk scaled."""
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    if fp32:
        p = tree_map(lambda a: a.float(), p)
    for a in attn_trees(p):
        for n in ("wq", "wk"):
            a[n] = (a[n].float() * QK_SCALE).to(a[n].dtype)
    tcfg = _tcfg()
    return {"params": p, "opt": tadam.adamw_init(p, tcfg.optim)}


def _batch(model, k, zero_rows=None, shape=SHAPE):
    b = tdp.batch_for_model(model, shape, None, k, full=True)
    if zero_rows is not None:
        b["patches"] = b["patches"].clone()
        b["patches"][zero_rows] = 0
    return b


# --------------------------------------------------------------- one device --
def _one_device(arch, fp32, microbatches=1, zero_rows=None, shape=SHAPE,
                remat=False):
    """The port's one-device run: (first step's loss, grad norm and
    gradients (fp32 case), each step's metrics). At ``shape`` B 1 (fp32)
    also the moe layers' plans of the first batch (``_plans``) and the
    gradients of its moe aux loss alone (``_aux_grads``). ``remat``: the
    first gradients as the step takes them (``TrainConfig.remat``)."""
    model = build_model(tiny_config(arch))
    state = _state(model, fp32)
    tcfg = _tcfg(microbatches)
    out = {}
    if fp32:
        leaves = tree_leaves(state["params"])
        for p in leaves:
            p.requires_grad_(True)
        loss = model.loss(state["params"], _batch(model, 0, zero_rows,
                                                  shape), remat=remat)
        out["loss"] = float(loss.detach())
        out["grads"] = [g.float().numpy()
                        for g in torch.autograd.grad(loss, leaves)]
        for p in leaves:
            p.requires_grad_(False)
        if arch == MOE and shape is SHAPE_B1:
            b0 = _batch(model, 0, shape=shape)
            out["plans"] = _plans(lambda: model.loss(state["params"], b0))
            out["aux"] = _aux_grads(lambda: model.loss(state["params"], b0),
                                    leaves, [])
    step = tsteps.make_train_step(model, tcfg)
    out["steps"] = []
    for k in range(1 if fp32 else STEPS):
        state, met = step(state, _batch(model, k, zero_rows, shape))
        out["steps"].append({n: float(v) for n, v in met.items()})
    return out


def _block_grads(arch, n, shape):
    """The one-device fp32 gradient taken as the sum of ``n`` sequence
    blocks' shares of the loss (each block's rows' summed losses over the
    whole sequence's count), each share's gradient alone, added in fp32:
    the reordering of the gradient's sum that a sequence split over ``n``
    data ranks makes, on one device (the control of whisper's
    cancellation-bound leaves)."""
    from repro_torch.models import transformer as t_tr
    model = build_model(tiny_config(arch))
    params = _state(model, True)["params"]
    b = _batch(model, 0, shape=shape)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    hidden, _, _, fmask = model.forward(params, b, unembed_mode="none")
    labels = b["labels"]
    S = labels.shape[1]
    w = torch.ones(labels.shape) if fmask is None else fmask
    nxt = torch.nn.functional.pad(torch.nn.functional.pad(
        labels, (w.shape[1] - S, 0))[:, 1:], (0, 1)).long()
    w = torch.nn.functional.pad(w[:, :-1], (0, 1))
    W = t_tr._unembed_weight(params, model.cfg, None)
    L, total = hidden.shape[1], None
    for r in range(n):
        blk = slice(r * L // n, (r + 1) * L // n)
        share = t_tr._chunk_ce(W, hidden[:, blk], nxt[:, blk], w[:, blk],
                               model.cfg, None) / w.sum()
        g = torch.autograd.grad(share, leaves, retain_graph=r < n - 1,
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(g, leaves)]
        total = g if total is None else [a + c for a, c in zip(total, g)]
    for p in leaves:
        p.requires_grad_(False)
    return [x.numpy() for x in total]


def _plans(loss_fn):
    """Each moe layer's plan in one forward of ``loss_fn`` (no gradient):
    the experts each (token, k) pair picks, whether it keeps a slot and
    its buffer row (models/moe.py::dispatch's idx, keep and dest, in the
    flat pairs' order), as integers."""
    from repro_torch.models import moe as moe_lib
    plans, dispatch = [], moe_lib.dispatch

    def record(idx, C, E, **kw):
        order, keep, dest = dispatch(idx, C, E, **kw)
        flat_keep, flat_dest = torch.empty_like(keep), torch.empty_like(dest)
        flat_keep[order], flat_dest[order] = keep, dest
        plans.append((idx.numpy(), flat_keep.numpy(), flat_dest.numpy()))
        return order, keep, dest
    moe_lib.dispatch = record
    try:
        with torch.no_grad():
            loss_fn()
    finally:
        moe_lib.dispatch = dispatch
    return plans


def _aux_grads(loss_fn, leaves, specs, whole=None):
    """(loss, gradients) of the moe aux loss alone: ``Model.loss`` with
    the cross-entropy replaced by 0 x the hidden rows' sum (the graph and
    the collectives kept), so its value is 0.01 x aux and its gradients
    the aux's (zeros for the leaves it does not reach: the final norm,
    the unembedding). ``whole`` makes a rank's gradient block whole."""
    from repro_torch.models import transformer as t_tr
    ce = t_tr.chunked_ce
    t_tr.chunked_ce = lambda params, hidden, *a, **k: 0.0 * hidden.sum()
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn()
        g = [torch.zeros_like(p) if x is None else x for x, p in zip(
            torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    finally:
        t_tr.chunked_ce = ce
        for p in leaves:
            p.requires_grad_(False)
    if whole is not None:
        g = [whole(x, s) for x, s in zip(g, specs)]
    return float(loss.detach()), [x.float().numpy() for x in g]


# ---------------------------------------------------------------- the worlds --
def _case(mesh, arch, fp32, zero_rows=None, mode="dp", shape=SHAPE):
    """A case through the sharded trainer under ``make_ac(mesh, mode)``:
    the first step's loss and gradients (whole, fp32 case) and each
    step's metrics. At B 1 (granite-moe) also the moe layers' plans and
    the aux loss's gradients alone, with the aux loss's gradient taken
    once (``DataSeqRows.once``) and, the control, on every rank."""
    model = build_model(tiny_config(arch))
    tr = tsh.ShardedTrainer(model, _tcfg(), shlib.make_ac(mesh, mode))
    st = tr.shard(_state(model, fp32), tr.specs)
    shapes_ok = all(tuple(x.shape) == shlib.local_shape(
        tuple(a.shape), s, tr.sizes) for x, a, s in zip(
        tree_leaves(st), tree_leaves(tr.abstract), tr.leaf_specs()))
    out = {"shapes_ok": shapes_ok, "steps": []}
    if fp32:
        b0 = _batch(model, 0, zero_rows, shape)
        loss, g = tr.grads(st["params"], *tr.rows(b0))
        out["loss"] = float(loss)
        out["grads"] = [tr.whole(x, s).float().numpy()
                        for x, s in zip(tree_leaves(g), tr.param_specs)]
        if arch == MOE and shape is SHAPE_B1:
            def loss_fn():
                rows, ac = tr.rows(b0)
                return model.loss(st["params"], rows,
                                  remat=True, dot=tr.dot, gather=tr.gather,
                                  ranks=tr.ranks, ac=ac)

            def aux(leaves=tree_leaves(st["params"])):
                loss, g = _aux_grads(loss_fn, leaves, tr.param_specs)
                g = [tr.whole(tr.sum_unsplit(torch.from_numpy(x), s), s)
                     .numpy() for x, s in zip(g, tr.param_specs)]
                return loss, g
            out["plans"] = _plans(loss_fn)
            out["aux"] = aux()
            once = shlib.DataSeqRows.once
            shlib.DataSeqRows.once = lambda self, a: a
            try:
                out["aux_every_rank"] = aux()
            finally:
                shlib.DataSeqRows.once = once
    for k in range(1 if fp32 else STEPS):
        st, met = tr.step(st, _batch(model, k, zero_rows, shape))
        out["steps"].append({n: float(v) for n, v in met.items()})
    return out


def _world1(arch, ckpt_dir):
    """train(mesh=<a world of one>) against train(), both on rank 0, from
    an empty checkpoint directory."""
    from repro_torch.launch.mesh import make_sub_mesh
    from repro_torch.training.loop import train
    sub = make_sub_mesh(1, 1, device_type="cpu")
    if sub is None:
        return None
    model = build_model(tiny_config(arch))
    quiet = dict(log=lambda r: None, num_steps=STEPS)
    tcfg = _tcfg(ckpt_dir=f"{ckpt_dir}/{arch}")
    a = train(model, SHAPE, tcfg, mesh=sub, **quiet)
    b = train(model, SHAPE, tcfg, device="cpu", **quiet)
    return {"hist": [(r["loss"], r["grad_norm"]) for r in a["history"]],
            "want": [(r["loss"], r["grad_norm"]) for r in b["history"]],
            "same": all(torch.equal(x, y) for x, y in zip(
                tree_leaves(a["state"]), tree_leaves(b["state"])))}


def _reference_case(mesh, arch, ref):
    """The reference's initial state through one sharded step: (loss,
    grad norm), and where the reference gave its first gradients
    ("grads") the port's first gradients on the same state and batch,
    whole."""
    from repro_torch.models.convert import from_jax_state
    model = build_model(tiny_config(arch))
    tr = tsh.ShardedTrainer(model, _tcfg(), shlib.make_ac(mesh))
    st = tr.shard(from_jax_state(ref["state"]), tr.specs)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    if "frames" in batch or "patches" in batch:
        for k in ("frames", "patches"):
            if k in batch:
                batch[k] = batch[k].to(torch.bfloat16)
    grads = None
    if "grads" in ref:
        _, g = tr.grads(st["params"], *tr.rows(batch))
        grads = [tr.whole(x, s).float().numpy()
                 for x, s in zip(tree_leaves(g), tr.param_specs)]
    _, met = tr.step(st, batch)
    return float(met["loss"]), float(met["grad_norm"]), grads


def _world(rank, world, device, data, tp, ckpt_dir, ref_file=None):
    from repro_torch.launch.mesh import make_serving_mesh
    mesh = make_serving_mesh(model=tp, data=data, device_type="cpu",
                             backend="gloo")
    out = {}
    for arch in ARCHS:
        out[(arch, "fp32")] = _case(mesh, arch, True)
        out[(arch, "bf16")] = _case(mesh, arch, False)
    if data == 1 and tp == 2:
        out[(MOE, "fp32")] = _case(mesh, MOE, True)
        for arch in SEQ_TP_ARCHS:
            out[(arch, "seq_tp")] = _case(mesh, arch, True, mode="seq_tp")
    if data == 2 and tp == 1:
        out["llava_zero"] = _case(mesh, "llava-next-mistral-7b", True,
                                  zero_rows=slice(2, 4))
        for arch in ARCHS:
            out[(arch, "world1")] = _world1(arch, ckpt_dir)
        for arch in ARCHS + (MOE,):     # the sequence split over data
            out[(arch, "b1")] = _case(mesh, arch, True, shape=SHAPE_B1)
        for arch in ARCHS:              # the row whole over data
            out[(arch, "odd")] = _case(mesh, arch, True, shape=SHAPE_ODD)
        out[(WHISPER, "mixed")] = _case(mesh, WHISPER, True,
                                        shape=SHAPE_MIXED)
    if ref_file:
        with open(ref_file, "rb") as f:
            ref = pickle.load(f)
        for arch in ARCHS + ((MOE,) if tp == 1 else ()):
            key = (arch, "b1") if tp == 1 else arch
            out[(arch, "ref")] = _reference_case(mesh, arch, ref[key])
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
from repro.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro.data import pipeline as jdp
from repro.distributed import sharding as j_sh
from repro.models.api import build_model
from repro.optim import adamw

ARCHS, MOE, QK, LR, BF16 = {ARCHS!r}, {MOE!r}, {QK}, {LR}, {BF16!r}
shape = ShapeConfig("t", {S}, {B}, "train")


def attn_trees(p):
    out = []
    for key in ("blocks", "shared", "enc", "dec"):
        sub = p.get(key)
        if sub is None:
            continue
        for s in (sub.values() if key == "blocks" else [sub]):
            out += [s[n] for n in ("attn", "xattn") if n in s]
    return out


mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
# B 1 at data=2: the batch's spec splits its sequence over data
mesh_b1 = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
shape_b1 = ShapeConfig("t", {S}, 1, "train")
tcfg = TrainConfig(optim=OptimConfig(lr=LR, warmup_steps=1, total_steps=10))
out = {{}}


def run(model, state, shape, mesh, grads=False):
    batch = jdp.batch_for_model(model, shape, None, 0)
    step, args, ins, outs, don, _ = rd.build_step(model, shape, mesh, tcfg)
    out = {{}}
    with mesh:
        if grads:     # the first gradients, and their float64 norm
            g = jax.tree.leaves(jax.jit(
                jax.grad(lambda p, b: model.loss(
                    p, b, remat=tcfg.remat, ac=j_sh.make_ac(mesh))),
                in_shardings=(ins[0]["params"], ins[1]))(
                state["params"], batch))
            out["grads"] = [np.asarray(x, np.float32) for x in g]
            out["norm64"] = float(np.sqrt(sum(
                np.sum(np.square(np.asarray(x, np.float64))) for x in g)))
        new, met = jax.jit(step, in_shardings=ins, out_shardings=outs)(
            state, batch)
    return dict(out, state=jax.tree.map(np.asarray, state),
                batch={{k: np.asarray(v, np.float32)
                       if v.dtype == jnp.bfloat16 else np.asarray(v)
                       for k, v in batch.items()}},
                loss=float(met["loss"]), grad_norm=float(met["grad_norm"]))


for arch in ARCHS + (MOE,):
    model = build_model(tiny_config(arch))
    dtype = jnp.bfloat16 if arch in BF16 else jnp.float32
    p = jax.tree.map(lambda a: a.astype(dtype),
                     model.init(jax.random.PRNGKey(0)))
    for a in attn_trees(p):
        for n in ("wq", "wk"):
            a[n] = (a[n].astype(jnp.float32) * QK).astype(dtype)
    state = {{"params": p, "opt": adamw.adamw_init(p, tcfg.optim)}}
    if arch != MOE:
        out[arch] = run(model, state, shape, mesh)
    out[(arch, "b1")] = run(model, state, shape_b1, mesh_b1,
                            grads=arch not in BF16)
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    script = REF_SCRIPT.format(ARCHS=ARCHS, MOE=MOE, QK=QK_SCALE, LR=LR,
                               BF16=BF16_REF, S=SHAPE.seq_len,
                               B=SHAPE.global_batch)
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=400,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-4000:]
    with open(path, "rb") as f:
        return str(path), pickle.load(f)


@pytest.fixture(scope="module")
def world_data2(tmp_path_factory, reference):
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(2, 1, str(tmp_path_factory.mktemp("ckpt")),
                       reference[0]))


@pytest.fixture(scope="module")
def world_model2():
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(1, 2, ""))


@pytest.fixture(scope="module")
def world4(reference):
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(2, 2, "", reference[0]))


@pytest.fixture(scope="module")
def one_device():
    out = {}
    for arch in ARCHS:
        out[(arch, "fp32")] = _one_device(arch, True)
        out[(arch, "bf16")] = _one_device(arch, False)
        out[(arch, "bf16", 2)] = _one_device(arch, False, 2)
    out["llava_zero"] = _one_device("llava-next-mistral-7b", True,
                                    zero_rows=slice(2, 4))
    for arch in ARCHS + (MOE,):
        out[(arch, "b1")] = _one_device(arch, True, shape=SHAPE_B1)
    for arch in ARCHS:
        out[(arch, "odd")] = _one_device(arch, True, shape=SHAPE_ODD,
                                         remat=True)
    out[(WHISPER, "mixed")] = _one_device(WHISPER, True, shape=SHAPE_MIXED,
                                          remat=True)
    out["whisper_blocks"] = _block_grads("whisper-large-v3", 2, SHAPE_B1)
    return out


WORLDS = {"data2": "world_data2", "model2": "world_model2", "2x2": "world4"}


def _check_fp32(got, want, arch, control=None):
    """The fp32 rules; with ``control`` (whisper's sequence-block
    gradients, ``_block_grads``) an XATTN leaf may also reach twice the
    control's distance from ``want``."""
    paths = shlib.leaf_paths(build_model(tiny_config(arch))
                             .abstract_params())
    for i, (path, w, g) in enumerate(zip(paths, want["grads"],
                                         got["grads"])):
        err = float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
        tol = XATTN_GRAD_TOL if arch == "whisper-large-v3" and \
            path in XATTN_LEAVES else GRAD_TOL
        if control is not None and path in XATTN_LEAVES:
            c = control[i]
            tol = max(tol, 2 * float(np.abs(w - c).max()
                                     / max(np.abs(w).max(), 1e-30)))
        assert err <= tol, (path, err)
    for k in ("loss", "grad_norm"):
        g, w = got["steps"][0][k], want["steps"][0][k]
        assert abs(g - w) <= LOSS_RTOL * abs(w), (k, g, w)


# ------------------------------------------------------------------ tests --
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes", [dict(data=2, model=1),
                                   dict(data=1, model=2),
                                   dict(data=2, model=2)],
                         ids=["data2", "model2", "2x2"])
def test_validate_train_mesh_accepts_the_families(arch, sizes):
    tsh.validate_train_mesh(get_config(arch), sizes)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(WORLDS))
def test_fp32_step_matches_one_device(name, arch, request, one_device):
    """The first step's gradients, loss and grad norm against the plain
    one-device step; every rank's gradients alike and its leaves of their
    at-rest shapes."""
    ranks = request.getfixturevalue(WORLDS[name])
    got = ranks[0][(arch, "fp32")]
    _check_fp32(got, one_device[(arch, "fp32")], arch)
    for r in ranks:
        assert r[(arch, "fp32")]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(
            r[(arch, "fp32")]["grads"], got["grads"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", list(WORLDS))
def test_bf16_steps_match_one_device(name, arch, request, one_device):
    """Two bf16 steps against the one-device run in as many microbatches
    as the mesh has data ranks."""
    ranks = request.getfixturevalue(WORLDS[name])
    data = MESHES[name][0]
    want = one_device[(arch, "bf16", 2) if data == 2 else (arch, "bf16")]
    for r in ranks:
        for g, w in zip(r[(arch, "bf16")]["steps"], want["steps"]):
            assert abs(g["loss"] - w["loss"]) <= BF16_LOSS_RTOL * w["loss"]
            assert abs(g["grad_norm"] - w["grad_norm"]) <= \
                BF16_NORM_RTOL * w["grad_norm"]


def test_llava_patch_rows_differ_by_rank(world_data2, one_device):
    """Zeroed patch embeddings on the second data rank's rows: the loss,
    grad norm and gradients are the one-device run's."""
    got, want = world_data2[0]["llava_zero"], one_device["llava_zero"]
    _check_fp32(got, want, "llava-next-mistral-7b")
    assert got["steps"][0]["loss"] != \
        one_device[("llava-next-mistral-7b", "fp32")]["steps"][0]["loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_world_of_one_is_the_unsharded_trainer(arch, world_data2):
    got = world_data2[0][(arch, "world1")]
    assert got["hist"] == got["want"] and got["same"]
    assert world_data2[1][(arch, "world1")] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_matches_the_reference_jitted_sharded_step(arch, world4,
                                                   reference):
    want = reference[1][arch]
    for r in world4:
        loss, norm, _ = r[(arch, "ref")]
        if arch in BF16_REF:
            assert abs(loss - want["loss"]) <= BF16_LOSS_RTOL * want["loss"]
            assert abs(norm - want["grad_norm"]) <= \
                BF16_NORM_RTOL * want["grad_norm"]
        else:
            assert abs(loss - want["loss"]) <= REF_RTOL * want["loss"]
            assert abs(norm - want["grad_norm"]) <= \
                REF_RTOL * want["grad_norm"]


def test_measured_gaps_are_recorded(world4, reference):
    """The reference gaps, for the record (printed with -s)."""
    import json
    out = {}
    for arch in ARCHS:
        loss, norm, _ = world4[0][(arch, "ref")]
        w = reference[1][arch]
        out[arch] = (abs(loss - w["loss"]) / w["loss"],
                     abs(norm - w["grad_norm"]) / w["grad_norm"])
    print(json.dumps(out))


@pytest.mark.parametrize("arch", SEQ_TP_ARCHS)
def test_seq_tp_step_is_dp_but_the_norm_scales(arch, world_model2):
    """One fp32 step at model=2 under make_ac(mesh, "seq_tp") against dp
    in the same world (tests/test_torch_train_sharded.py's seq_tp rules):
    the first loss bit-identical, every gradient leaf but the norm scales
    bit-identical, the norm scales within GRAD_TOL of each leaf's max
    |g|, the step's loss and grad norm within LOSS_RTOL."""
    paths = shlib.leaf_paths(build_model(tiny_config(arch))
                             .abstract_params())
    assert any(p[-1] in NORM_KEYS for p in paths)
    for r in world_model2:
        dp, seq = r[(arch, "fp32")], r[(arch, "seq_tp")]
        assert seq["loss"] == dp["loss"]
        for path, a, b in zip(paths, dp["grads"], seq["grads"]):
            if path[-1] in NORM_KEYS:
                err = float(np.abs(a - b).max()
                            / max(np.abs(a).max(), 1e-30))
                assert err <= GRAD_TOL, (path, err)
            else:
                assert np.array_equal(a, b), path
        _check_fp32(seq, dp, arch)


# ----------------------------------------- a sequence split over data --
@pytest.mark.parametrize("arch", ARCHS + (MOE,))
def test_seq_split_step_matches_one_device(arch, world_data2, one_device):
    """One row at data=2, its sequence split over data (whisper's frames
    and decoder tokens each, llava's patch and text rows as one
    sequence): the first step's gradients, loss and grad norm against the
    plain one-device step under the fp32 rules; every rank's gradients
    alike and its leaves of their at-rest shapes.

    At one row whisper's encoder ``ln1`` gradient, the smallest
    difference of large terms of the XATTN leaves, moves past
    XATTN_GRAD_TOL when one device only sums the two sequence blocks'
    shares of the loss apart (``_block_grads``; the split's and the
    control's distances are printed with -s): the XATTN leaves are held
    within that rule or twice the control's distance, as the bf16 rules
    hold a split to its microbatched control."""
    got = world_data2[0][(arch, "b1")]
    want = one_device[(arch, "b1")]
    control = one_device["whisper_blocks"] \
        if arch == "whisper-large-v3" else None
    _check_fp32(got, want, arch, control)
    if control is not None:         # the distances, printed with -s
        paths = shlib.leaf_paths(build_model(tiny_config(arch))
                                 .abstract_params())
        print({"/".join(p): [float(np.abs(w - x).max() / np.abs(w).max())
                             for x in (g, c)]
               for p, w, g, c in zip(paths, want["grads"], got["grads"],
                                     control) if p in XATTN_LEAVES})
    for r in world_data2:
        assert r[(arch, "b1")]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(
            r[(arch, "b1")]["grads"], got["grads"]))


@pytest.mark.parametrize("arch", ARCHS + (MOE,))
def test_seq_split_matches_the_reference_jitted_step(arch, world_data2,
                                                    reference):
    """One step at B 1 on data=2 against the reference's jitted step with
    its own in_shardings (the sequence over data), from the reference's
    initial state, on every rank. The fp32 families and granite-moe under
    the fp32 rules: the first gradients leaf by leaf against the
    reference's jitted gradients (the batch given its in_shardings too),
    the loss against its step's, and the grad norm against the float64
    norm of its gradients ("norm64"; the norm its step reports carries its
    own fp32 sums in XLA's order). Whisper under the bf16 rules, loss and
    grad norm: the reference runs it in bf16 only. The distances are
    printed with -s."""
    want = reference[1][(arch, "b1")]
    for r in world_data2:
        loss, norm, grads = r[(arch, "ref")]
        if arch in BF16_REF:
            assert abs(loss - want["loss"]) <= BF16_LOSS_RTOL * want["loss"]
            assert abs(norm - want["grad_norm"]) <= \
                BF16_NORM_RTOL * want["grad_norm"]
            continue
        print(arch, "against the reference: largest leaf error",
              max(float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
                  for w, g in zip(want["grads"], grads)),
              "loss", abs(loss - want["loss"]) / want["loss"],
              "grad norm", abs(norm - want["norm64"]) / want["norm64"],
              "(its reported norm",
              abs(want["grad_norm"] - want["norm64"]) / want["norm64"], ")")
        _check_fp32({"grads": grads, "steps": [
            {"loss": loss, "grad_norm": norm}]}, {
            "grads": want["grads"], "steps": [
                {"loss": want["loss"], "grad_norm": want["norm64"]}]}, arch)


def test_seq_split_moe_routes_as_one_device(world_data2, one_device):
    """granite-moe at B 1, data=2: every rank routes the whole rows as
    one device does, the experts each pair picks, which pairs keep a slot
    and their buffer rows equal as integers in every layer; the aux
    loss's value is one device's, and its gradient, taken on the first
    data rank alone, is one device's under the fp32 rule, while the
    control that takes it on every rank counts it twice and misses."""
    want = one_device[(MOE, "b1")]
    paths = shlib.leaf_paths(build_model(tiny_config(MOE))
                             .abstract_params())
    assert want["plans"]

    def err(w, g):
        return float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
    for r in world_data2:
        got = r[(MOE, "b1")]
        assert len(got["plans"]) == len(want["plans"])
        for g, w in zip(got["plans"], want["plans"]):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        loss, grads = got["aux"]
        assert abs(loss - want["aux"][0]) <= LOSS_RTOL * want["aux"][0]
        for path, w, g in zip(paths, want["aux"][1], grads):
            assert err(w, g) <= GRAD_TOL, path
        twice = max(err(w, g) for w, g in zip(want["aux"][1],
                                               got["aux_every_rank"][1])
                    if np.abs(w).max() > 0)
        assert twice > 100 * GRAD_TOL


# -------------------------------------------- a row held whole over data --
@pytest.mark.parametrize("arch,case", [(a, "odd") for a in ARCHS]
                         + [(WHISPER, "mixed")])
def test_row_held_whole_over_data_is_one_device(arch, case, world_data2,
                                                one_device):
    """One row at data=2 that data divides in no dim (``SHAPE_ODD``:
    S 63, whisper's 63 frames and 7 decoder tokens, llava's 15 patch rows
    and 48 tokens), or whose decoder tokens it does not divide beside
    frames it does (``SHAPE_MIXED``, which ``train(mesh=)``'s layout
    check takes: the rules split the frames over data): every rank
    computes the whole row from the gathered weights, its encoder too,
    and nothing sums over data, so on every rank the first loss and
    every gradient leaf are the one-device port's, bit for bit, and the
    step's loss and grad norm are within the fp32 rules."""
    if case == "mixed":
        from repro_torch.training.loop import _check_layout
        model = build_model(tiny_config(arch))
        sizes = {"data": 2, "model": 1}
        spec = shlib.specs_for(model.input_specs(SHAPE_MIXED),
                               model.batch_logical_specs(SHAPE_MIXED), sizes)
        assert (tuple(spec["frames"])[:2], tuple(spec["tokens"])) == \
            ((None, "data"), ())
        _check_layout(model, _tcfg(), SHAPE_MIXED, shlib.make_ac(sizes),
                      None)
    want = one_device[(arch, case)]
    for r in world_data2:
        got = r[(arch, case)]
        assert got["shapes_ok"] and got["loss"] == want["loss"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["grads"], want["grads"]))
        _check_fp32(got, want, arch)
