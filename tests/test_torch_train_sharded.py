"""The port's sharded training (training/sharded.py, the specs of
training/steps.py, optim/adamw.py and models/api.py, ``make_ac``,
``reshard_state``, ``train(mesh=)``) on the CPU.

Held against the reference's pure functions, spec for spec, for every
config of the registry at full and tiny shapes: ``abstract_train_state``
(shapes and dtypes), ``train_state_logical_specs`` and
``opt_state_logical_specs`` in both moment modes, ``input_specs`` and
``batch_logical_specs`` at train, prefill and decode shapes, both
``cache_axes``, and ``specs_for`` of the state and the inputs on six
meshes. Held against the reference's jitted ``make_train_step`` and
against the port's one-device step: tiny gemma2-2b trained in gloo worlds
at data=2, model=2 and data=2 x model=2 (world 4), tiny granite-moe at
model=2, and tiny gemma2-2b at data=3, where no leaf splits over data (d
128), so that every gradient takes the post-backward sum over data and
every leaf counts in the norm on one data rank; tiny gemma2-2b (4 query
heads, 2 kv heads) at model=4, where each rank slices its query head's kv
head from the whole wk/wv, and at model=8, where every rank computes the
whole attention; and at pod=2 x data=2, the FSDP dims split over both;
three steps each from the reference's state carried across
(models/convert.py::from_jax_state). ``make_ac(mesh, "seq_tp")`` (the
residual's rows split over model between sub-layers): which rows a rank
cuts, and at model=2 and data=2 x model=2 the trainer against dp on the
same mesh, state and batch, and against the reference's jitted step
under its own ``make_ac(mesh, "seq_tp")`` on forced host devices.

Tolerances, and why:
  * fp32 (``fp32`` cases): every run's parameters are set to its fp32
    master after each update, in the reference's run too, so all three
    steps run in fp32 and the runs differ only in summation order. The
    reference's initialisation saturates the tiny models' attention, so
    wq and wk are scaled by 1/8 in every run (tests/test_torch_train.py).
    Losses and grad norms within 1e-6 relative (measured: 3.1e-7 against
    the reference, 8.6e-8 against the one-device port); the first step's
    gradients, before the update, within 1e-5 of each leaf's max |g|
    (measured 1.2e-6 and 7.5e-7); masters after every step within 2 lr
    everywhere and within 1e-3 lr on 99.9% of elements (Adam's first step
    is lr * g / (|g| + eps), so an element whose gradient sits at rounding
    noise may move up to 2 lr the other way; measured 0.026 lr at most,
    7e-5 of elements past 1e-3 lr).
  * bf16 (``bf16`` cases, the trainer as ``train`` runs it): bf16
    parameters from the port's initialisation, wq and wk scaled as above,
    bf16 again after each update. Gradients are bf16 sums: split over
    ranks, each rank's share is rounded to bf16 before the fp32 sum,
    which is what the one-device step does with the batch cut into as
    many microbatches. So each run is held to the one-device run with the
    rows cut as its mesh cuts them (microbatches = the data size): losses
    within 2**-10 relative, grad norms within 2**-7, masters within Adam's
    bound, 2 lr a step (|m_hat / sqrt(v_hat)| <= 1 at these betas), and
    after the first step, whose weights are equal, within 1e-3 lr on 95%
    of elements (measured over the three steps and meshes: losses within
    1.2e-4, grad norms within 5.5e-4, 1.1% of masters past after the first
    step; 6e-6 at data=2 alone, where only the batch splits; model=2's
    input all-reduce rounds partial sums of its own). A mesh that splits
    the batch is held to the plain one-device run too, within those rules
    or twice the distance of the microbatched run from it (the control:
    what the split of a bf16 sum moves by itself). At the
    initialisation's saturated attention the same rounding moves a later
    step's grad norm by up to 74% (a bf16 ulp of a weight flips the
    softmax), so the scaling is what lets the steps be compared.
    chip_smoke.py's phase 18(b, c) holds full-width and tiny gemma2-2b
    on the card to these rules.
  * int8 moments (``quant``; ``quant256``, blocks of 256 that straddle
    model=2's shards of d_ff): one step under the fp32 rules, its moment
    codes within one code on 99.9% of elements. Later steps would not
    compare elementwise: where one run's v code rounds to 0 and the
    other's to 1, the reference's quantizer moves that element by up to
    lr |m_hat| / eps.
  * seq_tp against dp (fp32): the first loss and every gradient leaf but
    the norm scales bit-identical (both collectives it adds move data
    only); the norm scales, whose gradient sums every row and so is
    summed over model from each rank's rows' share, within GRAD_TOL of
    each leaf's max |g| (measured 1.8e-7 at most), and the control
    without that sum misses it by over 100x (measured 0.2-0.8); three
    steps under the fp32 rules against dp, the one-device port and the
    reference's seq_tp step.
  * Controls: the model=2 step without the input-side all-reduce of the
    tensor-parallel pair, the data=2 and data=3 steps with the other
    data ranks' gradients dropped (from the reduce-scatter and from the
    post-backward sum), and the model=4 step without the sum over model
    of the sliced wk/wv's gradient or without sum_grad on the k/v
    projections' input, must miss the gradient tolerance.
  * Checkpoints, ``reshard_state`` and the world of one: bit for bit.
  * A batch whose rows split over no batch axis, its sequence split over
    data (``DataSeqRows``): one row at data=2 and 2 x 2 (dp and seq_tp,
    which must agree bit for bit there), three rows and two rows in two
    microbatches at data=2, under the fp32 rules against the one-device
    port, and at data=2 against the reference's jitted step with its own
    in_shardings (the grad norm held to its gradients' float64 norm:
    ``test_seq_split_fp32_matches_one_device_and_reference``); each
    rank's residual S / data rows and its final hidden rows its block of
    one device's, bit for bit; bf16 under the bf16 rules against the
    one-device run that sums the two sequence blocks' bf16 gradients in
    fp32 (the analogue of the microbatched control); the step with
    ``DataSeqRows.whole``'s backward a cut must miss.
  * A (micro)batch an FSDP axis holds whole (``HELD``: rows over data
    alone, a sequence over data, or nothing split, at pod=2 x data=2 and
    data=3): every rank of that axis computes the same values and
    nothing sums over it, so the first loss and every gradient leaf are
    data=2's for the same batch (rows or sequence over data) or the
    one-device port's (nothing split), bit for bit, and the ranks'
    metrics the same bits at every step; three fp32 steps under the fp32
    rules against the one-device port, and (B 2, B 1) the reference's
    jitted step on pod=2 x data=2 x model=1 forced devices (the grad norm
    held to its float64 norm, as at data=2); with the backward over the
    held axis a reduce-scatter and a post-backward sum, the gradients
    double or triple and miss.

Each gloo world is spawned once (a module fixture) and returns all of its
cases. Workers run one intra-op thread, as does this process.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.distributed import sharding as j_sh  # noqa: E402
from repro.models import encdec as j_ed  # noqa: E402
from repro.models import transformer as j_tr  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch.checkpoint.ckpt import restore  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import (OptimConfig, ShapeConfig,  # noqa: E402
                                 TrainConfig)
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.data import pipeline as tdp  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import encdec as t_ed  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import DTYPES, from_jax_state  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_map,  # noqa: E402
                                        tree_unflatten)
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.training import sharded as tsh  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402
from repro_torch.training.loop import train  # noqa: E402

torch.set_num_threads(1)

# (data, model) and the pod mesh, as the rules read them
MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
WORLD_S = 120.0
STEPS = 3
SHAPE = ShapeConfig("t", 64, 4, "train")
# data=3: tiny gemma2-2b's d 128 does not divide by 3, so no leaf splits
# over data and every gradient takes the post-backward sum over data
SHAPE3 = ShapeConfig("t", 64, 6, "train")
# a batch whose sequence the rules split over data (DataSeqRows): one
# row at data=2 and at data=2 x model=2, three rows at data=2, and two
# rows in two microbatches of one at data=2
SHAPE_B1 = ShapeConfig("t", 64, 1, "train")
SHAPE_B2 = ShapeConfig("t", 64, 2, "train")
SHAPE_B3 = ShapeConfig("t", 64, 3, "train")
# one row of a sequence that data=2 does not divide
SHAPE_ODD = ShapeConfig("t", 63, 1, "train")
# a (micro)batch that an FSDP axis holds whole (training/sharded.py), case
# -> (shape, microbatches). At pod=2 x data=2: the rows over data alone
# (A: B 2, and B 4 in microbatches of 2), the sequence over data (B: B 1),
# neither (C: B 1 x S 63), each held whole over pod, over both in C. At
# data=3, B 2 x S 64 splits over neither (C). At data=2 "held_b2" and
# "held_m2" are the plain row splits that A at pod=2 x data=2 repeats.
HELD = {"held_b2": (SHAPE_B2, 1), "held_m2": (SHAPE, 2),
        "held_b1": (SHAPE_B1, 1), "held_odd": (SHAPE_ODD, 1)}
QK_SCALE = 0.125
LR = 1e-3
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
BF16_LOSS_RTOL = 2.0 ** -10
BF16_NORM_RTOL = 2.0 ** -7


class FakeMesh:
    """A mesh as the rules read it: only its axis sizes."""

    def __init__(self, **axes):
        self.shape = axes


# ------------------------------------------------------------ pure specs --
def _ref_leaves(abstract, logical):
    """(shape, dtype name, logical axes) of each reference leaf."""
    flat, tdef = jax.tree.flatten(abstract)
    logi = tdef.flatten_up_to(logical)
    return [(tuple(a.shape), jnp.dtype(a.dtype).name,
             None if l is None else tuple(l)) for a, l in zip(flat, logi)]


def _port_leaves(abstract, logical):
    names = {v: k for k, v in DTYPES.items()}
    return [(tuple(a.shape), names[a.dtype], None if l is None else tuple(l))
            for a, l in zip(tree_leaves(abstract),
                            shlib.leaves_like(abstract, logical))]


def _ref_choose(leaves, sizes):
    return [tuple(j_sh.choose_spec(s, l or (None,) * len(s),
                                   FakeMesh(**sizes))) for s, _, l in leaves]


def _port_specs(abstract, logical, sizes):
    return shlib.leaves_like(abstract,
                             shlib.specs_for(abstract, logical, sizes))


def _cfgs(arch, size):
    return (j_get(arch), t_get(arch)) if size == "full" \
        else (j_tiny(arch), t_tiny(arch))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_state_specs_match_reference(arch, size, quantized):
    """abstract_train_state (shapes, dtypes), train_state_logical_specs,
    opt_state_logical_specs and specs_for of the state on six meshes."""
    jcfg, tcfg = _cfgs(arch, size)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jt = JTrain(optim=JOptim(quantized_moments=quantized))
    tt = TrainConfig(optim=OptimConfig(quantized_moments=quantized))
    want = _ref_leaves(jsteps.abstract_train_state(jm, jt),
                       jsteps.train_state_logical_specs(jm, jt))
    abstract = tsteps.abstract_train_state(tm, tt)
    logical = tsteps.train_state_logical_specs(tm, tt)
    assert all(a.device.type == "meta" for a in tree_leaves(abstract))
    assert _port_leaves(abstract, logical) == want
    jo = jadam.opt_state_logical_specs(jm.logical_specs(), jt.optim)
    to = tadam.opt_state_logical_specs(tm.logical_specs(), tt.optim)
    assert _port_leaves(abstract["opt"], to) == _ref_leaves(
        jsteps.abstract_train_state(jm, jt)["opt"], jo)
    for sizes in MESHES:
        assert _port_specs(abstract, logical, sizes) == \
            _ref_choose(want, sizes), sizes
    assert shlib.scalar_sharding(MESHES[3]) == \
        tuple(j_sh.choose_spec((), (), FakeMesh(**MESHES[3])))


def _shapes(size):
    if size == "full":
        return {k: (J_SHAPES[n], ShapeConfig(n, J_SHAPES[n].seq_len,
                                              J_SHAPES[n].global_batch, k))
                for k, n in (("train", "train_4k"),
                             ("prefill", "prefill_32k"),
                             ("decode", "decode_32k"))}
    return {k: (JShape("t", 64, 4, k), ShapeConfig("t", 64, 4, k))
            for k in ("train", "prefill", "decode")}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_reference(arch, size, kind):
    """input_specs (shapes, dtypes, keys), batch_logical_specs and
    specs_for of the inputs on six meshes."""
    jcfg, tcfg = _cfgs(arch, size)
    jm, tm = j_build(jcfg), t_build(tcfg)
    jshape, tshape = _shapes(size)[kind]
    jin, tin = jm.input_specs(jshape), tm.input_specs(tshape)
    jax_ = jm.batch_logical_specs(jshape)
    assert tm.batch_logical_specs(tshape) == jax_
    assert sorted(tin) == sorted(jin)
    want = _ref_leaves(jin, jax_)
    got = _port_leaves(tin, tm.batch_logical_specs(tshape))
    assert got == want
    for sizes in MESHES:
        assert _port_specs(tin, tm.batch_logical_specs(tshape), sizes) == \
            _ref_choose(want, sizes), sizes


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_axes_match_reference(arch):
    for jcfg, tcfg in (_cfgs(arch, "full"), _cfgs(arch, "tiny")):
        if jcfg.is_encdec:
            assert t_ed.cache_axes(tcfg) == j_ed.cache_axes(jcfg)
        assert t_tr.cache_axes(tcfg) == j_tr.cache_axes(jcfg)


# ---------------------------------------------------------------- make_ac --
@pytest.mark.parametrize("B", [1, 2, 3, 4, 8, 64])
@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
def test_make_ac_rows_are_the_batch_spec(sizes, B):
    """The rows make_ac gives a rank are the batch dim's split under the
    reference's rule (choose_spec on ("batch",)), block by coordinate."""
    ac = shlib.make_ac(sizes)
    want = tuple(j_sh.choose_spec((B,), ("batch",), FakeMesh(**sizes)))
    assert ((ac.batch_axes(B),) if ac.batch_axes(B) else ()) == want
    x = torch.arange(B * 3).reshape(B, 3)
    axes = shlib._as_axes(want[0]) if want else ()
    n = math.prod(sizes[a] for a in axes)
    for j in range(n):
        ac.coords = {a: 0 for a in sizes}
        rest = j                    # block j: the split axes major to minor
        for a in reversed(axes):
            ac.coords[a] = rest % sizes[a]
            rest //= sizes[a]
        assert torch.equal(ac(x, "batch"), x[j * (B // n):(j + 1) * (B // n)])


def test_make_ac_modes_and_kinds():
    """dp leaves every kind but the batch as it is; seq_tp is taken (its
    row split: ``test_make_ac_seq_tp_splits_the_rows``) and leaves the
    decode kinds as they are; another mode is refused."""
    ac = shlib.make_ac({"data": 2, "model": 2})
    x = torch.zeros(4, 8, 16)
    for kind in ("resid", "decode_q", "decode_kv", "decode_scores",
                 "moe_buf"):
        assert ac(x, kind) is x
    assert ac.rows(x) is t_layers.WHOLE_ROWS
    seq = shlib.make_ac({"data": 2, "model": 2}, mode="seq_tp")
    assert seq.mode == "seq_tp"
    for kind in ("decode_q", "decode_kv", "decode_scores", "moe_buf"):
        assert seq(x, kind) is x
    with pytest.raises(ValueError, match="mode"):
        shlib.make_ac({"data": 2}, mode="tp")


@pytest.mark.parametrize("S", [1, 6, 8, 64])
@pytest.mark.parametrize("data,tp", [(2, 2), (1, 4), (4, 1)],
                         ids=["2x2", "model4", "data4"])
def test_make_ac_seq_tp_splits_the_rows(data, tp, S):
    """seq_tp's ``"resid"`` cuts a (B, S, D) residual to block
    coords["model"] of its S rows where the reference's condition holds
    (model > 1, S divisible by it, S > 1), and leaves it whole otherwise,
    a tensor of another rank too; ``rows`` gathers the block back to S
    rows. A batch no axis divides takes the dp layout (``for_batch``)."""
    from repro_torch.launch.mesh import _mesh, dry_world
    x = torch.arange(2 * S * 3, dtype=torch.float32).reshape(2, S, 3)
    split = tp > 1 and S % tp == 0 and S > 1
    with dry_world(data * tp):
        ac = shlib.make_ac(_mesh(data, tp, "cpu", 60.0), mode="seq_tp")
        assert (ac.rows(x) is not t_layers.WHOLE_ROWS) == split
        flat = x[0]
        assert ac(flat, "resid") is flat
        for r in range(tp):
            ac.coords["model"] = r
            got = ac(x, "resid")
            if not split:
                assert got is x
                continue
            n = S // tp
            assert torch.equal(got, x[:, r * n:(r + 1) * n])
            assert got.untyped_storage().nbytes() == got.numel() * 4
            assert tuple(ac.rows(x).whole(got).shape) == tuple(x.shape)
        assert ac.for_batch(2 * data) is ac
        assert (ac.for_batch(2 * data + 1).mode == "dp") == (data > 1)


@pytest.mark.parametrize("S", [1, 6, 8, 64])
@pytest.mark.parametrize("B", [1, 2, 3, 4])
@pytest.mark.parametrize("data,pod", [(2, 1), (4, 1), (2, 2)],
                         ids=["data2", "data4", "pod2xdata2"])
def test_make_ac_data_seq_rows(data, pod, B, S):
    """The layout of a training step over B whole rows on every rank
    (``whole_batch``, which ``ShardedTrainer.rows`` gives where no batch
    axis divides B) has ``DataSeqRows`` as its ``rows`` exactly where the
    reference's choose_spec of ("batch", "seq") puts data on the sequence
    (``seq_split``), in dp and seq_tp mode alike; ``"resid"`` then cuts
    block coords["data"] of the S rows, in storage of its own, the same
    block on every pod rank, and ``whole`` gives S rows back. The axes
    that hold the batch whole (``replicated_axes``) are the FSDP axes
    above 1 that the spec gives neither dim: on the pod mesh, pod under a
    sequence split over data, and both where data takes nothing. The
    sharded prefill's layout (``for_batch(B)``) and ``make_ac``'s own
    keep every batch's rows whole."""
    from repro_torch.launch.mesh import _mesh, dry_world
    sizes = {"data": data, "model": 1} if pod == 1 else \
        {"pod": pod, "data": data, "model": 1}
    spec = tuple(j_sh.choose_spec((B, S), ("batch", "seq"),
                                  FakeMesh(**sizes)))
    on_seq = spec[1:2] == ("data",)
    taken = sum((shlib._as_axes(e) for e in spec if e is not None), ())
    held = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1
                 and a not in taken)
    x = torch.arange(B * S * 3, dtype=torch.float32).reshape(B, S, 3)
    with dry_world(data * pod):
        mesh = _mesh(data, 1, "cpu", 60.0, pod=pod)
        for mode in ("dp", "seq_tp"):
            made = shlib.make_ac(mesh, mode)
            assert made.rows(x) is t_layers.WHOLE_ROWS
            assert made.for_batch(B).rows(x) is t_layers.WHOLE_ROWS
            assert made.replicated_axes(B, S) == held
            ac = shlib.ActivationLayout(mesh, mode, whole_batch=True)
            assert made.seq_split(B, S) == on_seq
            assert isinstance(ac.rows(x), shlib.DataSeqRows) == on_seq
            if not on_seq:
                assert ac(x, "resid") is x
                continue
            n = S // data
            for r in range(data * pod):
                ac.coords["data"] = r % data
                if pod > 1:
                    ac.coords["pod"] = r // data
                got = ac(x, "resid")
                blk = r % data
                assert torch.equal(got, x[:, blk * n:(blk + 1) * n])
                assert got.untyped_storage().nbytes() == got.numel() * 4
                assert tuple(ac.rows(x).whole(got).shape) == tuple(x.shape)


@pytest.mark.parametrize("B,rows_split", [(4, True), (2, True), (1, False)])
def test_train_refuses_a_batch_it_cannot_split(B, rows_split):
    """At data=2 the batch's rows split as make_ac splits them; a batch of
    one row splits its sequence over data instead, as the reference's
    batch spec gives seq the data axis (``DataSeqRows``), and is taken,
    its rules' spec (None, "data"). On a pod=2 x data=2 mesh every one is
    taken, with the rules' own in_shardings too: each rank of the
    trainer holds row 2 pod + data of 4 rows, row data of 2 (the batch
    whole over pod) and the whole row of one, its sequence over data
    (whole over pod). in_shardings may only be the rules' own layout."""
    seq = not rows_split
    from repro_torch.training.loop import _check_layout
    model = t_build(t_tiny("gemma2-2b"))
    tcfg = _tcfg()
    shape = ShapeConfig("t", 64, B, "train")
    ac = shlib.make_ac({"data": 2, "model": 1})
    assert ac.seq_split(B, shape.seq_len) == seq
    _check_layout(model, tcfg, shape, ac, None)
    rules = (shlib.specs_for(tsteps.abstract_train_state(model, tcfg),
                             tsteps.train_state_logical_specs(model, tcfg),
                             ac.mesh),
             shlib.specs_for(model.input_specs(shape),
                             model.batch_logical_specs(shape), ac.mesh))
    assert (tuple(rules[1]["tokens"]) == (None, "data")) == seq
    _check_layout(model, tcfg, shape, ac, rules)
    other = dict(rules[1], tokens=(None, "model"))
    with pytest.raises(NotImplementedError, match="rules' own"):
        _check_layout(model, tcfg, shape, ac, (rules[0], other))
    pod = shlib.make_ac({"pod": 2, "data": 2, "model": 1})
    _check_layout(model, tcfg, shape, pod, None)
    _check_layout(model, tcfg, shape, pod, tuple(
        shlib.specs_for(a, l, pod.mesh) for a, l in (
            (tsteps.abstract_train_state(model, tcfg),
             tsteps.train_state_logical_specs(model, tcfg)),
            (model.input_specs(shape), model.batch_logical_specs(shape)))))
    from repro_torch.launch.mesh import _mesh, dry_world
    batch = tdp.batch_for_model(model, shape, None, 0, full=True)
    with dry_world(4):
        tr = tsh.ShardedTrainer(model, tcfg, shlib.make_ac(
            _mesh(2, 1, "cpu", 60.0, pod=2)))
        for p in range(2):
            for d in range(2):
                tr.ac.coords.update(pod=p, data=d)
                rows, ac = tr.rows(batch)
                want = {4: [2 * p + d], 2: [d], 1: [0]}[B]
                assert torch.equal(rows["tokens"], batch["tokens"][want])
                assert ac.replicated == ((), ("pod",), ("pod",))[
                    [4, 2, 1].index(B)]
                assert ac.whole_batch == seq


REFUSALS = [("gemma2-2b", dict(expert=2, data=1), None, "pod/data/model"),
            ("nemotron-4-15b", dict(data=1, model=3), None, "straddle")]
ACCEPTED = [("gemma2-2b", dict(data=2, model=2), None),
            ("gemma2-2b", dict(data=16, model=4), None),
            # heads (8) and kv heads (4) replicated over model
            ("gemma2-2b", dict(data=1, model=16), None),
            ("gemma2-2b", dict(pod=2, data=1), None),
            # 2 query heads a rank, a kv head sliced for each pair of ranks
            ("granite-3-8b", dict(data=16, model=16), None),
            ("mistral-large-123b", dict(pod=2, data=16, model=16), None),
            ("gemma2-2b", dict(data=2, model=1), "dot"),
            ("granite-moe-3b-a800m", dict(data=1, model=2), None),
            ("mamba2-370m", dict(data=1, model=1), None),
            ("whisper-large-v3", dict(data=1, model=1), "dot"),
            # the families of item 11d (tests/test_torch_train_sharded_
            # families.py trains them on these meshes)
            ("mamba2-370m", dict(data=2, model=1), None),
            ("zamba2-1.2b", dict(data=1, model=2), None),
            ("whisper-large-v3", dict(data=2, model=1), None),
            ("llava-next-mistral-7b", dict(data=1, model=2), None),
            # item 11e: moe over data ranks (tests/test_torch_moe_sharded.py
            # trains it); item 11g: a dot hook under a model split
            # (tests/test_torch_quant_sharded.py)
            ("granite-moe-3b-a800m", dict(data=2, model=1), None),
            ("gemma2-2b", dict(data=1, model=2), "dot"),
            ("granite-moe-3b-a800m", dict(pod=2, model=2), None),
            ("llama4-maverick-400b-a17b", dict(pod=2, data=16, model=16),
             "dot")]


@pytest.mark.parametrize("arch,sizes,dot,match", REFUSALS,
                         ids=[f"{a}-{'-'.join(f'{k}{v}' for k, v in s.items())}"
                              f"{'-dot' if d else ''}"
                              for a, s, d, _ in REFUSALS])
def test_validate_train_mesh_refuses(arch, sizes, dot, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tsh.validate_train_mesh(t_get(arch), sizes)


@pytest.mark.parametrize("arch,sizes,dot", ACCEPTED)
def test_validate_train_mesh_accepts(arch, sizes, dot):
    """Every family and a ``dot`` hook on any mesh of pod, data and model
    whose query heads a rank takes lie in one kv group; the trainer takes
    the hook (``tp_dot``'s ``inner`` at model > 1)."""
    tsh.validate_train_mesh(t_get(arch), sizes)
    if dot and sizes.get("model", 1) > 1:
        from repro_torch.launch.mesh import _mesh, dry_world
        n = math.prod(sizes.values())
        model = t_build(t_tiny(arch))
        with dry_world(n):
            mesh = _mesh(sizes.get("data", 1), sizes["model"], "cpu", 60.0,
                         pod=sizes.get("pod", 1))
            tr = tsh.ShardedTrainer(model, _tcfg(), shlib.make_ac(mesh),
                                    dot=lambda a, w, n: a @ w)
            assert tr.dot is not None


# ------------------------------------------------------ runs on one device --
def _tcfg(**kw):
    optim = OptimConfig(lr=LR, warmup_steps=1, total_steps=10,
                        quantized_moments=kw.pop("quantized", False),
                        moment_block=kw.pop("block", 128))
    return TrainConfig(optim=optim, checkpoint_every=kw.pop("every", 0),
                       log_every=1, **kw)


def _scaled_qk(params):
    out = jax.tree.map(lambda a: a, params)
    for sub in out["blocks"].values():
        for n in ("wq", "wk"):
            a = sub["attn"][n]
            sub["attn"][n] = (a.astype(jnp.float32) * QK_SCALE).astype(
                a.dtype)
    return out


def _ref_state(arch, quantized=False, block=128):
    """The reference's initial state (PRNGKey(0), wq and wk scaled, fp32)
    as numpy, and its config (int8 moments in blocks of ``block``)."""
    jm = j_build(j_tiny(arch))
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     _scaled_qk(jm.init(jax.random.PRNGKey(0))))
    jo = JOptim(lr=LR, warmup_steps=1, total_steps=10,
                quantized_moments=quantized, moment_block=block)
    return jax.tree.map(np.asarray, {"params": p,
                                     "opt": jadam.adamw_init(p, jo)}), jo


def _reference_run(arch, shape=SHAPE):
    """The reference's jitted make_train_step, STEPS steps in fp32 (the
    parameters set to the master after each), and its first step's
    gradients."""
    jm = j_build(j_tiny(arch))
    np_state, jo = _ref_state(arch)
    state = jax.tree.map(jnp.asarray, np_state)
    step = jax.jit(jsteps.make_train_step(jm, JTrain(optim=jo)))
    b0 = jdp.batch_for_model(jm, shape, None, 0)
    _, g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b0, remat=True)))(state["params"])
    out = {"grads": [np.asarray(x, np.float32) for x in jax.tree.leaves(g)],
           "steps": []}
    for k in range(STEPS):
        state, met = step(state, jdp.batch_for_model(jm, shape, None, k))
        state = {"params": state["opt"]["master"], "opt": state["opt"]}
        out["steps"].append(({n: float(v) for n, v in met.items()}, [
            np.asarray(x, np.float32)
            for x in jax.tree.leaves(state["opt"]["master"])]))
    return out


def _port_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss(params, batch, remat=True)
    g = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return [x.float().numpy() for x in g]


def _run_steps(step_fn, state, fp32, batch_of, whole_of=lambda s: s,
               steps=STEPS):
    """``steps`` steps; each: (metrics, the whole state's masters
    (numpy)); and the whole state's moments after the first step."""
    out, first = [], None
    for k in range(steps):
        state, met = step_fn(state, batch_of(k))
        if fp32:
            state["params"] = tree_map(lambda a: a.clone(),
                                       state["opt"]["master"])
        whole = whole_of(state)
        out.append(({n: float(v) for n, v in met.items()},
                    None if whole is None else [
                        x.float().clone().numpy()
                        for x in tree_leaves(whole["opt"]["master"])]))
        if k == 0 and whole is not None:
            first = [x.clone().numpy() for x in tree_leaves(
                {"m": whole["opt"]["m"], "v": whole["opt"]["v"]})]
    return out, first


def _one_device(arch, case, microbatches=1, shape=SHAPE):
    """The port's one-device run of a case (see ``_case``), the batch cut
    into ``microbatches``."""
    model = t_build(t_tiny(arch))
    tcfg, state, fp32 = _case_setup(model, case)
    tcfg = dataclasses.replace(tcfg, microbatches=microbatches)
    b0 = tdp.batch_for_model(model, shape, None, 0, full=True)
    grads = _port_grads(model, state["params"], b0)
    steps, first = _run_steps(
        tsteps.make_train_step(model, tcfg), state, fp32,
        lambda k: tdp.batch_for_model(model, shape, None, k, full=True),
        steps=1 if case.startswith("quant") else STEPS)
    return {"grads": grads, "steps": steps, "moments": first}


def _case_setup(model, case):
    """(train config, whole initial state, fp32 mode) of a case: "fp32"
    and "quant" from the reference's state, "bf16" from the port's
    initialisation."""
    arch = model.cfg.name[:-len("-tiny")]
    quantized = case.startswith("quant")
    block = 256 if case == "quant256" else 128
    tcfg = _tcfg(quantized=quantized, block=block)
    if case == "bf16":
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        for sub in params["blocks"].values():
            for n in ("wq", "wk"):
                sub["attn"][n] = (sub["attn"][n].float() * QK_SCALE).to(
                    sub["attn"][n].dtype)
        return tcfg, {"params": params,
                      "opt": tadam.adamw_init(params, tcfg.optim)}, False
    np_state, _ = _ref_state(arch, quantized, block)
    return tcfg, from_jax_state(np_state), True


# ------------------------------------------------------------ the worlds --
def _case(trainer_of, model, case, rank, shape=SHAPE, steps=None,
          by_rows=False):
    """A case through the sharded trainer: the first step's loss and
    gradients (whole) and ``steps`` steps' metrics (every rank) and
    masters (whole, rank 0; STEPS, one for int8 moments). The first loss
    and gradients are those of the rows and layout the step's ``rows``
    gives this rank; in M > 1 microbatches, of its rows of the whole
    batch taken as one microbatch (the one-device runs' first
    gradients), or with ``by_rows`` of its rows of every microbatch under
    the layout of one."""
    tcfg, state, fp32 = _case_setup(model, case)
    tr = trainer_of(tcfg)
    st = tr.shard(state, tr.specs)
    shapes_ok = all(tuple(x.shape) == shlib.local_shape(
        tuple(a.shape), s, tr.sizes) for x, a, s in zip(
        tree_leaves(st), tree_leaves(tr.abstract), tr.leaf_specs()))
    b0 = tdp.batch_for_model(model, shape, None, 0, full=True)
    rows = tr.rows(b0) if by_rows or tr.tcfg.microbatches == 1 else (
        {k: tr.ac(v, "batch") for k, v in b0.items()}, tr.ac)
    loss, g = tr.grads(st["params"], *rows)
    grads = [tr.whole(x, s).float().numpy()
             for x, s in zip(tree_leaves(g), tr.param_specs)]
    rest = sum(x.numel() * x.element_size() for x in tree_leaves(st))
    if steps is None:
        steps = 1 if case.startswith("quant") else STEPS
    steps, first = _run_steps(
        tr.step, st, fp32,
        lambda k: tdp.batch_for_model(model, shape, None, k, full=True),
        tr.host_state, steps=steps)
    return {"loss": float(loss), "grads": grads,
            "steps": steps if rank == 0 else None,
            "metrics": [m for m, _ in steps],
            "moments": first, "shapes_ok": shapes_ok, "bytes": rest,
            "data_split": [any("data" in (e if isinstance(e, tuple) else (e,))
                               for e in s if e is not None)
                           for s in tr.param_specs]}


def _control(trainer_of, model, name, rank, shape=SHAPE):
    """The fp32 case's first gradients with one collective taken out:
    "no_tp" (the input-side all-reduce of the tensor-parallel pair),
    "drop" (the other data ranks' gradients dropped: from the
    reduce-scatter of a leaf split over data, and from the post-backward
    sum of one that is not), "no_kv_sum" (a sliced wk/wv's gradient not
    summed over model) or "no_kv_input" (the k/v projections' input not
    passing sum_grad, the q projection's still)."""
    saved = shlib.sum_grad, shlib.reduce_scatter_dim, shlib.kv_slice
    make = trainer_of
    if name == "no_tp":
        shlib.sum_grad = lambda x, group: x
    elif name == "no_kv_sum":
        shlib.kv_slice = lambda w, group, lo, hi: w[:, lo:hi]
    elif name == "no_kv_input":
        def make(tcfg):
            tr = trainer_of(tcfg)
            inner, group = tr.dot, tr.groups["model"]
            span = shlib.kv_span(model.cfg, tr.sizes["model"],
                                 tr.coords["model"])

            def dot(a, w, site):
                if site in ("attn_k", "attn_v"):
                    return t_attn._proj_in(
                        a, shlib.kv_slice(w, group, *span), site)
                return inner(a, w, site)
            tr.dot = dot
            return tr
    else:
        def own_only(x, dim, group):
            n = x.shape[dim] // torch.distributed.get_world_size(group)
            me = torch.distributed.get_rank(group)
            return x.narrow(dim, me * n, n).float()
        shlib.reduce_scatter_dim = own_only

        def make(tcfg):
            tr = trainer_of(tcfg)
            tr.sum_over_data = lambda g: g
            return tr
    try:
        return _case(make, model, "fp32", rank, shape)["grads"]
    finally:
        shlib.sum_grad, shlib.reduce_scatter_dim, shlib.kv_slice = saved


def _seq_probe(trainer_of, model, shape):
    """One fp32 forward and loss of the first batch through the trainer's
    hooks (no gradient): the shapes of the residual each dense block
    takes on this rank, the rows the unembedding scores, and the final
    hidden rows."""
    tcfg, state, _ = _case_setup(model, "fp32")
    tr = trainer_of(tcfg)
    st = tr.shard(state, tr.specs)
    seen = {"resid": set(), "unembed": 0}
    fwd, ce = t_tr._dense_block_fwd, t_tr._chunk_ce

    def block(p, x, *a, **k):
        seen["resid"].add(tuple(x.shape))
        return fwd(p, x, *a, **k)

    def chunk(w, xc, *a):
        seen["unembed"] += xc.shape[1]
        return ce(w, xc, *a)
    t_tr._dense_block_fwd, t_tr._chunk_ce = block, chunk
    rows, ac = tr.rows(tdp.batch_for_model(model, shape, None, 0,
                                           full=True))
    hooks = dict(gather=tr.gather, ranks=tr.ranks, ac=ac,
                 dot=tr.dot)
    try:
        with torch.no_grad():
            hidden = model.forward(st["params"], rows, unembed_mode="none",
                                   **hooks)[0]
            model.loss(st["params"], rows, **hooks)
    finally:
        t_tr._dense_block_fwd, t_tr._chunk_ce = fwd, ce
    return {"resid": sorted(seen["resid"]), "unembed": seen["unembed"],
            "hidden": hidden.numpy()}


def _ckpt_cases(mesh, model, ckpt_dir):
    """6 steps in one run against 3, a checkpoint, a restore on the same
    mesh and 3 more; the state after step 2 (whole, rank 0)."""
    quiet = dict(mesh=mesh, log=lambda r: None)
    whole = train(model, SHAPE, _tcfg(checkpoint_dir=f"{ckpt_dir}/a"),
                  num_steps=6, **quiet)
    first = train(model, SHAPE, _tcfg(checkpoint_dir=f"{ckpt_dir}/b",
                                      every=3), num_steps=3, **quiet)
    layout = tsh.StateLayout(model, _tcfg(), mesh)
    at2 = layout.host_state(first["state"])
    rest = train(model, SHAPE, _tcfg(checkpoint_dir=f"{ckpt_dir}/b",
                                     every=3), num_steps=6, **quiet)
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(layout.host_state(whole["state"]) or {}),
        tree_leaves(layout.host_state(rest["state"]) or {}))]
    return {"losses": [r["loss"] for r in whole["history"]][3:],
            "resumed": [r["loss"] for r in rest["history"]],
            "steps": [r["step"] for r in rest["history"]],
            "same": same, "at2": at2}


def _world1(model, ckpt_dir):
    """train(mesh=<a world of one>) against train(), both on rank 0."""
    from repro_torch.launch.mesh import make_sub_mesh
    sub = make_sub_mesh(1, 1, device_type="cpu")
    if sub is None:
        return None
    quiet = dict(log=lambda r: None, num_steps=STEPS)
    tcfg = _tcfg(checkpoint_dir=f"{ckpt_dir}/none")
    a = train(model, SHAPE, tcfg, mesh=sub, **quiet)
    b = train(model, SHAPE, tcfg, device="cpu", **quiet)
    return {"hist": [(r["loss"], r["grad_norm"]) for r in a["history"]],
            "want": [(r["loss"], r["grad_norm"]) for r in b["history"]],
            "same": [torch.equal(x, y) for x, y in zip(
                tree_leaves(a["state"]), tree_leaves(b["state"]))]}


def _reshard(mesh, model, ckpt_dir):
    """model=2 -> data=2 -> one device: every leaf, at each stage, the
    block of the whole state that the new mesh gives this rank."""
    from repro_torch.distributed.fault_tolerance import reshard_state
    from repro_torch.launch.mesh import make_serving_mesh, make_sub_mesh
    tcfg = _tcfg(checkpoint_dir=f"{ckpt_dir}/none")
    out = train(model, SHAPE, tcfg, mesh=mesh, num_steps=2,
                log=lambda r: None)
    old = tsh.StateLayout(model, tcfg, mesh)
    whole = [old.whole(x, s) for x, s in zip(tree_leaves(out["state"]),
                                             old.leaf_specs())]
    data2 = make_serving_mesh(model=1, data=2, device_type="cpu")
    new = tsh.StateLayout(model, tcfg, data2)
    st = reshard_state(out["state"], model, tcfg, data2, old_mesh=mesh)
    at_data2 = [torch.equal(x, shlib.local_block(w, s, new.sizes,
                                                 new.coords))
                for x, w, s in zip(tree_leaves(st), whole,
                                   new.leaf_specs())]
    one = make_sub_mesh(1, 1, device_type="cpu")
    st1 = reshard_state(st, model, tcfg, one, old_mesh=data2, donate=True)
    at_one = None if st1 is None else [
        torch.equal(x, w) for x, w in zip(tree_leaves(st1), whole)]
    return {"data2": at_data2, "one": at_one,
            "donated": all(x is None for x in tree_leaves(st))}


def _world(rank, world, device, data, tp, cases, ckpt_dir, shape=SHAPE,
           pod=1):
    """A rank of a test world: the ("data", "model") mesh (with a leading
    "pod" dim when ``pod`` > 1) and every case in ``cases`` (the training
    cases at ``shape``)."""
    from repro_torch.launch.mesh import _mesh, make_serving_mesh
    mesh = make_serving_mesh(model=tp, data=data, device_type="cpu",
                             backend="gloo") if pod == 1 else \
        _mesh(data, tp, "cpu", WORLD_S, pod=pod)
    ac = shlib.make_ac(mesh)
    out = {}
    for case in cases:
        arch = "granite-moe-3b-a800m" if case == "moe" else "gemma2-2b"
        model = t_build(t_tiny(arch))

        def trainer_of(tcfg, model=model):
            return tsh.ShardedTrainer(model, tcfg, ac)
        if case in ("fp32", "bf16", "quant", "quant256"):
            out[case] = _case(trainer_of, model, case, rank, shape)
        elif case == "moe":
            out[case] = _case(trainer_of, model, "fp32", rank)
        elif case in ("seq_tp", "seq_tp_nosum"):
            def seq_trainer(tcfg, model=model):
                return tsh.ShardedTrainer(model, tcfg,
                                          shlib.make_ac(mesh, "seq_tp"))
            if case == "seq_tp":
                out[case] = _case(seq_trainer, model, "fp32", rank, shape)
                continue
            # the control: the norm scales' gradient not summed over model
            norm = shlib.SplitRows.norm
            shlib.SplitRows.norm = \
                lambda self, x, scale, eps: t_layers.rms_norm(x, scale, eps)
            try:
                out[case] = _case(seq_trainer, model, "fp32", rank, shape,
                                  steps=0)
            finally:
                shlib.SplitRows.norm = norm
        elif case.startswith("seq_") and case not in ("seq_tp",
                                                         "seq_tp_nosum"):
            out[case] = _seq_world_case(case, mesh, trainer_of, model, rank)
        elif case.startswith("held_"):
            out[case] = _held_case(case, trainer_of, model, rank)
        elif case in ("no_tp", "drop", "no_kv_sum", "no_kv_input"):
            out[case] = _control(trainer_of, model, case, rank, shape)
        elif case == "ckpt":
            out[case] = _ckpt_cases(mesh, model, ckpt_dir)
        elif case == "world1":
            out[case] = _world1(model, ckpt_dir)
        elif case == "restore":
            layout = tsh.StateLayout(model, _tcfg(), mesh)
            st, step = layout.restore(f"{ckpt_dir}/b", 2)
            out[case] = layout.host_state(st)
        elif case == "reshard":
            out[case] = _reshard(mesh, model, ckpt_dir)
    return out


def _seq_world_case(case, mesh, trainer_of, model, rank):
    """A case of a batch whose sequence splits over data: "seq_fp32" (B 1,
    with ``_seq_probe``), "seq_b3" (B 3), "seq_micro" (B 2 in two
    microbatches of one row), "seq_bf16" (B 1), "seq_tp_b1" (B 1 under
    make_ac(mesh, "seq_tp"), one step) and "seq_cut" (the control:
    ``DataSeqRows.whole``'s backward a cut, the ranks' input gradients
    not reduce-scattered; first gradients only)."""
    if case == "seq_fp32":
        return dict(_case(trainer_of, model, "fp32", rank, SHAPE_B1),
                    probe=_seq_probe(trainer_of, model, SHAPE_B1))
    if case == "seq_b3":
        return _case(trainer_of, model, "fp32", rank, SHAPE_B3)
    if case == "seq_micro":
        def micro(tcfg):
            return trainer_of(dataclasses.replace(tcfg, microbatches=2))
        return _case(micro, model, "fp32", rank, SHAPE_B2)
    if case == "seq_bf16":
        return _case(trainer_of, model, "bf16", rank, SHAPE_B1)
    if case == "seq_tp_b1":
        def seq_trainer(tcfg):
            return tsh.ShardedTrainer(model, tcfg,
                                      shlib.make_ac(mesh, "seq_tp"))
        return _case(seq_trainer, model, "fp32", rank, SHAPE_B1, steps=1)
    assert case == "seq_cut"
    whole = shlib.DataSeqRows.whole
    shlib.DataSeqRows.whole = lambda self, x: x \
        if x.shape[1] == self.length \
        else shlib.gather_shard(x, 1, self.group, reduce=False)
    try:
        return _case(trainer_of, model, "fp32", rank, SHAPE_B1,
                     steps=0)["grads"]
    finally:
        shlib.DataSeqRows.whole = whole


def _held_case(case, trainer_of, model, rank):
    """A (micro)batch that an FSDP axis holds whole (``HELD``), fp32:
    ``STEPS`` steps; with "_first", the first loss and gradients alone;
    with "_sum", those of the control, whose backward over the axes that
    hold the batch whole is the reduce-scatter and the post-backward sum
    of an axis that splits it."""
    name = case.removesuffix("_first").removesuffix("_sum")
    shape, micro = HELD[name]

    def held_trainer(tcfg):
        tr = trainer_of(dataclasses.replace(tcfg, microbatches=micro))
        if case.endswith("_sum"):
            gather, unsplit = tr.gather, tr.sum_unsplit
            tr.gather = lambda tree, path, replicated=(): gather(tree, path)
            tr.sum_unsplit = lambda g, spec, replicated=(): unsplit(g, spec)
        return tr
    return _case(held_trainer, model, "fp32", rank, shape,
                 steps=0 if case != name else None, by_rows=True)


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def world_data2(ckpt_root):
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(2, 1, ("fp32", "bf16", "drop", "ckpt", "world1",
                              "seq_fp32", "seq_b3", "seq_micro", "seq_bf16",
                              "seq_cut", "held_b2_first", "held_m2_first"),
                       ckpt_root))


@pytest.fixture(scope="module")
def world_model2(ckpt_root, world_data2):
    return spawn(_world, 2, backend="gloo", timeout_s=WORLD_S,
                 args=(1, 2, ("fp32", "bf16", "moe", "quant", "no_tp",
                              "quant256", "restore", "reshard", "seq_tp",
                              "seq_tp_nosum"),
                       ckpt_root))


@pytest.fixture(scope="module")
def world4():
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(2, 2, ("fp32", "bf16", "seq_tp", "seq_tp_nosum",
                              "seq_fp32", "seq_tp_b1"), ""))


@pytest.fixture(scope="module")
def world_model4():
    """Tiny gemma2-2b's 4 query heads split over model=4, its 2 kv heads
    not: each rank projects the one kv head of its query head."""
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(1, 4, ("fp32", "bf16", "no_kv_sum", "no_kv_input"),
                       ""))


@pytest.fixture(scope="module")
def world_model8():
    """model=8: neither the 4 query heads nor the 2 kv heads divide it,
    so every rank computes the whole attention."""
    return spawn(_world, 8, backend="gloo", timeout_s=WORLD_S,
                 args=(1, 8, ("fp32", "bf16"), ""))


@pytest.fixture(scope="module")
def world_pod():
    """pod=2 x data=2 (world 4): the FSDP dims split over ("pod", "data"),
    the batch's 4 rows one a rank; and the batches held whole over pod
    (``HELD``) with the control."""
    return spawn(_world, 4, backend="gloo", timeout_s=WORLD_S,
                 args=(2, 1, ("fp32", "held_b2", "held_m2", "held_b1",
                              "held_odd", "held_b2_sum"), "", SHAPE, 2))


@pytest.fixture(scope="module")
def world_data3():
    return spawn(_world, 3, backend="gloo", timeout_s=WORLD_S,
                 args=(3, 1, ("fp32", "drop", "held_b2", "held_b2_sum"), "",
                       SHAPE3))


@pytest.fixture(scope="module")
def reference():
    return {arch: _reference_run(arch)
            for arch in ("gemma2-2b", "granite-moe-3b-a800m")}


@pytest.fixture(scope="module")
def one_device():
    return {("gemma2-2b", c): _one_device("gemma2-2b", c)
            for c in ("fp32", "bf16", "quant", "quant256")} | {
        ("granite-moe-3b-a800m", "fp32"): _one_device(
            "granite-moe-3b-a800m", "fp32"),
        ("gemma2-2b", "bf16", 2): _one_device("gemma2-2b", "bf16", 2)}


@pytest.fixture(scope="module")
def at_shape3():
    """The reference's and the one-device port's fp32 runs at SHAPE3."""
    return {"reference": _reference_run("gemma2-2b", SHAPE3),
            "one_device": _one_device("gemma2-2b", "fp32", shape=SHAPE3)}


def _grad_err(want, got):
    return max(float(np.abs(w - g).max() / max(np.abs(w).max(), 1e-30))
               for w, g in zip(want, got))


def _check_fp32(got, want, steps=STEPS):
    """The fp32 rules of the module docstring, step by step."""
    assert _grad_err(want["grads"], got["grads"]) <= GRAD_TOL
    for (gm, gmast), (wm, wmast) in zip(got["steps"][:steps],
                                        want["steps"][:steps]):
        for k in ("loss", "grad_norm"):
            assert abs(gm[k] - wm[k]) <= LOSS_RTOL * abs(wm[k]), k
        d = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(gmast, wmast)])
        assert d.max() <= 2 * LR * (1 + 1e-3)
        assert np.mean(d > 1e-3 * LR) <= 1e-3


def _distances(got, want):
    """Per step: (loss rel, grad norm rel, masters' max |diff|, share of
    masters past 1e-3 lr)."""
    out = []
    for (gm, gmast), (wm, wmast) in zip(got["steps"], want["steps"]):
        d = np.concatenate([np.abs(a - b).ravel()
                            for a, b in zip(gmast, wmast)])
        out.append((abs(gm["loss"] - wm["loss"]) / wm["loss"],
                    abs(gm["grad_norm"] - wm["grad_norm"]) / wm["grad_norm"],
                    d.max(), np.mean(d > 1e-3 * LR)))
    return out


def _check_bf16(got, want, control=None):
    """The bf16 rules; with ``control``, each distance may also reach twice
    the control's distance from ``want``."""
    ctrl = _distances(control, want) if control else [(0.0,) * 4] * STEPS
    lr_sum = 0.0
    for k, ((el, en, dmax, frac), (cl, cn, _, cf)) in enumerate(zip(
            _distances(got, want), ctrl)):
        assert el <= max(BF16_LOSS_RTOL, 2 * cl)
        assert en <= max(BF16_NORM_RTOL, 2 * cn)
        lr_sum += want["steps"][k][0]["lr"]
        assert dmax <= 2 * lr_sum * (1 + 1e-3)
        if k == 0:
            assert frac <= max(0.05, 2 * cf)


WORLDS = {"data2": "world_data2", "model2": "world_model2",
          "world4": "world4", "model4": "world_model4",
          "model8": "world_model8"}


@pytest.mark.parametrize("name", list(WORLDS))
def test_fp32_steps_match_reference_and_one_device(name, request,
                                                   reference, one_device):
    """Three fp32 steps of tiny gemma2-2b on the mesh against the
    reference's jitted step and the one-device port; every rank's first
    gradients alike and its leaves of their at-rest shapes."""
    ranks = request.getfixturevalue(WORLDS[name])
    got = ranks[0]["fp32"]
    _check_fp32(got, reference["gemma2-2b"])
    _check_fp32(got, one_device["gemma2-2b", "fp32"])
    for r in ranks:
        assert r["fp32"]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(r["fp32"]["grads"],
                                                        got["grads"]))


@pytest.mark.parametrize("name", list(WORLDS))
def test_bf16_steps_match_one_device(name, request, one_device):
    """The trainer as train() runs it (bf16 weights after each update)
    against the one-device port with the rows cut as the mesh cuts them
    (microbatches = the data size), under the bf16 rules; where the mesh
    splits the batch, against the plain one-device run too, within the
    rules or twice the microbatched run's distance from it."""
    ranks = request.getfixturevalue(WORLDS[name])
    got = ranks[0]["bf16"]
    plain = one_device["gemma2-2b", "bf16"]
    if name in ("model2", "model4", "model8"):
        _check_bf16(got, plain)
    else:
        split = one_device["gemma2-2b", "bf16", 2]
        _check_bf16(got, split)
        _check_bf16(got, plain, control=split)


def test_moe_at_model2_matches_reference(world_model2, reference,
                                         one_device):
    got = world_model2[0]["moe"]
    _check_fp32(got, reference["granite-moe-3b-a800m"])
    _check_fp32(got, one_device["granite-moe-3b-a800m", "fp32"])


def test_quantized_moments_at_model2(world_model2, one_device):
    """int8 moments at model=2: the first step under the fp32 rules and
    its codes within one of the one-device port's, the scales within
    1e-5. d_ff's blocks of 128 divide its shard of 128; blocks of 256
    straddle the two ranks' shards, each block's max taken over both."""
    for case in ("quant", "quant256"):
        got, want = world_model2[0][case], one_device["gemma2-2b", case]
        _check_fp32(got, want, steps=1)
        n = len(got["moments"])
        assert n == len(want["moments"]) == 4 * len(tree_leaves(
            t_build(t_tiny("gemma2-2b")).abstract_params()))
        codes = np.concatenate([
            np.abs(a.astype(np.int32) - b.astype(np.int32)).ravel()
            for a, b in zip(got["moments"], want["moments"])
            if a.dtype == np.int8])
        assert codes.max() <= 1 and np.mean(codes > 0) <= 1e-3, case
        for a, b in zip(got["moments"], want["moments"]):
            if a.dtype != np.int8:
                np.testing.assert_allclose(a, b, rtol=1e-5)


@pytest.mark.parametrize("block", [128, 256])
def test_moment_scale_views_at_model2(block):
    """The update reads a split int8 moment through one scale a run of
    gcd(block, columns) columns: a view of the scales at rest where the
    runs are whole blocks (no bytes of its own), one scale a run where
    blocks straddle the ranks; dequantized, the moment is the one a scale
    a column gives. ``quantize_moment`` given its own blocks' max is
    itself, bit for bit."""
    from repro_torch.launch.mesh import _mesh, dry_world
    model = t_build(t_tiny("gemma2-2b"))
    g = np.random.default_rng(7)
    with dry_world(2):
        tr = tsh.ShardedTrainer(
            model, _tcfg(quantized=True, block=block),
            shlib.make_ac(_mesh(1, 2, "cpu", 60.0)))
        state = tr.init_state(torch.Generator().manual_seed(0))
        split = tr._quantized(state["opt"])
        assert split
        runs = set()
        for i, mom in split:
            b, r, start, local = tr._runs(i)
            runs.add(r == b)
            mom["scale"].copy_(torch.from_numpy(
                g.random(tuple(mom["scale"].shape), dtype=np.float32)))
            view = tr._scale_view(i, mom["scale"])
            assert view.shape[-1] == local // r
            if r == b:
                assert view.data_ptr() == mom["scale"].data_ptr() \
                    + start // b * view.element_size()
            cols = (start + torch.arange(local)) // b
            q = torch.from_numpy(g.integers(
                -127, 128, tuple(mom["q"].shape), dtype=np.int8))
            assert torch.equal(
                tadam.dequantize_moment({"q": q, "scale": view}, q.shape),
                q.float() * mom["scale"][..., cols])
        assert runs == {block == 128}     # 128 columns a rank
    x = torch.from_numpy(g.standard_normal((3, 512), dtype=np.float32))
    own = x.abs().reshape(3, 512 // block, block).amax(-1)
    for k, v in tadam.quantize_moment(x, block, amax=own).items():
        assert torch.equal(v, tadam.quantize_moment(x, block)[k])


def test_data3_unsplit_leaves_match_reference(world_data3, at_shape3):
    """At data=3 no leaf of tiny gemma2-2b splits over data (d 128), so
    every gradient is summed over data after the backward and every leaf
    counts in the global norm on one rank of the three: three fp32 steps
    against the reference's jitted step and the one-device port."""
    got = world_data3[0]["fp32"]
    assert not any(got["data_split"])
    _check_fp32(got, at_shape3["reference"])
    _check_fp32(got, at_shape3["one_device"])
    for r in world_data3:
        assert r["fp32"]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(r["fp32"]["grads"],
                                                        got["grads"]))


@pytest.mark.parametrize("name,world", [("no_tp", "world_model2"),
                                        ("drop", "world_data2"),
                                        ("drop", "world_data3"),
                                        ("no_kv_sum", "world_model4"),
                                        ("no_kv_input", "world_model4")])
def test_controls_miss(name, world, request, one_device):
    """Without the tensor-parallel input all-reduce, or with the other
    data ranks' gradients dropped (from the reduce-scatter at data=2,
    where every leaf splits over data, and from the post-backward sum at
    data=3, where none does), or at model=4 without the sum over model of
    the sliced wk/wv's gradient or of the k/v projections' input
    gradient, the first gradients miss the tolerance."""
    ranks = request.getfixturevalue(world)
    want = request.getfixturevalue("at_shape3")["one_device"]["grads"] \
        if world == "world_data3" else one_device["gemma2-2b", "fp32"]["grads"]
    assert _grad_err(want, ranks[0]["fp32"]["grads"]) <= GRAD_TOL
    assert _grad_err(want, ranks[0][name]) > 100 * GRAD_TOL


def test_pod_axis_matches_reference_and_one_device(world_pod, reference,
                                                  one_device):
    """pod=2 x data=2: the embed dims split over both axes (gathered over
    data, then pod), the batch over both; three fp32 steps against the
    reference's jitted step and the one-device port."""
    got = world_pod[0]["fp32"]
    assert all(got["data_split"])
    _check_fp32(got, reference["gemma2-2b"])
    _check_fp32(got, one_device["gemma2-2b", "fp32"])
    for r in world_pod:
        assert r["fp32"]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(r["fp32"]["grads"],
                                                        got["grads"]))


def test_data2_rank_holds_half_the_state(world_data2):
    """At data=2 every leaf of tiny gemma2-2b splits (d 128), so a rank
    holds half the state's bytes at rest, the step count aside."""
    model = t_build(t_tiny("gemma2-2b"))
    whole = sum(math.prod(a.shape) * a.element_size() for a in tree_leaves(
        tsteps.abstract_train_state(model, _tcfg())))
    for r in world_data2:
        assert r["bf16"]["bytes"] - 4 == (whole - 4) // 2


def test_world_of_one_is_the_unsharded_trainer(world_data2):
    got = world_data2[0]["world1"]
    assert got["hist"] == got["want"]
    assert got["same"] and all(got["same"])
    assert world_data2[1]["world1"] is None


def test_checkpoint_resume_on_the_mesh(world_data2):
    """3 steps, a checkpoint, a restore on the same mesh and 3 more equal
    6 steps, bit for bit (losses and every leaf)."""
    for r in world_data2:
        c = r["ckpt"]
        assert c["steps"] == [3, 4, 5]
        assert c["resumed"] == c["losses"]
    assert all(world_data2[0]["ckpt"]["same"])


def test_checkpoint_restores_on_other_meshes(world_data2, world_model2,
                                             ckpt_root):
    """The data=2 checkpoint of step 2 restores on one device and on
    model=2, every leaf bit-equal to the data=2 state."""
    want = world_data2[0]["ckpt"]["at2"]
    model = t_build(t_tiny("gemma2-2b"))
    like = tsteps.init_train_state(model, _tcfg(),
                                   torch.Generator().manual_seed(1), "cpu")
    one, step = restore(f"{ckpt_root}/b", like, 2)
    assert step == 2
    for got in (one, world_model2[0]["restore"]):
        for a, b in zip(tree_leaves(want), tree_leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_reshard_state_model2_data2_one_device(world_model2):
    """Every leaf bit-equal to the whole state's block at each stage; the
    donated state is emptied on every rank."""
    for rank, r in enumerate(world_model2):
        assert r["reshard"]["data2"] and all(r["reshard"]["data2"])
        assert r["reshard"]["donated"]
        if rank == 0:
            assert r["reshard"]["one"] and all(r["reshard"]["one"])
        else:
            assert r["reshard"]["one"] is None


# --------------------------------------------------------------- seq_tp --
# the norm scales: the one gradient seq_tp sums in another order
NORM_KEYS = ("ln1", "ln2", "ln1_post", "ln2_post", "ln_x", "mamba_ln",
             "final_norm", "enc_norm")
SEQ_TP_WORLDS = {"model2": (1, 2), "world4": (2, 2)}

SEQ_TP_REF = """
import pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
jax.devices()                     # 4 forced host devices, before the
from jax.sharding import Mesh     # dry-run module's own device flag
import repro.launch.dryrun as rd
from repro.configs import tiny_config
from repro.configs.base import OptimConfig, ShapeConfig, TrainConfig
from repro.data import pipeline as jdp
from repro.distributed import sharding as j_sh
from repro.models.api import build_model
with open(sys.argv[2], "rb") as f:
    state0 = pickle.load(f)
model = build_model(tiny_config("gemma2-2b"))
tcfg = TrainConfig(optim=OptimConfig(lr={LR}, warmup_steps=1,
                                     total_steps=10))
out = {{}}
for pod, data, tp, B, mode, key in {RUNS!r}:
    shape = ShapeConfig("t", {S}, B, "train")
    devs = np.asarray(jax.devices()[:pod * data * tp])
    mesh = Mesh(devs.reshape(pod, data, tp), ("pod", "data", "model")) \
        if pod > 1 else Mesh(devs.reshape(data, tp), ("data", "model"))
    ac = j_sh.make_ac(mesh, mode)
    step, args, ins, outs, don, _ = rd.build_step(model, shape, mesh, tcfg,
                                                  ac_mode=mode)
    state = jax.tree.map(jnp.asarray, state0)
    b0 = jdp.batch_for_model(model, shape, None, 0)
    with mesh:
        gf = jax.jit(jax.grad(lambda p, b: model.loss(p, b, remat=True,
                                                      ac=ac)),
                     in_shardings=(ins[0]["params"], ins[1]))
        g = gf(state["params"], b0)
        f = jax.jit(step, in_shardings=ins, out_shardings=outs)
        steps, norm64 = [], []
        for k in range({STEPS}):
            bk = jdp.batch_for_model(model, shape, None, k)
            norm64.append(float(np.sqrt(sum(
                np.sum(np.square(np.asarray(x, np.float64)))
                for x in jax.tree.leaves(gf(state["params"], bk))))))
            state, met = f(state, bk)
            state = {{"params": jax.device_put(state["opt"]["master"],
                                              ins[0]["params"]),
                     "opt": state["opt"]}}
            steps.append(({{n: float(v) for n, v in met.items()}}, [
                np.asarray(x, np.float32)
                for x in jax.tree.leaves(state["opt"]["master"])]))
    out[key] = {{"grads": [np.asarray(x, np.float32)
                           for x in jax.tree.leaves(g)],
                 "steps": steps, "norm64": norm64}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_seq_tp(tmp_path_factory):
    """The reference's jitted make_train_step under make_ac(mesh,
    "seq_tp"), with build_step's shardings, on 4 forced host devices at
    model=2 and data=2 x model=2, and under dp at data=2 on a batch of
    one row (its spec splits the sequence over data: key "data2_b1") and
    at pod=2 x data=2 x model=1 on batches that pod holds whole (keys
    "held_b2": the rows over data; "held_b1": the sequence over data), in
    a subprocess: the first gradients (the batch given its in_shardings
    too), STEPS fp32 steps from ``_ref_state`` and, before each, the
    float64 norm of the gradients at the step's state ("norm64")."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path
    tmp = tmp_path_factory.mktemp("seq_tp_ref")
    path, inputs = tmp / "ref.pkl", tmp / "state.pkl"
    with open(inputs, "wb") as f:
        pickle.dump(_ref_state("gemma2-2b")[0], f)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=4", JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"))
    runs = [(1, d, t, SHAPE.global_batch, "seq_tp", (d, t))
            for d, t in SEQ_TP_WORLDS.values()] + [
        (1, 2, 1, SHAPE_B1.global_batch, "dp", "data2_b1")] + [
        (2, 2, 1, HELD[k][0].global_batch, "dp", k)
        for k in ("held_b2", "held_b1")]
    script = SEQ_TP_REF.format(S=SHAPE.seq_len, LR=LR, STEPS=STEPS,
                               RUNS=runs)
    r = subprocess.run([sys.executable, "-c", script, str(path),
                        str(inputs)], env=env, capture_output=True,
                       text=True, timeout=400, cwd=str(root))
    assert r.returncode == 0, r.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _norm_paths():
    return [p[-1] in NORM_KEYS for p in shlib.leaf_paths(
        t_build(t_tiny("gemma2-2b")).abstract_params())]


@pytest.mark.parametrize("name", list(SEQ_TP_WORLDS))
def test_seq_tp_is_dp_but_the_norm_scales(name, request):
    """make_ac(mesh, "seq_tp") against dp on the same mesh, state and
    batch (fp32): the first loss bit-identical, every gradient leaf but
    the norm scales bit-identical, the norm scales (each rank's rows'
    share summed over model) within GRAD_TOL of each leaf's max |g|; the
    control without that sum misses it by over 100x."""
    norms = _norm_paths()
    assert any(norms)
    for r in request.getfixturevalue(WORLDS[name]):
        dp, seq, ctrl = r["fp32"], r["seq_tp"], r["seq_tp_nosum"]
        assert seq["loss"] == dp["loss"] == ctrl["loss"]
        if r["fp32"]["steps"] is not None:
            assert seq["steps"][0][0]["loss"] == dp["steps"][0][0]["loss"]
        for norm, a, b in zip(norms, dp["grads"], seq["grads"]):
            if norm:
                assert _grad_err([a], [b]) <= GRAD_TOL
            else:
                assert np.array_equal(a, b)
        miss = max(_grad_err([a], [c]) for norm, a, c in zip(
            norms, dp["grads"], ctrl["grads"]) if norm)
        assert miss > 100 * GRAD_TOL


@pytest.mark.parametrize("name", list(SEQ_TP_WORLDS))
def test_seq_tp_steps_match_dp_one_device_and_reference(
        name, request, one_device, reference_seq_tp):
    """Three fp32 seq_tp steps under the fp32 rules against the dp steps
    of the same world, the one-device port and the reference's jitted
    seq_tp step on as many forced devices."""
    got = request.getfixturevalue(WORLDS[name])[0]["seq_tp"]
    _check_fp32(got, request.getfixturevalue(WORLDS[name])[0]["fp32"])
    _check_fp32(got, one_device["gemma2-2b", "fp32"])
    _check_fp32(got, reference_seq_tp[SEQ_TP_WORLDS[name]])


# ------------------------------------------- a sequence split over data --
def _one_device_blocks(arch, n, shape):
    """The one-device bf16 run whose gradient is the fp32 sum of the
    gradients of each of ``n`` sequence blocks' share of the loss (its
    rows' summed losses over the whole sequence's count), each taken
    alone in the leaves' dtype: what a sequence split over ``n`` data
    ranks rounds, as microbatches are for a split of the rows."""
    model = t_build(t_tiny(arch))
    tcfg, state, fp32 = _case_setup(model, "bf16")

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        hidden = model.forward(params, batch, unembed_mode="none",
                               remat=True)[0]
        labels = batch["labels"]
        S = labels.shape[1]
        nxt = torch.nn.functional.pad(labels[:, 1:], (0, 1)).long()
        w = torch.nn.functional.pad(torch.ones(labels[:, 1:].shape), (0, 1))
        W = t_tr._unembed_weight(params, model.cfg, None)
        total, loss = None, 0.0
        for r in range(n):
            blk = slice(r * S // n, (r + 1) * S // n)
            share = t_tr._chunk_ce(W, hidden[:, blk], nxt[:, blk],
                                   w[:, blk], model.cfg, None) / w.sum()
            g = torch.autograd.grad(share, leaves, retain_graph=r < n - 1)
            total = [x.float() for x in g] if total is None else [
                a + b.float() for a, b in zip(total, g)]
            loss = loss + share.detach()
        for p in leaves:
            p.requires_grad_(False)
        return loss, tree_unflatten(params, [
            t.to(p.dtype) for t, p in zip(total, leaves)])

    step = tsteps.run_train_step(tcfg, grad_fn, lambda g, o: tadam.adamw_update(
        g, o, tcfg.optim))
    steps, _ = _run_steps(step, state, fp32, lambda k: tdp.batch_for_model(
        model, shape, None, k, full=True))
    return {"steps": steps}


@pytest.fixture(scope="module")
def seq_one_device():
    """The one-device port on the batches whose sequence splits over data:
    B 1 (fp32, bf16, the bf16 control of two sequence blocks, and the
    first batch's final hidden rows in fp32), B 3 (fp32) and B 2 in two
    microbatches (fp32)."""
    model = t_build(t_tiny("gemma2-2b"))
    _, state, _ = _case_setup(model, "fp32")
    b0 = tdp.batch_for_model(model, SHAPE_B1, None, 0, full=True)
    with torch.no_grad():
        hidden = model.forward(state["params"], b0, unembed_mode="none")[0]
    return {"fp32": _one_device("gemma2-2b", "fp32", shape=SHAPE_B1),
            "b3": _one_device("gemma2-2b", "fp32", shape=SHAPE_B3),
            "micro": _one_device("gemma2-2b", "fp32", 2, SHAPE_B2),
            "bf16": _one_device("gemma2-2b", "bf16", shape=SHAPE_B1),
            "bf16_blocks": _one_device_blocks("gemma2-2b", 2, SHAPE_B1),
            "hidden": hidden.numpy()}


SEQ_WORLDS = {"data2": (2, 1), "world4": (2, 2)}


def _check_reference_norm64(got, ref, what):
    """``got`` under the fp32 rules against the reference's run ``ref``,
    every step's grad norm held to the float64 norm of the reference's
    gradients at that step's state (``norm64``); both distances are
    printed with -s."""
    _check_fp32(got, dict(ref, steps=[
        (dict(m, grad_norm=n), mast)
        for (m, mast), n in zip(ref["steps"], ref["norm64"])]))

    def rel(steps, norms):
        return ", ".join(f"{abs(m['grad_norm'] - n) / n:.3g}"
                         for (m, _), n in zip(steps, norms))
    print(f"{what} against the reference's float64 grad norms: "
          f"{rel(got['steps'], ref['norm64'])}; the reference's "
          f"reported norms against them: {rel(ref['steps'], ref['norm64'])}")


@pytest.mark.parametrize("name", list(SEQ_WORLDS))
def test_seq_split_fp32_matches_one_device_and_reference(
        name, request, seq_one_device, reference_seq_tp):
    """One row of 64 at data=2 (and data=2 x model=2), its sequence split
    over data: three fp32 steps under the fp32 rules against the
    one-device port and, at data=2, the reference's jitted step with its
    own in_shardings (the sequence over data); every rank's first
    gradients alike and its leaves of their at-rest shapes.

    Against the reference every step's grad norm is held to the float64
    norm of the reference's gradients at that step's state (``norm64``):
    at this batch the norm its step reports sits 1.12e-6, 1.25e-6 and
    6.55e-7 from those at steps 0-2 (its jitted step's own fp32 sums, in
    XLA's order), the split's within 9e-8 of them. Both distances are
    printed with -s."""
    ranks = request.getfixturevalue(WORLDS[name])
    got = ranks[0]["seq_fp32"]
    _check_fp32(got, seq_one_device["fp32"])
    if name == "data2":
        _check_reference_norm64(got, reference_seq_tp["data2_b1"],
                                "seq split")
    for r in ranks:
        assert r["seq_fp32"]["shapes_ok"]
        assert all(np.array_equal(a, b) for a, b in zip(
            r["seq_fp32"]["grads"], got["grads"]))


@pytest.mark.parametrize("name", list(SEQ_WORLDS))
def test_seq_split_rows_are_the_ranks_own(name, request, seq_one_device):
    """Each rank's residual between sub-layers holds S / data of the
    sequence's rows, and its unembedding and loss score those rows
    alone: its final hidden rows are its block of the one-device
    forward's, bit for bit (every sub-layer runs on the gathered whole
    rows, so the forward is one device's)."""
    data, _ = SEQ_WORLDS[name]
    ranks = request.getfixturevalue(WORLDS[name])
    n = SHAPE_B1.seq_len // data
    d = t_tiny("gemma2-2b").d_model
    want = seq_one_device["hidden"]
    for i, r in enumerate(ranks):
        probe = r["seq_fp32"]["probe"]
        assert probe["resid"] == [(1, n, d)]
        assert probe["unembed"] == n
        blk = (i // (len(ranks) // data)) * n
        assert np.array_equal(probe["hidden"], want[:, blk:blk + n])


def test_seq_split_three_rows(world_data2, seq_one_device):
    """Three rows at data=2: no batch axis divides them, so each rank
    holds its half of every row's sequence (its tokens are not a
    contiguous run of the flattened B x S order); three fp32 steps
    against the one-device port."""
    got = world_data2[0]["seq_b3"]
    _check_fp32(got, seq_one_device["b3"])
    for r in world_data2:
        assert all(np.array_equal(a, b) for a, b in zip(
            r["seq_b3"]["grads"], got["grads"]))


def test_seq_split_microbatches(world_data2, seq_one_device):
    """Two rows in two microbatches at data=2: a microbatch's one row
    splits over no batch axis, so each of the reference's global
    microbatches splits its sequence over data (every rank given both
    rows); three fp32 steps against the one-device port in two
    microbatches."""
    _check_fp32(world_data2[0]["seq_micro"], seq_one_device["micro"])


def test_seq_split_bf16_matches_one_device(world_data2, seq_one_device):
    """The trainer as train() runs it (bf16) on one row at data=2, under
    the bf16 rules against the one-device run whose gradient is the fp32
    sum of each data block's bf16 gradient (``_one_device_blocks``), and
    against the plain one-device run within the rules or twice the
    control's distance."""
    got = world_data2[0]["seq_bf16"]
    _check_bf16(got, seq_one_device["bf16_blocks"])
    _check_bf16(got, seq_one_device["bf16"],
                control=seq_one_device["bf16_blocks"])


def test_seq_split_under_seq_tp_is_dp(world4, seq_one_device):
    """make_ac(mesh, "seq_tp") on one row at data=2 x model=2: the
    reference's seq_tp constrains nothing at such a batch, so its batch
    spec decides and the step is dp's (the sequence over data) bit for
    bit, its first loss and every gradient leaf, and under the fp32 rules
    against the one-device port."""
    for r in world4:
        dp, seq = r["seq_fp32"], r["seq_tp_b1"]
        assert seq["loss"] == dp["loss"]
        assert all(np.array_equal(a, b) for a, b in zip(dp["grads"],
                                                        seq["grads"]))
    _check_fp32(world4[0]["seq_tp_b1"], seq_one_device["fp32"], steps=1)


def test_seq_split_control_misses(world_data2, seq_one_device):
    """With ``DataSeqRows.whole``'s backward a cut (each rank keeps its
    own rows' input gradient, the other ranks' shares dropped), the first
    gradients miss the fp32 tolerance by far (the distance is printed
    with -s)."""
    want = seq_one_device["fp32"]["grads"]
    assert _grad_err(want, world_data2[0]["seq_fp32"]["grads"]) <= GRAD_TOL
    miss = _grad_err(want, world_data2[0]["seq_cut"])
    print(f"seq split without the reduce-scatter: {miss:.3g} of a leaf's "
          f"max |g|")
    assert miss > 100 * GRAD_TOL


# ------------------------------ a (micro)batch an FSDP axis holds whole --
@pytest.fixture(scope="module")
def held_one_device(seq_one_device):
    """The one-device port's fp32 runs of the ``HELD`` cases."""
    return {"held_b2": _one_device("gemma2-2b", "fp32", shape=SHAPE_B2),
            "held_m2": _one_device("gemma2-2b", "fp32", 2, SHAPE),
            "held_b1": seq_one_device["fp32"],
            "held_odd": _one_device("gemma2-2b", "fp32", shape=SHAPE_ODD)}


# the data=2 case whose step pod=2 x data=2 repeats on each pod rank
AT_DATA2 = {"held_b2": "held_b2_first", "held_m2": "held_m2_first",
            "held_b1": "seq_fp32"}


@pytest.mark.parametrize("case", list(AT_DATA2))
def test_held_over_pod_is_the_data2_step(case, world_pod, world_data2):
    """Layouts A (the rows over data alone: B 2, and B 4 in microbatches
    of 2) and B (B 1, its sequence over data) at pod=2 x data=2: each pod
    rank computes its data rank's rows from the same gathered weights and
    nothing sums over pod, so the first loss and every gradient leaf,
    gathered whole, are the same batch's at data=2, bit for bit (the same
    two shares summed in the same group-rank order), and the pod replicas'
    losses and grad norms are the same bits at every step."""
    for i, r in enumerate(world_pod):
        got, want = r[case], world_data2[i % 2][AT_DATA2[case]]
        assert got["loss"] == want["loss"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["grads"], want["grads"]))
        assert got["metrics"] == world_pod[0][case]["metrics"]
        assert got["shapes_ok"]


HELD_WORLDS = [("world_pod", c) for c in HELD] + [("world_data3",
                                                   "held_b2")]


@pytest.mark.parametrize("world,case", HELD_WORLDS)
def test_held_steps_match_one_device(world, case, request, held_one_device):
    """Every layout an FSDP axis holds whole (A, B and C at pod=2 x
    data=2, C at data=3): three fp32 steps under the fp32 rules against
    the one-device port, every rank's first gradients and every step's
    loss and grad norm alike."""
    ranks = request.getfixturevalue(world)
    got = ranks[0][case]
    _check_fp32(got, held_one_device[case])
    for r in ranks:
        assert all(np.array_equal(a, b)
                   for a, b in zip(r[case]["grads"], got["grads"]))
        assert r[case]["metrics"] == got["metrics"]


@pytest.mark.parametrize("world,case", [("world_pod", "held_odd"),
                                        ("world_data3", "held_b2")])
def test_held_whole_is_one_device(world, case, request, held_one_device):
    """Layout C (no axis splits the rows or the sequence: B 1 x S 63 at
    pod=2 x data=2, B 2 x S 64 at data=3): every rank computes the whole
    batch from the gathered weights and nothing sums over data or pod, so
    the first loss and every gradient leaf are the one-device port's, bit
    for bit."""
    want = held_one_device[case]
    for r in request.getfixturevalue(world):
        got = r[case]
        assert got["metrics"][0]["loss"] == want["steps"][0][0]["loss"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(got["grads"], want["grads"]))


@pytest.mark.parametrize("case", ["held_b2", "held_b1"])
def test_held_over_pod_matches_reference(case, world_pod, reference_seq_tp):
    """A (B 2) and B (B 1) at pod=2 x data=2 against the reference's
    jitted step on pod=2 x data=2 x model=1 forced host devices with its
    own in_shardings: three fp32 steps under the fp32 rules, the grad
    norm held to the reference's gradients' float64 norm."""
    _check_reference_norm64(world_pod[0][case], reference_seq_tp[case],
                            f"{case} at pod=2 x data=2")


@pytest.mark.parametrize("world", ["world_pod", "world_data3"])
def test_held_control_misses(world, request, held_one_device):
    """B 2 with the backward over the axes that hold it whole a
    reduce-scatter and a post-backward sum, as over an axis that splits
    the rows (pod at pod=2 x data=2, data at data=3): each gradient is
    doubled or tripled, and the first gradients miss the fp32 tolerance
    (the distance is printed with -s)."""
    ranks = request.getfixturevalue(world)
    want = held_one_device["held_b2"]["grads"]
    assert _grad_err(want, ranks[0]["held_b2"]["grads"]) <= GRAD_TOL
    miss = _grad_err(want, ranks[0]["held_b2_sum"]["grads"])
    print(f"{world} with the held axes summed: {miss:.3g} of a leaf's "
          f"max |g|")
    assert miss > 100 * GRAD_TOL
