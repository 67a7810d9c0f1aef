"""The tables' shared pieces on the port (src/repro_torch/tables/common.py)
against the reference's ``benchmarks/common.py`` on the CPU.

* ``trained_tiny_model``: memoized per argument tuple; from the
  reference's initial state, the reference's own training loop and the
  port's reach the same val loss (SUBJECT_RTOL, argued at the test).
* ``make_traced_policy_loss``: the port's closure against the reference's
  loss function run under ``jax.disable_jit`` (its eager definitions).
  Losses within LOSS_TOL (1e-4) where no activation is quantized; where
  one is, within the larger of LOSS_TOL and twice ``control``
  (tests/tables_parity.py): an activation within an fp32 rounding of a
  PACT code boundary takes the neighbouring code in one package, and the
  control measures how far this policy's loss moves when every quantized
  activation is scaled by 1 +- 2**-20 (eight fp32 ulps) before its
  quantizer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as j_common  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import haq as j_haq  # noqa: E402
from repro.data.pipeline import DataConfig as JData  # noqa: E402
from repro.data.pipeline import batch_for_model as j_batch  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.training import steps as j_steps  # noqa: E402
from repro_torch.configs import tiny_config as t_tiny  # noqa: E402
from repro_torch.core import haq as t_haq  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        from_jax_state)
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.tables import common as t_common  # noqa: E402
from tables_parity import (GRANITE, LOSS_TOL, SUBJECT_STEPS,  # noqa: E402
                           control)

torch.set_num_threads(1)



# ----------------------------------------------------- trained_tiny_model --
def test_trained_tiny_model_is_memoized():
    a = t_common.trained_tiny_model(GRANITE, steps=0, B=2, S=16,
                                    device="cpu")
    b = t_common.trained_tiny_model(GRANITE, steps=0, B=2, S=16,
                                    device="cpu")
    assert a is b
    c = t_common.trained_tiny_model(GRANITE, steps=0, B=2, S=16, seed=1,
                                    device="cpu")
    assert c is not a and not torch.equal(c[1]["embed"], a[1]["embed"])


# The port's trained_tiny_model from the reference's initial state against
# the reference's trained_tiny_model body run from the same state: the val
# losses after SUBJECT_STEPS steps within SUBJECT_RTOL. Both in fp32 with
# wq and wk times 1/8 (tests/test_torch_train.py's convention): at the
# reference's own init the attention is saturated and its bf16 gradients
# sit 1.00 (relative L2) from its fp32 ones (tests/test_torch_train.py), so
# 20 steps there would part the packages by their roundings, not their
# code. Measured 6.9e-6 relative, held at 1e-4.
SUBJECT_RTOL = 1e-4
QK_SCALE = 0.125


def _scale_qk(tree, f):
    if isinstance(tree, dict):
        return {k: v * f if k in ("wq", "wk") and not isinstance(v, dict)
                else _scale_qk(v, f) for k, v in tree.items()}
    return tree


def test_trained_tiny_model_from_the_reference_init():
    """The reference's trained_tiny_model (benchmarks/common.py:39) step
    for step, from its initial state in fp32 (wq, wk scaled)."""
    model = j_build(j_tiny(GRANITE))
    tcfg = JTrain(optim=JOptim(lr=5e-3, warmup_steps=4,
                               total_steps=SUBJECT_STEPS))
    state = j_steps.init_train_state(model, tcfg, jax.random.PRNGKey(0))
    params = _scale_qk(jax.tree.map(lambda a: a.astype(jnp.float32),
                                    state["params"]), QK_SCALE)
    state = {"params": params, "opt": dict(
        state["opt"], master=_scale_qk(state["opt"]["master"], QK_SCALE))}
    init = from_jax_state(jax.tree.map(np.asarray, state))
    step = jax.jit(j_steps.make_train_step(model, tcfg))
    shape = JShape("bench", 64, 8, "train")
    dcfg = JData(model.cfg.vocab_size, 64, 8, seed=0)
    for s in range(SUBJECT_STEPS):
        state, _ = step(state, j_batch(model, shape, dcfg, s))
    jv = j_batch(model, shape, dcfg, 10_000)
    tm, tp, tv = t_common.trained_tiny_model(
        GRANITE, steps=SUBJECT_STEPS, device="cpu", init_state=init)
    # both subjects scored by the port's loss, which on the same fp32
    # parameters is the reference's within 1e-5 (tests/test_torch_haq.py)
    jp = from_jax_params(jax.tree.map(np.asarray, state["params"]))
    with torch.no_grad():
        got, want = float(tm.loss(tp, tv)), float(tm.loss(jp, tv))
    print(f"val loss: port {got!r}, reference {want!r}, gap "
          f"{abs(got - want) / abs(want):.3g}")
    assert abs(got - want) <= SUBJECT_RTOL * abs(want), (got, want)
    assert torch.equal(tv["tokens"], torch.from_numpy(np.asarray(
        jv["tokens"])))


# ------------------------------------------------- the traced policy loss --
def test_policy_loss_is_the_references_eager_loss():
    """The port's closure against the reference's jitted loss run eagerly,
    on the reference's subject at 0 steps in fp32: mixed bits, all-16
    (the select's no-op, the plain loss bit for bit), weights alone at 4
    bits (the case where the reference's compiled constant-bit quantizer
    moves the loss by 0.0954, ROADMAP Queue 3), a site absent."""
    jm, jp, jv = j_common.trained_tiny_model(GRANITE, steps=0)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tm = t_build(t_tiny(GRANITE))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    tv = from_jax_params(jax.tree.map(np.asarray, jv))
    names = {s.name for s in j_haq.enumerate_sites(
        j_get_config(GRANITE), 1, 4096, decode=True)}
    assert names == {s.name for s in t_haq.enumerate_sites(
        t_get_config(GRANITE), 1, 4096, decode=True)}
    jev = j_common.make_traced_policy_loss(jm, jp, jv, names)
    tev = t_common.make_traced_policy_loss(tm, tp, tv, names)
    for policy in ({n: (16, 16) for n in names},
                   {n: (4, 16) for n in names},
                   {n: (3, 5) for n in names if n != "attn_q"},
                   {"ffn_in": (16, 4), "attn_o": (2, 16), "lm_head": (4, 4)}):
        with jax.disable_jit():
            want = jev(policy)
        got = tev(policy)
        assert abs(got - want) <= max(LOSS_TOL,
                                      2 * control(tev, policy, got)), policy
    with torch.no_grad():
        plain = float(tm.loss(tp, tv))
    assert tev({n: (16, 16) for n in names}) == plain
