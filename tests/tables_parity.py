"""What the port's table tests share (tests/test_torch_tables_amc.py,
tests/test_torch_tables_haq.py, tests/test_torch_tables_nas.py,
tests/test_torch_tables_subject.py): running a reference table's
``main`` and the port's twin on one subject with their calls logged, and
holding the two runs to each other.

Subject: the reference's ``trained_tiny_model`` (benchmarks/common.py:39;
tiny granite-3-8b trained SUBJECT_STEPS steps; tiny granite-moe-3b-a800m
and llava-next-mistral-7b, the second archs of Tables 4 and 7, at 0 steps:
another compiled training run each would not fit a file's time), its
parameters cast to fp32 and carried into the port by models/convert.py
(``make_subjects``). Each reference table runs its own ``main`` on it, its
module names swapped where the test needs to: ``trained_tiny_model`` to
hand it the subject, the searches' configs to the test's episode counts,
``time_call`` to a stub (its times are the host's, not compared), and
loggers around the loss functions, the rollouts and ``haq.resource``. The
port's tables run with the reference's V5E targets passed in, so their row
names are the reference's.

The reference's policy loss is jitted with the bits traced, so its weight
quantizer divides by a traced qmax: compiled, it agrees with its eager
definition to fp32 rounding (measured 3.1e-6 at most on this subject),
unlike ``make_quant_dot``'s constant bits, which XLA turns into a multiply
by 1/qmax (ROADMAP Queue 3). The tables are held to it as it runs; the
port's closure is also held to the eager definition
(``test_policy_loss_is_the_references_eager_loss``).

Agents: the port's DDPG starts from the reference's initial weights
(``DDPG.set_weights``), as tests/test_torch_haq.py and
tests/test_torch_pruning_amc.py carry them; exploration draws from the
same numpy generator.

Tolerances:
  * hardware-model numbers (``model_latency_bytes``, ``haq.resource``,
    the cross matrix's cells, Fig. 4's intensities and latencies): 1e-6
    relative (float64 in the port, fp32 steps in the reference);
  * HAQ bits and the policies the tables evaluate: equal, episode by
    episode; AMC keep ratios within RATIO_TOL (1e-5) and the FLOPs
    fractions likewise;
  * losses: LOSS_TOL (1e-4) absolute where no activation is quantized
    (measured 3.3e-6 at most). Where one is (a_bits < 16), an activation
    within an fp32 rounding of a PACT code boundary takes the neighbouring
    code in one package (a step of up to 6/7 at 4 bits): such a loss is
    held to the larger of LOSS_TOL and twice a control, the port's own
    loss with every quantized activation scaled by 1 +- 2**-20 (eight fp32
    ulps) before its quantizer (``control``). Measured over 30 random
    policies: the gap to the reference up to 1.28e-3, where the control
    moved 2.8e-2; where the control moved less than the gap, the gap was
    under 3.7e-5; in Table 5's run the gap reached 1.16 times the control
    (3.05e-3 against 2.62e-3);
  * boolean flags in the rows: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import common as j_common
from repro.core import amc as j_amc
from repro.core import haq as j_haq
from repro.core.rl import ddpg as j_ddpg
from repro_torch.configs import tiny_config as t_tiny
from repro_torch.core import amc as t_amc
from repro_torch.core import haq as t_haq
from repro_torch.core import hardware_model as t_hwm
from repro_torch.core import quantization as t_q
from repro_torch.core.rl import ddpg as t_ddpg
from repro_torch.models.api import build_model as t_build
from repro_torch.models.convert import from_jax_params
from repro_torch.tables import common as t_common

REL = 1e-6
RATIO_TOL = 1e-5
LOSS_TOL = 1e-4
ACT_SHIFT = 2.0 ** -20
SUBJECT_STEPS = 20
GRANITE, MOE, LLAVA = "granite-3-8b", "granite-moe-3b-a800m", \
    "llava-next-mistral-7b"


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def t_hw(h):
    """The port's Hardware for a reference target (same name, fields)."""
    return t_hwm.HARDWARES[h.name]


def make_subjects(steps_by_arch):
    """{arch: (reference model, fp32 params, val, port model, params,
    val)}: the reference's trained_tiny_model at the given steps, its
    parameters cast to fp32 and carried across."""
    out = {}
    for arch, steps in steps_by_arch.items():
        jm, jp, jv = j_common.trained_tiny_model(arch, steps=steps)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        out[arch] = (jm, jp, jv, t_build(t_tiny(arch)),
                     from_jax_params(jax.tree.map(np.asarray, jp)),
                     from_jax_params(jax.tree.map(np.asarray, jv)))
    return out


def proxy(mod, **names):
    """A stand-in for module ``mod`` with ``names`` replaced, to swap a
    table module's imported module."""
    import types
    ns = types.SimpleNamespace(**{k: v for k, v in vars(mod).items()
                                  if not k.startswith("__")})
    for k, v in names.items():
        setattr(ns, k, v)
    return ns


def recording(fn, log):
    """``fn``, appending each call's result to the list ``log``."""
    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(out)
        return out
    return wrapped


def shifted(ev, policy, f) -> float:
    """``ev(policy)`` with every quantized activation scaled by ``f``
    before the port's PACT quantizer."""
    fq = t_q.fake_quant_act
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_q, "fake_quant_act",
                   lambda x, bits, clip=6.0: fq(x * f, bits, clip))
        return float(ev(policy))


def control(ev, policy, loss) -> float:
    """The largest move of the port's ``ev(policy)`` (``loss``) with the
    quantized activations scaled by 1 +- ACT_SHIFT (0 where none is)."""
    policy = dict(policy)
    if all(int(a) >= 16 for _, a in policy.values()):
        return 0.0
    return max(abs(shifted(ev, policy, f) - loss)
               for f in (1 + ACT_SHIFT, 1 - ACT_SHIFT))


def carried_ddpg(cfg, seed=0, **kw):
    ref = j_ddpg.DDPG(j_ddpg.DDPGConfig(**dataclasses.asdict(cfg)),
                      seed=seed)
    agent = t_ddpg.DDPG(cfg, seed=seed, **kw)
    agent.set_weights(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in ref.actor],
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in ref.critic])
    return agent


class Side:
    """One package's run of a table: the rows, and what its searches and
    calls returned, in call order."""

    def __init__(self):
        self.log = {}
        self.rows = []


def watch(monkeypatch, side, amc_mod, haq_mod):
    """Log every AMC and HAQ rollout's record through the classes the
    searches build."""
    for cls in (amc_mod.AMCEnv, haq_mod.HAQEnv):
        monkeypatch.setattr(cls, "rollout", recording(
            cls.rollout, side.log.setdefault(cls.__name__, [])))


def eval_logger(fn, side):
    """Wrap a table's ``make_traced_policy_loss`` so each evaluation's
    (policy, loss, its loss function) is logged."""
    def make(*a, **k):
        ev = fn(*a, **k)

        def logged(policy):
            loss = float(ev(policy))
            key = tuple(sorted((n, tuple(int(b) for b in v))
                               for n, v in policy.items()))
            side.log.setdefault("evals", []).append((key, loss, ev))
            return loss
        return logged
    return make


def reference_run(monkeypatch, capsys, mod, subjects, *, episodes):
    """Run the reference table ``mod``'s main on the fp32 subjects."""
    side = Side()
    subj = {a: s[:3] for a, s in subjects.items()}
    monkeypatch.setattr(mod, "trained_tiny_model",
                        lambda arch=GRANITE, *a, **k: subj[arch])
    if hasattr(mod, "time_call"):
        monkeypatch.setattr(mod, "time_call", lambda fn, *a, **k: 0.0)
    if hasattr(mod, "make_traced_policy_loss"):
        monkeypatch.setattr(mod, "make_traced_policy_loss", eval_logger(
            j_common.make_traced_policy_loss, side))
    if hasattr(mod, "haq"):
        monkeypatch.setattr(mod, "haq", proxy(
            j_haq, HAQConfig=lambda **kw: j_haq.HAQConfig(
                **{**kw, "episodes": episodes}),
            resource=recording(j_haq.resource,
                               side.log.setdefault("resource", []))))
    if hasattr(mod, "amc"):
        monkeypatch.setattr(mod, "amc", proxy(
            j_amc, AMCConfig=lambda **kw: j_amc.AMCConfig(
                **{**kw, "episodes": episodes})))
        monkeypatch.setattr(mod, "jax", proxy(jax, jit=lambda f: recording(
            jax.jit(f), side.log.setdefault("losses", []))))
    if hasattr(mod, "model_latency_bytes"):
        monkeypatch.setattr(mod, "model_latency_bytes", recording(
            mod.model_latency_bytes,
            side.log.setdefault("model_latency_bytes", [])))
    watch(monkeypatch, side, j_amc, j_haq)
    capsys.readouterr()
    mod.main()
    out = capsys.readouterr().out
    side.rows = [tuple(ln.split(",", 2)) for ln in out.splitlines()
                 if "/" in ln.split(",")[0]]
    monkeypatch.undo()
    return side


def port_run(monkeypatch, mod, **kw):
    """Run the port's table ``mod``'s main on the CPU with the carried
    agents, logging as ``reference_run`` does."""
    side = Side()
    monkeypatch.setattr(t_haq, "DDPG", carried_ddpg)
    monkeypatch.setattr(t_amc, "DDPG", carried_ddpg)
    if hasattr(mod, "make_traced_policy_loss"):
        monkeypatch.setattr(mod, "make_traced_policy_loss", eval_logger(
            t_common.make_traced_policy_loss, side))
    if hasattr(mod, "loss_fn"):
        monkeypatch.setattr(mod, "loss_fn", lambda m, b: recording(
            t_common.loss_fn(m, b), side.log.setdefault("losses", [])))
        monkeypatch.setattr(mod, "time_call", lambda fn, *a, **k: 0.0)
    if hasattr(mod, "haq"):
        monkeypatch.setattr(mod, "haq", proxy(
            t_haq, resource=recording(t_haq.resource,
                                      side.log.setdefault("resource", []))))
    if hasattr(mod, "model_latency_bytes"):
        monkeypatch.setattr(mod, "model_latency_bytes", recording(
            mod.model_latency_bytes,
            side.log.setdefault("model_latency_bytes", [])))
    watch(monkeypatch, side, t_amc, t_haq)
    res = mod.main(device="cpu", **kw)
    side.rows = [(n, f"{us:.4g}", d) for n, us, d in res["rows"]]
    monkeypatch.undo()
    return side, res


def flags(derived):
    return {k: v for k, v in (kv.split("=", 1) for kv in derived.split(";"))
            if v in ("True", "False")}


def hold_rows(got, want):
    assert [r[0] for r in got.rows] == [r[0] for r in want.rows]
    for g, w in zip(got.rows, want.rows):
        assert [kv.split("=")[0] for kv in g[2].split(";")] == \
            [kv.split("=")[0] for kv in w[2].split(";")], g[0]
        assert flags(g[2]) == flags(w[2]), (g, w)


def hold_amc(got, want):
    t, j = got.log["AMCEnv"], want.log["AMCEnv"]
    assert len(t) == len(j)
    for ep, (a, b) in enumerate(zip(t, j)):
        assert np.allclose(a["ratios"], b["ratios"], rtol=0,
                           atol=RATIO_TOL), ep
        assert abs(a["flops_frac"] - b["flops_frac"]) <= RATIO_TOL, ep
        assert abs(a["loss"] - b["loss"]) <= LOSS_TOL, ep
    assert np.allclose(got.log["losses"], [float(x) for x in
                                           want.log["losses"]],
                       rtol=0, atol=LOSS_TOL)


def hold_haq(got, want):
    t, j = got.log["HAQEnv"], want.log["HAQEnv"]
    assert len(t) == len(j)
    for ep, (a, b) in enumerate(zip(t, j)):
        assert a["policy"] == {k: tuple(int(x) for x in v)
                               for k, v in b["policy"].items()}, ep
        for k in ("resource", "budget", "base_resource"):
            assert rel(a[k], b[k]) < REL, (ep, k)
    # every evaluation, the rollouts' included: the same policies, losses
    # within LOSS_TOL or the activation control (the module docstring)
    te, je = got.log["evals"], want.log["evals"]
    assert [p for p, _, _ in te] == [p for p, _, _ in je]
    for (p, a, ev), (_, b, _) in zip(te, je):
        if abs(a - b) > LOSS_TOL:
            ctrl = control(ev, p, a)
            assert abs(a - b) <= 2 * ctrl, (p, a, b, ctrl)
    tr, jr = got.log.get("resource", []), want.log.get("resource", [])
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        assert rel(a, b) < REL
