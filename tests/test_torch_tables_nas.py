"""The port's NAS tables (src/repro_torch/tables/table1_specialization.py,
table2_cross_hw.py) and the tables' runner (tables/run.py) against the
reference's ``benchmarks/`` on the CPU, and two of the port's examples
(examples/torch_quickstart.py, torch_nas_specialize.py) on the CPU at
their smallest settings (the other two: tests/test_torch_examples.py).

The NAS search's trajectory cannot match the reference's: the port draws
its paths from a torch.Generator, the reference from jax.random keys (the
same distribution, other draws; tests/test_torch_nas.py). So each table is
checked twice:
  * against the reference's ``main`` with the search stubbed in both
    packages to return the same architectures (and ``eval_arch`` to a
    constant): the same row names in the same order with the reference's
    targets passed in, the same search configs (the latency budget within
    1e-6 relative), and every latency the tables price (``arch_latency``
    on each LUT, the cross matrix) within 1e-6 relative (the LUT is fp32
    in both, each entry within a few fp32 ulps; tests/test_torch_nas.py);
    the boolean flags equal;
  * on the port alone with its real search at a few steps on the H100
    targets: valid architectures, finite numbers consistent with the LUTs.
``eval_arch`` of a fixed architecture from the reference's supernet init
(fp32) after EVAL_STEPS steps: the val CE within 1e-4 relative (measured
2.2e-7). The backbone is cut to EVAL_BLOCKS blocks: the reference compiles
all seven ops of every block (``lax.switch``) into each call's step, 25 s
at six blocks. At six blocks its init's attention is saturated (scores
spread with fan-in H, tests/test_torch_train.py), and three normalized SGD
steps carry the two packages' fp32 rounding to 1.4e-2 of the loss; with
wq and wk scaled by 1/8 the six blocks agree to 8e-8.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import run as j_run  # noqa: E402
from benchmarks import table1_specialization as j_t1  # noqa: E402
from benchmarks import table2_cross_hw as j_t2  # noqa: E402
from repro.core import latency_table as j_lt  # noqa: E402
from repro.core import nas as j_nas  # noqa: E402
from repro.core import supernet as j_sn  # noqa: E402
from repro_torch.configs.supernet_lm import CANDIDATE_OPS  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.core import latency_table as t_lt  # noqa: E402
from repro_torch.core import nas as t_nas  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.tables import run as t_run  # noqa: E402
from repro_torch.tables import table1_specialization as t_t1  # noqa: E402
from repro_torch.tables import table2_cross_hw as t_t2  # noqa: E402
from tables_parity import proxy, recording  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6
EVAL_REL = 1e-4
EVAL_STEPS = 3
EVAL_BLOCKS = 2
ARCHS = (["attn_full_e2", "mamba2_e2", "attn_local1k_e4", "zero",
          "attn_local4k_e4", "attn_full_e4"],
         ["attn_local1k_e2"] * 3 + ["zero"] * 3,
         ["mamba2_e2"] * 2 + ["attn_full_e4"] * 4)


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def t_hw(h):
    return t_hwm.HARDWARES[h.name]


def test_tiny_backbone_luts_and_latencies_match_reference():
    tc, jc = t_t1.tiny_backbone(), j_t1.tiny_backbone()
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
              "head_dim", "d_ff", "vocab_size"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert vars(tc.ssm) == vars(jc.ssm)
    luts = [(t_lt.build_lut(tc, 4, 64, t_hwm.V5E_POD),
             j_lt.build_lut(jc, 4, 64, j_t1.V5E_POD))]
    luts += [(t_lt.build_lut(tc, hw=t_hw(hw), **kw),
              j_lt.build_lut(jc, hw=hw, **kw))
             for hw, kw in j_t2.TARGETS.values()]
    for tl, jl in luts:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=REL)
        for arch in ARCHS:
            assert _rel(t_t1.arch_latency(arch, tl),
                        j_t1.arch_latency(arch, jl)) < REL


def _stub_search(archs, calls, lat_fn):
    """A search returning ``archs`` in turn, recording its configs."""
    def search(data, hw=None, ncfg=None, cfg=None, lut=None, **kw):
        arch = list(archs[len(calls) % len(archs)])
        calls.append((hw.name, ncfg))
        return {"arch": arch, "e_lat_us": lat_fn(arch, lut)}
    return search


def _reference_rows(mod, monkeypatch, capsys, archs, calls, lats):
    monkeypatch.setattr(mod, "nas", proxy(j_nas, search=_stub_search(
        archs, calls, j_t1.arch_latency)))
    monkeypatch.setattr(mod, "arch_latency", recording(j_t1.arch_latency,
                                                        lats))
    if hasattr(mod, "eval_arch"):
        monkeypatch.setattr(mod, "eval_arch", lambda *a, **k: 0.0)
    capsys.readouterr()
    mod.main()
    out = capsys.readouterr().out
    monkeypatch.undo()
    return [tuple(ln.split(",", 2)) for ln in out.splitlines()
            if ln.startswith(("table1/", "table2/"))]


def _port_rows(mod, monkeypatch, archs, calls, lats, **kw):
    monkeypatch.setattr(mod, "nas", proxy(t_nas, search=_stub_search(
        archs, calls, t_t1.arch_latency)))
    monkeypatch.setattr(mod, "arch_latency", recording(t_t1.arch_latency,
                                                        lats))
    if hasattr(mod, "eval_arch"):
        monkeypatch.setattr(mod, "eval_arch", lambda *a, **k: 0.0)
    res = mod.main(device="cpu", **kw)
    monkeypatch.undo()
    return [(n, f"{us:.4g}", d) for n, us, d in res["rows"]]


def _flags(derived):
    return {k: v for k, v in (kv.split("=", 1) for kv in derived.split(";"))
            if v in ("True", "False")}


def _hold(got, want, tcalls, jcalls, tlats, jlats):
    assert [r[0] for r in got] == [r[0] for r in want]
    for g, w in zip(got, want):
        assert _flags(g[2]) == _flags(w[2]), (g, w)
        assert [kv.split("=")[0] for kv in g[2].split(";")] == \
            [kv.split("=")[0] for kv in w[2].split(";")]
    assert [h for h, _ in tcalls] == [h for h, _ in jcalls]
    for (_, tn), (_, jn) in zip(tcalls, jcalls):
        for f in ("steps", "warmup_steps", "batch", "seq", "alpha_lr",
                  "log_every"):
            assert getattr(tn, f) == getattr(jn, f), f
        assert _rel(tn.lat_ref, jn.lat_ref) < REL
    assert len(tlats) == len(jlats)
    for a, b in zip(tlats, jlats):
        assert _rel(a, b) < REL


def test_table1_rows_match_reference(monkeypatch, capsys):
    jcalls, jlats, tcalls, tlats = [], [], [], []
    want = _reference_rows(j_t1, monkeypatch, capsys, ARCHS[:1], jcalls,
                           jlats)
    got = _port_rows(t_t1, monkeypatch, ARCHS[:1], tcalls, tlats,
                     hw=t_hwm.V5E_POD)
    _hold(got, want, tcalls, jcalls, tlats, jlats)
    assert got[-1] == want[-1]          # the searched arch and its E[lat]


def test_table2_matrix_matches_reference(monkeypatch, capsys):
    """Three different architectures, one a target: the cross matrix's
    latencies, its column-normalized cells and the diagonal flags."""
    jcalls, jlats, tcalls, tlats = [], [], [], []
    want = _reference_rows(j_t2, monkeypatch, capsys, ARCHS, jcalls, jlats)
    targets = {n: (t_hw(hw), kw) for n, (hw, kw) in j_t2.TARGETS.items()}
    got = _port_rows(t_t2, monkeypatch, ARCHS, tcalls, tlats,
                     targets=targets)
    _hold(got, want, tcalls, jcalls, tlats, jlats)
    assert len(tlats) == 9
    for g, w in zip(got, want):
        assert g[2] == w[2]              # cells to 3 decimals, flags, arch


def test_table1_and_table2_search_on_the_port():
    """The port's real searches, a few steps each, on its H100 targets:
    valid architectures; every latency finite and the LUT's."""
    res = t_t1.main(steps=3, warmup_steps=1, eval_steps=1, device="cpu")
    names = [n for n, _, _ in res["rows"]]
    assert names == ["table1/uniform-full-e4", "table1/uniform-full-e2",
                     "table1/uniform-local1k-e2", "table1/nas-specialized",
                     "table1/nas-arch"]
    arch = res["search"]["arch"]
    assert len(arch) == 6 and set(arch) <= set(CANDIDATE_OPS)
    assert res["rows"][3][1] == t_t1.arch_latency(arch, res["lut"])
    assert res["rows"][4][1] == res["search"]["e_lat_us"]
    for _, us, derived in res["rows"][:4]:
        assert math.isfinite(us) and us > 0
        assert math.isfinite(float(derived.split("=")[1]))
    res = t_t2.main(steps=2, warmup_steps=1, device="cpu")
    assert [n for n, _, _ in res["rows"]] == [
        f"table2/specialized-for-{t}" for t in t_t2.TARGETS]
    lats = res["lats"]
    for a, arch in res["archs"].items():
        assert len(arch) == 6 and set(arch) <= set(CANDIDATE_OPS)
        for t, lut in res["luts"].items():
            assert lats[a][t] == t_t1.arch_latency(arch, lut)
            assert math.isfinite(lats[a][t]) and lats[a][t] >= 0


def test_eval_arch_matches_reference(monkeypatch):
    """A fixed architecture (local attention at expansion 4, then mamba2)
    trained EVAL_STEPS steps from the reference's supernet init in fp32 in
    both packages."""
    cfg_j = j_t1.tiny_backbone().replace(num_layers=EVAL_BLOCKS)
    cfg_t = t_t1.tiny_backbone().replace(num_layers=EVAL_BLOCKS)
    arch = ["attn_local1k_e4", "mamba2_e2"]
    params, _ = j_sn.init_supernet(jax.random.PRNGKey(1), cfg_j)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    monkeypatch.setattr(j_t1, "sn", proxy(
        j_sn, init_supernet=lambda key, cfg: (
            params, jnp.zeros((cfg.num_layers, len(CANDIDATE_OPS)),
                              jnp.float32))))
    want = j_t1.eval_arch(arch, cfg_j,
                          j_nas.synthetic_lm_data(cfg_j, batch=4, seq=64),
                          steps=EVAL_STEPS)
    got = t_t1.eval_arch(
        arch, cfg_t, t_nas.synthetic_lm_data(cfg_t, batch=4, seq=64),
        EVAL_STEPS, params=from_jax_params(jax.tree.map(np.asarray, params)),
        device="cpu")
    assert _rel(got, want) < EVAL_REL, (got, want)


# -------------------------------------------------------------- the runner --
def test_run_has_the_references_sections_but_the_engine():
    assert [t for t, _ in t_run.SECTIONS] == [
        t for t, _ in j_run.SECTIONS if t != "engine"]


def test_run_prints_each_section_and_fails_on_a_failed_one(monkeypatch,
                                                           capsys):
    """A failed section is printed and counted, the next one still runs,
    and the runner exits non-zero; each section's ``# <tag> done``."""
    from repro_torch.tables import roofline_report as t_roof
    from repro_torch.tables import table3_amc_speedup as t_t3

    def broken(**kw):
        raise RuntimeError("a broken section")
    monkeypatch.setattr(t_t3, "main", broken)
    with pytest.raises(SystemExit) as e:
        t_run.main(["table3", "roofline", "--device", "cpu"])
    assert e.value.code not in (0, None)
    out = capsys.readouterr().out
    assert "# table3 FAILED: RuntimeError('a broken section')" in out
    assert "# roofline done in" in out
    assert "fig4/attn_q," in out
    monkeypatch.setattr(t_roof, "main", lambda **kw: {"rows": []})
    t_run.main(["roofline", "--device", "cpu"])    # no failure: returns
    with pytest.raises(ValueError):
        t_run.run_sections(["engine"], device="cpu")


# ------------------------------------------------------------ the examples --
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_on_the_cpu(capsys):
    """Train tiny gemma2-2b 2 steps, checkpoint, restore the same
    parameters, generate 8 tokens through the paged walk."""
    out = _example("torch_quickstart").main(["--steps", "2", "--device",
                                             "cpu"])
    text = capsys.readouterr().out
    assert "parameters equal" in text and "generated:" in text
    toks = out["tokens"]
    assert toks.shape == (2, 24) and bool((toks[:, :16] == 1).all())
    assert [h["step"] for h in out["history"]] == [0, 1]


@pytest.mark.parametrize("target", ["decode-edge", "prefill-node",
                                    "train-2node"])
def test_nas_specialize_example_on_the_cpu(target, capsys):
    ex = _example("torch_nas_specialize")
    assert set(ex.TARGETS) == {"decode-edge", "prefill-node", "train-2node"}
    out = ex.main(["--target", target, "--steps", "2", "--layers", "2",
                   "--device", "cpu"])
    assert ex.TARGETS[target][0].name in capsys.readouterr().out
    arch = out["search"]["arch"]
    assert len(arch) == 2 and set(arch) <= set(CANDIDATE_OPS)
    assert math.isfinite(out["search"]["e_lat_us"])
