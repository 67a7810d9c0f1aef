"""The port's serving autotuner (src/repro_torch/serving/autotune, the
engine's ``roofline_scales`` and the launcher's ``--autotune`` /
``--serving-config``) against the reference, on the same inputs.

The mesh dimension: ``ConfigSpace(max_devices=N)`` for N = 2, 4 and 8
lists the reference's candidates, and the search ranks them as the
reference's does under injected calibration scales. In one process a
candidate with ``mesh_model > 1`` is wider than the world and
unmeasurable; in a gloo world of 2 ranks (``launch.mesh.spawn``) a
``mesh_model = 2`` candidate is measured on the sharded engine over both
ranks, a ``mesh_model = 1`` one on rank 0 alone, and every rank returns
rank 0's numbers, so ``autotune_serving_config`` and ``serve.main
--autotune`` pick the same winner on both.

Tolerances. Scores are the admission roofline, float64 in the port and
float32 per op in the reference: a relative 1e-6. Discrete choices —
dims, encodings, violations, searched configs, rankings — are equal.
The DDPG searcher carries the reference's initial agent weights
(tests/test_torch_haq.py says why).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as j_configs  # noqa: E402
from repro.core import hardware_model as j_hwm  # noqa: E402
from repro.core.rl import ddpg as j_ddpg  # noqa: E402
from repro.serving import autotune as j_at  # noqa: E402
from repro.serving.telemetry import ScaleLookup as JScales  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.core.rl import ddpg as t_ddpg  # noqa: E402
from repro_torch.models.api import build_model as t_build  # noqa: E402
from repro_torch.serving import autotune as t_at  # noqa: E402
from repro_torch.serving.autotune import search as t_search  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402
from repro_torch.serving.telemetry import ScaleLookup  # noqa: E402

torch.set_num_threads(1)

REL = 1e-6
ARCH = "gemma2-2b"
MAX_LEN = 96
SCALES = dict(by_shape={("decode", 8, 1): 700.0, ("chunk", 1, 32): 30.0},
              by_kind={"decode": 900.0, "chunk": 40.0})


def carried_ddpg(cfg, seed=0, **kw):
    """The port's agent with the reference's initial weights."""
    ref = j_ddpg.DDPG(j_ddpg.DDPGConfig(**dataclasses.asdict(cfg)),
                      seed=seed)
    agent = t_ddpg.DDPG(cfg, seed=seed, **kw)
    layers = [[{k: np.asarray(v) for k, v in layer.items()} for layer in p]
              for p in (ref.actor, ref.critic)]
    agent.set_weights(*layers)
    return agent


def spaces(tiny=True, hw="v5e-1chip", max_len=MAX_LEN, **kw):
    get = "tiny_config" if tiny else "get_config"
    jhw = j_hwm.HARDWARES.get(hw) or j_hwm.Hardware(**{
        f.name: getattr(t_hwm.HARDWARES[hw], f.name)
        for f in dataclasses.fields(t_hwm.Hardware)})
    kw = dict(max_model_len=max_len, max_devices=1, **kw)
    return (j_at.ConfigSpace(getattr(j_configs, get)(ARCH), jhw, **kw),
            t_at.ConfigSpace(getattr(t_configs, get)(ARCH),
                             t_hwm.HARDWARES[hw], **kw))


def _close(got, want):
    """Equal, or within REL for floats."""
    if isinstance(want, float) and isinstance(got, float):
        return got == want or abs(got - want) <= REL * max(abs(want), 1e-30)
    return got == want


def _samples(space, n, seed):
    rng = np.random.default_rng(seed)
    return [space.default()] + [space.sample(rng) for _ in range(n)]


# the reference prices each full-width candidate in ~1 s of eager jnp ops
SAMPLES = {"tiny-v5e": 24, "full-h100": 3}
SPACE_CASES = {"tiny-v5e": dict(),
               "full-h100": dict(tiny=False, hw="h100-sxm", max_len=272,
                                 param_bytes=5_228_000_000)}


@pytest.mark.parametrize("case", sorted(SPACE_CASES))
def test_config_space_matches_reference(case):
    js, ts = spaces(**SPACE_CASES[case])
    assert ts.dims == js.dims and dict(ts.dims)["mesh_model"] == (1,)
    assert ts.size() == js.size()
    assert ts.default().as_dict() == js.default().as_dict()
    for kv in t_at.KV_POLICIES:
        assert ts.kv_bits_for(kv) == js.kv_bits_for(kv)
    jc = j_at.ServingConfig
    for c in _samples(ts, SAMPLES[case], seed=0):
        assert np.array_equal(ts.encode(c), js.encode(jc(**c.as_dict())))
        assert ts.decode(ts.encode(c)) == c
        assert js.decode(ts.encode(c)).as_dict() == c.as_dict()
        assert ts.violations(c) == js.violations(jc(**c.as_dict())), c
        if not ts.violations(c):
            got = dataclasses.asdict(ts.to_policy(c))
            want = dataclasses.asdict(js.to_policy(jc(**c.as_dict())))
            assert got.keys() == want.keys()
            for k in want:
                assert _close(got[k], want[k]), (c, k, got[k], want[k])
    vec = np.random.default_rng(1).random(ts.num_dims)
    assert ts.decode(vec).as_dict() == js.decode(vec).as_dict()
    bad = dataclasses.replace(ts.default(), page_size=7)
    assert ts.violations(bad) == js.violations(jc(**bad.as_dict())) != ()


@pytest.mark.parametrize("slo", (None, 1e-4))
@pytest.mark.parametrize("case", sorted(SPACE_CASES))
def test_objective_matches_reference(case, slo):
    js, ts = spaces(**SPACE_CASES[case])
    jo = j_at.Objective(js, scales=JScales(**SCALES), prompt_len=24,
                        ttft_slo_s=slo)
    to = t_at.Objective(ts, scales=ScaleLookup(**SCALES), prompt_len=24,
                        ttft_slo_s=slo)
    for c in _samples(ts, SAMPLES[case], seed=2):
        got = to(c).as_dict()
        want = jo(j_at.ServingConfig(**c.as_dict())).as_dict()
        assert got.keys() == want.keys()
        for k in want:
            assert _close(got[k], want[k]), (c, k, got[k], want[k])


def test_serving_config_json_crosses_packages(tmp_path):
    """A record written by either package loads in the other, and both
    write the same bytes for the same config."""
    js, ts = spaces()
    c = ts.from_indices([1, 2, 3, 2, 0, 1])
    jc = j_at.ServingConfig(**c.as_dict())
    prov = dict(budget=8, seed=0, rank_correlation=None, note="x")
    jrec = j_at.config_record(js, jc, **prov)
    trec = t_at.config_record(ts, c, **prov)
    assert trec == jrec
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    j_at.save_serving_config(str(jp), jrec)
    t_at.save_serving_config(str(tp), trec)
    assert tp.read_bytes() == jp.read_bytes()
    assert t_at.load_serving_config(str(jp)) == (c, jrec)
    assert j_at.load_serving_config(str(tp)) == (jc, json.loads(
        tp.read_text()))
    tp.write_text(json.dumps(dict(trec, schema=2)))
    with pytest.raises(ValueError, match="schema"):
        t_at.load_serving_config(str(tp))


def test_spearman_matches_reference():
    rng = np.random.default_rng(0)
    cases = [([1, 2], [2, 1]), ([1, 1, 1], [1, 2, 3]),
             ([1, 2, 2, 3], [1, 2, 3, 4])]
    cases += [(rng.random(n), rng.random(n)) for n in (3, 5, 9)]
    cases += [(rng.integers(0, 3, 8), rng.integers(0, 4, 8))
              for _ in range(3)]
    for xs, ys in cases:
        assert t_at.spearman(xs, ys) == j_at.spearman(xs, ys)


@pytest.mark.parametrize("seed", (0, 3))
def test_evolutionary_search_matches_reference(seed):
    js, ts = spaces()
    want = j_at.evolutionary_search(js, j_at.Objective(js), budget=16,
                                    seed=seed)
    got = t_at.evolutionary_search(ts, t_at.Objective(ts), budget=16,
                                   seed=seed)
    assert [s.config.as_dict() for s in got] \
        == [s.config.as_dict() for s in want]
    for g, w in zip(got, want):
        assert _close(g.score, w.score) or g.score == w.score


def test_ddpg_search_matches_reference(monkeypatch):
    """16 episodes over 6 knobs: the agent trains from episode 11 on
    (warmup 8, replay batch 64); every candidate, in order, agrees."""
    monkeypatch.setattr(t_search, "DDPG", carried_ddpg)
    js, ts = spaces()
    want = j_at.ddpg_search(js, j_at.Objective(js), budget=16, seed=0)
    got = t_at.ddpg_search(ts, t_at.Objective(ts), budget=16, seed=0)
    assert [s.config.as_dict() for s in got] \
        == [s.config.as_dict() for s in want]
    r_j = j_at.search_serving_config(js, j_at.Objective(js), budget=8)
    r_t = t_at.search_serving_config(ts, t_at.Objective(ts), budget=8)
    assert [s.config.as_dict() for s in r_t.ranked] \
        == [s.config.as_dict() for s in r_j.ranked]
    assert (r_t.evaluated, r_t.admissible) == (r_j.evaluated, r_j.admissible)


@pytest.mark.parametrize("devices", [2, 4, 8])
def test_mesh_dimension_and_ranking_match_reference(devices, monkeypatch):
    """max_devices = the world: the mesh choices, the candidates' encodings
    and violations, and the searched ranking under injected scales."""
    monkeypatch.setattr(t_search, "DDPG", carried_ddpg)
    jhw = j_hwm.HARDWARES["v5e-1chip"]
    for arch in (ARCH, "granite-3-8b"):
        kw = dict(max_model_len=MAX_LEN, max_devices=devices)
        js = j_at.ConfigSpace(j_configs.tiny_config(arch), jhw, **kw)
        ts = t_at.ConfigSpace(t_configs.tiny_config(arch),
                              t_hwm.HARDWARES["v5e-1chip"], **kw)
        assert ts.dims == js.dims and ts.size() == js.size()
        assert dict(ts.dims)["mesh_model"] == \
            tuple(m for m in (1, 2, 4, 8) if m <= devices and m <= 2)
        for c in _samples(ts, 12, seed=devices):
            jc = j_at.ServingConfig(**c.as_dict())
            assert np.array_equal(ts.encode(c), js.encode(jc))
            assert ts.violations(c) == js.violations(jc)
        jo = j_at.Objective(js, scales=JScales(**SCALES), prompt_len=24)
        to = t_at.Objective(ts, scales=ScaleLookup(**SCALES), prompt_len=24)
        want = j_at.search_serving_config(js, jo, budget=16, seed=1)
        got = t_at.search_serving_config(ts, to, budget=16, seed=1)
        assert [s.config.as_dict() for s in got.ranked] \
            == [s.config.as_dict() for s in want.ranked]
        assert any(s.config.mesh_model > 1 for s in got.ranked)


def _world_tune(rank, world, device, out_file):
    """A rank of a gloo world of 2: a mesh_model=2 candidate and a
    mesh_model=1 one measured, then the whole loop; each rank's view."""
    cfg, model, params = _tiny_model()
    space = t_at.ConfigSpace(cfg, t_hwm.V5E_EDGE, max_model_len=48,
                             max_devices=world, max_batch_cap=4,
                             param_bytes=model.param_bytes())
    out = {}
    for m in (2, 1):
        c = dataclasses.replace(space.default(), mesh_model=m)
        got = t_at.measure_candidate(
            model, params, space,
            t_at.ScoredCandidate(config=c, score=1.0, admissible=True),
            _reqs(cfg))
        out[m] = dataclasses.asdict(got)
    wide = dataclasses.replace(space.default(), mesh_model=4)
    out["wide"] = t_at.measure_candidate(
        model, params, space,
        t_at.ScoredCandidate(config=wide, score=1.0, admissible=True),
        _reqs(cfg))
    tune = t_at.autotune_serving_config(model, params, space, _reqs(cfg),
                                        budget=10, top_k=10, seed=0)
    out["tune"] = {"winner": tune.winner.scored.config.as_dict(),
                   "measured": [(m.scored.config.as_dict(), m.decode_tok_s)
                                for m in tune.validated],
                   "scales": tune.scales.as_dict()}
    import contextlib
    import io
    from repro_torch.launch import serve
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        serve.main(["--arch", ARCH, "--tiny", "--device", "cpu",
                    "--requests", "3", "--prompt-len", "24", "--gen", "8",
                    "--max-batch", "4", "--autotune", "8",
                    "--autotune-out", out_file])
    out["cli"] = [x.split("winner ", 1)[1]
                  for x in (so.getvalue() + se.getvalue()).splitlines()
                  if "]: winner " in x]
    out["measured_line"] = [x for x in so.getvalue().splitlines()
                            if "]: measured " in x]
    return out


def test_mesh_candidates_measured_alike_in_a_gloo_world(tmp_path):
    """measure_candidate, autotune_serving_config and serve.main
    --autotune in a gloo world of 2: the same numbers and winner on both
    ranks, a mesh_model=2 candidate measured, the record loadable."""
    from repro_torch.launch.mesh import spawn
    out_file = str(tmp_path / "serving.json")
    a, b = spawn(_world_tune, 2, backend="gloo", timeout_s=240.0,
                 args=(out_file,))
    assert {k: v for k, v in a.items() if k != "measured_line"} == \
        {k: v for k, v in b.items() if k != "measured_line"}
    assert a[2]["decode_tok_s"] > 0 and a[2]["decode_ticks"] > 0
    assert a[1]["decode_tok_s"] > 0 and a["wide"] is None
    measured = a["tune"]["measured"]
    assert a["tune"]["winner"] in [c for c, _ in measured]
    assert {c["mesh_model"] for c, _ in measured} == {1, 2}
    assert len(a["cli"]) == 1 and a["cli"] == b["cli"]
    assert len(a["measured_line"]) == 1
    sc, record = t_at.load_serving_config(out_file)
    assert str(sc.as_dict()) == a["cli"][0]
    assert record["provenance"]["candidates"] >= 1


# ------------------------------------------------------------- the engine --
def _tiny_model():
    cfg = t_configs.tiny_config(ARCH)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _reqs(cfg, n=3, prompt=24, gen=8):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(2, cfg.vocab_size, prompt)
                    .astype(np.int32), max_new=gen) for i in range(n)]


def test_engine_roofline_scales_reach_the_ticks():
    cfg, model, params = _tiny_model()
    policy = t_at.ConfigSpace(cfg, t_hwm.V5E_EDGE, max_model_len=48) \
        .to_policy(t_at.ConfigSpace(cfg, t_hwm.V5E_EDGE,
                                    max_model_len=48).default())
    raw = Engine(model, params, policy)
    scaled = Engine(model, params, policy,
                    roofline_scales=ScaleLookup(by_kind={"decode": 3.0}))
    for eng in (raw, scaled):
        eng.run(_reqs(cfg, n=2, gen=4))
    pred = {id(e): {(t.kind, t.batch, t.q_len): t.predicted_s
                    for t in e.telemetry.ticks} for e in (raw, scaled)}
    decode = [k for k in pred[id(raw)] if k[0] == "decode"]
    assert decode
    for k in pred[id(raw)]:
        want = pred[id(raw)][k] * (3.0 if k[0] == "decode" else 1.0)
        assert pred[id(scaled)][k] == pytest.approx(want)


def test_mesh_candidates_are_unmeasurable():
    cfg, model, params = _tiny_model()
    space = t_at.ConfigSpace(cfg, t_hwm.V5E_EDGE, max_model_len=48)
    c = dataclasses.replace(space.default(), mesh_model=2)
    sc = t_at.ScoredCandidate(config=c, score=1.0, admissible=True)
    assert t_at.measure_candidate(model, params, space, sc,
                                  _reqs(cfg)) is None


def test_autotune_end_to_end_tiny_engine():
    """The reference's end-to-end test on the port's tiny engine on the
    CPU: calibrate, search, validate, and the acceptance floor — the
    winner's measured decode tok/s never falls below the default's."""
    cfg, model, params = _tiny_model()
    space = t_at.ConfigSpace(cfg, t_hwm.V5E_EDGE, max_model_len=48,
                             max_devices=1, max_batch_cap=4,
                             param_bytes=model.param_bytes())
    tune = t_at.autotune_serving_config(model, params, space, _reqs(cfg),
                                        budget=10, top_k=2, seed=0)
    assert tune.searched_vs_default >= 0.95
    assert tune.winner.decode_tok_s >= tune.default.decode_tok_s * 0.95
    assert tune.search.evaluated >= 1 and tune.search.admissible >= 1
    assert tune.validated[0].scored.config == space.default()
    assert tune.scales.kinds()            # the warmup really calibrated
    assert all(m.scored.calibrated for m in tune.validated)
    rec = tune.record(space)
    assert rec["knobs"] == tune.winner.scored.config.as_dict()
    assert rec["provenance"]["searched_vs_default"] == pytest.approx(
        tune.searched_vs_default)
    json.dumps(rec)


# -------------------------------------------------------------------- CLI --
def test_serve_autotune_then_serving_config_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve
    out_file = tmp_path / "serving.json"
    base = ["--arch", ARCH, "--tiny", "--device", "cpu", "--requests", "3",
            "--prompt-len", "24", "--gen", "8", "--max-batch", "4"]
    serve.main(base + ["--autotune", "8", "--autotune-out", str(out_file)])
    tuned = capsys.readouterr().out
    assert "autotune[h100-sxm]: " in tuned and "candidates" in tuned
    record = json.loads(out_file.read_text())
    assert record["hw"] == "h100-sxm" and record["max_model_len"] == 32
    assert record["knobs"]["mesh_model"] == 1
    serve.main(base + ["--serving-config", str(out_file)])
    loaded = capsys.readouterr().out
    knobs = t_at.ServingConfig.from_dict(record["knobs"]).as_dict()
    assert f"serving-config[h100-sxm]: {knobs}" in loaded

    def line(out, prefix):
        return next(x for x in out.splitlines() if x.startswith(prefix))

    for prefix in ("admission[", "sample:"):
        assert line(tuned, prefix) == line(loaded, prefix)
    assert "served 3 requests, 24 tokens" in loaded


@pytest.mark.parametrize("flags", (
    ["--autotune", "8", "--serving-config", "x.json"],
    ["--autotune-out", "x.json"],
    ["--autotune", "8", "--kv-bits", "8"],
    ["--serving-config", "x.json", "--kv-policy", "haq"],
    ["--sequential", "--autotune", "8"],
), ids=("both", "out-alone", "kv-bits", "kv-policy", "sequential"))
def test_serve_autotune_flag_conflicts_exit(flags):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--tiny", "--device", "cpu", *flags])
