"""The port's AMC tables and the roofline report
(src/repro_torch/tables/table3_amc_speedup.py, table4_amc_vs_uniform.py,
roofline_report.py with Fig. 4) against the reference's ``benchmarks/``
on the CPU, on the reference's subject (tests/tables_parity.py: how the
two runs are made and held, and every tolerance). Subjects: tiny
granite-3-8b trained SUBJECT_STEPS steps and tiny granite-moe-3b-a800m
at 0 steps (one more compiled training run would not fit the file's
time).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline_report as j_roof  # noqa: E402
from benchmarks import table3_amc_speedup as j_t3  # noqa: E402
from benchmarks import table4_amc_vs_uniform as j_t4  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import amc as j_amc  # noqa: E402
from repro.core import haq as j_haq  # noqa: E402
from repro.core import hardware_model as j_hwm  # noqa: E402
from repro_torch.core import amc as t_amc  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.tables import roofline_report as t_roof  # noqa: E402
from repro_torch.tables import table3_amc_speedup as t_t3  # noqa: E402
from repro_torch.tables import table4_amc_vs_uniform as t_t4  # noqa: E402
from tables_parity import (GRANITE, MOE, REL, SUBJECT_STEPS,  # noqa: E402
                           hold_amc, hold_rows, make_subjects, port_run,
                           reference_run, rel)

torch.set_num_threads(1)

AMC_EPISODES = 3


@pytest.fixture(scope="module")
def subjects():
    return make_subjects({GRANITE: SUBJECT_STEPS, MOE: 0})


def test_table3_amc_speedup(subjects, monkeypatch, capsys):
    want = reference_run(monkeypatch, capsys, j_t3, subjects,
                         episodes=AMC_EPISODES)
    _, jp, _, tm, tp, tv = subjects[GRANITE]
    got, res = port_run(monkeypatch, t_t3, subject=(tm, tp, tv),
                        hw=t_hwm.V5E_EDGE, episodes=AMC_EPISODES)
    hold_rows(got, want)
    hold_amc(got, want)
    mlb_t, mlb_j = got.log["model_latency_bytes"], \
        want.log["model_latency_bytes"]
    assert len(mlb_t) == len(mlb_j) == 3
    for (lat, mem), (jlat, jmem) in zip(mlb_t, mlb_j):
        assert rel(lat, jlat) < REL and rel(mem, jmem) < REL
    for best, target in res["amc"]:
        assert best["flops_frac"] <= target + 1e-6


def test_model_latency_bytes_matches_reference(subjects):
    """At ratios off the searches' path, on the reference's edge chip and
    on the port's own H100 (the reference's model priced on a Hardware of
    the same fields)."""
    jm, _, _, tm, _, _ = subjects[GRANITE]
    jl = j_amc.enumerate_layers(jm, tokens=4096)
    tl = t_amc.enumerate_layers(tm, tokens=4096)
    jh100 = j_hwm.Hardware(**{f.name: getattr(t_hwm.H100_SXM, f.name)
                              for f in dataclasses.fields(t_hwm.H100_SXM)})
    for ratios in ([1.0, 1.0], [0.5, 0.25], [0.2, 0.9]):
        lat, mem = t_t3.model_latency_bytes(tm, ratios, tl, t_hwm.V5E_EDGE)
        jlat, jmem = j_t3.model_latency_bytes(jm, ratios, jl)
        assert rel(lat, jlat) < REL and rel(mem, jmem) < REL
        lat, _ = t_t3.model_latency_bytes(tm, ratios, tl)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_t3, "V5E_EDGE", jh100)
            jlat, _ = j_t3.model_latency_bytes(jm, ratios, jl)
        assert rel(lat, jlat) < REL


def test_table4_amc_vs_uniform(subjects, monkeypatch, capsys):
    want = reference_run(monkeypatch, capsys, j_t4, subjects,
                         episodes=AMC_EPISODES)
    got, res = port_run(
        monkeypatch, t_t4, episodes=AMC_EPISODES,
        subjects={a: subjects[a][3:] for a in (GRANITE, MOE)})
    hold_rows(got, want)
    hold_amc(got, want)
    assert [t for _, t in res["amc"]] == [0.5, 0.7, 0.5, 0.7]
    for best, target in res["amc"]:
        assert best["flops_frac"] <= target + 1e-6


# ------------------------------------------------------ roofline report ----
def test_roofline_report_matches_reference(tmp_path, monkeypatch, capsys):
    """One dry-run record, in the layout both dry-runs write, gives the
    same row; Fig. 4's six sites the same names, intensities and priced
    latencies on the reference's edge chip."""
    rec = {"arch": "gemma2-2b", "shape": "decode_32k", "roofline": {
        "bottleneck": "collective", "t_compute_s": 2.8e-05,
        "t_memory_s": 1.2e-3, "t_collective_s": 7.4e-3,
        "useful_flops_ratio": 0.0631, "mfu_bound": 0.0038}}
    (tmp_path / "gemma2-2b__decode_32k__single.json").write_text(
        json.dumps(rec))
    monkeypatch.setattr(j_roof, "ART", tmp_path)
    capsys.readouterr()
    j_roof.main()
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    got = t_roof.main(art=tmp_path, hw=t_hwm.V5E_EDGE)["rows"]
    assert [n for n, _, _ in got] == [ln.split(",")[0] for ln in want]
    assert ",".join(f"{x:.4g}" if isinstance(x, float) else x
                    for x in got[0]) == want[0]
    jsites = j_haq.enumerate_sites(j_get_config(t_roof.FIG4_ARCH), batch=1,
                                   seq=4096, decode=True)[:6]
    for ts, js in zip(t_roof.fig4_sites(), jsites):
        assert ts.name == js.name
        for bits in ((16, 16), (4, 8), (8, 16), (4, 16)):
            assert rel(ts.cost.intensity(*bits),
                        js.cost.intensity(*bits)) < REL
            assert rel(ts.latency(t_hwm.V5E_EDGE, *bits),
                        js.latency(j_hwm.V5E_EDGE, *bits)) < REL
    # no records: says so and prints Fig. 4 alone
    empty = tmp_path / "none"
    capsys.readouterr()
    rows = t_roof.main(art=empty)["rows"]
    assert "no dry-run records" in capsys.readouterr().out
    assert [n for n, _, _ in rows] == [f"fig4/{s.name}" for s in jsites]
