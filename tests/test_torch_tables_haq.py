"""The port's HAQ tables (src/repro_torch/tables/table5_cross_hw_quant.py,
table6_haq_latency.py, table7_transfer.py) against the reference's
``benchmarks/`` on the CPU, on the reference's subject
(tests/tables_parity.py: how the two runs are made and held, and every
tolerance). Subjects: tiny granite-3-8b trained SUBJECT_STEPS steps and
tiny llava-next-mistral-7b at 0 steps (one more compiled training run
would not fit the file's time).
"""
import pytest

torch = pytest.importorskip("torch")

from benchmarks import table5_cross_hw_quant as j_t5  # noqa: E402
from benchmarks import table6_haq_latency as j_t6  # noqa: E402
from benchmarks import table7_transfer as j_t7  # noqa: E402
from repro_torch.core import hardware_model as t_hwm  # noqa: E402
from repro_torch.tables import table5_cross_hw_quant as t_t5  # noqa: E402
from repro_torch.tables import table6_haq_latency as t_t6  # noqa: E402
from repro_torch.tables import table7_transfer as t_t7  # noqa: E402
from tables_parity import (GRANITE, LLAVA, SUBJECT_STEPS,  # noqa: E402
                           hold_haq, hold_rows, make_subjects, port_run,
                           reference_run, t_hw)

torch.set_num_threads(1)

HAQ_EPISODES = {"table5": 4, "table6": 2, "table7": 2}


@pytest.fixture(scope="module")
def subjects():
    return make_subjects({GRANITE: SUBJECT_STEPS, LLAVA: 0})


def test_table5_cross_hw_quant(subjects, monkeypatch, capsys):
    """Ten episodes: the agents train in the last (7 sites x 10 episodes
    fill the 64-row replay batch)."""
    want = reference_run(monkeypatch, capsys, j_t5, subjects,
                         episodes=HAQ_EPISODES["table5"])
    targets = {n: (t_hw(hw), kw, mode, frac)
               for n, (hw, kw, mode, frac) in j_t5.TARGETS.items()}
    got, res = port_run(monkeypatch, t_t5, subject=subjects[GRANITE][3:],
                        targets=targets, episodes=HAQ_EPISODES["table5"])
    hold_rows(got, want)
    hold_haq(got, want)
    # the cross matrix: 3 base resources, then 3 x 3 cells, as called
    assert len(got.log["resource"]) == 3 + 9
    for best in res["haq"]:
        assert best["resource"] <= best["budget"] * (1 + 1e-6)


def test_table6_haq_latency(subjects, monkeypatch, capsys):
    want = reference_run(monkeypatch, capsys, j_t6, subjects,
                         episodes=HAQ_EPISODES["table6"])
    regimes = ((t_hwm.V5E_EDGE, dict(batch=1, seq=4096, decode=True),
                "edge"),
               (t_hwm.V5E_POD, dict(batch=8, seq=4096, decode=False),
                "cloud"))
    got, res = port_run(monkeypatch, t_t6, subject=subjects[GRANITE][3:],
                        regimes=regimes, episodes=HAQ_EPISODES["table6"])
    hold_rows(got, want)
    hold_haq(got, want)
    for best in res["haq"]:
        assert best["resource"] <= best["budget"] * (1 + 1e-6)


def test_table7_transfer(subjects, monkeypatch, capsys):
    """The last rollout of each run is the zero-episode transfer of A's
    agents to B: the same policy as the reference's."""
    want = reference_run(monkeypatch, capsys, j_t7, subjects,
                         episodes=HAQ_EPISODES["table7"])
    got, res = port_run(
        monkeypatch, t_t7, hw=t_hwm.V5E_EDGE,
        episodes=HAQ_EPISODES["table7"],
        subjects={a: subjects[a][3:] for a in (GRANITE, LLAVA)})
    hold_rows(got, want)
    hold_haq(got, want)
    assert res["transfer"]["policy"] == got.log["HAQEnv"][-1]["policy"]
    assert res["transfer"]["policy"] == {
        k: tuple(int(x) for x in v)
        for k, v in want.log["HAQEnv"][-1]["policy"].items()}
