"""The port's two examples that train for many steps
(examples/torch_train_lm.py, torch_compress_pipeline.py; the other two are
in tests/test_torch_tables_nas.py), each ``main`` on the CPU at its
smallest settings (``--device cpu``): what each prints and returns, and
the budgets its searches must meet. The examples import only
``repro_torch`` (tests/test_torch_isolation.py), so nothing here runs the
reference.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import haq  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_lm_example_on_the_cpu(tmp_path, capsys):
    """The example's model, 4 steps at B 1 x 16: the loss falls (the
    example's own assertion; in the first steps from its init, inside the
    learning rate's warmup, it may rise first), a checkpoint written under
    --ckpt-dir."""
    ex = _example("torch_train_lm")
    out = ex.main(["--steps", "4", "--batch", "1", "--seq", "16",
                   "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    n = ex.build_model(ex.CFG_100M).param_count()
    assert f"repro-lm-100m: {n:,} params on 1 device(s)" in \
        capsys.readouterr().out
    assert [h["step"] for h in out["history"]] == [0, 3]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert (tmp_path / "step_3" / "DONE").exists()


def test_compress_pipeline_example_on_the_cpu(capsys):
    """examples/torch_compress_pipeline.py at its settings (the reference's:
    80 steps, AMC to 60% FLOPs over 16 episodes, HAQ over 12 at 0.55 of
    the W8A8 decode latency on one H100), on the CPU: each stage's result
    within its budget, and stage 3 serves 8 tokens through the hook."""
    out = _example("torch_compress_pipeline").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "pipeline complete: prune -> quantize -> serve" in text
    assert out["amc"]["flops_frac"] <= 0.6 + 1e-6
    assert out["haq"]["resource"] <= out["haq"]["budget"] * (1 + 1e-6)
    assert set(out["policy"]) == {s.name for s in haq.enumerate_sites(
        get_config("granite-3-8b"), 1, 4096, decode=True)}
    toks = out["tokens"]
    assert toks.shape == (1, 24) and torch.equal(toks[:, :16],
                                                 out["prompt"])
    assert int(toks.min()) >= 0 and int(toks.max()) < out["model"].cfg.\
        vocab_size
