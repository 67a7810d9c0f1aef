"""The port stands alone: importing every ``repro_torch`` module pulls in
no ``jax*`` and no ``repro.*`` module (checked in a fresh interpreter),
and no source of the port, its examples (``examples/torch_*.py``) or
``chip_smoke.py`` imports either (static scan). Also the hardware targets
the port's tables price on (core/hardware_model.py)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "examples").glob("torch_*.py"))


def _modules():
    names = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "             or n == 'repro')\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_source_imports_jax_or_the_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_examples_are_scanned():
    assert {p.name for p in SOURCES if p.parent.name == "examples"} == {
        "torch_quickstart.py", "torch_compress_pipeline.py",
        "torch_nas_specialize.py", "torch_train_lm.py"}


def test_h100_multi_card_targets():
    """The DGX H100 node (8 cards over NVLink, 450 GB/s each way) and two
    nodes over one 400 Gb/s NDR InfiniBand port a card (50 GB/s): one
    H100 SXM's per-card terms, kept out of the serving registry."""
    from repro_torch.core import hardware_model as hwm
    for hw, name, chips, ici in ((hwm.H100_NODE8, "h100-node8", 8, 450e9),
                                 (hwm.H100_2NODE16, "h100-2node16", 16,
                                  50e9)):
        assert (hw.name, hw.chips, hw.ici_bw) == (name, chips, ici)
        assert (hw.peak_flops_bf16, hw.peak_flops_int8, hw.hbm_bw,
                hw.hbm_bytes) == (989e12, 1979e12, 3.35e12, 80 * 2**30)
        for f in ("pj_per_flop", "pj_per_hbm_byte", "pj_per_ici_byte"):
            assert getattr(hw, f) == getattr(hwm.H100_SXM, f)
        assert name not in hwm.HARDWARES and hw not in \
            hwm.HARDWARES.values()
    assert set(hwm.HARDWARES) == {"v5e-1chip", "v5e-pod256", "v5e-2pod512",
                                  "h100-sxm"}
