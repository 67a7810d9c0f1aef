"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) on the CPU:
the reference's substrate tests (bf16 roundtrip, atomicity and gc) on the
port, and checkpoints crossing packages in the reference's on-disk layout:
the port's save restored by ``repro.checkpoint.ckpt.restore`` and the
reference's save restored by the port, bit for bit, train states with
fp32 and quantized moments included; the async writer's host copy."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import tiny_config as j_tiny  # noqa: E402
from repro.configs.base import OptimConfig as JOptim  # noqa: E402
from repro.models.api import build_model as j_build  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.models.convert import from_jax_state  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402


def _tree():
    return {"a": torch.ones((3, 4), dtype=torch.bfloat16) * 1.5,
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.zeros((2,), dtype=torch.float32)}}


def _bits(t):
    """A leaf's raw bytes, whichever package holds it."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes(), str(t.dtype).split(".")[-1], \
            tuple(t.shape)
    a = np.asarray(t)
    return a.tobytes(), str(a.dtype), tuple(a.shape)


def _same(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert _bits(a) == _bits(b)


def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree)
    like = tree_map(torch.zeros_like, tree)
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 7
    _same(tree_leaves(tree), tree_leaves(restored))
    meta = json.loads((tmp_path / "step_7" / "tree.json").read_text())
    assert [m["dtype"] for m in meta["leaves"]] == \
        ["bfloat16", "int32", "float32"]
    assert meta["treedef"] == "PyTreeDef({'a': *, 'b': {'c': *, 'd': *}})"


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5]
    # a .tmp dir (simulated crash) is never picked up
    (tmp_path / "step_9.tmp").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5
    # nor a directory without its DONE sentinel
    (tmp_path / "step_11").mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


def _jax_state(quantized):
    model = j_build(j_tiny("gemma2-2b"))
    params = model.init(jax.random.PRNGKey(0))
    ocfg = JOptim(lr=0.01, warmup_steps=1, total_steps=10,
                  quantized_moments=quantized)
    state = {"params": params, "opt": jadam.adamw_init(params, ocfg)}
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    new_params, opt, _ = jadam.adamw_update(grads, state["opt"], ocfg)
    return {"params": new_params, "opt": opt}


@pytest.mark.parametrize("quantized", [False, True])
def test_checkpoints_cross_packages(tmp_path, quantized):
    """The reference writes, the port restores (into its own train
    state's structure); the port writes, the reference restores: every
    leaf bit for bit, bf16 parameters, fp32 master and moments (or int8
    codes and fp32 scales) and the int32 count."""
    jstate = _jax_state(quantized)
    jckpt.save(str(tmp_path / "ref"), 3, jstate)
    like = from_jax_state(jax.tree.map(
        lambda a: np.zeros(a.shape, np.asarray(a).dtype), jstate))
    tstate, step = ckpt.restore(str(tmp_path / "ref"), like)
    assert step == 3
    _same(jax.tree.leaves(jstate), tree_leaves(tstate))
    assert tstate["opt"]["count"].dtype == torch.int32

    ckpt.save(str(tmp_path / "port"), 4, tstate)
    back, step = jckpt.restore(str(tmp_path / "port"), jstate)
    assert step == 4
    # the reference's restore gives its scalar count the recorded shape
    # [1] whoever wrote it (its own writer records scalars so)
    _same([np.reshape(a, np.shape(b)) for a, b in
           zip(jax.tree.leaves(jstate), jax.tree.leaves(back))],
          jax.tree.leaves(back))
    ref_meta = json.loads((tmp_path / "ref" / "step_3" / "tree.json")
                          .read_text())
    port_meta = json.loads((tmp_path / "port" / "step_4" / "tree.json")
                           .read_text())
    assert ref_meta["leaves"] == port_meta["leaves"]
    assert ref_meta["treedef"] == port_meta["treedef"]


def test_async_checkpointer_takes_a_host_copy(tmp_path):
    """The optimizer updates in place: a save must hold the values of the
    moment it was called, whatever the caller does to its tensors next."""
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    writer = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    writer.save(1, tree)
    tree["w"].add_(100.0)
    writer.wait()
    assert writer.last_saved == 1
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(restored["w"], torch.arange(6, dtype=torch.float32))
