"""Atomic, async, restart-discoverable checkpoints (port of
``repro.checkpoint.ckpt``), in the reference's on-disk layout.

``<dir>/step_<N>/`` holds ``arrays.npz`` (each leaf as a flat uint8 byte
view under ``leaf_<i>``), ``tree.json`` (each leaf's dtype name and shape,
the step, the time) and the ``DONE`` sentinel. A save writes
``step_<N>.tmp`` and renames it, atomic on POSIX, so a crash mid-write
never leaves a restore point behind. Leaves are in the reference's order
(dicts flattened by sorted key, as ``jax.tree`` does), so a checkpoint
written by either package restores in the other: bf16 leaves are their
raw bytes under the dtype name "bfloat16", read back without ml_dtypes.
``latest_step`` is the trainer's restart discovery.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.convert import DTYPES
from repro_torch.models.params import tree_leaves, tree_unflatten

_SENTINEL = "DONE"
_NAMES = {v: k for k, v in DTYPES.items()}     # torch dtype -> tree.json


def _treedef(tree) -> str:
    """The structure as the reference's ``str(treedef)`` prints it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _to_bytes(t: torch.Tensor):
    """(flat uint8 numpy view of a CPU tensor's bytes, dtype name)."""
    t = t.detach().contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {t.dtype}")
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8), name


def _flatten(tree):
    """(byte views by ``leaf_<i>``, each leaf's dtype name and shape). A
    0-d leaf is recorded with shape [1], as the reference's writer records
    it (its ``np.ascontiguousarray`` makes scalars 1-d)."""
    arrays, meta = {}, []
    for i, x in enumerate(tree_leaves(tree)):
        raw, name = _to_bytes(x.cpu())
        meta.append({"dtype": name, "shape": list(x.shape) or [1]})
        arrays[f"leaf_{i}"] = raw
    return arrays, meta


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> Path:
    """Atomic synchronous save. Returns the final path."""
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step}.tmp"
    final = root / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays, meta = _flatten(tree)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "tree.json").write_text(json.dumps({
        "treedef": _treedef(tree),
        "leaves": meta,
        "step": step,
        "time": time.time(),
    }))
    (tmp / _SENTINEL).write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(root, keep)
    return final


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype not in DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {dtype!r} has no torch "
                        f"dtype")
    td = DTYPES[dtype]
    if td == torch.bfloat16:
        return torch.from_numpy(raw.view(np.int16).copy()) \
            .view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype)).copy()).reshape(shape)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None, *,
            place=None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf in the dtype the
    checkpoint recorded, in the shape of ``like``'s leaf (the recorded one
    may be [1] for a scalar, see ``_flatten``; the element counts must
    agree) and on its device, or, with ``place``, as ``place(leaf, i)``
    makes it from the whole leaf ``i`` in host memory (a sharded
    trainer's block of it). Returns (tree, step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = Path(ckpt_dir) / f"step_{step}"
    data = np.load(path / "arrays.npz")
    meta = json.loads((path / "tree.json").read_text())["leaves"]
    leaves = tree_leaves(like)
    assert len(leaves) == len(meta), \
        f"checkpoint has {len(meta)} leaves, model needs {len(leaves)}"
    out = []
    for i, (m, leaf) in enumerate(zip(meta, leaves)):
        t = _from_bytes(data[f"leaf_{i}"], m["dtype"], m["shape"])
        if t.numel() != leaf.numel():
            raise ValueError(f"checkpoint leaf {i} has shape {m['shape']}, "
                             f"the model's {list(leaf.shape)}")
        t = t.reshape(leaf.shape)
        out.append(t.to(leaf.device) if place is None else place(t, i))
    return tree_unflatten(like, out), step


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = []
    for p in root.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                and (p / _SENTINEL).exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _gc(root: Path, keep: int):
    steps = sorted(int(p.name.split("_")[1]) for p in root.iterdir()
                   if p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(root / f"step_{s}", ignore_errors=True)


class AsyncCheckpointer:
    """One save in flight at a time (a new save waits for the previous
    one). The state is copied to host memory before the call returns: the
    optimizer updates its tensors in place, and a CPU tensor's ``.cpu()``
    is the same storage, so the copy is forced."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = tree_unflatten(tree, [x.detach().to("cpu", copy=True)
                                    for x in tree_leaves(tree)])

        def _work():
            save(self.ckpt_dir, step, host_tree, keep=self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
