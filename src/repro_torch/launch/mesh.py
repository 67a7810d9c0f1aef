"""Serving, training and production meshes over ``torch.distributed``
(port of ``repro.launch.mesh``).

The reference drives every device from one host through ``shard_map``;
the port runs one process per device (a rank), every rank running the
same host loop. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with dims ``("data", "model")``: rank ``d * model + m`` sits at (d, m),
and each dim's process group (``mesh.get_group("model")``) carries the
engine's all-gathers. A mesh of several pods adds a leading ``"pod"``
dim: rank ``(p * data + d) * model + m`` sits at (p, d, m). Every group
is made here with a timeout, so a rank that raised leaves its peers to
time out rather than hang.

Backends are the caller's and are never switched on failure: ``nccl``
when each rank has its own card, ``gloo`` on the CPU, and gloo for two
ranks sharing one card (NCCL refuses two ranks on one device); the
sharded engine's collective stages a CUDA tensor through host memory
for a gloo group (distributed/sharding.py::all_gather_dim).

``make_production_mesh`` is the reference's (data 16, model 16) and
(pod 2, data 16, model 16): over a torchrun world of 256 or 512 ranks,
or, for the dry-run (launch/dryrun.py), over ``dry_world``: a world of
that size under torch's ``fake`` backend, of which this process is rank
0 and whose collectives move nothing.

Under ``torchrun --nproc-per-node N`` (``python -m
torch.distributed.run``) a process joins with ``init_from_env``;
``spawn`` starts a world of processes from Python (tests, chip_smoke.py)
with a ``file://`` rendezvous, so no port is taken.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def _timeout(s: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=s)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % cards}`` (torchrun's local
    rank; with fewer cards than ranks several share one, which NCCL
    refuses with its own error), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_from_env(backend: str, device: torch.device,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world ``torchrun`` describes (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT in the environment), once."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=_timeout(timeout_s),
                                **_device_id(backend, device))


def _device_id(backend: str, device: torch.device) -> dict:
    """NCCL binds a rank's communicators to its card when told which."""
    return {"device_id": device} if backend == "nccl" else {}


def make_serving_mesh(model: int = 1, data: int = 1, *,
                      device_type: str = "cuda",
                      backend: Optional[str] = None,
                      timeout_s: float = DEFAULT_TIMEOUT_S):
    """Explicit-size ("data", "model") mesh for the sharded serving engine
    (serving/engine/sharded.py). Sizes are taken literally, as the
    engine's exactness contract depends on them, and must equal the
    world size of the initialized process group. ``backend``, when
    given, must be the group's."""
    if model < 1 or data < 1:
        raise ValueError(f"mesh axes must be >= 1, got model={model} "
                         f"data={data}")
    n = model * data
    if not dist.is_initialized():
        raise ValueError(
            f"serving mesh model={model} x data={data} needs {n} processes "
            f"in an initialized process group; launch with torchrun "
            f"--nproc-per-node {n} (python -m torch.distributed.run)")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"serving mesh model={model} x data={data} needs {n} processes,"
            f" have {world} (launch with torchrun --nproc-per-node {n})")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    return _mesh(data, model, device_type, timeout_s)


def make_host_mesh(model: int = 1, *, device_type: str = "cpu",
                   timeout_s: float = DEFAULT_TIMEOUT_S):
    """Whatever-ranks-exist mesh: the initialized world split into
    ``world // model`` data rows of ``model`` ranks."""
    if not dist.is_initialized():
        raise ValueError("make_host_mesh needs an initialized process group "
                         "(torchrun, or launch.mesh.spawn)")
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"model={model}")
    return _mesh(world // model, model, device_type, timeout_s)


def make_sub_mesh(data: int, model: int, *, device_type: str = "cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S):
    """A ("data", "model") mesh over the first ``data * model`` ranks of
    the initialized world (the ranks ``shrink_mesh`` keeps): the mesh a
    state is resharded onto (``reshard_state``). Every rank of the world
    calls it, as each group is made by all of them; a rank outside the
    mesh gets None."""
    if model < 1 or data < 1:
        raise ValueError(f"mesh axes must be >= 1, got model={model} "
                         f"data={data}")
    if not dist.is_initialized() or data * model > dist.get_world_size():
        raise ValueError(f"a sub-mesh of data={data} x model={model} needs "
                         f"an initialized world of {data * model} ranks or "
                         f"more")
    return _mesh(data, model, device_type, timeout_s)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S):
    """The reference's production mesh: ("data", "model") of 16 x 16, or
    ("pod", "data", "model") of 2 x 16 x 16, over the initialized world,
    which must have that many ranks (torchrun, or ``dry_world``)."""
    pod, data, model = (2, 16, 16) if multi_pod else (1, 16, 16)
    n = pod * data * model
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(
            f"the production mesh {'2 x ' if multi_pod else ''}16 x 16 needs "
            f"an initialized world of {n} ranks (torchrun --nproc-per-node, "
            f"or launch.mesh.dry_world({n}) for a dry-run)")
    return _mesh(data, model, device_type, timeout_s, pod=pod)


@contextlib.contextmanager
def dry_world(n: int):
    """A world of ``n`` ranks under torch's ``fake`` backend, this process
    its rank 0, for the block: collectives return at once and move
    nothing, so a step traced on meta tensors (roofline/step_costs.py)
    issues every collective of rank 0 with its real shapes. Refused when
    a process group is already initialized; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dry_world needs a process without a process "
                           "group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(data: int, model: int, device_type: str, timeout_s: float,
          pod: int = 1):
    """Every rank of the world makes every model, data (and pod) group in
    the same order (a collective), then keeps its own; a rank outside the
    ``pod * data * model`` first ones gets None. ``pod`` > 1 adds a
    leading "pod" dim."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(pod * data * model).reshape(pod, data, model)
    me = dist.get_rank()
    lines = {"model": ranks.reshape(-1, model),
             "data": ranks.permute(0, 2, 1).reshape(-1, data),
             "pod": ranks.permute(1, 2, 0).reshape(-1, pod)}
    names = ("pod", "data", "model") if pod > 1 else ("data", "model")
    mine = {}
    for name in ("model", "data", "pod"):
        if name not in names:
            continue
        for members in lines[name].tolist():
            g = dist.new_group(members, timeout=_timeout(timeout_s))
            if me in members:
                mine[name] = g
    if not mine:
        return None
    return DeviceMesh.from_group([mine[a] for a in names], device_type,
                                 mesh=ranks if pod > 1 else ranks[0],
                                 mesh_dim_names=names)


# ---------------------------------------------------------------- spawn --
def _worker(rank: int, fn: Callable, world: int, backend: str,
            device: str, init_file: str, out_dir: str, timeout_s: float,
            args: tuple) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=_timeout(timeout_s),
                            **_device_id(backend, dev))
    try:
        result = fn(rank, world, dev, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class WorldFailed(RuntimeError):
    """A spawned world failed: a rank raised (its traceback in the
    message) or the world ran past its deadline and was killed."""


def spawn(fn: Callable, world: int, *, backend: str, device: str = "cpu",
          timeout_s: float = 300.0, args: tuple = ()) -> List:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    (start method "spawn") joined in one process group of ``backend``,
    each on ``device``; return every rank's result, in rank order
    (``torch.save``-able values). ``fn`` must be importable by name.
    Workers run one intra-op thread each. A rank that raises fails the
    call with its traceback; past ``timeout_s`` every process is killed
    and the call fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _worker, args=(fn, world, backend, device, init_file, tmp,
                           timeout_s, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise WorldFailed(f"world of {world} ({backend}) ran "
                                      f"past {timeout_s} s and was killed")
                if ctx.join(timeout=min(left, 1.0)):
                    break
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errs = sorted(Path(tmp).glob("rank*.err"))
            raise WorldFailed("\n".join(p.read_text() for p in errs)
                              or str(e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
