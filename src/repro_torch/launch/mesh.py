"""Serving meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

The reference drives every device from one host through ``shard_map``;
the port runs one process per device (a rank), every rank running the
same host loop. A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with dims ``("data", "model")``: rank ``d * model + m`` sits at (d, m),
and each dim's process group (``mesh.get_group("model")``) carries the
engine's all-gathers. Every group is made here with a timeout, so a rank
that raised leaves its peers to time out rather than hang.

Backends are the caller's and are never switched on failure: ``nccl``
when each rank has its own card, ``gloo`` on the CPU, and gloo for two
ranks sharing one card (NCCL refuses two ranks on one device); the
sharded engine's collective stages a CUDA tensor through host memory
for a gloo group (distributed/sharding.py::all_gather_dim).

``make_production_mesh`` (the dry-run's 16 x 16) waits for the dry-run
(ROADMAP Queue 1, item 11).

Under ``torchrun --nproc-per-node N`` (``python -m
torch.distributed.run``) a process joins with ``init_from_env``;
``spawn`` starts a world of processes from Python (tests, chip_smoke.py)
with a ``file://`` rendezvous, so no port is taken.
"""
from __future__ import annotations

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


def _mesh(data: int, model: int, device_type: str, timeout_s: float):
    """Every rank of the world makes every row and column group in the
    same order (a collective), then keeps its own two; a rank outside the
    ``data * model`` first ones gets None."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(data * model).reshape(data, model)
    me = dist.get_rank()
    mine = {}
    for name, groups in (("model", ranks.tolist()),
                         ("data", ranks.T.tolist())):
        for members in groups:
            g = dist.new_group(members, timeout=_timeout(timeout_s))
            if me in members:
                mine[name] = g
    if not mine:
        return None
    return DeviceMesh.from_group([mine["data"], mine["model"]], device_type,
                                 mesh=ranks, mesh_dim_names=("data", "model"))


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
