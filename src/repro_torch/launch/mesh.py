"""Meshes and ranks (port of ``repro/launch/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices one process
sees.  The port's counterpart is a :class:`torch.distributed.device_mesh.
DeviceMesh` with named dims over the ranks of an already initialized
default process group, one rank per process: :func:`make_mesh_compat`.
The rule engine and the planners only read axis names and sizes, so they
also take an :class:`AbstractMesh` (:func:`abstract_mesh`), a named shape
with no process group, as the reference's ``AbstractMesh`` is one with no
devices.

Single pod: (data=16, model=16) = 256 chips.  Multi-pod: (pod=2, data=16,
model=16) = 512 chips; the ``pod`` axis is data-parallel across hosts and
the 2.5-D GEMM schedule's C-replication axis.  These production shapes
are abstract here (:func:`make_production_mesh`).

:func:`spawn_ranks` runs a function on ``world`` fresh processes (the
``spawn`` start method), each with its default process group initialized
over a :class:`torch.distributed.FileStore` in a temporary directory, so
concurrent runs (tests under several workers) never contend for a port.
A rank that raises, or a run past its timeout, ends every rank and
raises in the caller.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A named mesh shape with no process group (the reference's
    ``jax.sharding.AbstractMesh``): ``shape`` maps each axis name to its
    size, in order."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} vs axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def axis_sizes(mesh) -> "collections.OrderedDict[str, int]":
    """Axis name -> size of an :class:`AbstractMesh` or a named
    ``DeviceMesh`` (whose own ``shape`` is a tuple)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("the mesh has no axis names")
    return collections.OrderedDict(zip(names, tuple(mesh.shape)))


def abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
                  ) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def make_mesh_compat(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                     device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``mesh_dim_names=axes`` over the
    ranks of the initialized default group (its world size must be the
    mesh's size), rank-major as ``jax.make_mesh`` orders devices.
    ``device`` is the mesh's device type: the card unless the caller
    asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_compat needs an initialized default "
                           "process group (torch.distributed)")
    size = 1
    for s in shape:
        size *= int(s)
    if size != dist.get_world_size():
        raise ValueError(f"a mesh of {tuple(shape)} needs {size} ranks, "
                         f"the group has {dist.get_world_size()}")
    return init_device_mesh(device, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def make_host_mesh(shape: Optional[Tuple[int, ...]] = None, axes=None, *,
                   device: str = "cuda"):
    """A small mesh over the group's ranks (tests, examples): by default
    ``(1, world)`` over ``("data", "model")``."""
    if shape is None:
        shape = (1, dist.get_world_size())
        axes = ("data", "model")
    return make_mesh_compat(shape, axes, device=device)


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def n_chips(mesh) -> int:
    n = 1
    for v in axis_sizes(mesh).values():
        n *= v
    return n


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------

def rank_device(rank: int, backend: str, device: str = "cuda"
                ) -> torch.device:
    """The device a rank computes on: ``cpu``; under NCCL its own card
    (``cuda:rank``, one rank per card); under gloo the card its rank
    maps to, so ranks share a card when there are fewer cards than
    ranks (NCCL refuses two ranks on one card)."""
    if device == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device for a rank on the card")
    if backend == "nccl" and rank >= n:
        raise ValueError(f"rank {rank} under NCCL needs a card of its own; "
                         f"{n} present")
    return torch.device("cuda", rank % n)


class RankError(RuntimeError):
    """A rank of :func:`spawn_ranks` raised; ``rank`` and ``trace`` say
    which and where."""

    def __init__(self, rank: int, trace: str):
        super().__init__(f"rank {rank} failed:\n{trace}")
        self.rank = rank
        self.trace = trace


def _rank_main(fn, rank: int, world: int, store_path: str, backend: str,
               timeout_s: float, args: Sequence[Any], results) -> None:
    """One spawned rank: join the group, run ``fn``, report, leave."""
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        # The rank's boundary: report the failure to the parent, which
        # ends the other ranks and raises it, then exit with it.
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable[..., Any], world: int, args: Sequence[Any] = (),
                *, timeout: float = 180.0, backend: str = "gloo"
                ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes and
    return their results in rank order (each must pickle: numpy arrays,
    numbers, dicts).  Each rank's default process group is initialized
    over a ``FileStore`` in a fresh temporary directory.  ``fn`` must be
    importable by module path (the spawn method pickles it by name).

    The first rank to raise ends every other rank and raises
    :class:`RankError` here with its traceback; a run past ``timeout``
    seconds ends every rank and raises ``TimeoutError``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store_path, backend, timeout,
                               tuple(args), results), daemon=True)
             for r in range(world)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world - len(out)} of {world} ranks did not finish "
                    f"within {timeout:.0f} s (done: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if not dead:
                    continue
                try:   # a report written just before the rank exited
                    rank, ok, value = results.get(timeout=1.0)
                except _queue.Empty:
                    raise RankError(dead[0], "exited with code "
                                    f"{procs[dead[0]].exitcode} before "
                                    "reporting") from None
            if not ok:
                raise RankError(rank, value)
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
