"""Process groups for multi-GPU training: the reference's (data, model)
mesh over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  A ``Mesh`` is the world of
``dp * ep`` ranks laid out row-major, as ``make_mesh((dp, ep), ("data",
"model"))`` lays out devices: rank r sits at data index ``r // ep`` and
model index ``r % ep``.  Each rank holds a group over its ``data`` axis
(the ranks that share its model index: the expert leaves' gradient sum)
and one over its ``model`` axis (the ranks that share its data index: the
expert-parallel all-to-all), besides the world.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``, and
no other.  The ranks meet through a ``torch.distributed.FileStore`` at a
path (no network), or through ``torchrun``'s environment variables when
they are set.  Every group has a timeout, so a rank that never arrives
fails the collective instead of stalling the run.

``make_test_mesh()`` is world 1 with no process group: every collective
of the port is then the identity, as the reference's are on a
single-device mesh.  ``init_mesh(1, 1, ...)`` is world 1 WITH groups: each
collective launches (NCCL on the card), a copy at one rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
DEFAULT_TIMEOUT_S = 300.0
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world, its two axis groups and this rank's place in them.
    Groups are None on a group-less mesh (``make_test_mesh``)."""
    dp: int
    ep: int
    rank: int
    device: torch.device
    world_group: object = None
    data_group: object = None
    model_group: object = None

    axis_names = AXES

    @property
    def world(self) -> int:
        return self.dp * self.ep

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.ep}

    @property
    def data_index(self) -> int:
        return self.rank // self.ep

    @property
    def model_index(self) -> int:
        return self.rank % self.ep

    @property
    def has_groups(self) -> bool:
        return self.world_group is not None

    def group(self, axis: Optional[str]):
        """The group of an axis name ('data' / 'model'), the world for
        None."""
        if axis is None:
            return self.world_group
        if axis == "data":
            return self.data_group
        if axis == "model":
            return self.model_group
        raise ValueError(f"unknown mesh axis {axis!r}; pick from {AXES}")


def make_test_mesh(device="cpu") -> Mesh:
    """World 1 with no process group (every collective the identity)."""
    return Mesh(dp=1, ep=1, rank=0, device=resolve_device(device))


def backend_for(device) -> str:
    return _BACKEND[resolve_device(device).type]


def _from_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_mesh(dp: int, ep: int, *, device="cuda", store: Optional[str] = None,
              rank: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join (or start) the world of dp * ep ranks and build the axis
    groups.  `store`: a FileStore path every rank shares; without it the
    torchrun variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) are
    read, and a world of one with neither raises.  On ``cuda`` the rank's
    card is LOCAL_RANK (else the rank modulo the visible cards)."""
    if dp < 1 or ep < 1:
        raise ValueError(f"mesh ({dp}, {ep}): both sizes must be >= 1")
    world = dp * ep
    dev = resolve_device(device)
    backend = _BACKEND[dev.type]
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        if store is not None:
            if rank is None:
                rank = int(os.environ.get("RANK", 0))
            kw = dict(store=dist.FileStore(store, world), rank=rank,
                      world_size=world)
        elif _from_env():
            rank = int(os.environ["RANK"])
            kw = dict(init_method="env://")
        else:
            raise ValueError(
                "init_mesh needs a FileStore path (store=) or torchrun's "
                "RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, timeout=timeout, **kw)
    elif dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"the device {dev.type} needs {backend}")
    if dist.get_world_size() != world:
        raise ValueError(f"mesh ({dp}, {ep}) needs {world} ranks; the "
                         f"world has {dist.get_world_size()}")
    rank = dist.get_rank()
    # every rank creates every group, in the same order
    world_group = dist.new_group(list(range(world)), timeout=timeout)
    data_group = model_group = None
    for m in range(ep):
        g = dist.new_group([d * ep + m for d in range(dp)], timeout=timeout)
        if rank % ep == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * ep + m for m in range(ep)], timeout=timeout)
        if rank // ep == d:
            model_group = g
    return Mesh(dp=dp, ep=ep, rank=rank, device=dev,
                world_group=world_group, data_group=data_group,
                model_group=model_group)


def close_mesh() -> None:
    """Leave the world (every group with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
