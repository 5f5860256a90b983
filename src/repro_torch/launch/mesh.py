"""Process groups for multi-GPU training and serving: the reference's
(data, model) and (pod, data, model) meshes over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  A ``Mesh`` is the world of
``dp * ep`` ranks laid out row-major, as ``make_mesh((dp, ep), ("data",
"model"))`` lays out devices: rank r sits at data index ``r // ep`` and
model index ``r % ep``.  With a pod axis (``init_mesh(dp, ep, pod=p)``,
the reference's ``make_production_mesh(multi_pod=True)``) the world is
``p * dp * ep`` ranks in ``make_mesh((p, dp, ep), ("pod", "data",
"model"))``'s order: pod index ``r // (dp * ep)``.  Each rank holds the
group of every set of axes (the ranks that share its coordinates on the
other axes): ``data`` (the FSDP gathers, ZeRO-1 and the expert leaves'
gradient sum), ``model`` (the expert-parallel all-to-all, the TP
collectives), ``pod`` x ``data`` (``dp_group``: the data-parallel
gradient sums and the serving batch's split), and the world.

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
import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
DEFAULT_TIMEOUT_S = 300.0
_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world, its axis groups and this rank's place in them.
    ``pod`` None is the (data, model) mesh; an int adds the leading pod
    axis.  ``groups`` maps each non-empty set of axis names to the group
    of the ranks that share this rank's coordinates on the other axes
    (None on a group-less mesh, ``make_test_mesh``)."""
    dp: int
    ep: int
    rank: int
    device: torch.device
    pod: Optional[int] = None
    groups: Optional[dict] = dataclasses.field(default=None, compare=False,
                                               repr=False)

    @property
    def axis_names(self) -> tuple:
        return AXES if self.pod is None else POD_AXES

    @property
    def sizes(self) -> tuple:
        return (self.dp, self.ep) if self.pod is None else \
            (self.pod, self.dp, self.ep)

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def dp_axes(self) -> tuple:
        """The axes the batch is data-parallel over: ('pod', 'data') on a
        pod mesh, else ('data',) (the reference's ``make_plan``)."""
        return self.axis_names[:-1]

    @property
    def dp_size(self) -> int:
        return math.prod(self.sizes[:-1])

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (row-major layout)."""
        names, sizes = self.axis_names, self.sizes
        if axis not in names:
            raise ValueError(f"unknown mesh axis {axis!r}; pick from {names}")
        i = names.index(axis)
        return self.rank // math.prod(sizes[i + 1:]) % sizes[i]

    @property
    def data_index(self) -> int:
        return self.index("data")

    @property
    def model_index(self) -> int:
        return self.index("model")

    @property
    def dp_index(self) -> int:
        """This rank's place in the pod x data group."""
        return self.rank // self.ep

    @property
    def has_groups(self) -> bool:
        return self.groups is not None

    def group(self, axes=None):
        """The group over an axis name or a tuple of names ('pod', 'data',
        'model'); the world for None.  None on a group-less mesh."""
        names = self.axis_names
        if axes is None:
            axes = names
        elif isinstance(axes, str):
            axes = (axes,)
        bad = [a for a in axes if a not in names]
        if bad or not axes:
            raise ValueError(f"unknown mesh axes {axes!r}; pick from {names}")
        return None if self.groups is None else self.groups[frozenset(axes)]

    @property
    def world_group(self):
        return self.group(None)

    @property
    def data_group(self):
        return self.group("data")

    @property
    def model_group(self):
        return self.group("model")

    @property
    def dp_group(self):
        """The pod x data group (the data group without a pod axis)."""
        return self.group(self.dp_axes)


def make_test_mesh(device="cpu") -> Mesh:
    """World 1 with no process group (every collective the identity)."""
    return Mesh(dp=1, ep=1, rank=0, device=resolve_device(device))


def backend_for(device) -> str:
    return _BACKEND[resolve_device(device).type]


def _from_env() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_of(coords, sizes) -> int:
    """The rank at `coords` of a row-major mesh of `sizes`, as
    ``make_mesh(sizes, names)`` lays out devices."""
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def _axis_groups(sizes, names, rank, timeout):
    """Every rank creates the group of every coset of every non-empty set
    of axes, in the same order; returns this rank's, by axis set."""
    groups = {}
    for k in range(1, len(sizes) + 1):
        for sub in itertools.combinations(range(len(sizes)), k):
            rest = [i for i in range(len(sizes)) if i not in sub]
            for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
                members = []
                for free in itertools.product(*(range(sizes[i])
                                                for i in sub)):
                    coords = [0] * len(sizes)
                    for i, c in zip(rest, fixed):
                        coords[i] = c
                    for i, c in zip(sub, free):
                        coords[i] = c
                    members.append(rank_of(coords, sizes))
                g = dist.new_group(sorted(members), timeout=timeout)
                if rank in members:
                    groups[frozenset(names[i] for i in sub)] = g
    return groups


def init_mesh(dp: int, ep: int, *, pod: Optional[int] = None, device="cuda",
              store: Optional[str] = None, rank: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join (or start) the world of dp * ep ranks (pod * dp * ep with a
    pod axis) and build the axis groups.  `pod`: None keeps the (data,
    model) mesh; an int adds the reference's leading pod axis
    (``make_production_mesh(multi_pod=True)``), one more data-parallel
    axis.  `store`: a FileStore path every rank shares; without it the
    torchrun variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) are
    read, and a world of one with neither raises.  On ``cuda`` the rank's
    card is LOCAL_RANK (else the rank modulo the visible cards)."""
    sizes = (dp, ep) if pod is None else (pod, dp, ep)
    if min(sizes) < 1:
        raise ValueError(f"mesh {sizes}: every size must be >= 1")
    names = AXES if pod is None else POD_AXES
    world = math.prod(sizes)
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
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {world} "
                         f"ranks; the world has {dist.get_world_size()}")
    rank = dist.get_rank()
    return Mesh(dp=dp, ep=ep, rank=rank, device=dev, pod=pod,
                groups=_axis_groups(sizes, names, rank, timeout))


def close_mesh() -> None:
    """Leave the world (every group with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
