"""The collectives of the multi-GPU path, counted.

Every collective the port runs goes through one of these wrappers over
``torch.distributed``: the expert-parallel all-to-all (``core/moe.py``),
the DP gradient wire and the ZeRO-1 gather (``dist/grad_comm.py``), the
gradient all-reduce of the plain step (``train/train_step.py``), the FP8
psum (``runtime/compression.py``) and the tensor-parallel and FSDP
collectives of ``models/lm.py`` (token gathers, combine and input-gradient
all-reduces, weight gathers and their gradients' reduce-scatters).  A
group of None is no group: the wrapper returns its input and launches
nothing, as the reference's collectives are identities with no mesh axis
mapped.  With a group, even
a group of one rank, the collective launches (a copy at one rank).

Payloads travel as their bytes (a ``uint8`` view of the same memory, no
cast): gloo has no float8 type and refuses int16, and an all-to-all or a
gather moves bytes anyway.  Sums and maxima run on the tensor's own
dtype.

``COUNTS`` keeps, by kind, the calls and the bytes of the buffers handed
to the collectives (an all-to-all's message, an all-reduce's buffer, an
all-gather's gathered output, a reduce-scatter's input), and an open
``roofline.analysis.tally()`` records the same.  What a rank puts on the
interconnect is that times the kind's ring factor at the group's size
(``wire_factor``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.roofline import analysis as roofline

KINDS = ("all-to-all", "all-reduce", "all-gather", "reduce-scatter")
COUNTS = {k: [0, 0] for k in KINDS}          # kind -> [calls, bytes]


def reset_counts() -> None:
    for rec in COUNTS.values():
        rec[0] = rec[1] = 0


def counts() -> dict:
    """{kind: {'calls', 'bytes'}} since the last reset."""
    return {k: {"calls": c, "bytes": b} for k, (c, b) in COUNTS.items()}


def wire_factor(kind: str, n: int) -> float:
    """Bytes a rank sends per buffer byte in a ring at n ranks."""
    ring = (n - 1) / n if n > 0 else 0.0
    return 2 * ring if kind == "all-reduce" else ring


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _record(kind: str, nbytes: int) -> None:
    rec = COUNTS[kind]
    rec[0] += 1
    rec[1] += nbytes
    roofline.collective(kind, nbytes)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (R, w) uint8 view of t's bytes (contiguous)."""
    t = t.contiguous()
    # flat first: a size-1 axis may keep any stride in a contiguous tensor
    return t.reshape(-1).view(torch.uint8).reshape(t.shape[0], -1)


class Pending:
    """An all-to-all in flight: ``wait()`` joins it and returns the
    received tensor (its dtype and shape).  A no-group call is done."""

    def __init__(self, work, out: torch.Tensor, like: torch.Tensor):
        self._work, self._out, self._like = work, out, like

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        like = self._like
        if self._out is like:
            return like
        if self._out.dtype == torch.uint8 and like.dtype != torch.uint8:
            return self._out.view(like.dtype).reshape(like.shape)
        return self._out.reshape(like.shape)


def all_to_all(t: torch.Tensor, group, async_op: bool = False):
    """``jax.lax.all_to_all(split_axis=0, concat_axis=0)`` over `group`:
    t's leading axis is cut into size(group) equal blocks, block j goes to
    rank j, and the received blocks stack in rank order.  Returns the
    tensor, or with ``async_op`` a ``Pending``."""
    if group is None:
        return Pending(None, t, t) if async_op else t
    n = size(group)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: {t.shape[0]} rows over {n} ranks")
    u = _as_bytes(t)
    out = torch.empty_like(u)
    work = dist.all_to_all_single(out, u, group=group, async_op=async_op)
    _record("all-to-all", u.numel())
    p = Pending(work if async_op else None, out, t)
    return p if async_op else p.wait()


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce ('sum' or 'max') of t over `group`; returns t.
    The identity with no group."""
    if group is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if not t.is_contiguous():
        raise ValueError("all_reduce_: t must be contiguous")
    dist.all_reduce(t, op=rop, group=group)
    _record("all-reduce", t.numel() * t.element_size())
    return t


def all_reduce_async(t: torch.Tensor, group, op: str = "sum"):
    """all_reduce_ in flight: returns a handle whose ``wait()`` gives t."""
    if group is None:
        return Pending(None, t, t)
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    work = dist.all_reduce(t, op=rop, group=group, async_op=True)
    _record("all-reduce", t.numel() * t.element_size())
    return Pending(work, t, t)


def all_gather(shard: torch.Tensor, group) -> torch.Tensor:
    """The ranks' shards stacked on the leading axis in rank order
    (``all_gather(tiled=True)``)."""
    if group is None:
        return shard
    n = size(group)
    u = _as_bytes(shard)
    out = torch.empty((n * u.shape[0], u.shape[1]), dtype=torch.uint8,
                      device=u.device)
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, u, group=group)
    _record("all-gather", out.numel())
    full = out.view(shard.dtype) if shard.dtype != torch.uint8 else out
    return full.reshape(n * shard.shape[0], *shard.shape[1:])


def agree_max_int(x: torch.Tensor, group) -> torch.Tensor:
    """An int32 scalar (flags) made the same on every rank by MAX."""
    if group is None:
        return x
    y = x.to(torch.int32).reshape(1).clone()
    all_reduce_(y, group, "max")
    return y.reshape(())


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``psum_scatter(scatter_dimension=0, tiled=True)`` over `group`: the
    ranks' t summed, cut on the leading axis into size(group) equal
    blocks, block j kept by rank j.  The identity with no group."""
    if group is None:
        return t
    n = size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows over {n} ranks")
    t = t.contiguous()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    _record("reduce-scatter", t.numel() * t.element_size())
    return out


def barrier(group) -> None:
    """Every rank of `group` waits for the others (not counted: it moves
    no payload).  Nothing with no group."""
    if group is not None:
        dist.barrier(group=group)
