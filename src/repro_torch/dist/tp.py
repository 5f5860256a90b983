"""The differentiable collectives of the tensor-parallel and FSDP stages.

Counterpart of what the reference's ``shard_map`` regions do at their
boundaries (``repro/models/lm.py:209-488``), as autograd Functions over
``dist/comm.py``'s counted wrappers.  A group of None is the identity
both ways (no mesh, or a group-less one); a group of one rank launches
(a copy).

The port splits the global batch over every rank, and a TP region (the
TP MoE block, the TP dense MLP) works on the tokens of the whole model
group, as the reference's regions see their tokens over the data axes
only.  Inside the region every rank holds the same tokens and an F-slice
of the weights, and computes the same replicated values (router,
probabilities, aux loss, combined output) from them, Megatron's layout:

- ``gather_rows``: the region's entry, an all-gather of the ranks' rows.
  Its backward keeps this rank's rows of the cotangent: the cotangent is
  the same on every rank of the group (each partial sum was all-reduced
  inside the region: the FFN's input gradient by ``gx_groups``
  (``core/linear.py``), the probabilities' by ``sum_grad``), so the sum a
  reduce-scatter would take is already made.
- ``all_reduce_sum``: the combine's sum of the F-slices' partial outputs
  (Megatron's g): forward an all-reduce, backward the identity, because
  its cotangent is replicated.
- ``own_rows``: the region's exit, this rank's rows of a replicated
  output.  Its backward gathers the ranks' cotangents: each rank's loss
  reads only its own rows, so the replicated output's cotangent is their
  concatenation.
- ``reduce_scatter_rows``: ``all_reduce_sum`` then ``own_rows`` in one
  collective (the ``reduce_scatter`` combine); backward the all-gather.
- ``sum_grad``: the identity forward whose backward all-reduces the
  cotangent (Megatron's f): for a replicated value read by a partial sum
  (the router probabilities under the ``local_first`` and
  ``reduce_scatter`` combines) or by every rank's loss (the aux loss).
- ``fsdp_gather``: an FSDP weight's shards all-gathered on its cut axis
  inside the stage; backward the reduce-scatter of the gradient (the sum
  over the data group, each rank keeping its block).
"""
from __future__ import annotations

import torch

from repro_torch.dist import comm


def _own(t: torch.Tensor, group) -> torch.Tensor:
    n = comm.size(group)
    rows = t.shape[0] // n
    r = comm.rank(group)
    return t[r * rows:(r + 1) * rows]


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group).contiguous(), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _OwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _own(y, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.group), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return comm.reduce_scatter(y, group)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g.contiguous(), ctx.group), None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.contiguous().clone(), ctx.group), None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, axis):
        ctx.group, ctx.axis = group, axis
        full = comm.all_gather(w.movedim(axis, 0), group)
        return full.movedim(0, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        part = comm.reduce_scatter(g.movedim(ctx.axis, 0), ctx.group)
        return part.movedim(0, ctx.axis).contiguous(), None, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(T, ...) rows of each rank -> (size * T, ...) in rank order."""
    return x if group is None else _GatherRows.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of x (a new tensor); identity backward."""
    return x if group is None else _AllReduceSum.apply(x, group)


def own_rows(y: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of a replicated (size * T, ...) tensor."""
    return y if group is None else _OwnRows.apply(y, group)


def reduce_scatter_rows(y: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of y, this rank's block of rows."""
    return y if group is None else _ReduceScatterRows.apply(y, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose cotangent is summed over the group."""
    return x if group is None else _SumGrad.apply(x, group)


def fsdp_gather(w: torch.Tensor, group, axis: int) -> torch.Tensor:
    """An FSDP weight's data-group shards gathered on `axis`."""
    return w if group is None else _FSDPGather.apply(w, group, axis)
