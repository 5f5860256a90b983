"""What lives where on the mesh, for eager PyTorch.

Counterpart of the part of ``repro.launch.sharding`` (``:49-145``) that a
run without a compiler needs.  The layout is Megatron's:

- the expert leaves (``we13`` (L, E, D, g, F) and ``we2`` (L, E, F, D),
  stacked over layers) are cut on their E axis over the ``model`` axis:
  the rank at model index m holds experts [m * E_loc, (m + 1) * E_loc),
  the reference's ``P(None, 'model', ...)``;
- every other leaf (attention, norms, embeddings, the router, dense and
  shared-expert MLPs) is replicated;
- the global batch is cut over every rank in rank order, the reference's
  ``token_axes_moe = dp_axes + (tp_axis,)`` (``lm.py:67-69``): each rank
  runs attention and the dense layers on its own share, and the MoE
  blocks' all-to-alls move its tokens to the experts' ranks.

The loss is the mean over the global batch: each rank's loss is the mean
over its share, and the train step averages the ranks' (equal shares).

``MeshShardings`` moves the plain step's state between the ranks and a
checkpoint: the checkpoint holds the world-1 tree, written by the world's
rank 0 alone.
"""
from __future__ import annotations

import torch

from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor
from repro_torch.dist import comm

EXPERT_LEAVES = ("we13", "we2")
# the AdamW state trees that mirror the params (optim/adamw.init_state)
_MIRRORS = ("m", "v", "master")


def is_expert_leaf(path: str) -> bool:
    """A leaf sharded over the model axis (its E axis after the layer
    axis)."""
    return path.split(".")[-1] in EXPERT_LEAVES


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def expert_slice(mesh, n_experts: int) -> slice:
    """This rank's experts on the E axis."""
    ep = mesh.ep
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over EP={ep}")
    e_loc = n_experts // ep
    m = mesh.model_index
    return slice(m * e_loc, (m + 1) * e_loc)


def shard_params(params, mesh):
    """The reference's ``init_params`` tree (the port's stacked layout) cut
    to this rank: expert leaves to its E_loc experts (copies, so the other
    experts' memory is freed), every other leaf as it is."""
    if mesh is None or mesh.ep == 1:
        return params

    def cut(path, leaf):
        if not is_expert_leaf(path):
            return leaf
        sl = expert_slice(mesh, leaf.shape[1])
        return leaf[:, sl].clone()
    return _walk(params, cut)


def shard_batch(batch, mesh, *, lead: int = 0):
    """This rank's share of a global batch: every leaf's batch axis
    (after `lead` leading axes, e.g. 1 for a grad-accum axis) cut into
    mesh.world equal blocks, block r to rank r."""
    if mesh is None or mesh.world == 1:
        return batch
    W, r = mesh.world, mesh.rank

    def cut(leaf):
        B = leaf.shape[lead]
        if B % W:
            raise ValueError(f"a global batch of {B} does not split over "
                             f"{W} ranks")
        n = B // W
        return leaf.narrow(lead, r * n, n).contiguous()
    return {k: cut(v) for k, v in batch.items()}


def grad_group(path: str, mesh):
    """The group a leaf's gradient is summed over: the data axis for an
    expert leaf (the reference's dp_axes Wgrad psum, core/moe.py:52-53;
    the model axis already met in the all-to-all's backward), the world
    for a replicated one (the router included: a replicated input of a
    shard_map gets the psum of every rank's cotangent)."""
    if is_expert_leaf(path) and mesh.ep > 1:
        return mesh.data_group
    return mesh.world_group


def gather_expert_leaf(leaf: torch.Tensor, mesh) -> torch.Tensor:
    """A sharded expert leaf (L, E_loc, ...) back to (L, E, ...) on every
    rank of the model axis (for checks and whole-tree checkpoints)."""
    if mesh is None or mesh.ep == 1:
        return leaf
    t = leaf.transpose(0, 1).contiguous()
    full = comm.all_gather(t, mesh.model_group)
    return full.transpose(0, 1).contiguous()


def _map_experts(state, fn):
    """`state` with each expert leaf of its params, and of the AdamW trees
    that mirror them, replaced by fn(leaf, param): a plain tensor of the
    param's shape or a QTensor of its (rows, TILE) encoding."""
    from repro_torch.dist.plan import flatten_with_paths
    params = dict(flatten_with_paths(state["params"]))

    def at(path, leaf):
        return fn(leaf, params[path]) if is_expert_leaf(path) else leaf
    out = dict(state)
    out["params"] = _walk(state["params"], at)
    out["opt"] = {k: _walk(v, at) if k in _MIRRORS else v
                  for k, v in state["opt"].items()}
    return out


def _by_expert(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """t (param-shaped, or an encoding's (rows, w) part) as (L, E_loc, -1):
    the flat order of a stacked expert leaf is layer-major, then expert.
    An encoding's rows must not straddle two experts."""
    L, e = p.shape[0], p.shape[1]
    if t.shape != p.shape and p.numel() % (L * e * TILE):
        raise ValueError(f"an expert leaf {tuple(p.shape)}: its {TILE}-wide "
                         "state rows straddle experts")
    return t.view(L, e, -1)


def _parts(enc, fn):
    if isinstance(enc, QTensor):
        return QTensor(fn(enc.data), fn(enc.scale), enc.tile)
    return fn(enc)


class MeshShardings:
    """The plain step's state on a mesh, to and from a checkpoint.

    ``full(state)`` is the world-1 tree: the expert leaves (the params'
    and the AdamW trees' that mirror them) gathered over the model axis (a
    collective: every rank calls it); ``writer`` is true on the world's
    rank 0 alone, which writes it.  ``template(state)`` is a full-size
    tree to restore into (every replicated leaf shared with `state`), and
    ``shard(full, state)`` copies this rank's experts of it into the live
    leaves.  A checkpoint saved at one EP size restores at world 1 and at
    any EP dividing E, bit for bit.  ``barrier()`` holds every rank until
    a write has landed."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def writer(self) -> bool:
        return self.mesh.rank == 0

    def barrier(self) -> None:
        comm.barrier(self.mesh.world_group)

    def full(self, state):
        if self.mesh.ep == 1:
            return state

        def gather(enc, p):
            return _parts(enc, lambda t: gather_expert_leaf(
                _by_expert(t, p), self.mesh).reshape(self._grown(t, p)))
        return _map_experts(state, gather)

    def _grown(self, t, p):
        if t.shape == p.shape:
            return (p.shape[0], p.shape[1] * self.mesh.ep, *p.shape[2:])
        return (t.shape[0] * self.mesh.ep, *t.shape[1:])

    def template(self, state):
        if self.mesh.ep == 1:
            return state
        return _map_experts(state, lambda enc, p: _parts(
            enc, lambda t: t.new_empty(self._grown(t, p))))

    @torch.no_grad()
    def shard(self, full, state):
        """`full` (restored into ``template(state)``) with this rank's
        experts copied into `state`'s live expert leaves, which take their
        places."""
        if self.mesh.ep == 1:
            return full
        live = []
        _map_experts(state, lambda enc, p: live.append((enc, p)))
        it = iter(live)
        sl = expert_slice(self.mesh, self.mesh.ep * live[0][1].shape[1]) \
            if live else None

        def put(fenc, _):
            enc, p = next(it)
            if isinstance(enc, QTensor):
                pairs = ((fenc.data, enc.data), (fenc.scale, enc.scale))
            else:
                pairs = ((fenc, enc),)
            for f, t in pairs:
                whole = f.reshape(p.shape[0], self.mesh.ep * p.shape[1], -1)
                _by_expert(t, p).copy_(whole[:, sl])
            return enc
        return _map_experts(full, put)
