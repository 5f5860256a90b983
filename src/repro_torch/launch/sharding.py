"""What lives where on the mesh, for eager PyTorch.

Counterpart of ``repro.launch.sharding``'s ``make_plan`` (``:22-35``) and
the part of its ``param_specs`` / ``tree_specs`` (``:49-145``) that a run
without a compiler needs.  The layout is Megatron's:

- the global batch is cut over every rank in rank order, the reference's
  ``token_axes_moe = dp_axes + (tp_axis,)`` (``lm.py:67-69``): each rank
  runs attention and the dense layers on its own share; the EP blocks'
  all-to-alls move its tokens to the experts' ranks, and the TP stages
  gather the model group's tokens (``dist/tp.py``);
- the expert leaves (``we13`` (L, E, D, g, F), ``we2`` (L, E, F, D)) are
  cut on E over ``model`` (EP, ``moe_mode='ep'`` at EP > 1) or on F over
  ``model`` (TP-in-expert, ``moe_mode='tp'``), the reference's
  ``P(None, 'model', ...)`` and ``P(None, None, fs, None, 'model')``;
- with ``mlp_tp`` the dense MLPs and shared experts whose F passes
  ``mlp_tp_ok`` are cut on F over ``model``;
- with ``fsdp_axis='data'`` those weights are cut on their d_model axis
  over ``data`` too (we13 on D, we2 on D, w13 / ws13 on D, w2 / ws2 on
  D), and each stage all-gathers them;
- every other leaf (attention, norms, embeddings, the router) is
  replicated.

``models.lm.ParallelPlan.leaf_cuts`` names the cuts of each leaf: a cut
applies only where it divides and leaves the last axis a multiple of 128,
as ``tree_specs`` drops uneven ones.  ``grad_group`` gives each leaf's
post-hoc gradient sum: what its stage's collectives have not summed yet.

The loss is the mean over the global batch: each rank's loss is the mean
over its share, and the train step averages the ranks' (equal shares).
On a pod mesh the batch is cut over every rank all the same, the
replicated leaves' gradients are summed over pod x data (x model), and
FSDP and ZeRO-1 stay over ``data`` (the reference's rules, its
``:1-8``).

Serving (``serving_cut``) cuts only the routed experts of the world-1
tree, before the W8 quantize, so that no rank ever holds the whole W8
tree: ``moe_mode='ep'`` keeps the rank's E / tp experts (at its model
index), ``'tp'`` every expert's F-slice (we13's and we2's F axis, at a
multiple of 128).  Attention, the embeddings, the LM head, the dense
MLPs, the shared experts, the router and the norms stay whole on every
rank, and every rank holds the same rows (``ParallelPlan.for_serving``).
The W8 tiles are (1, 1, 128, 1, 128) and (1, 1, 128, 128)
(``serve/w8.py``), so cutting then quantizing gives the bits of
quantizing then cutting.

``MeshShardings`` moves the plain step's state between the ranks and a
checkpoint: the checkpoint holds the world-1 tree, gathered over every
cut (the params, the AdamW trees that mirror them and their (rows, 128)
QTensor encodings) and written by the world's rank 0 alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor
from repro_torch.dist import comm

# the AdamW state trees that mirror the params (optim/adamw.init_state)
_MIRRORS = ("m", "v", "master")


def make_plan(cfg, mesh, *, moe_tp_combine: str = "local_first",
              mlp_tp: bool = False):
    """The reference's production plan (``repro/launch/sharding.py:22-35``)
    for `cfg` on `mesh`: ``moe_mode`` 'ep' iff the experts split over the
    model axis (E % tp == 0 and E >= tp), else 'tp'; ``fsdp_axis`` 'data'
    iff ``cfg.fsdp``.  The combine and the MLP's TP mode are keywords
    (the reference reads them from environment variables).  Reads only
    ``mesh.shape`` and ``mesh.axis_names``."""
    from repro_torch.models.lm import ParallelPlan
    tp = mesh.shape["model"]
    moe_mode = "ep" if (cfg.moe and cfg.n_experts % tp == 0
                        and cfg.n_experts >= tp) else "tp"
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ParallelPlan(mesh=mesh, dp_axes=dp_axes, tp_axis="model",
                        moe_mode=moe_mode,
                        fsdp_axis="data" if cfg.fsdp else None,
                        moe_tp_combine=moe_tp_combine, mlp_tp=mlp_tp)


def serving_axis(cfg, plan, name: str):
    """The stacked axis the serving cut takes of expert leaf `name`
    ('we13' (L, E, D, g, Fe) or 'we2' (L, E, Fe, D)) under `plan`, with
    the size it must have whole: E at EP > 1, Fe in TP mode (at TP > 1),
    None for no cut.  Raises where the cut does not divide, or leaves an
    F-slice that is not a multiple of 128 (the W8 and GEMM tiles)."""
    mesh = plan.mesh
    tp = 1 if mesh is None else mesh.shape[plan.tp_axis]
    if name not in ("we13", "we2") or not cfg.moe or tp == 1:
        return None
    if plan.moe_mode == "ep":
        if cfg.n_experts % tp:
            raise ValueError(f"{cfg.n_experts} experts do not split over "
                             f"EP = {tp}")
        return 1, cfg.n_experts
    F = cfg.d_ff_expert
    if F % tp or (F // tp) % TILE:
        raise ValueError(f"{name}: d_ff_expert {F} over TP = {tp} leaves an "
                         f"F-slice of {F / tp:g}, not a multiple of {TILE}")
    return (4 if name == "we13" else 2), F


def _narrow(t, ax: int, n: int, i: int):
    w = t.shape[ax] // n
    return t.narrow(ax, i * w, w).clone()


def serving_cut(params, cfg, plan):
    """This rank's serving weights from the world-1 tree (module
    docstring): the routed experts cut on E (EP) or F (TP) over the model
    axis at the rank's model index, copies, every other leaf as it is.
    A leaf already at the cut's size is taken as this rank's; W8 leaves
    (QTensors) cut their scales with their payload."""
    mesh = plan.mesh
    if mesh is None or "layers" not in params:
        return params
    layers = dict(params["layers"])
    for name in ("we13", "we2"):
        cut = serving_axis(cfg, plan, name)
        leaf = layers.get(name)
        if cut is None or leaf is None:
            continue
        ax, whole = cut
        n, i = mesh.shape[plan.tp_axis], mesh.model_index
        size = leaf.shape[ax]
        if size == whole // n:
            continue
        if size != whole:
            raise ValueError(f"layers.{name} {tuple(leaf.shape)}: axis {ax} "
                             f"is neither {whole} nor its cut {whole // n}")
        if isinstance(leaf, QTensor):
            layers[name] = QTensor(_narrow(leaf.data, ax, n, i),
                                   _narrow(leaf.scale, ax, n, i), leaf.tile)
        else:
            layers[name] = _narrow(leaf, ax, n, i)
    return dict(params, layers=layers)


def _plan_of(mesh, plan):
    if plan is not None:
        return plan
    from repro_torch.models.lm import ParallelPlan
    return ParallelPlan(mesh=mesh)


def _walk(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def shard_params(params, mesh, cfg, plan=None):
    """The reference's ``init_params`` tree (the port's stacked layout) cut
    to this rank by ``ParallelPlan.leaf_cuts`` (copies, so the other ranks' memory is
    freed); every other leaf as it is.  `plan` defaults to the EP plan of
    `mesh`."""
    plan = _plan_of(mesh, plan)
    if mesh is None:
        return params

    def cut(path, leaf):
        whole = leaf
        for ax, m in plan.leaf_cuts(cfg, path):
            n = mesh.shape[m]
            if leaf.shape[ax] % n:
                raise ValueError(f"{path} {tuple(leaf.shape)}: axis {ax} "
                                 f"does not split over {m} = {n}")
            w = leaf.shape[ax] // n
            leaf = leaf.narrow(ax, mesh.index(m) * w, w)
        return whole if leaf.shape == whole.shape else leaf.clone()
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


def grad_group(path: str, mesh, cfg, plan=None):
    """The group a leaf's gradient is still summed over after the
    backward: the world, less the axes its stage's collectives already
    summed it over.  'model' is done for a leaf cut over model (EP: the
    all-to-all's backward brings every rank's cotangent to the expert;
    TP: the model group's tokens are gathered, so each F-slice's gradient
    is whole) and for the router in TP mode (replicated over the group
    with the same gradient on every rank); 'data' for an FSDP-cut leaf
    (its gather's backward reduce-scattered it).  A pod axis is never
    done.  None: nothing left."""
    plan = _plan_of(mesh, plan)
    done = {m for _, m in plan.leaf_cuts(cfg, path)}
    if (path.split(".")[-1] == "w_router" and plan.moe_mode == "tp"
            and cfg.moe):
        done.add("model")
    left = tuple(a for a in mesh.axis_names if a not in done)
    return mesh.group(left) if left else None


def norm_groups(path: str, mesh, cfg, plan=None) -> tuple:
    """The groups a leaf's sum of squares is summed over for the global
    norm: one for each axis the leaf is cut on."""
    plan = _plan_of(mesh, plan)
    return tuple(mesh.group(m) for _, m in plan.leaf_cuts(cfg, path))


def _gather_axis(t: torch.Tensor, shape, ax: int, group):
    """t (a leaf of `shape`, or a (rows, w) encoding of it whose rows do
    not straddle the blocks of axis `ax`) gathered over `group` on ax."""
    pre = math.prod(shape[:ax])
    v = t.reshape(pre, -1).t().contiguous()
    full = comm.all_gather(v, group).t()
    n = comm.size(group)
    if tuple(t.shape) == tuple(shape):
        grown = list(shape)
        grown[ax] *= n
        return full.reshape(grown)
    return full.reshape(t.shape[0] * n, *t.shape[1:])


def _check_rows(t, shape, ax: int, path: str):
    if tuple(t.shape) == tuple(shape):
        return
    block = math.prod(shape[ax:])
    if block % TILE:
        raise ValueError(f"{path} {tuple(shape)} cut on axis {ax}: its "
                         f"{TILE}-wide state rows straddle the cut")


def gather_leaf(leaf: torch.Tensor, mesh, cuts) -> torch.Tensor:
    """A cut leaf back to its full shape over every cut (every rank of
    the cuts' groups calls it)."""
    for ax, m in cuts:
        leaf = _gather_axis(leaf, list(leaf.shape), ax, mesh.group(m))
    return leaf


def _parts(enc, fn):
    if isinstance(enc, QTensor):
        return QTensor(fn(enc.data), fn(enc.scale), enc.tile)
    return fn(enc)


class MeshShardings:
    """The plain step's state on a mesh, to and from a checkpoint.

    ``full(state)`` is the world-1 tree: every cut leaf (the params' and
    the AdamW trees' that mirror them, plain or as (rows, 128) QTensor
    encodings) gathered over its cuts (a collective: every rank calls
    it); ``writer`` is true on the world's rank 0 alone, which writes it.
    ``template(state)`` is a full-size tree to restore into (every whole
    leaf shared with `state`), and ``shard(full, state)`` copies this
    rank's blocks of it into the live leaves.  A cut's encoding rows must
    not straddle its blocks (the cut rule's 128-multiple last axis), so
    they regroup exactly: a checkpoint saved on one layout restores at
    world 1 and on any layout whose cuts divide, bit for bit.
    ``barrier()`` holds every rank until a write has landed."""

    def __init__(self, mesh, cfg, plan=None):
        self.mesh = mesh
        self.cfg, self.plan = cfg, _plan_of(mesh, plan)

    @property
    def writer(self) -> bool:
        return self.mesh.rank == 0

    def barrier(self) -> None:
        comm.barrier(self.mesh.world_group)

    def _cuts(self, path):
        return self.plan.leaf_cuts(self.cfg, path)

    def _map(self, state, fn):
        """`state` with each cut leaf of its params, and of the AdamW
        trees that mirror them, replaced by fn(path, leaf, param, cuts)."""
        from repro_torch.dist.plan import flatten_with_paths
        params = dict(flatten_with_paths(state["params"]))

        def at(path, leaf):
            cuts = self._cuts(path)
            return fn(path, leaf, params[path], cuts) if cuts else leaf
        out = dict(state)
        out["params"] = _walk(state["params"], at)
        out["opt"] = {k: _walk(v, at) if k in _MIRRORS else v
                      for k, v in state["opt"].items()}
        return out

    def _grown(self, t, p, cuts):
        n = math.prod(self.mesh.shape[m] for _, m in cuts)
        if tuple(t.shape) == tuple(p.shape):
            shape = list(p.shape)
            for ax, m in cuts:
                shape[ax] *= self.mesh.shape[m]
            return tuple(shape)
        return (t.shape[0] * n, *t.shape[1:])

    def full(self, state):
        def gather(path, enc, p, cuts):
            def one(t):
                shape = list(p.shape)
                for ax, m in cuts:
                    _check_rows(t, shape, ax, path)
                    g = self.mesh.group(m)
                    t = _gather_axis(t, shape, ax, g)
                    shape[ax] *= comm.size(g)
                return t
            return _parts(enc, one)
        return self._map(state, gather)

    def template(self, state):
        return self._map(state, lambda path, enc, p, cuts: _parts(
            enc, lambda t: t.new_empty(self._grown(t, p, cuts))))

    @torch.no_grad()
    def shard(self, full, state):
        """`full` (restored into ``template(state)``) with this rank's
        blocks copied into `state`'s live cut leaves, which take their
        places."""
        live = []
        self._map(state, lambda path, enc, p, cuts: live.append((enc, p)))
        it = iter(live)

        def put(path, fenc, _, cuts):
            enc, p = next(it)
            if isinstance(enc, QTensor):
                pairs = ((fenc.data, enc.data), (fenc.scale, enc.scale))
            else:
                pairs = ((fenc, enc),)
            for f, t in pairs:
                shape = list(self._grown(p, p, cuts))
                for ax, m in cuts:
                    n = self.mesh.shape[m]
                    pre = math.prod(shape[:ax])
                    cols = f.numel() // pre
                    f = f.reshape(pre, cols).narrow(
                        1, self.mesh.index(m) * (cols // n),
                        cols // n)
                    shape[ax] //= n
                t.copy_(f.reshape(t.shape))
            return enc
        return self._map(full, put)
