"""The training step: loss -> backward -> (grad accumulation) -> gradient
reduction -> guard -> AdamW update.

Counterpart of ``repro.train.train_step``.  PyTorch runs eagerly, so
``make_train_step`` returns a plain function that updates the state IN
PLACE (parameters, moments, master weights) and returns it with the
step's metrics.  Two reduction regimes, as in the reference:

  dist=None      the plain step.  Without a mesh (or on a group-less one)
                 nothing is reduced.  On a mesh (``plan=ParallelPlan(
                 mesh=...)``: each rank holds its share of the global
                 batch and its E_loc experts, ``launch/sharding.py``) every
                 gradient is all-reduced in f32 and divided by the world
                 size: a replicated leaf over the world, an expert leaf
                 over the ``data`` group only (its ``model`` ranks met in
                 the all-to-all's backward; the reference's dp_axes Wgrad
                 psum), the router over the world.  The loss is the mean
                 over the ranks, the quant stats and guard flags their MAX,
                 so every rank skips the same step.
  dist=DistPlan  the FP8 DP wire with ZeRO-1 (the reference's
                 ``_make_dist_train_step``, 'posthoc' schedule): the
                 forward is replica-local, the buckets are reduce-scattered
                 after the backward (e4m3 payload + int8 po2 exponents in
                 one uint8 message a bucket), the global norm is the
                 all-reduce of the owned squares plus the sensitive
                 leaves', each bucket's owned shard is updated on the
                 ``adamw_update`` kernel, and the updated shards are
                 gathered back.  A DP-only mesh: a 'model' axis larger
                 than 1 raises, as in the reference.

``grad_accum > 1``: the batch carries a leading microbatch axis; each
microbatch's gradient is added into f32 sums and the sums are divided by
`grad_accum`, as the reference does (4 B a parameter more); the loss and
forward metrics are the microbatches' means.

The activation-residency plan is the config's (``cfg.remat_policy``,
``train/memory.py``): the model's stack drivers checkpoint their layer
blocks by it, so each microbatch's backward recomputes what the policy
does not keep, and the recompute records no cast and no quant stat.
Every policy gives the same losses, gradients and guard flags.

``guard=GuardPlan``: the FP8 quantize-site stats are collected
(``core.quant.collect_stats``), ``guards.evaluate`` folds the step's
health into ``guard_flags`` after the global norm, and the update writes
nothing where ``guard_flags & guard.skip_flags`` is nonzero: skip-step is
decided on the device, before the update, with no copy of the state.
The optimizer's host step counter still moves; the loop winds it back
(and restores the guard state) after its fetch.  ``state['guard']`` is
replaced, not updated in place.  On the DP wire the guard also checks
each received bucket (``grad_comm.reduce_scatter_bucket``): a poisoned
one takes the bf16 all-reduce instead, in the step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.core.fp8 import TILE
from repro_torch.core.recipes import Recipe
from repro_torch.device import CHUNK_ELEMS
from repro_torch.dist import comm
from repro_torch.models.lm import NO_PLAN, forward
from repro_torch.optim import adamw, schedules
from repro_torch.train import guards


def make_train_step(cfg: ArchConfig, recipe: Recipe, opt: adamw.AdamWConfig,
                    *, grad_accum: int = 1, dist=None, plan=None,
                    total_steps: int = 100_000, warmup_steps: int = 100,
                    guard: Optional[guards.GuardPlan] = None):
    """Returns train_step(state, batch) -> (state, metrics); state =
    {'params', 'opt'[, 'guard']} as ``init_train_state`` builds it (with
    the same `dist` and mesh).  With grad_accum > 1 every batch leaf has
    a leading (grad_accum,) axis; on a mesh the batch is this rank's share
    (``launch.sharding.shard_batch``).  `plan` (``models.lm.ParallelPlan``)
    carries the mesh and the chunked blocks' DispatchPlan.  The function
    carries its GuardPlan as ``train_step.guard`` (None when unguarded),
    which ``loop.run`` checks against its GuardPolicy, and on a mesh
    ``train_step.shardings``, with which the loop saves and restores the
    sharded state: ``dist.opt_state.Zero1Shardings`` on the DP wire,
    ``launch.sharding.MeshShardings`` for the plain step."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}")
    plan = NO_PLAN if plan is None else plan
    if dist is not None and dist.active:
        return _make_dist_train_step(cfg, recipe, opt, dist, plan,
                                     grad_accum=grad_accum,
                                     total_steps=total_steps,
                                     warmup_steps=warmup_steps, guard=guard)
    mesh = plan.mesh
    on_mesh = mesh is not None and mesh.has_groups

    def train_step(state, batch):
        params = state["params"]
        ctx = quant.collect_stats() if guard is not None \
            else contextlib.nullcontext()
        with ctx:
            loss, metrics, grads = _local_grads(cfg, recipe, params, batch,
                                                grad_accum, guard is not None,
                                                plan)
        if on_mesh:
            grads = reduce_grads(grads, mesh)
            loss, metrics = _mean_metrics(loss, metrics, mesh.world_group,
                                          mesh.world)
        lr_scale = schedules.warmup_cosine(
            state["opt"]["step"], total_steps=total_steps,
            warmup_steps=warmup_steps)
        gnorm = mesh_global_norm(grads, mesh) if on_mesh and mesh.ep > 1 \
            else adamw.global_norm(grads)
        flags = None
        if guard is not None:
            flags, new_g, gm = guards.evaluate(
                guard, state["guard"], loss=loss, gnorm=gnorm,
                sat_frac=metrics.get("quant_sat_frac"),
                flush_frac=metrics.get("quant_flush_frac"))
            if on_mesh:
                flags = gm["guard_flags"] = comm.agree_max_int(
                    flags, mesh.world_group)
        skip_mask = guard.skip_flags if guard is not None else 0
        opt_metrics = adamw.apply_updates(opt, params, grads, state["opt"],
                                          lr_scale=lr_scale, gnorm=gnorm,
                                          skip=flags, skip_mask=skip_mask)
        del grads
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        if guard is not None:
            state["guard"] = new_g
            metrics.update(gm)
        return state, metrics

    train_step.guard = guard
    if on_mesh:
        from repro_torch.launch.sharding import MeshShardings
        train_step.shardings = MeshShardings(mesh)
    return train_step


@torch.no_grad()
def reduce_grads(grads, mesh):
    """Every leaf's gradient summed in f32 over its group
    (``launch.sharding.grad_group``) and divided by the world size; a leaf
    at a time, each bf16 gradient freed as its f32 mean is made."""
    from repro_torch.launch.sharding import grad_group

    def walk(tree, path=""):
        out = {}
        for k in list(tree):
            p = f"{path}.{k}" if path else k
            if isinstance(tree[k], dict):
                out[k] = walk(tree[k], p)
                continue
            g = tree[k]
            g32 = g.to(torch.float32, copy=True)
            tree[k] = None
            del g
            comm.all_reduce_(g32, grad_group(p, mesh))
            out[k] = g32.div_(mesh.world)
        return out
    return walk(grads)


@torch.no_grad()
def mesh_global_norm(grads, mesh) -> torch.Tensor:
    """The global norm at EP > 1: a rank holds only its experts'
    gradients, so each expert leaf's sum of squares is summed over the
    model axis first; the replicated leaves' are the same on every rank.
    The leaves add in ``adamw.global_norm``'s order."""
    from repro_torch.dist.plan import flatten_with_paths
    from repro_torch.launch.sharding import is_expert_leaf
    total = None
    for p, g in flatten_with_paths(grads, sort=False):
        part = _sq_sum(g)
        if is_expert_leaf(p):
            part = comm.all_reduce_(part.reshape(1).clone(),
                                    mesh.model_group)[0]
        total = part if total is None else total + part
    return torch.sqrt(total)


def _mean_metrics(loss, metrics, group, n: int):
    """The loss and forward metrics averaged over the group, the quant
    stats' MAX (an anomaly anywhere trips every rank)."""
    loss = comm.all_reduce_(loss.to(torch.float32).reshape(1).clone(),
                            group)[0] / n
    out = {}
    for k, v in metrics.items():
        if not torch.is_tensor(v) or not v.is_floating_point():
            out[k] = v
            continue
        t = v.to(torch.float32).reshape(-1).clone()
        if k.startswith("quant_"):
            out[k] = comm.all_reduce_(t, group, "max").reshape(v.shape)
        else:
            out[k] = (comm.all_reduce_(t, group) / n).reshape(v.shape)
    return loss, out


def _grads_of(params):
    """The leaves' gradients (jax.grad's zeros for a leaf the forward never
    reads, e.g. mamba2's ln2: its layers have no MLP), cleared off the
    leaves."""
    def take(p):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
        return g
    return adamw.tree_map(take, params)


def _forward_backward(cfg, recipe, params, mb, armed, plan=None):
    for p in adamw.tree_leaves(params):
        p.grad = None
    loss, metrics = forward(cfg, recipe, params, mb, plan=plan)
    loss.backward()
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    if armed:
        sv = quant.drain_stats(loss.device)
        sm = quant.site_maxima(sv)
        metrics.update(quant_sat_frac=sm[0], quant_flush_frac=sm[1],
                       quant_site_stats=sv)
    return loss.detach(), metrics


def _local_grads(cfg, recipe, params, batch, grad_accum: int, armed: bool,
                 plan=None):
    """(loss, forward metrics, grads).  With grad_accum > 1 the
    microbatch grads are summed in f32 and divided by grad_accum, and the
    loss and metrics are averaged, as the reference's scan does."""
    if grad_accum == 1:
        loss, metrics = _forward_backward(cfg, recipe, params, batch, armed,
                                          plan)
        return loss, metrics, _grads_of(params)
    gsum = lsum = None
    ms = []
    for m in range(grad_accum):
        mb = {k: v[m] for k, v in batch.items()}
        loss, metrics = _forward_backward(cfg, recipe, params, mb, armed,
                                          plan)
        g = _grads_of(params)
        if gsum is None:
            gsum = adamw.tree_map(lambda a: a.to(torch.float32), g)
            lsum = loss
        else:
            adamw.tree_map(lambda s, a: s.add_(a), gsum, g)
            lsum = lsum + loss
        del g
        ms.append(metrics)
    grads = adamw.tree_map(lambda s: s.div_(grad_accum), gsum)
    metrics = {k: torch.stack([mm[k] for mm in ms]).mean(dim=0)
               for k in ms[0]}
    return lsum / grad_accum, metrics, grads


# ---------------------------------------------------------------------------
# The FP8 DP wire + ZeRO-1 step (repro_torch.dist).
# ---------------------------------------------------------------------------
def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    """sum(t^2) in f32, a CHUNK_ELEMS slice at a time."""
    flat = t.reshape(-1)
    parts = [flat[i:i + CHUNK_ELEMS].to(torch.float32).square().sum()
             for i in range(0, flat.numel(), CHUNK_ELEMS)]
    return torch.stack(parts).sum()


def _dist_global_norm(params, layout, owned, sens_g, n_dp: int, rank: int,
                      group) -> torch.Tensor:
    """The global norm from the owned shards and the sensitive leaves.
    Each replica owns disjoint rows, so the all-reduce of the owned
    squares is the exact total (the reference's psum).  The squares are
    taken a leaf and a CHUNK_ELEMS chunk at a time and added in the
    params' own order, as ``adamw.global_norm`` adds them: at one replica
    the norm is the plain step's bit for bit."""
    from repro_torch.dist.plan import flatten_with_paths
    index = {p: i for i, (p, _) in enumerate(flatten_with_paths(params))}
    parts = {}                      # leaf index -> [chunk sums]
    for b, o in zip(layout.buckets, owned):
        rows_l = b.rows // n_dp
        r0 = rank * rows_l
        flat = o.reshape(-1)
        for s in b.slots:
            e0 = max(s.offset_rows, r0) * TILE - s.offset_rows * TILE
            e1 = min(s.size, (r0 + rows_l - s.offset_rows) * TILE)
            out = parts.setdefault(s.index, [])
            for c in range(e0 - e0 % CHUNK_ELEMS, max(e1, 0), CHUNK_ELEMS):
                lo, hi = max(c, e0), min(c + CHUNK_ELEMS, e1)
                if lo < hi:
                    off = (s.offset_rows - r0) * TILE
                    out.append(flat[off + lo:off + hi].square().sum())
    order = [index[p] for p, _ in flatten_with_paths(params, sort=False)]
    dev = owned[0].device if owned else next(iter(sens_g.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if n_dp > 1 and parts:
        keys = [i for i in order if i in parts]
        sums = torch.stack([torch.stack(parts[i]).sum() if parts[i]
                            else zero for i in keys])
        comm.all_reduce_(sums, group)
        parts = {i: [sums[k]] for k, i in enumerate(keys)}
    for i, p in layout.sensitive:    # replicated: not reduced
        parts[i] = [_sq_sum(c) for c in adamw._chunks(sens_g[p])]
    total = None
    for i in order:
        for part in parts.get(i) or [zero]:
            total = part if total is None else total + part
    return torch.sqrt(total)


def _make_dist_train_step(cfg: ArchConfig, recipe: Recipe,
                          opt: adamw.AdamWConfig, dist, plan, *,
                          grad_accum: int, total_steps: int,
                          warmup_steps: int, guard=None):
    from repro_torch.dist import grad_comm
    from repro_torch.dist import opt_state as ost
    from repro_torch.dist.plan import (bucket_flat, bucket_scatter,
                                       build_layout, flatten_with_paths)

    mesh = plan.mesh
    if mesh is None or dist.axis not in mesh.axis_names:
        raise ValueError(f"DistPlan needs a plan.mesh with axis "
                         f"'{dist.axis}'; got {mesh}")
    nontrivial = [a for a in mesh.axis_names
                  if a != dist.axis and mesh.shape[a] != 1]
    if nontrivial:
        raise ValueError(
            f"the DistPlan wire runs the forward replica-locally over "
            f"'{dist.axis}'; model-parallel axes {nontrivial} are not "
            f"supported with it (as in the reference): use dist=None")
    n_dp = mesh.shape[dist.axis]
    if dist.shard_multiple % n_dp != 0:
        raise ValueError(
            f"DP size {n_dp} does not divide DistPlan.shard_multiple="
            f"{dist.shard_multiple}: bucket rows pad to shard_multiple, so "
            f"ZeRO-1 shards would be unequal")
    group = mesh.group(dist.axis)
    rank = comm.rank(group)
    # the forward is replica-local: no expert-parallel group
    local_plan = dataclasses.replace(plan, mesh=None)
    wire = dist.wire
    layouts = {}

    def train_step(state, batch):
        params = state["params"]
        flat_params = flatten_with_paths(params)
        key = tuple((p, tuple(t.shape)) for p, t in flat_params)
        if key not in layouts:
            layouts[key] = build_layout(params, dist)
        layout = layouts[key]
        pleaves = [t for _, t in flat_params]
        ctx = quant.collect_stats() if guard is not None \
            else contextlib.nullcontext()
        with ctx:
            loss, metrics, grads = _local_grads(cfg, recipe, params, batch,
                                                grad_accum, guard is not None,
                                                local_plan)
            gleaves = [g for _, g in flatten_with_paths(grads)]
            del grads
            # one fused uint8 message a bucket, scales agreed first; a
            # bucket's gradients are freed once it is reduced
            owned, wire_bad = [], None
            for b in layout.buckets:
                gdt = torch.float32 if any(
                    gleaves[s.index].dtype == torch.float32
                    for s in b.slots) else gleaves[b.slots[0].index].dtype
                flat = bucket_flat(b, gleaves, gdt)
                if guard is not None:
                    o, bad = grad_comm.reduce_scatter_bucket(
                        flat, group, n_dp, wire, guard=guard)
                    wire_bad = bad if wire_bad is None else wire_bad | bad
                else:
                    o = grad_comm.reduce_scatter_bucket(flat, group, n_dp,
                                                        wire)
                owned.append(o)
                del flat
                for s in b.slots:
                    gleaves[s.index] = None
            if guard is not None:
                # the wire quantize's stats, recorded after forward()'s
                wire_sv = quant.drain_stats(loss.device)
                sites = torch.maximum(metrics["quant_site_stats"], wire_sv)
                sm = quant.site_maxima(sites)
                metrics.update(quant_site_stats=sites, quant_sat_frac=sm[0],
                               quant_flush_frac=sm[1])
        sens_g = {p: grad_comm.reduce_sensitive(gleaves[i], group, n_dp,
                                                wire)
                  for i, p in layout.sensitive}
        del gleaves

        gnorm = _dist_global_norm(params, layout, owned, sens_g, n_dp, rank,
                                  group)
        loss, metrics = _mean_metrics(loss, metrics, group, n_dp)
        lr_scale = schedules.warmup_cosine(
            state["opt"]["step"], total_steps=total_steps,
            warmup_steps=warmup_steps)
        flags = None
        if guard is not None:
            flags, new_g, gm = guards.evaluate(
                guard, state["guard"], loss=loss, gnorm=gnorm,
                sat_frac=metrics.get("quant_sat_frac"),
                flush_frac=metrics.get("quant_flush_frac"),
                wire_bad=wire_bad)
            flags = gm["guard_flags"] = comm.agree_max_int(flags, group)
        skip_mask = guard.skip_flags if guard is not None else 0
        opt_st = state["opt"]
        step = opt_st["step"] + 1
        clip = adamw.clip_factor(opt, gnorm)
        b1c, b2c = adamw.bias_corrections(opt, step)
        lr = adamw.lr_at(opt, lr_scale)
        keep = None if flags is None else (flags & skip_mask) != 0

        # ZeRO-1: update the owned shard on the adamw_update kernel, gather
        # the shards back, write them into the leaves.  The shards travel
        # in the bucket's param dtype: bf16, or f32 where an f32 leaf (a
        # stacked norm scale) shares the bucket.  The reference gathers
        # bf16 always, which rounds such a leaf to bf16 every step; in the
        # port it keeps its f32 value, as the plain step's update writes
        # it, so the f32 wire is the plain step bit for bit.
        with torch.no_grad():
            for b, o_g, st_b in zip(layout.buckets, owned, opt_st["flat"]):
                own = ost._owned_rows(b.rows, n_dp, rank)
                p_shard = bucket_flat(b, [t.detach() for t in pleaves],
                                      ost.bucket_dtype(b, pleaves))[own]
                if not p_shard.is_contiguous():
                    p_shard = p_shard.contiguous()
                ost.flat_bucket_update(opt, st_b, o_g, clip, lr, b1c, b2c,
                                       p_shard, flags, skip_mask)
                full = grad_comm.all_gather_shard(p_shard, group)
                for i, piece in bucket_scatter(b, full, pleaves).items():
                    leaf = pleaves[i].detach()
                    if keep is not None:
                        piece = torch.where(keep, leaf, piece)
                    leaf.copy_(piece)
                del full
            del owned
            # sensitive leaves: the replicated update, f32 state
            sens_st = opt_st["sens"]
            for i, pth in layout.sensitive:
                adamw.update_leaf(
                    opt, lr, b1c, b2c, pleaves[i], sens_g[pth], clip,
                    sens_st["m"][pth], sens_st["v"][pth],
                    sens_st["master"][pth] if "master" in sens_st else None,
                    flags, skip_mask)
        opt_st["step"] = step
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        if guard is not None:
            state["guard"] = new_g
            metrics.update(gm)
        return state, metrics

    train_step.guard = guard
    train_step.shardings = ost.Zero1Shardings(n_dp, rank, group)
    return train_step


def init_train_state(cfg: ArchConfig, opt: adamw.AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16, device="cuda",
                     params=None, guard: Optional[guards.GuardPlan] = None,
                     dist=None, mesh=None) -> Dict[str, Any]:
    """{'params': leaves that require grad, 'opt': AdamW state[, 'guard':
    the guard's carried state]}.  `params` (e.g. the reference's
    init_params tree carried across by ``weights.params_from_numpy``)
    replaces the port's own random init.  With an active `dist`
    (DistPlan) the optimizer state is the ZeRO-1 state of this replica on
    `mesh`'s data axis (``dist.opt_state.init_dist_state``); on a mesh
    with EP > 1 the expert leaves are cut to this rank's experts
    (``launch.sharding.shard_params``)."""
    if params is None:
        from repro_torch.models.lm import init_params
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
    if mesh is not None and mesh.ep > 1:
        from repro_torch.launch.sharding import shard_params
        params = shard_params(params, mesh)
    for p in adamw.tree_leaves(params):
        p.requires_grad_()
    if dist is not None and dist.active:
        from repro_torch.dist import opt_state as ost
        from repro_torch.dist.plan import build_layout
        n_dp = 1 if mesh is None else mesh.shape[dist.axis]
        rank = 0 if mesh is None else comm.rank(mesh.group(dist.axis))
        opt_state = ost.init_dist_state(opt, params,
                                        build_layout(params, dist), dist,
                                        n_dp, rank)
    else:
        opt_state = adamw.init_state(opt, params)
    state = {"params": params, "opt": opt_state}
    if guard is not None:
        dev = adamw.tree_leaves(params)[0].device
        state["guard"] = guards.init_guard_state(dev)
    return state
