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
    # a cut leaf's squares are summed over its groups (identities on a
    # group-less mesh, so with and without groups the norm adds alike)
    mesh_norm = mesh is not None and (mesh.ep > 1
                                      or plan.shards_weights(cfg))

    def train_step(state, batch):
        params = state["params"]
        ctx = quant.collect_stats() if guard is not None \
            else contextlib.nullcontext()
        with ctx:
            loss, metrics, grads = _local_grads(cfg, recipe, params, batch,
                                                grad_accum, guard is not None,
                                                plan)
        if on_mesh:
            grads = reduce_grads(grads, mesh, cfg, plan)
            loss, metrics = _mean_metrics(loss, metrics, mesh.world_group,
                                          mesh.world)
        lr_scale = schedules.warmup_cosine(
            state["opt"]["step"], total_steps=total_steps,
            warmup_steps=warmup_steps)
        gnorm = mesh_global_norm(grads, mesh, cfg, plan) if mesh_norm \
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
        train_step.shardings = MeshShardings(mesh, cfg, plan)
    return train_step


@torch.no_grad()
def reduce_grads(grads, mesh, cfg, plan=None):
    """Every leaf's gradient summed in f32 over its group
    (``launch.sharding.grad_group``: what the stages' collectives left to
    sum; `plan` defaults to the EP plan of `mesh`) and divided by the
    world size; a leaf at a time, each bf16 gradient freed as its f32
    mean is made.  The means stay f32, as the f32 DP wire's do (the two
    steps agree bit for bit), so a leaf's mean is one f32 allocation
    (12 GiB for grok1_314b's we13)."""
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
            comm.all_reduce_(g32, grad_group(p, mesh, cfg, plan))
            out[k] = g32.div_(mesh.world)
        return out
    return walk(grads)


@torch.no_grad()
def mesh_global_norm(grads, mesh, cfg, plan=None) -> torch.Tensor:
    """The global norm when leaves are cut (EP > 1, TP, FSDP): a rank
    holds only its block of a cut leaf's gradient, so that leaf's sum of
    squares is summed over its cuts' groups first
    (``launch.sharding.norm_groups``); the whole leaves' are the same on
    every rank.  The leaves add in ``adamw.global_norm``'s order."""
    from repro_torch.dist.plan import flatten_with_paths
    from repro_torch.launch.sharding import norm_groups
    total = None
    for p, g in flatten_with_paths(grads, sort=False):
        part = _sq_sum(g)
        for group in norm_groups(p, mesh, cfg, plan):
            part = comm.all_reduce_(part.reshape(1).clone(), group)[0]
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


# ---------------------------------------------------------------------------
# The streaming schedule (the reference's _streamed_grads, train_step.py:
# 127-336): the staged forward keeps each block's input and outputs, the
# backward walks the blocks in reverse, and each layer's buckets go on the
# wire as soon as its gradients exist.
# ---------------------------------------------------------------------------
def _streamed_grads(cfg, recipe, lplan, params, batch, layout, group,
                    n_dp: int, wire: str, grad_accum: int = 1, guard=None):
    """Returns (loss, metrics, owned, sens_done, sens_raw, wire_bad):
    `owned` aligns with layout.buckets (the layered layout) and holds each
    bucket's reduced f32 shard; `sens_done` maps a stack-tagged sensitive
    leaf's path to its reduced, restacked f32 gradient (each layer's
    slice sent with that layer's buckets); `sens_raw` maps the other
    sensitive leaves' (embedding, final norm, head) flatten indices to
    their local gradients, which the caller reduces post hoc.

    Each block's layer parameters are fresh leaves (a layer slice of the
    stacked leaf, detached), so a block's backward writes that layer's
    gradients alone (no full-size stacked gradient a block).  Each block
    runs under the config's MemoryPlan (``pair``: two-layer blocks), its
    input and outputs kept; the backward is ``torch.autograd.backward`` on
    the block's outputs (the residual's cotangent and AUX_LOSS_COEF for
    each aux loss).  The wire: the moment a layer's gradients exist, its
    buckets are flattened, quantized and put on an ``async_op``
    all-to-all (``grad_comm.issue_reduce_scatter``, range
    ``wire/bucket{i}_{stack}_l{l}``) and its stack-tagged sensitive slices
    all-reduced (``wire/sensitive_{stack}_l{l}``); the received shards
    are read after the backward, where the guard's verdicts are taken
    together (one host read).  grad_accum > 1: every microbatch's flats
    and slices add up locally (f32) and are sent once, from the last
    microbatch's backward, divided by grad_accum as the post-hoc sums
    are; the post-hoc step gives the same bits."""
    from repro_torch.dist import grad_comm
    from repro_torch.dist.plan import bucket_flat_parts, flatten_with_paths
    from repro_torch.models import lm
    from repro_torch.obs.trace import annotate
    from repro_torch.train.memory import MemoryPlan

    mem = MemoryPlan.from_config(cfg)
    flat_params = flatten_with_paths(params)
    index = {p: i for i, (p, _) in enumerate(flat_params)}
    layer_buckets = {}
    for bi, b in enumerate(layout.buckets):
        layer_buckets.setdefault((b.stack, b.layer), []).append((bi, b))
    sens_stacked = {s.index: s for s in layout.sensitive
                    if s.stack is not None}
    armed = quant.stats_armed()
    dev = flat_params[0][1].device

    inflight = [None] * len(layout.buckets)
    flat_acc = [None] * len(layout.buckets)
    sens_acc = {}                    # (index, layer) -> local f32 sum
    sens_parts = {}                  # index -> {layer: reduced slice}
    sens_raw = {}
    wire_sv = []
    losses, ms = [], []
    ends = ["embed", "final_norm_s", "final_norm_b", "lm_head"]
    ends = [n for n in ends if n in params]

    for m in range(grad_accum):
        mb = batch if grad_accum == 1 else {k: v[m]
                                            for k, v in batch.items()}
        emit = m == grad_accum - 1
        for n in ends:
            params[n].grad = None
        x0 = lm._embed_tokens(cfg, params, mb["tokens"])
        positions = torch.arange(x0.shape[1], device=x0.device)
        x = x0.detach().requires_grad_()
        recs = []
        aux = torch.zeros((), dtype=torch.float32, device=x0.device)
        for stack, pattern, n, moe in lm.decoder_stacks(cfg):
            # fresh leaves a layer: a block's backward writes its own
            leaves = [{name: leaf[li].detach().requires_grad_()
                       for name, leaf in params[stack].items()}
                      for li in range(n)]
            fns = lm.stack_layer_fns(cfg, recipe, leaves, pattern, moe,
                                     positions, plan=lplan)
            stack_aux = torch.zeros((), dtype=torch.float32,
                                    device=x0.device)
            for layers in mem.layer_blocks(n):
                x_in = x
                x_out, auxes = lm.run_block(cfg, [fns[i] for i in layers],
                                            x_in)
                stack_aux = lm.add_auxes(stack_aux, auxes)
                recs.append((stack, layers, [leaves[i] for i in layers],
                             x_in, x_out, auxes))
                x = x_out.detach().requires_grad_()
            aux = aux + stack_aux
        xent = lm.batch_xent(lm.head_logits(cfg, params, x), mb)
        loss = xent + lm.AUX_LOSS_COEF * aux
        head = [params[n] for n in ends if n != "embed"
                or cfg.tie_embeddings]
        torch.autograd.backward(xent, inputs=[x] + head)
        g_x = x.grad
        g_aux = torch.full((), lm.AUX_LOSS_COEF, dtype=torch.float32,
                           device=x0.device)
        while recs:          # each block's record freed once it is used
            stack, layers, leaves, x_in, x_out, auxes = recs.pop()
            outs = [x_out] + [a for a in auxes if a is not None]
            grads = [g_x] + [g_aux] * (len(outs) - 1)
            torch.autograd.backward(outs, grads, inputs=[x_in] + [
                t for lp in leaves for t in lp.values()])
            g_x = x_in.grad
            del outs, x_out, auxes
            for li, lp in reversed(list(zip(layers, leaves))):
                g_leaf = {}
                for name, t in lp.items():
                    g = t.grad
                    g_leaf[index[f"{stack}.{name}"]] = \
                        torch.zeros_like(t) if g is None else g
                    t.grad = None
                for bi, b in layer_buckets.get((stack, li), ()):
                    gdt = torch.float32 if grad_accum > 1 or any(
                        g_leaf[sl.index].dtype == torch.float32
                        for sl in b.slots) else \
                        g_leaf[b.slots[0].index].dtype
                    flat = bucket_flat_parts(b, lambda sl: g_leaf[sl.index],
                                             gdt)
                    if flat_acc[bi] is not None:
                        flat = flat_acc[bi].add_(flat)
                    if not emit:
                        flat_acc[bi] = flat
                        continue
                    flat_acc[bi] = None
                    if grad_accum > 1:
                        flat = flat.div_(grad_accum)
                    with annotate(f"wire/bucket{bi}_{stack}_l{li}"):
                        ctx = quant.collect_stats() if armed \
                            else contextlib.nullcontext()
                        with ctx as col:
                            inflight[bi] = grad_comm.issue_reduce_scatter(
                                flat, group, n_dp, wire)
                        if armed:
                            wire_sv.append(_drain_into(col, dev))
                    del flat
                for i, g in g_leaf.items():
                    if i not in sens_stacked:
                        continue
                    key = (i, li)
                    if grad_accum > 1:
                        g = g.to(torch.float32)
                        if key in sens_acc:
                            g = sens_acc.pop(key).add_(g)
                    if not emit:
                        sens_acc[key] = g
                        continue
                    if grad_accum > 1:
                        g = g.div_(grad_accum)
                    with annotate(f"wire/sensitive_{stack}_l{li}"):
                        sens_parts.setdefault(i, {})[li] = \
                            grad_comm.reduce_sensitive(g, group, n_dp, wire)
                del g_leaf
        torch.autograd.backward(x0, g_x)
        del g_x, x0
        for n in ends:
            i = index[n]
            g = params[n].grad
            g = torch.zeros_like(params[n]) if g is None else g
            params[n].grad = None
            if grad_accum > 1:
                g = g.to(torch.float32)
                g = g if i not in sens_raw else sens_raw[i].add_(g)
            sens_raw[i] = g
        metrics = {"aux_loss": aux.detach(), "loss": loss.detach()}
        if armed:
            sv = quant.drain_stats(dev)
            sm = quant.site_maxima(sv)
            metrics.update(quant_sat_frac=sm[0], quant_flush_frac=sm[1],
                           quant_site_stats=sv)
        losses.append(loss.detach())
        ms.append(metrics)
    if grad_accum > 1:
        sens_raw = {i: g.div_(grad_accum) for i, g in sens_raw.items()}
        loss = torch.stack(losses).sum() / grad_accum
        metrics = {k: torch.stack([mm[k] for mm in ms]).mean(dim=0)
                   for k in ms[0]}
    else:
        loss, metrics = losses[0], ms[0]
    sens_done = {sens_stacked[i].path: torch.stack(
        [pieces[li] for li in range(len(pieces))])
        for i, pieces in sens_parts.items()}
    # the shards are read here, after the backward: the guard's verdicts
    # first (collectives, in bucket order), read on the host once
    wire_bad = None
    if guard is not None:
        bads = torch.stack([f.bad(guard) for f in inflight]) if inflight \
            else torch.zeros((0,), dtype=torch.bool, device=dev)
        flags = bads.tolist()
        owned = [f.finish(bad) for f, bad in zip(inflight, flags)]
        wire_bad = bads.any()
        if wire_sv:
            sites = metrics["quant_site_stats"]
            for sv in wire_sv:
                sites = torch.maximum(sites, sv)
            sm = quant.site_maxima(sites)
            metrics.update(quant_site_stats=sites, quant_sat_frac=sm[0],
                           quant_flush_frac=sm[1])
    else:
        owned = [f.finish() for f in inflight]
    return loss, metrics, owned, sens_done, sens_raw, wire_bad


def _drain_into(col, dev) -> torch.Tensor:
    """A nested collector's stats, max-merged (zeros if none)."""
    out = quant.zero_stats(dev)
    for v in col.vals:
        out = torch.maximum(out, v)
    return out


def _posthoc_grads(cfg, recipe, lplan, params, batch, layout, group,
                   n_dp: int, wire: str, grad_accum: int = 1, guard=None):
    """The post-hoc schedule, ``_streamed_grads``'s returns: the whole
    backward, then one fused uint8 message a bucket (scales agreed
    first), each leaf's gradient freed once its last bucket is reduced."""
    from repro_torch.dist import grad_comm
    from repro_torch.dist.plan import bucket_flat, flatten_with_paths
    loss, metrics, grads = _local_grads(cfg, recipe, params, batch,
                                        grad_accum, guard is not None, lplan)
    gleaves = [g for _, g in flatten_with_paths(grads)]
    del grads
    left = {}
    for b in layout.buckets:
        for sl in b.slots:
            left[sl.index] = left.get(sl.index, 0) + 1
    owned, wire_bad = [], None
    for b in layout.buckets:
        gdt = torch.float32 if any(
            gleaves[sl.index].dtype == torch.float32
            for sl in b.slots) else gleaves[b.slots[0].index].dtype
        flat = bucket_flat(b, gleaves, gdt)
        if guard is not None:
            o, bad = grad_comm.reduce_scatter_bucket(flat, group, n_dp, wire,
                                                     guard=guard)
            wire_bad = bad if wire_bad is None else wire_bad | bad
        else:
            o = grad_comm.reduce_scatter_bucket(flat, group, n_dp, wire)
        owned.append(o)
        del flat
        for sl in b.slots:
            left[sl.index] -= 1
            if not left[sl.index]:
                gleaves[sl.index] = None
    if guard is not None:
        # the wire quantize's stats, recorded after forward()'s
        wire_sv = quant.drain_stats(loss.device)
        sites = torch.maximum(metrics["quant_site_stats"], wire_sv)
        sm = quant.site_maxima(sites)
        metrics.update(quant_site_stats=sites, quant_sat_frac=sm[0],
                       quant_flush_frac=sm[1])
    sens_raw = {i: gleaves[i] for i, _ in layout.sensitive}
    return loss, metrics, owned, {}, sens_raw, wire_bad


def _make_dist_train_step(cfg: ArchConfig, recipe: Recipe,
                          opt: adamw.AdamWConfig, dist, plan, *,
                          grad_accum: int, total_steps: int,
                          warmup_steps: int, guard=None):
    from repro_torch.dist import grad_comm
    from repro_torch.dist import opt_state as ost
    from repro_torch.dist.plan import (bucket_flat, bucket_scatter,
                                       build_layout, flatten_with_paths,
                                       streaming_fallback_reason)

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
            f"supported with it: the reference's wire needs a DP-only mesh "
            f"and refuses a model or pod axis larger than one "
            f"(repro/train/train_step.py:361-368): use dist=None")
    n_dp = mesh.shape[dist.axis]
    if dist.shard_multiple % n_dp != 0:
        raise ValueError(
            f"DP size {n_dp} does not divide DistPlan.shard_multiple="
            f"{dist.shard_multiple}: bucket rows pad to shard_multiple, so "
            f"ZeRO-1 shards would be unequal")
    stream = dist.schedule == "stream"

    def refuse_stream(layout=None):
        reason = streaming_fallback_reason(cfg, layout, grad_accum)
        if reason:
            raise ValueError(
                f"DistPlan schedule='stream' cannot run: {reason}; use "
                f"schedule='posthoc' (launch/train.py falls back to it)")
    if stream:
        refuse_stream()
    group = mesh.group(dist.axis)
    rank = comm.rank(group)
    # the forward is replica-local: no expert-parallel group
    local_plan = dataclasses.replace(plan, mesh=None, moe_mode="ep",
                                     fsdp_axis=None, mlp_tp=False)
    wire = dist.wire
    layouts = {}

    def train_step(state, batch):
        params = state["params"]
        flat_params = flatten_with_paths(params)
        key = tuple((p, tuple(t.shape)) for p, t in flat_params)
        if key not in layouts:
            layouts[key] = build_layout(params, dist)
            if stream:
                refuse_stream(layouts[key])
        layout = layouts[key]
        pleaves = [t for _, t in flat_params]
        ctx = quant.collect_stats() if guard is not None \
            else contextlib.nullcontext()
        with ctx:
            if stream:
                loss, metrics, owned, sens_done, sens_raw, wire_bad = \
                    _streamed_grads(cfg, recipe, local_plan, params, batch,
                                    layout, group, n_dp, wire, grad_accum,
                                    guard)
            else:
                loss, metrics, owned, sens_done, sens_raw, wire_bad = \
                    _posthoc_grads(cfg, recipe, local_plan, params, batch,
                                   layout, group, n_dp, wire, grad_accum,
                                   guard)
        sens_g = {p: sens_done[p] if p in sens_done else
                  grad_comm.reduce_sensitive(sens_raw[i], group, n_dp, wire)
                  for i, p in layout.sensitive}
        del sens_done, sens_raw

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
                # a layered bucket writes one layer slice of its leaves
                for key, piece in bucket_scatter(b, full, pleaves).items():
                    i, li = key if isinstance(key, tuple) else (key, None)
                    leaf = pleaves[i].detach()
                    if li is not None:
                        leaf = leaf[li]
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
                     dist=None, mesh=None, plan=None) -> Dict[str, Any]:
    """{'params': leaves that require grad, 'opt': AdamW state[, 'guard':
    the guard's carried state]}.  `params` (e.g. the reference's
    init_params tree carried across by ``weights.params_from_numpy``)
    replaces the port's own random init.  With an active `dist`
    (DistPlan) the optimizer state is the ZeRO-1 state of this replica on
    `mesh`'s data axis (``dist.opt_state.init_dist_state``).  On a mesh
    the leaves are cut to this rank's blocks by `plan` (a
    ``models.lm.ParallelPlan``; default the EP plan of `mesh`: the expert
    leaves at EP > 1), ``launch.sharding.shard_params``."""
    if params is None:
        from repro_torch.models.lm import init_params
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
    if plan is not None and mesh is None:
        mesh = plan.mesh
    if dist is not None and dist.active:
        plan = None         # the wire's forward is replica-local and whole
    if mesh is not None:
        from repro_torch.launch.sharding import shard_params
        params = shard_params(params, mesh, cfg, plan)
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
