"""The training step: loss -> backward -> (grad accumulation) -> guard ->
AdamW update, on one device.

Counterpart of ``repro.train.train_step``'s local path.  ``dist`` (the FP8
DP wire and ZeRO-1) raises (ROADMAP.md, Queue 1, item 7).  PyTorch runs
eagerly, so ``make_train_step`` returns a plain function that updates the
state IN PLACE (parameters, moments, master weights) and returns it with
the step's metrics.

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
replaced, not updated in place.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quant
from repro_torch.core.recipes import Recipe
from repro_torch.models.lm import forward
from repro_torch.optim import adamw, schedules
from repro_torch.train import guards


def make_train_step(cfg: ArchConfig, recipe: Recipe, opt: adamw.AdamWConfig,
                    *, grad_accum: int = 1, dist=None,
                    total_steps: int = 100_000, warmup_steps: int = 100,
                    guard: Optional[guards.GuardPlan] = None,
                    moe_overlap=None):
    """Returns train_step(state, batch) -> (state, metrics); state =
    {'params', 'opt'[, 'guard']} as ``init_train_state`` builds it.  With
    grad_accum > 1 every batch leaf has a leading (grad_accum,) axis.
    The function carries its plan as ``train_step.guard`` (None when
    unguarded), which ``loop.run`` checks against its GuardPolicy.
    `moe_overlap` (a ``core.moe.DispatchPlan``) runs the MoE layers through
    the chunked blocks (``models.lm.forward``)."""
    if dist is not None:
        raise NotImplementedError(
            "the distributed train step (FP8 DP wire, ZeRO-1) is not ported "
            "yet (ROADMAP.md, Queue 1, item 7)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum}")

    def train_step(state, batch):
        params = state["params"]
        ctx = quant.collect_stats() if guard is not None \
            else contextlib.nullcontext()
        with ctx:
            loss, metrics, grads = _local_grads(cfg, recipe, params, batch,
                                                grad_accum, guard is not None,
                                                moe_overlap)
        lr_scale = schedules.warmup_cosine(
            state["opt"]["step"], total_steps=total_steps,
            warmup_steps=warmup_steps)
        gnorm = adamw.global_norm(grads)
        flags = None
        if guard is not None:
            flags, new_g, gm = guards.evaluate(
                guard, state["guard"], loss=loss, gnorm=gnorm,
                sat_frac=metrics.get("quant_sat_frac"),
                flush_frac=metrics.get("quant_flush_frac"))
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
    return train_step


def _grads_of(params):
    """The leaves' gradients (jax.grad's zeros for a leaf the forward never
    reads, e.g. mamba2's ln2: its layers have no MLP), cleared off the
    leaves."""
    def take(p):
        g = torch.zeros_like(p) if p.grad is None else p.grad
        p.grad = None
        return g
    return adamw.tree_map(take, params)


def _forward_backward(cfg, recipe, params, mb, armed, moe_overlap=None):
    for p in adamw.tree_leaves(params):
        p.grad = None
    loss, metrics = forward(cfg, recipe, params, mb, moe_overlap=moe_overlap)
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
                 moe_overlap=None):
    """(loss, forward metrics, grads).  With grad_accum > 1 the
    microbatch grads are summed in f32 and divided by grad_accum, and the
    loss and metrics are averaged, as the reference's scan does."""
    if grad_accum == 1:
        loss, metrics = _forward_backward(cfg, recipe, params, batch, armed,
                                          moe_overlap)
        return loss, metrics, _grads_of(params)
    gsum = lsum = None
    ms = []
    for m in range(grad_accum):
        mb = {k: v[m] for k, v in batch.items()}
        loss, metrics = _forward_backward(cfg, recipe, params, mb, armed,
                                          moe_overlap)
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


def init_train_state(cfg: ArchConfig, opt: adamw.AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16, device="cuda",
                     params=None, guard: Optional[guards.GuardPlan] = None
                     ) -> Dict[str, Any]:
    """{'params': leaves that require grad, 'opt': AdamW state[, 'guard':
    the guard's carried state]}.  `params` (e.g. the reference's
    init_params tree carried across by ``weights.params_from_numpy``)
    replaces the port's own random init."""
    if params is None:
        from repro_torch.models.lm import init_params
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
    for p in adamw.tree_leaves(params):
        p.requires_grad_()
    state = {"params": params, "opt": adamw.init_state(opt, params)}
    if guard is not None:
        dev = adamw.tree_leaves(params)[0].device
        state["guard"] = guards.init_guard_state(dev)
    return state
