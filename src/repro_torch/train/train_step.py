"""The training step: loss -> backward -> AdamW update, on one device.

Counterpart of ``repro.train.train_step`` without its distributed and
guarded forms: ``dist`` (the FP8 DP wire and ZeRO-1), ``guard`` (the
numerics guardrails) and ``grad_accum > 1`` raise, each naming its
ROADMAP.md Queue 1 item.  PyTorch runs eagerly, so ``make_train_step``
returns a plain function that updates the state IN PLACE (parameters,
moments and master weights) and returns it with the step's metrics.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.recipes import Recipe
from repro_torch.models.lm import forward
from repro_torch.optim import adamw, schedules


def make_train_step(cfg: ArchConfig, recipe: Recipe, opt: adamw.AdamWConfig,
                    *, grad_accum: int = 1, dist=None,
                    total_steps: int = 100_000, warmup_steps: int = 100,
                    guard=None):
    """Returns train_step(state, batch) -> (state, metrics); state =
    {'params', 'opt'} as ``init_train_state`` builds it."""
    if dist is not None:
        raise NotImplementedError(
            "the distributed train step (FP8 DP wire, ZeRO-1) is not ported "
            "yet (ROADMAP.md, Queue 1, item 7)")
    if guard is not None:
        raise NotImplementedError(
            "the numerics guardrails are not ported yet (ROADMAP.md, Queue 1, "
            "item 6)")
    if grad_accum > 1:
        raise NotImplementedError(
            "gradient accumulation is not ported yet (ROADMAP.md, Queue 1, "
            "item 6)")

    def train_step(state, batch):
        params = state["params"]
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.grad = None
        loss, metrics = forward(cfg, recipe, params, batch)
        loss.backward()
        # a leaf the forward never reads (mamba2's ln2: its layers have no
        # MLP) gets jax.grad's zero gradient
        grads = adamw.tree_map(
            lambda p: torch.zeros_like(p) if p.grad is None else p.grad,
            params)
        lr_scale = schedules.warmup_cosine(
            state["opt"]["step"], total_steps=total_steps,
            warmup_steps=warmup_steps)
        opt_metrics = adamw.apply_updates(opt, params, grads, state["opt"],
                                          lr_scale=lr_scale)
        del grads
        for p in leaves:
            p.grad = None
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return state, metrics

    return train_step


def init_train_state(cfg: ArchConfig, opt: adamw.AdamWConfig, seed: int = 0,
                     dtype=torch.bfloat16, device="cuda",
                     params=None) -> Dict[str, Any]:
    """{'params': leaves that require grad, 'opt': AdamW state}.  `params`
    (e.g. the reference's init_params tree carried across by
    ``weights.params_from_numpy``) replaces the port's own random init."""
    if params is None:
        from repro_torch.models.lm import init_params
        params = init_params(cfg, seed=seed, dtype=dtype, device=device)
    for p in adamw.tree_leaves(params):
        p.requires_grad_()
    return {"params": params, "opt": adamw.init_state(opt, params)}
