"""AdamW with FP32 master weights and a global-norm clip.

Counterpart of ``repro.optim.adamw`` without the FP8-split state
(``state_policy`` raises; ROADMAP.md, Queue 1, item 3).  ``adamw_math``
is the one copy of the update arithmetic.  Moments and master weights
are f32, the one path: the reference's bf16-moment and no-master options
come with that state.  The update runs in place under
``no_grad``, one slice of each leaf at a time: at full width an f32 copy of
the (128, 4096, 3072) expert leaf alone is 6.4 GB, so neither the global
norm nor the update ever widens a whole leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import CHUNK_ELEMS


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_policy: Optional[Any] = None

    def __post_init__(self):
        if self.state_policy is not None:
            raise NotImplementedError(
                "the FP8-split optimizer state is not ported yet (ROADMAP.md, "
                "Queue 1, item 3)")


def tree_leaves(tree):
    """Leaves of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _chunks(t: torch.Tensor):
    flat = t.reshape(-1)
    for i in range(0, flat.numel(), CHUNK_ELEMS):
        yield flat[i:i + CHUNK_ELEMS]


def adamw_math(cfg: AdamWConfig, g32, m32, v32, base32, lr, b1c, b2c):
    """The single copy of the update math (f32 in, f32 out).  `g32` arrives
    pre-clipped."""
    m_new = cfg.b1 * m32 + (1 - cfg.b1) * g32
    v_new = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
    mhat = m_new / b1c
    vhat = v_new / b2c
    new_master = base32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                + cfg.weight_decay * base32)
    return new_master, m_new, v_new


def init_state(cfg: AdamWConfig, params):
    """f32 moments and f32 master weights for every leaf."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "step": 0,
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
    }


@torch.no_grad()
def global_norm(grads) -> torch.Tensor:
    """Global L2 norm, sums of squares in f32 a slice at a time."""
    total = None
    for g in tree_leaves(grads):
        for c in _chunks(g):
            part = c.to(torch.float32).square().sum()
            total = part if total is None else total + part
    return torch.sqrt(total) if total is not None else torch.zeros(())


def clip_factor(cfg: AdamWConfig, gnorm: torch.Tensor) -> torch.Tensor:
    if not cfg.grad_clip:
        return torch.ones((), dtype=torch.float32, device=gnorm.device)
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)


def bias_corrections(cfg: AdamWConfig, step: int):
    f = np.float32
    return (float(f(1.0) - f(cfg.b1) ** f(step)),
            float(f(1.0) - f(cfg.b2) ** f(step)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """Update params and state IN PLACE (the reference returns new trees);
    returns the metrics.  Every leaf must have a gradient."""
    g_leaves = tree_leaves(grads)
    if any(g is None for g in g_leaves):
        raise ValueError("apply_updates: a parameter has no gradient")
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = clip_factor(cfg, gnorm)
    b1c, b2c = bias_corrections(cfg, step)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    leaves = zip(tree_leaves(params), g_leaves, tree_leaves(state["m"]),
                 tree_leaves(state["v"]), tree_leaves(state["master"]))
    for p, g, m, v, master in leaves:
        for pc, gc, mc, vc, wc in zip(_chunks(p), _chunks(g), _chunks(m),
                                      _chunks(v), _chunks(master)):
            new_w, m_new, v_new = adamw_math(cfg, gc.to(torch.float32) * clip,
                                             mc, vc, wc, lr, b1c, b2c)
            mc.copy_(m_new)
            vc.copy_(v_new)
            wc.copy_(new_w)
            pc.copy_(new_w)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
