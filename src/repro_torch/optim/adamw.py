"""AdamW with master weights, optional low-precision state, global-norm
clip.

Counterpart of ``repro.optim.adamw``.  Each piece of the state is
dtype-configurable two ways, as there:
  moment_dtype    f32 or bf16 moments, leaf-shaped
  state_policy    ``dist.opt_state.StatePolicy``: the FP8-split state
                  (e4m3 m, bf16 v, po2-scaled f16 master behind QTensor)
                  for large leaves; small or 1-D leaves keep f32
and ``master_weights=False`` updates from the bf16 parameter itself.

``adamw_math`` is the one copy of the update arithmetic.  The update runs
in place under ``no_grad`` (the reference returns new trees), one chunk of
``CHUNK_ELEMS`` elements of each leaf at a time: a multiple of 128, so
chunks cut an encoded leaf on its row boundaries.  Each chunk is one call
of ``kernels.ops.adamw_update``: the fused kernel on the card
(``csrc/adamw_update.cu``), its plain twin (decode, ``adamw_math``,
``encode_like``) on the CPU.  The global norm is still plain passes a
chunk at a time (ROADMAP.md, speed item 1).  At full width neither ever
widens a whole leaf: an f32 copy of qwen3's (128, 4096, 3072) expert leaf
alone is 6.4 GB.

``apply_updates(..., skip=flags)`` takes the guard's anomaly bits as a
device scalar: where ``flags & skip_mask`` is nonzero the update writes
nothing, decided on the device with no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import CHUNK_ELEMS
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32      # bf16 at >100B scale
    master_weights: bool = True
    # FP8-split state (dist.opt_state.StatePolicy); None = plain state
    state_policy: Optional[Any] = None


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


def _state_chunk(enc, start: int, n: int):
    """Elements [start, start + n) of a state leaf (start a multiple of
    128): a flat slice, or the QTensor rows that hold them."""
    if enc is None:
        return None
    if isinstance(enc, QTensor):
        r0, r1 = start // 128, -(-(start + n) // 128)
        return QTensor(enc.data[r0:r1], enc.scale[r0:r1], enc.tile)
    return enc.reshape(-1)[start:start + n]


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
    """Zero moments and the master weights, in the configured encodings."""
    pol = cfg.state_policy
    if pol is None:
        def zeros(p):
            return torch.zeros(p.shape, dtype=cfg.moment_dtype,
                               device=p.device)
        state = {"step": 0, "m": tree_map(zeros, params),
                 "v": tree_map(zeros, params)}
        if cfg.master_weights:
            state["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return state

    from repro_torch.dist import opt_state as ost

    def kind(p, k):
        return k if pol.applies(p) else "f32"

    state = {
        "step": 0,
        "m": tree_map(lambda p: ost.zeros_encoded(kind(p, pol.m), p),
                      params),
        "v": tree_map(lambda p: ost.zeros_encoded(kind(p, pol.v), p),
                      params),
    }
    if cfg.master_weights:
        # a policy leaf encodes straight from the bf16 param (po2 division
        # is exact there): no f32 copy of the tree
        state["master"] = tree_map(
            lambda p: ost.encode(kind(p, pol.master), p.detach()), params)
    return state


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


def _state_leaves(state, key, n):
    return tree_leaves(state[key]) if key in state else [None] * n


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, lr_scale=1.0, *,
                  gnorm: Optional[torch.Tensor] = None,
                  skip: Optional[torch.Tensor] = None,
                  skip_mask: int = 0):
    """Update params and state IN PLACE (the reference returns new trees);
    returns the metrics.  Every leaf must have a gradient (bf16, or f32
    sums).  `gnorm`: the global norm if the caller already took it.
    `skip`: int32 device flags; the update writes nothing where
    ``skip & skip_mask`` is nonzero (the host step counter still moves:
    the caller winds it back after its fetch)."""
    g_leaves = tree_leaves(grads)
    if any(g is None for g in g_leaves):
        raise ValueError("apply_updates: a parameter has no gradient")
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = clip_factor(cfg, gnorm)
    b1c, b2c = bias_corrections(cfg, step)
    lr = lr_at(cfg, lr_scale)
    p_leaves = tree_leaves(params)
    n = len(p_leaves)
    leaves = zip(p_leaves, g_leaves, _state_leaves(state, "m", n),
                 _state_leaves(state, "v", n),
                 _state_leaves(state, "master", n))
    for p, g, m, v, master in leaves:
        update_leaf(cfg, lr, b1c, b2c, p, g, clip, m, v, master, skip,
                    skip_mask)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def update_leaf(cfg: AdamWConfig, lr: float, b1c: float, b2c: float, p, g,
                clip, m, v, master, skip=None, skip_mask: int = 0) -> None:
    """One leaf (or one ZeRO-1 flat shard) updated in place, one
    ``ops.adamw_update`` call a CHUNK_ELEMS chunk."""
    pf, gf = p.detach().reshape(-1), g.reshape(-1)
    for s in range(0, pf.numel(), CHUNK_ELEMS):
        k = min(CHUNK_ELEMS, pf.numel() - s)
        ops.adamw_update(cfg, lr, b1c, b2c, gf[s:s + k], clip,
                         _state_chunk(m, s, k), _state_chunk(v, s, k),
                         _state_chunk(master, s, k), pf[s:s + k],
                         flags=skip, skip_mask=skip_mask)


def lr_at(cfg: AdamWConfig, lr_scale) -> float:
    """The step's learning rate as apply_updates takes it (f32 product)."""
    return float(np.float32(cfg.lr) * np.float32(lr_scale))
