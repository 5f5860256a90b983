"""Deterministic synthetic data pipeline.

Counterpart of ``repro.data.pipeline``: a reproducible token stream (a
hash-mixed counter mapped into the vocabulary: a noisy periodic grammar,
so losses fall) that is a pure function of (seed, step).  The hash is the
reference's uint32 splitmix recipe, computed in numpy ``uint32`` with the
same wrap-around, so the tokens are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _mix(a: np.ndarray) -> np.ndarray:
    """The reference's integer hash on uint32 (wrapping multiplies)."""
    a = a.astype(np.uint32)
    a = (a ^ (a >> np.uint32(16))) * np.uint32(0x7feb352d)
    a = (a ^ (a >> np.uint32(15))) * np.uint32(0x846ca68b)
    return a ^ (a >> np.uint32(16))


def make_batch_np(cfg: DataConfig, step: int):
    """Global batch for `step` as numpy arrays: tokens / targets (B, S)
    int32 and mask (B, S) float32."""
    u = np.uint32
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    with np.errstate(over="ignore"):
        st = u(step % 2 ** 32)
        seq_ids = (np.arange(B, dtype=u) + st * u(B)
                   + u(cfg.seed) * u(0x9e3779b9))
        pos = np.arange(S + 1, dtype=u)
        base = _mix(seq_ids[:, None] * u(31)) % u(max(V // 4, 1))
        tmpl = (base + (pos[None, :] % u(17)) * _mix(seq_ids[:, None] + u(7))
                % u(13)) % u(V)
        noise = _mix(seq_ids[:, None] ^ _mix(pos[None, :] + st))
    use_noise = (noise % u(5)) == 0                 # 20% random tokens
    toks = np.where(use_noise, noise % u(V), tmpl).astype(np.int32)
    return {"tokens": toks[:, :S], "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32)}


def make_batch(cfg: DataConfig, step: int, device="cuda"):
    """make_batch_np's arrays as tensors on `device`."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in make_batch_np(cfg, step).items()}
