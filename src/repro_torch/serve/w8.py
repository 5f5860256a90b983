"""W8-resident serving: pre-quantized FP8 expert weights.

Counterpart of ``repro.serve.w8``: the expert weights are quantized ONCE to
blockwise po2 e4m3 (the layout the grouped GEMMs consume) and stay
resident; norms, router and attention projections keep their dtypes.
Only the routed experts' ``we13`` / ``we2`` convert, as in the reference:
the dense layers' and shared experts' MLP weights stay bf16, and an
fp8_flow prefill quantizes them inside ``expert_ffn`` at every call
(``core.linear._quant_weights``); decode multiplies them in bf16.
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor, _scale_shape, quantize_fields

# stacked leaves converted for serving, with their tiles
_W8_LEAVES = {
    "we13": (1, 1, TILE, 1, TILE),   # (L, E, D, g, Fe)
    "we2": (1, 1, TILE, TILE),       # (L, E, Fe, D)
}


def _pad_ok(shape, tile):
    return all(n % t == 0 for n, t in zip(shape, tile))


def _quantize_stacked(leaf: torch.Tensor, tile, tag: str) -> QTensor:
    """Quantize layer by layer (bounds the temporaries at full width); the
    bits equal one quantize of the whole stack, whose leading tile is 1."""
    casts.record("fused_quantize", tag, leaf.numel())
    data = torch.empty(leaf.shape, dtype=torch.float8_e4m3fn,
                       device=leaf.device)
    scale = torch.empty(_scale_shape(leaf.shape, tile), dtype=torch.float32,
                        device=leaf.device)
    for i in range(leaf.shape[0]):
        d, scale[i] = quantize_fields(leaf[i], tile[1:])
        data.view(torch.uint8)[i] = d.view(torch.uint8)
    return QTensor(data, scale, tuple(tile))


def quantize_params_for_serving(params):
    """A copy of the params tree with the big expert weights replaced by
    blockwise-po2 QTensors."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, tile in _W8_LEAVES.items():
        leaf = layers.get(name)
        if isinstance(leaf, torch.Tensor) and leaf.ndim == len(tile) \
                and _pad_ok(leaf.shape, tile):
            layers[name] = _quantize_stacked(leaf, tile, f"q_w8_{name}")
    out["layers"] = layers
    return out


def w8_merge_gate(q: QTensor) -> QTensor:
    """(E, D, g, Fe) blockwise QTensor -> (E, D, g*Fe): exact block
    relabeling (gate/up halves stay contiguous)."""
    E, D, g, Fe = q.data.shape
    return QTensor(data=q.data.reshape(E, D, g * Fe),
                   scale=q.scale.reshape(E, D // TILE, g * Fe // TILE),
                   tile=(1, TILE, TILE))
