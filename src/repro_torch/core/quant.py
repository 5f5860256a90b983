"""Tile-quantized FP8 tensors (QTensor) and the quantize/dequantize ops.

Counterpart of ``repro.core.quant``'s quantizers: per-tile scales over
128 contiguous elements (paper Eq. 2), po2 by default or linear
(``scale_mode="linear"``, s = amax / 448: the conventional recipe of the
``blockwise`` and ``naive_fp8`` baselines), the same normative tile
convention, and the cast-ledger records.  The training-only pieces (the
quant-stats collector and the checkpoint tags) are not ported.

Tile-metadata convention (as in the reference):

  * ``len(tile) == data.ndim``; leading batch/expert axes get explicit 1s.
  * Row-wise tiles are ``(1,) * (ndim - 1) + (TILE,)`` -- ``row_tile``.
  * Weight blocks are ``(1,) * (ndim - 2) + (TILE, TILE)``.
  * ``scale.shape[i] * tile[i] == data.shape[i]`` for every axis.

These are the plain PyTorch quantizers, used for weights, KV pages and
``double_quant_error``.  The activation quantizes on the MoE path run
through the hand-written kernel in ``repro_torch.kernels`` (same
function, same bits).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import (E4M3, TILE, cast_to, linear_scale,
                                  po2_scale)
from repro_torch.device import CHUNK_ELEMS


@dataclasses.dataclass(frozen=True)
class QTensor:
    data: torch.Tensor            # e4m3 payload
    scale: torch.Tensor           # f32 po2 or linear scales, one per tile
    tile: Tuple[int, ...]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scale.to(device), self.tile)


def row_tile(ndim: int) -> Tuple[int, ...]:
    return (1,) * (ndim - 1) + (TILE,)


def _scale_shape(shape, tile):
    if len(shape) != len(tile):
        raise ValueError(f"tile {tile} does not match shape {shape}")
    for s, t in zip(shape, tile):
        if s % t:
            raise ValueError(f"shape {tuple(shape)} not divisible by tile {tile}")
    return tuple(s // t for s, t in zip(shape, tile))


def _split_shape(shape, tile):
    """(n0, n1, ...) -> interleaved (n0/t0, t0, ...) with 1s for the scale."""
    xs, ss = [], []
    for n, t in zip(shape, tile):
        if t == 1:
            xs.append(n)
            ss.append(n)
        else:
            xs.extend((n // t, t))
            ss.extend((n // t, 1))
    return tuple(xs), tuple(ss)


def _tiled_op(x, scale, tile, op):
    """x <op> per-tile scale by reshape-broadcast (no upsampled copy)."""
    xs, ss = _split_shape(x.shape, tile)
    return op(x.reshape(xs), scale.reshape(ss)).reshape(x.shape)


def _tile_amax(x: torch.Tensor, tile) -> torch.Tensor:
    """amax over each tile, computed in the input dtype (max is exact in any
    float format) and widened to f32 at the reduced size."""
    _scale_shape(x.shape, tile)
    xs, _ = _split_shape(x.shape, tile)
    red, i = [], 0
    for n, t in zip(x.shape, tile):
        if t == 1:
            i += 1
        else:
            red.append(i + 1)
            i += 2
    y = x.reshape(xs).abs()
    return y.amax(dim=tuple(red)).to(torch.float32) if red else \
        y.to(torch.float32)


def compute_scale(x: torch.Tensor, tile, scale_mode: str = "po2"
                  ) -> torch.Tensor:
    if scale_mode == "po2":
        return po2_scale(_tile_amax(x, tile))
    if scale_mode == "linear":
        return linear_scale(_tile_amax(x, tile))
    raise ValueError(f"scale_mode {scale_mode!r}: 'po2' or 'linear'")


def quantize_fields(x: torch.Tensor, tile, scale_mode: str = "po2"):
    """(payload e4m3, scales) of x under `tile`, without a ledger record.
    With po2 scales a bf16 input is divided in bf16: division by a power
    of two is exact there, and bf16 -> e4m3 rounds as f32 -> e4m3 (same
    bits as the f32 route at half the temporary bytes).  A linear scale
    divides the f32-widened input, as the reference does (quant.py:342-349):
    the bf16 shortcut is exact only for po2.  Tiles never span the leading
    axis when tile[0] == 1, so a tensor larger than CHUNK_ELEMS (the
    (E, K, N) expert weights) is quantized a slice of experts at a time,
    with the same bits and temporaries of a slice, not of the whole leaf."""
    if x.ndim >= 3 and tile[0] == 1 and x.numel() > CHUNK_ELEMS:
        step = max(1, CHUNK_ELEMS // (x.numel() // x.shape[0]))
        data = torch.empty(x.shape, dtype=E4M3, device=x.device)
        scale = torch.empty(_scale_shape(x.shape, tile), dtype=torch.float32,
                            device=x.device)
        for i in range(0, x.shape[0], step):
            data[i:i + step], scale[i:i + step] = _quantize_fields(
                x[i:i + step], tile, scale_mode)
        return data, scale
    return _quantize_fields(x, tile, scale_mode)


def _quantize_fields(x: torch.Tensor, tile, scale_mode: str):
    scale = compute_scale(x, tile, scale_mode)
    if x.dtype == torch.bfloat16 and scale_mode == "po2":
        xf = _tiled_op(x, scale.to(torch.bfloat16), tile, torch.div)
    else:
        xf = _tiled_op(x.to(torch.float32), scale, tile, torch.div)
    return cast_to(xf), scale


def quantize(x: torch.Tensor, tile, scale_mode: str = "po2", tag: str = "q",
             kind: str = "quantize") -> QTensor:
    """Quantize a dense tensor to per-tile fp8; counted on the CastLedger."""
    casts.record(kind, tag, x.numel())
    data, scale = quantize_fields(x, tile, scale_mode)
    return QTensor(data=data, scale=scale, tile=tuple(tile))


def quantize_rowwise(x: torch.Tensor, scale_mode="po2", tag="q_row",
                     kind="quantize") -> QTensor:
    """1 x TILE tiles along the last axis (Fprop/Dgrad activation layout)."""
    return quantize(x, row_tile(x.ndim), scale_mode, tag=tag, kind=kind)


def quantize_colwise(x: torch.Tensor, scale_mode="po2",
                     tag="q_col") -> QTensor:
    """TILE x 1 tiles along the second-to-last axis (Wgrad layout,
    untransposed)."""
    return quantize(x, (1,) * (x.ndim - 2) + (TILE, 1), scale_mode, tag=tag)


def quantize_blockwise(w: torch.Tensor, scale_mode="po2",
                       tag="q_wblk") -> QTensor:
    """TILE x TILE blocks over the last two axes (weight layout)."""
    return quantize(w, (1,) * (w.ndim - 2) + (TILE, TILE), scale_mode,
                    tag=tag)


def dequantize(q: QTensor, dtype=torch.bfloat16, tag: str = "dq",
               kind: str = "dequantize") -> torch.Tensor:
    casts.record(kind, tag, q.data.numel())
    return _dequantize_nocount(q, dtype)


def _dequantize_nocount(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    if dtype == torch.bfloat16:
        # e4m3 -> bf16 is exact, and x * po2 is exact in bf16
        return _tiled_op(q.data.to(torch.bfloat16),
                         q.scale.to(torch.bfloat16), q.tile, torch.mul)
    return _tiled_op(q.data.to(torch.float32), q.scale, q.tile,
                     torch.mul).to(dtype)
