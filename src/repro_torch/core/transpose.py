"""Scaling-aware FP8 transpose (paper §3.1, Algorithm 1).

Counterpart of ``repro.core.transpose.transpose_direct``: a row-wise
quantized QTensor (tiles (1, 128) along the contraction axis) becomes the
column-wise layout Wgrad needs WITHOUT dequantizing or requantizing, hence
without double quantization error.  Per 128 x 128 block every row is
rebased onto the block's largest scale by an exact exponent shift; the
dequantized values are unchanged except where the rebased encoding
underflows the e4m3 subnormal grid (the elements a requantization at that
scale would flush too).

The work is the scaling-aware transpose kernel (``kernels.fp8_transpose``:
the CUDA kernel on a card, its integer twin on the CPU), which equals the
reference's float formulation bit for bit.

The naive baseline of ``naive_fp8``, ``transpose_naive`` (dequantize ->
transpose -> requantize: two counted casts, the requantize through the
quantize kernel), and ``double_quant_error`` (paper Eq. 1) are the
counterparts of ``repro.core.transpose``'s, with the same ledger records.
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import (QTensor, _dequantize_nocount, dequantize,
                                    quantize_colwise, quantize_rowwise,
                                    row_tile)
from repro_torch.kernels import ops


def _check_rowwise(q: QTensor):
    if q.ndim < 2 or q.tile[-1] != TILE or any(t != 1 for t in q.tile[:-1]):
        raise ValueError(f"expected row-wise tiles (...,1,{TILE}), got {q.tile}")
    M, K = q.shape[-2:]
    if M % TILE or K % TILE:
        raise ValueError(f"dims ({M},{K}) must be multiples of {TILE}")


def transpose_direct(q: QTensor) -> QTensor:
    """(..., M, K) row-wise -> (..., K, M) row-wise, scales block-aligned.

    Records nothing on the cast ledger: the operator is casting-free."""
    _check_rowwise(q)
    *lead, M, K = q.shape
    q3 = QTensor(q.data.reshape(-1, M, K), q.scale.reshape(-1, M, K // TILE),
                 row_tile(3))
    qt = ops.fp8_transpose(q3)
    return QTensor(qt.data.reshape(*lead, K, M),
                   qt.scale.reshape(*lead, K, M // TILE), row_tile(len(lead) + 2))


def transpose_naive(q: QTensor, scale_mode: str = "po2") -> QTensor:
    """Baseline: dequantize (f32) -> transpose -> requantize row-wise (2
    counted casts).  The requantize of the contiguous transposed copy goes
    through the quantize kernel (the twin on the CPU)."""
    xt = dequantize(q, torch.float32, tag="dq_transpose").transpose(-1, -2)
    casts.record("quantize", "q_transpose", xt.numel())
    *lead, K, M = xt.shape
    qt = ops.quantize_rowwise(xt.contiguous().reshape(-1, M), scale_mode)
    return QTensor(qt.data.reshape(*lead, K, M),
                   qt.scale.reshape(*lead, K, M // TILE),
                   row_tile(len(lead) + 2))


def double_quant_error(x: torch.Tensor, scale_mode: str = "linear"
                       ) -> torch.Tensor:
    """Paper Eq. (1): E = Q_col(D(Q_row(X))) - Q_col(X), dequantized to
    f32.  Generically nonzero with linear scales; with po2 scales only
    subnormal flushes are left."""
    q_row = quantize_rowwise(x, scale_mode, tag="q_err_row")
    x_rt = dequantize(q_row, torch.float32, tag="dq_err")
    q_col_rt = quantize_colwise(x_rt, scale_mode, tag="q_err_col_rt")
    q_col = quantize_colwise(x, scale_mode, tag="q_err_col")
    return _dequantize_nocount(q_col_rt) - _dequantize_nocount(q_col)
