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
reference's float formulation bit for bit.  The naive baseline
(dequantize -> transpose -> requantize) belongs to the ``naive_fp8``
recipe, which is not ported yet (ROADMAP.md, Queue 1, item 4).
"""
from __future__ import annotations

from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor, row_tile
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
