"""Public wrappers of the kernel suite, on QTensors.

Counterpart of ``repro.kernels.ops``.  The device decides: a tensor on the
CPU takes the kernel's plain PyTorch twin, a CUDA tensor launches the
hand-written kernel, and a failure to build or launch raises -- there is
no fallback.  Row and capacity axes are taken as they come (no padding to
128 as the TPU wrappers do).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, row_tile
from repro_torch.kernels.fused_permute_pad import (fused_permute_pad_cuda,
                                                   fused_permute_pad_plain)
from repro_torch.kernels.fused_swiglu_quant import (fused_swiglu_quant_cuda,
                                                    fused_swiglu_quant_plain)
from repro_torch.kernels.grouped_gemm_fp8 import (grouped_gemm_fp8_cuda,
                                                  grouped_gemm_fp8_plain)
from repro_torch.kernels.quantize import (quantize_rowwise_cuda,
                                          quantize_rowwise_plain)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def quantize_rowwise(x: torch.Tensor) -> QTensor:
    """(M, K) bf16/f32 -> row-tiled QTensor."""
    fn = quantize_rowwise_cuda if _on_card(x) else quantize_rowwise_plain
    data, scale = fn(x)
    return QTensor(data, scale, row_tile(2))


def fused_swiglu_quant(h: torch.Tensor) -> QTensor:
    """(M, 2F) bf16 [gate | up] -> row-tiled QTensor (M, F)."""
    fn = fused_swiglu_quant_cuda if _on_card(h) else fused_swiglu_quant_plain
    data, scale = fn(h)
    return QTensor(data, scale, row_tile(2))


def fused_permute_pad(q: QTensor, row_map: torch.Tensor) -> QTensor:
    """Gather a 2-D row-tiled QTensor's rows by int32 row_map (-1 = pad)."""
    fn = fused_permute_pad_cuda if _on_card(q.data) else fused_permute_pad_plain
    data, scale = fn(q.data, q.scale, row_map.to(torch.int32))
    return QTensor(data, scale, q.tile)


def grouped_gemm_fp8(qx: QTensor, qw: QTensor) -> torch.Tensor:
    """qx (E, C, K) row-tiled x qw (E, K, N) block-tiled -> (E, C, N) bf16."""
    fn = grouped_gemm_fp8_cuda if _on_card(qx.data) else grouped_gemm_fp8_plain
    return fn(qx.data, qx.scale, qw.data, qw.scale)
