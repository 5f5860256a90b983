"""Fused SwiGLU + row-wise po2 FP8 quantize: h (M, 2F) bf16 = [gate | up]
-> silu(gate) * up in f32 -> (M, F) e4m3 + (M, F/128) scales.

Replaces ``repro/kernels/fused_swiglu_quant.py::fused_swiglu_quant_pallas``
(``pallas_call`` at fused_swiglu_quant.py:47).  CUDA source:
``csrc/swiglu_quant.cu`` (bound: bytes; one read of h, one write of the
payload).  Like the Pallas kernel, the f32 product is quantized with no
bf16 round in between (the reference's XLA route rounds it to bf16 first,
so the port matches the Pallas kernel, not that route).  The sigmoid is
1 / (1 + exp(-g)) in f32 in both the kernel and the twin; its bits differ
from jax's logistic on a fraction of a percent of lanes.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build
from repro_torch.kernels.quantize import quantize_rowwise_plain

REPLACES = "src/repro/kernels/fused_swiglu_quant.py:47"
SOURCE = "src/repro_torch/csrc/swiglu_quant.cu"


def swiglu_f32(h: torch.Tensor) -> torch.Tensor:
    F = h.shape[-1] // 2
    g = h[..., :F].to(torch.float32)
    u = h[..., F:].to(torch.float32)
    return (g * torch.sigmoid(g)) * u


def fused_swiglu_quant_plain(h: torch.Tensor):
    return quantize_rowwise_plain(swiglu_f32(h))


def fused_swiglu_quant_cuda(h: torch.Tensor):
    kernels.check_cuda_input(h, "fused_swiglu_quant", torch.bfloat16, 2)
    M, twoF = h.shape
    F = twoF // 2
    if twoF % 2 or F % TILE:
        raise ValueError(f"fused_swiglu_quant: 2F={twoF} needs F % {TILE} == 0")
    data = torch.empty((M, F), dtype=E4M3, device=h.device)
    scale = torch.empty((M, F // TILE), dtype=torch.float32, device=h.device)
    if M:
        build.launch("swiglu_quant", h.data_ptr(), data.data_ptr(),
                     scale.data_ptr(), M, F)
        kernels.LAUNCHES["fused_swiglu_quant"] += 1
    return data, scale
