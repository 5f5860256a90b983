"""Row-wise po2 FP8 quantize: (M, K) bf16/f32 -> e4m3 + (M, K/128) scales.

Replaces ``repro/kernels/quantize.py::quantize_rowwise_pallas``
(``pallas_call`` at quantize.py:54).  CUDA source: ``csrc/quantize.cu``,
whose header says what bounds it on H100 (bytes) and how the design keeps
enough bytes in flight.  The plain twin below computes the kernel's
function: f32 tile amax, the bit-built po2 scale, x / scale (the kernel
multiplies by the scale's exact reciprocal: the same correctly rounded
value), clip to +-448 and an RNE e4m3 cast.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE, cast_to, po2_scale
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/quantize.py:54"
SOURCE = "src/repro_torch/csrc/quantize.cu"


def quantize_rowwise_plain(x: torch.Tensor):
    M, K = x.shape
    xt = x.to(torch.float32).reshape(M, K // TILE, TILE)
    scale = po2_scale(xt.abs().amax(dim=-1))
    return cast_to(xt / scale[..., None]).reshape(M, K), scale


def quantize_rowwise_cuda(x: torch.Tensor):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rowwise: bf16 or f32, got {x.dtype}")
    kernels.check_cuda_input(x, "quantize_rowwise", x.dtype, 2)
    M, K = x.shape
    if K % TILE:
        raise ValueError(f"quantize_rowwise: K={K} is not a multiple of {TILE}")
    data = torch.empty((M, K), dtype=E4M3, device=x.device)
    scale = torch.empty((M, K // TILE), dtype=torch.float32, device=x.device)
    if M:
        build.launch("quantize", x.data_ptr(), int(x.dtype == torch.bfloat16),
                     data.data_ptr(), scale.data_ptr(), M, K)
        kernels.LAUNCHES["quantize_rowwise"] += 1
    return data, scale
