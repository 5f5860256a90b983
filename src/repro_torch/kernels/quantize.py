"""Row-wise FP8 quantize: (M, K) bf16/f32 -> e4m3 + (M, K/128) scales,
po2 (fp8_flow) or linear (the blockwise and naive_fp8 baselines).

Replaces ``repro/kernels/quantize.py::quantize_rowwise_pallas``
(``pallas_call`` at quantize.py:54), whose scales are po2 only; the
reference quantizes with linear scales through XLA ops
(``repro/core/quant.py:321-346``).  CUDA source: ``csrc/quantize.cu``,
whose header says what bounds it on H100 (bytes) and how the design keeps
enough bytes in flight; the linear mode is a template flag of the same
tile walk with its own launch counter (``quantize_rowwise_linear``).

The plain twins compute the kernel's function: f32 tile amax, then the
bit-built po2 scale and x / scale (the kernel multiplies by the scale's
exact reciprocal: the same correctly rounded value), or the linear scale
amax / 448 and x / scale (divided in the kernel too: a linear scale has
no exact reciprocal), clip to +-448 and an RNE e4m3 cast.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import (E4M3, TILE, cast_to, linear_scale,
                                  po2_scale)
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/quantize.py:54"
SOURCE = "src/repro_torch/csrc/quantize.cu"
SCALE_MODES = ("po2", "linear")


def _quantize_plain(x: torch.Tensor, scale_fn):
    M, K = x.shape
    xt = x.to(torch.float32).reshape(M, K // TILE, TILE)
    scale = scale_fn(xt.abs().amax(dim=-1))
    return cast_to(xt / scale[..., None]).reshape(M, K), scale


def quantize_rowwise_plain(x: torch.Tensor):
    return _quantize_plain(x, po2_scale)


def quantize_rowwise_linear_plain(x: torch.Tensor):
    return _quantize_plain(x, linear_scale)


def quantize_rowwise_cuda(x: torch.Tensor, scale_mode: str = "po2"):
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"quantize_rowwise: scale_mode {scale_mode!r}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rowwise: bf16 or f32, got {x.dtype}")
    kernels.check_cuda_input(x, "quantize_rowwise", x.dtype, 2)
    M, K = x.shape
    if K % TILE:
        raise ValueError(f"quantize_rowwise: K={K} is not a multiple of {TILE}")
    data = torch.empty((M, K), dtype=E4M3, device=x.device)
    scale = torch.empty((M, K // TILE), dtype=torch.float32, device=x.device)
    if M:
        linear = scale_mode == "linear"
        build.launch("quantize", x.data_ptr(), int(x.dtype == torch.bfloat16),
                     int(linear), data.data_ptr(), scale.data_ptr(), M, K)
        kernels.LAUNCHES["quantize_rowwise_linear" if linear
                         else "quantize_rowwise"] += 1
    return data, scale
