"""Masked FP8 grouped GEMM-1 with the SwiGLU + row-wise quantize fused into
its epilogue: x (E, C, K) e4m3 with row scales, w13 (E, K, 2F) = [gate |
up] e4m3 with block scales, masked_m (E,) int32 -> silu(g) * u quantized
row-wise to e4m3 (E, C, F) + (E, C, F/128) po2 scales, where g and u are
the gate and up columns of x @ w13, each summed in f32 and rounded to
bf16 (the bf16 island h, which never reaches device memory).  128-row
groups at or beyond masked_m[e] come out as payload 0 with scale 1.0.

It equals ``grouped_gemm_fp8`` (bf16 out) followed by
``fused_swiglu_quant`` bit for bit, on the card (both kernels share the
tensor-core tile loop of ``csrc/gemm_tile.cuh``, the same ``wgmma``
chain and promotion for every gate and up column, and the SwiGLU device
function) and in the twin below,
which is that pair's twins with dead groups zeroed in between.

Replaces ``repro/kernels/grouped_gemm_fp8.py::
masked_grouped_gemm_swiglu_quant_pallas`` (``pallas_call`` at
grouped_gemm_fp8.py:360).  CUDA source: ``csrc/grouped_gemm_swiglu_quant.cu``
(bound at the serving and training shapes: bytes, the live experts' w13).
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build
from repro_torch.kernels.fused_swiglu_quant import fused_swiglu_quant_plain
from repro_torch.kernels.grouped_gemm_fp8 import (_check_shapes,
                                                  check_masked_m,
                                                  grouped_gemm_fp8_plain,
                                                  live_rows)

REPLACES = "src/repro/kernels/grouped_gemm_fp8.py:360"
SOURCE = "src/repro_torch/csrc/grouped_gemm_swiglu_quant.cu"
NAME = "masked_grouped_gemm_swiglu_quant"


def _check(x, sx, w13, sw13, masked_m):
    E, C, K, twoF = _check_shapes(x, sx, w13, sw13)
    if twoF % (2 * TILE):
        raise ValueError(f"{NAME}: 2F={twoF} needs F % {TILE} == 0")
    check_masked_m(masked_m, E, NAME)
    return E, C, K, twoF // 2


def masked_grouped_gemm_swiglu_quant_plain(x, sx, w13, sw13, masked_m):
    E, C, K, F = _check(x, sx, w13, sw13, masked_m)
    h = grouped_gemm_fp8_plain(x, sx, w13, sw13)              # bf16 island
    h = torch.where(live_rows(masked_m, C)[..., None], h, 0)
    data, scale = fused_swiglu_quant_plain(h.reshape(E * C, 2 * F))
    return data.reshape(E, C, F), scale.reshape(E, C, F // TILE)


def masked_grouped_gemm_swiglu_quant_cuda(x, sx, w13, sw13, masked_m):
    """masked_m: (E,) int32 on the card, never read on the host."""
    for t, dtype in ((x, E4M3), (w13, E4M3), (sx, torch.float32),
                     (sw13, torch.float32)):
        kernels.check_cuda_input(t, NAME, dtype, 3)
    kernels.check_cuda_input(masked_m, NAME, torch.int32, 1)
    E, C, K, F = _check(x, sx, w13, sw13, masked_m)
    data = torch.empty((E, C, F), dtype=E4M3, device=x.device)
    scale = torch.empty((E, C, F // TILE), dtype=torch.float32,
                        device=x.device)
    if E and C:
        build.launch("grouped_gemm_swiglu_quant", x.data_ptr(),
                     sx.data_ptr(), w13.data_ptr(), sw13.data_ptr(),
                     masked_m.data_ptr(), data.data_ptr(), scale.data_ptr(),
                     E, C, K, F)
        kernels.LAUNCHES[NAME] += 1
    return data, scale
