"""FP8 grouped GEMM with per-tile scaling (bf16 out).

out[e] = sum_k (x[e, :, k] @ w[e, k, :]) * (sx[e, :, k] * sw[e, k, nblk])
over 128-wide K steps, f32 accumulation; x (E, C, K) e4m3 with row scales
(E, C, K/128), w (E, K, N) e4m3 with block scales (E, K/128, N/128).

Replaces ``repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas``
in its bf16-out form (``pallas_call`` at grouped_gemm_fp8.py:135).  CUDA
source: ``csrc/grouped_gemm_fp8.cu`` (bound at the serving shapes: bytes;
its header says what the simple first design leaves).  Row counts are
ragged: C need not be a multiple of 128 (the TPU wrapper's pad-to-128 is
not copied; padded rows are zero, so the result is the same).  The plain
twin keeps the per-step scale promotion of the reference
(grouped_gemm_fp8.py:71) and converts one K step of operands at a time.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/grouped_gemm_fp8.py:135"
SOURCE = "src/repro_torch/csrc/grouped_gemm_fp8.cu"


def _check_shapes(x, sx, w, sw):
    E, C, K = x.shape
    if w.shape[0] != E or w.shape[1] != K or K % TILE or w.shape[2] % TILE:
        raise ValueError(f"grouped_gemm_fp8: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    N = w.shape[2]
    if tuple(sx.shape) != (E, C, K // TILE) or \
            tuple(sw.shape) != (E, K // TILE, N // TILE):
        raise ValueError("grouped_gemm_fp8: scale shapes do not match")
    return E, C, K, N


def grouped_gemm_fp8_plain(x, sx, w, sw) -> torch.Tensor:
    E, C, K, N = _check_shapes(x, sx, w, sw)
    acc = torch.zeros((E, C, N), dtype=torch.float32, device=x.device)
    for k in range(K // TILE):
        ks = slice(k * TILE, (k + 1) * TILE)
        part = torch.bmm(x[:, :, ks].to(torch.float32),
                         w[:, ks, :].to(torch.float32))
        sw_k = sw[:, k, :].repeat_interleave(TILE, dim=-1)[:, None, :]
        acc += part * (sx[:, :, k:k + 1] * sw_k)
    return acc.to(torch.bfloat16)


def grouped_gemm_fp8_cuda(x, sx, w, sw) -> torch.Tensor:
    kernels.check_cuda_input(x, "grouped_gemm_fp8", E4M3, 3)
    kernels.check_cuda_input(w, "grouped_gemm_fp8", E4M3, 3)
    kernels.check_cuda_input(sx, "grouped_gemm_fp8", torch.float32, 3)
    kernels.check_cuda_input(sw, "grouped_gemm_fp8", torch.float32, 3)
    E, C, K, N = _check_shapes(x, sx, w, sw)
    out = torch.empty((E, C, N), dtype=torch.bfloat16, device=x.device)
    if E and C:
        build.launch("grouped_gemm_fp8", x.data_ptr(), sx.data_ptr(),
                     w.data_ptr(), sw.data_ptr(), out.data_ptr(), E, C, K, N)
        kernels.LAUNCHES["grouped_gemm_fp8"] += 1
    return out
