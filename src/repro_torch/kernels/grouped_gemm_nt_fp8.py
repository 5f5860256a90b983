"""FP8 grouped GEMM, NT layout (the Wgrad form): contraction over the last
axis of both operands.

out[e] = sum_k (a[e, :, k] @ b[e, :, k]^T) * (sa[e, :, k] (x) sb[e, :, k])
over 128-wide C steps, f32 accumulation; a (E, M, C) and b (E, N, C) e4m3,
both row-tiled over C (scales (E, M, C/128), (E, N, C/128)): the layouts
the scaling-aware transpose produces.  The output is f32 or bf16; bf16 is
one rounding of the f32 sum.

Replaces ``repro/kernels/grouped_gemm_nt_fp8.py::grouped_gemm_nt_fp8_pallas``
(``pallas_call`` at grouped_gemm_nt_fp8.py:67).  CUDA source:
``csrc/grouped_gemm_nt_fp8.cu`` (bound at the Wgrad shapes: bytes, the
output's).
The plain twin keeps the per-step outer-product promotion of the reference
(grouped_gemm_nt_fp8.py:50) and converts one C step at a time.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/grouped_gemm_nt_fp8.py:67"
SOURCE = "src/repro_torch/csrc/grouped_gemm_nt_fp8.cu"
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(a, sa, b, sb, out_dtype):
    E, M, C = a.shape
    N = b.shape[1]
    if b.shape[0] != E or b.shape[2] != C or M % TILE or N % TILE or C % TILE:
        raise ValueError(f"grouped_gemm_nt_fp8: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} need (E, M, C), (E, N, C) with "
                         f"M, N, C multiples of {TILE}")
    if tuple(sa.shape) != (E, M, C // TILE) or \
            tuple(sb.shape) != (E, N, C // TILE):
        raise ValueError("grouped_gemm_nt_fp8: scale shapes do not match")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"grouped_gemm_nt_fp8: out_dtype {out_dtype} not in "
                        f"{OUT_DTYPES}")
    return E, M, N, C


def grouped_gemm_nt_fp8_plain(a, sa, b, sb, out_dtype=torch.float32):
    E, M, N, C = _check_shapes(a, sa, b, sb, out_dtype)
    acc = torch.zeros((E, M, N), dtype=torch.float32, device=a.device)
    for k in range(C // TILE):
        ks = slice(k * TILE, (k + 1) * TILE)
        part = torch.bmm(a[:, :, ks].to(torch.float32),
                         b[:, :, ks].to(torch.float32).transpose(1, 2))
        acc += part * (sa[:, :, k:k + 1] * sb[:, None, :, k])
    return acc.to(out_dtype)


def grouped_gemm_nt_fp8_cuda(a, sa, b, sb, out_dtype=torch.float32):
    kernels.check_cuda_input(a, "grouped_gemm_nt_fp8", E4M3, 3)
    kernels.check_cuda_input(b, "grouped_gemm_nt_fp8", E4M3, 3)
    kernels.check_cuda_input(sa, "grouped_gemm_nt_fp8", torch.float32, 3)
    kernels.check_cuda_input(sb, "grouped_gemm_nt_fp8", torch.float32, 3)
    E, M, N, C = _check_shapes(a, sa, b, sb, out_dtype)
    out = torch.empty((E, M, N), dtype=out_dtype, device=a.device)
    if E:
        build.launch("grouped_gemm_nt_fp8", a.data_ptr(), sa.data_ptr(),
                     b.data_ptr(), sb.data_ptr(), out.data_ptr(),
                     int(out_dtype == torch.bfloat16), E, M, N, C)
        kernels.LAUNCHES["grouped_gemm_nt_fp8"] += 1
    return out
