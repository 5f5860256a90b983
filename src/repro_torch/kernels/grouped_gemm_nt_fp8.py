"""FP8 grouped GEMM, NT layout (the Wgrad form): contraction over the last
axis of both operands.

out[e] = sum_k (a[e, :, k] @ b[e, :, k]^T) * (sa[e, :, k] (x) sb[e, :, k])
over 128-wide C steps, f32 accumulation; a (E, M, C) and b (E, N, C) e4m3,
both row-tiled over C (scales (E, M, C/128), (E, N, C/128)): the layouts
the scaling-aware transpose produces.  The output is f32 or bf16; bf16 is
one rounding of the f32 sum.

The masked layout (``masked_*``) takes ``masked_m`` (E,) int32, each
expert's live tokens: the token axis is the contraction, so the C steps k
with k * 128 >= masked_m[e] are skipped.  On the dispatch layout (dead
token columns zero) masked == padded bit for bit.

Replaces ``repro/kernels/grouped_gemm_nt_fp8.py::grouped_gemm_nt_fp8_pallas``
(``pallas_call`` at grouped_gemm_nt_fp8.py:67) and
``masked_grouped_gemm_nt_fp8_pallas`` (:131).  CUDA source:
``csrc/grouped_gemm_nt_fp8.cu``.  At the Wgrad shapes the bound is bytes,
94% of them the bf16 output; measured, the SM's own work (widening,
promotion, output conversion) decides the time.  A persistent block a SM
walks panels (an expert's 128 b rows) and their 128-row tiles; operands
arrive by TMA as e4m3 and are widened exactly to f16 for the tensor cores
(f16 ``wgmma``, exact products, f32 sums), a panel's b once for all its
tiles; the two warpgroups take turns at the tensor cores and store their
rows straight from registers in whole sectors.  FP8 ``wgmma`` would take
both operands as they are, but its ~14-bit sums failed the rtol=atol=2e-2
gate against this twin on near-zero outputs at both Wgrad shapes and left
5% of bf16 lanes off it (this loop: 3e-6).

The plain twin keeps the per-step outer-product promotion of the reference
(grouped_gemm_nt_fp8.py:50) and converts one C step at a time.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build
from repro_torch.kernels.grouped_gemm_fp8 import check_masked_m

REPLACES = "src/repro/kernels/grouped_gemm_nt_fp8.py:67"
REPLACES_MASKED = "src/repro/kernels/grouped_gemm_nt_fp8.py:131"
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


def _plain(a, sa, b, sb, out_dtype, masked_m):
    E, M, N, C = _check_shapes(a, sa, b, sb, out_dtype)
    acc = torch.zeros((E, M, N), dtype=torch.float32, device=a.device)
    for k in range(C // TILE):
        ks = slice(k * TILE, (k + 1) * TILE)
        part = torch.bmm(a[:, :, ks].to(torch.float32),
                         b[:, :, ks].to(torch.float32).transpose(1, 2))
        part = part * (sa[:, :, k:k + 1] * sb[:, None, :, k])
        if masked_m is not None:   # drop step k where k*128 >= masked_m[e]
            part = torch.where((k * TILE < masked_m)[:, None, None], part, 0.0)
        acc += part
    return acc.to(out_dtype)


def grouped_gemm_nt_fp8_plain(a, sa, b, sb, out_dtype=torch.float32):
    return _plain(a, sa, b, sb, out_dtype, None)


def masked_grouped_gemm_nt_fp8_plain(a, sa, b, sb, masked_m,
                                     out_dtype=torch.float32):
    """The padded twin without the C steps at or beyond masked_m[e]."""
    check_masked_m(masked_m, a.shape[0], "masked_grouped_gemm_nt_fp8")
    return _plain(a, sa, b, sb, out_dtype, masked_m)


def _launch(a, sa, b, sb, out_dtype, masked_m, name):
    kernels.check_cuda_input(a, name, E4M3, 3)
    kernels.check_cuda_input(b, name, E4M3, 3)
    kernels.check_cuda_input(sa, name, torch.float32, 3)
    kernels.check_cuda_input(sb, name, torch.float32, 3)
    E, M, N, C = _check_shapes(a, sa, b, sb, out_dtype)
    if masked_m is not None:
        kernels.check_cuda_input(masked_m, name, torch.int32, 1)
        check_masked_m(masked_m, E, name)
    out = torch.empty((E, M, N), dtype=out_dtype, device=a.device)
    if E:
        build.launch("grouped_gemm_nt_fp8", a.data_ptr(), sa.data_ptr(),
                     b.data_ptr(), sb.data_ptr(),
                     None if masked_m is None else masked_m.data_ptr(),
                     out.data_ptr(), int(out_dtype == torch.bfloat16), E, M,
                     N, C)
        kernels.LAUNCHES[name] += 1
    return out


def grouped_gemm_nt_fp8_cuda(a, sa, b, sb, out_dtype=torch.float32):
    return _launch(a, sa, b, sb, out_dtype, None, "grouped_gemm_nt_fp8")


def masked_grouped_gemm_nt_fp8_cuda(a, sa, b, sb, masked_m,
                                    out_dtype=torch.float32):
    """masked_m: (E,) int32 on the card, never read on the host."""
    return _launch(a, sa, b, sb, out_dtype, masked_m,
                   "masked_grouped_gemm_nt_fp8")
