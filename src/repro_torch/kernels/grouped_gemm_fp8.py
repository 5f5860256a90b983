"""FP8 grouped GEMM with per-tile scaling: bf16 out, or FP8 out through
the quantizing epilogue; the weight read as stored or transposed.

out[e] = sum_k (x[e, :, k] @ w[e, k, :]) * (sx[e, :, k] * sw[e, k, nblk])
over 128-wide K steps, f32 accumulation; x (E, C, K) e4m3 with row scales
(E, C, K/128), w (E, K, N) e4m3 with block scales (E, K/128, N/128).
``w_trans=True`` takes the weight as stored the other way round, (E, N, K)
with (E, N/128, K/128) scales, and multiplies by its transpose (the Dgrad
GEMMs' w^T; the reference's ``_block_t`` relabel).  ``quant_out=True``
quantizes the f32 accumulator row-wise (one po2 scale per row and 128
columns) into e4m3, as the Pallas epilogue does.

Replaces ``repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas``
in its bf16-out form (``pallas_call`` at grouped_gemm_fp8.py:135) and its
``quant_out=True`` form (``pallas_call`` at :147).  CUDA source:
``csrc/grouped_gemm_fp8.cu`` (bound at the serving and training shapes:
bytes; its header says what the simple first design leaves).  Row counts
are ragged: C need not be a multiple of 128 (the TPU wrapper's pad-to-128
is not copied; padded rows are zero, so the result is the same).  The
plain twin keeps the per-step scale promotion of the reference
(grouped_gemm_fp8.py:71) and converts one K step of operands at a time.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build
from repro_torch.kernels.quantize import quantize_rowwise_plain

REPLACES = "src/repro/kernels/grouped_gemm_fp8.py:135"
REPLACES_QUANT_OUT = "src/repro/kernels/grouped_gemm_fp8.py:147"
SOURCE = "src/repro_torch/csrc/grouped_gemm_fp8.cu"


def _check_shapes(x, sx, w, sw, w_trans=False):
    E, C, K = x.shape
    N = w.shape[1] if w_trans else w.shape[2]
    Kw = w.shape[2] if w_trans else w.shape[1]
    if w.shape[0] != E or Kw != K or K % TILE or N % TILE:
        raise ValueError(f"grouped_gemm_fp8: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} (w_trans={w_trans}) do not chain")
    sw_shape = (E, N // TILE, K // TILE) if w_trans else \
        (E, K // TILE, N // TILE)
    if tuple(sx.shape) != (E, C, K // TILE) or tuple(sw.shape) != sw_shape:
        raise ValueError("grouped_gemm_fp8: scale shapes do not match")
    return E, C, K, N


def grouped_gemm_fp8_plain(x, sx, w, sw, *, w_trans=False, quant_out=False):
    """bf16 (E, C, N), or with quant_out the (payload, scales) pair."""
    E, C, K, N = _check_shapes(x, sx, w, sw, w_trans)
    if w_trans:
        w, sw = w.transpose(1, 2), sw.transpose(1, 2)
    acc = torch.zeros((E, C, N), dtype=torch.float32, device=x.device)
    for k in range(K // TILE):
        ks = slice(k * TILE, (k + 1) * TILE)
        part = torch.bmm(x[:, :, ks].to(torch.float32),
                         w[:, ks, :].to(torch.float32))
        sw_k = sw[:, k, :].repeat_interleave(TILE, dim=-1)[:, None, :]
        acc += part * (sx[:, :, k:k + 1] * sw_k)
    if not quant_out:
        return acc.to(torch.bfloat16)
    data, scale = quantize_rowwise_plain(acc.reshape(E * C, N))
    return data.reshape(E, C, N), scale.reshape(E, C, N // TILE)


def grouped_gemm_fp8_cuda(x, sx, w, sw, *, w_trans=False, quant_out=False):
    kernels.check_cuda_input(x, "grouped_gemm_fp8", E4M3, 3)
    kernels.check_cuda_input(w, "grouped_gemm_fp8", E4M3, 3)
    kernels.check_cuda_input(sx, "grouped_gemm_fp8", torch.float32, 3)
    kernels.check_cuda_input(sw, "grouped_gemm_fp8", torch.float32, 3)
    E, C, K, N = _check_shapes(x, sx, w, sw, w_trans)
    if quant_out:
        out = torch.empty((E, C, N), dtype=E4M3, device=x.device)
        sout = torch.empty((E, C, N // TILE), dtype=torch.float32,
                           device=x.device)
        name = "grouped_gemm_fp8_quant_out"
    else:
        out = torch.empty((E, C, N), dtype=torch.bfloat16, device=x.device)
        sout = None
        name = "grouped_gemm_fp8"
    if E and C:
        build.launch("grouped_gemm_fp8", x.data_ptr(), sx.data_ptr(),
                     w.data_ptr(), sw.data_ptr(), out.data_ptr(),
                     sout.data_ptr() if quant_out else None, int(w_trans),
                     int(quant_out), E, C, K, N)
        kernels.LAUNCHES[name] += 1
    return (out, sout) if quant_out else out
