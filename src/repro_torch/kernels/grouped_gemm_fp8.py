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

The masked layout (``masked_*``) takes ``masked_m`` (E,) int32, each
expert's live rows: a 128-row group that starts at or beyond masked_m[e]
is not computed and comes out as the padded kernel's zero rows (bf16 +0,
or payload 0 with scale 1.0); live groups are computed whole.  On the
dispatch layout (rows beyond masked_m are zero) masked == padded bit for
bit.

Replaces ``repro/kernels/grouped_gemm_fp8.py::grouped_gemm_fp8_pallas``
in its bf16-out form (``pallas_call`` at grouped_gemm_fp8.py:135) and its
``quant_out=True`` form (``pallas_call`` at :147), and
``masked_grouped_gemm_fp8_pallas`` in both forms (:297, :313).  CUDA
source: ``csrc/grouped_gemm_fp8.cu`` (bound at the serving and training
shapes: bytes; its header says what the simple first design leaves).  Row
counts are ragged: C need not be a multiple of 128 (the TPU wrapper's
pad-to-128 is not copied; padded rows are zero, so the result is the
same).  The plain twin keeps the per-step scale promotion of the
reference (grouped_gemm_fp8.py:71) and converts one K step of operands at
a time.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build
from repro_torch.kernels.quantize import quantize_rowwise_plain

REPLACES = "src/repro/kernels/grouped_gemm_fp8.py:135"
REPLACES_QUANT_OUT = "src/repro/kernels/grouped_gemm_fp8.py:147"
REPLACES_MASKED = "src/repro/kernels/grouped_gemm_fp8.py:297"
REPLACES_MASKED_QUANT_OUT = "src/repro/kernels/grouped_gemm_fp8.py:313"
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


def _accumulate(x, sx, w, sw, w_trans):
    """The f32 accumulator of every row: per-step scale promotion as the
    reference's (grouped_gemm_fp8.py:71), one K step converted at a time."""
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
    return acc


def _finish(acc, quant_out):
    if not quant_out:
        return acc.to(torch.bfloat16)
    E, C, N = acc.shape
    data, scale = quantize_rowwise_plain(acc.reshape(E * C, N))
    return data.reshape(E, C, N), scale.reshape(E, C, N // TILE)


def live_rows(masked_m: torch.Tensor, C: int) -> torch.Tensor:
    """(E,) live-row counts -> (E, C) bool: row r is computed iff its
    128-row group starts below masked_m[e] (the reference's tile-granular
    masking, ref.py:_tile_live_rows)."""
    starts = torch.arange(C, device=masked_m.device) // TILE * TILE
    return starts[None, :] < masked_m[:, None]


def check_masked_m(masked_m, E: int, name: str) -> None:
    if masked_m.dtype != torch.int32 or tuple(masked_m.shape) != (E,):
        raise ValueError(f"{name}: masked_m must be int32 of shape ({E},), got "
                         f"{masked_m.dtype} {tuple(masked_m.shape)}")


def grouped_gemm_fp8_plain(x, sx, w, sw, *, w_trans=False, quant_out=False):
    """bf16 (E, C, N), or with quant_out the (payload, scales) pair."""
    return _finish(_accumulate(x, sx, w, sw, w_trans), quant_out)


def masked_grouped_gemm_fp8_plain(x, sx, w, sw, masked_m, *, w_trans=False,
                                  quant_out=False):
    """The padded twin with the rows of dead 128-row groups zeroed before
    the output cast or quantize (payload 0 and scale 1.0)."""
    check_masked_m(masked_m, x.shape[0], "masked_grouped_gemm_fp8")
    acc = _accumulate(x, sx, w, sw, w_trans)
    acc = torch.where(live_rows(masked_m, x.shape[1])[..., None], acc, 0.0)
    return _finish(acc, quant_out)


def _launch(x, sx, w, sw, masked_m, w_trans, quant_out, name):
    kernels.check_cuda_input(x, name, E4M3, 3)
    kernels.check_cuda_input(w, name, E4M3, 3)
    kernels.check_cuda_input(sx, name, torch.float32, 3)
    kernels.check_cuda_input(sw, name, torch.float32, 3)
    E, C, K, N = _check_shapes(x, sx, w, sw, w_trans)
    if masked_m is not None:
        kernels.check_cuda_input(masked_m, name, torch.int32, 1)
        check_masked_m(masked_m, E, name)
    if quant_out:
        out = torch.empty((E, C, N), dtype=E4M3, device=x.device)
        sout = torch.empty((E, C, N // TILE), dtype=torch.float32,
                           device=x.device)
    else:
        out = torch.empty((E, C, N), dtype=torch.bfloat16, device=x.device)
        sout = None
    if E and C:
        build.launch("grouped_gemm_fp8", x.data_ptr(), sx.data_ptr(),
                     w.data_ptr(), sw.data_ptr(),
                     None if masked_m is None else masked_m.data_ptr(),
                     out.data_ptr(), sout.data_ptr() if quant_out else None,
                     int(w_trans), int(quant_out), E, C, K, N)
        kernels.LAUNCHES[name] += 1
    return (out, sout) if quant_out else out


def grouped_gemm_fp8_cuda(x, sx, w, sw, *, w_trans=False, quant_out=False):
    name = "grouped_gemm_fp8_quant_out" if quant_out else "grouped_gemm_fp8"
    return _launch(x, sx, w, sw, None, w_trans, quant_out, name)


def masked_grouped_gemm_fp8_cuda(x, sx, w, sw, masked_m, *, w_trans=False,
                                 quant_out=False):
    """masked_m: (E,) int32 on the card, never read on the host."""
    name = ("masked_grouped_gemm_fp8_quant_out" if quant_out
            else "masked_grouped_gemm_fp8")
    return _launch(x, sx, w, sw, masked_m, w_trans, quant_out, name)
