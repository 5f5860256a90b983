"""Public wrappers of the kernel suite, on QTensors.

Counterpart of ``repro.kernels.ops``.  The device decides: a tensor on the
CPU takes the kernel's plain PyTorch twin, a CUDA tensor launches the
hand-written kernel, and a failure to build or launch raises -- there is
no fallback.  Row and capacity axes are taken as they come (no padding to
128 as the TPU wrappers do).  The masked-layout wrappers take
``masked_m`` (E,), each expert's live rows, as a tensor on the operands'
device; it is never read on the host (the reference's static
``expected_m`` hint, which only its benchmark passes, is not taken).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, row_tile
from repro_torch.kernels.fp8_transpose import (fp8_transpose_cuda,
                                               fp8_transpose_plain)
from repro_torch.kernels.fused_permute_pad import (fused_permute_pad_cuda,
                                                   fused_permute_pad_plain)
from repro_torch.kernels.fused_swiglu_quant import (fused_swiglu_quant_cuda,
                                                    fused_swiglu_quant_plain)
from repro_torch.kernels.grouped_gemm_fp8 import (
    grouped_gemm_fp8_cuda, grouped_gemm_fp8_plain,
    masked_grouped_gemm_fp8_cuda, masked_grouped_gemm_fp8_plain)
from repro_torch.kernels.grouped_gemm_nt_fp8 import (
    grouped_gemm_nt_fp8_cuda, grouped_gemm_nt_fp8_plain,
    masked_grouped_gemm_nt_fp8_cuda, masked_grouped_gemm_nt_fp8_plain)
from repro_torch.kernels.grouped_gemm_swiglu_quant import (
    masked_grouped_gemm_swiglu_quant_cuda,
    masked_grouped_gemm_swiglu_quant_plain)
from repro_torch.kernels.quantize import (quantize_rowwise_cuda,
                                          quantize_rowwise_linear_plain,
                                          quantize_rowwise_plain)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def quantize_rowwise(x: torch.Tensor, scale_mode: str = "po2") -> QTensor:
    """(M, K) bf16/f32 -> row-tiled QTensor, po2 or linear scales."""
    if _on_card(x):
        data, scale = quantize_rowwise_cuda(x, scale_mode)
    elif scale_mode == "po2":
        data, scale = quantize_rowwise_plain(x)
    elif scale_mode == "linear":
        data, scale = quantize_rowwise_linear_plain(x)
    else:
        raise ValueError(f"quantize_rowwise: scale_mode {scale_mode!r}")
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


def _weight_fields(qw: QTensor):
    """(payload, scales, w_trans) of a block-tiled (E, K, N) weight: the
    stored tensors, or -- when qw is the transposed view of a stored
    (E, N, K) weight, as ``core.linear._block_t`` makes it -- that stored
    layout and w_trans=True (the kernel reads it transposed)."""
    d, s = qw.data, qw.scale
    if d.is_contiguous() and s.is_contiguous():
        return d, s, False
    dt, st = d.transpose(1, 2), s.transpose(1, 2)
    if dt.is_contiguous() and st.is_contiguous():
        return dt, st, True
    raise ValueError("grouped_gemm_fp8: the weight must be contiguous or "
                     "the transpose of a contiguous weight")


def grouped_gemm_fp8(qx: QTensor, qw: QTensor) -> torch.Tensor:
    """qx (E, C, K) row-tiled x qw (E, K, N) block-tiled -> (E, C, N) bf16."""
    fn = grouped_gemm_fp8_cuda if _on_card(qx.data) else grouped_gemm_fp8_plain
    w, sw, w_trans = _weight_fields(qw)
    return fn(qx.data, qx.scale, w, sw, w_trans=w_trans)


def grouped_gemm_fp8_quant_out(qx: QTensor, qw: QTensor) -> QTensor:
    """As grouped_gemm_fp8, with the f32 accumulator quantized row-wise to
    e4m3 in the epilogue -> row-tiled QTensor (E, C, N)."""
    fn = grouped_gemm_fp8_cuda if _on_card(qx.data) else grouped_gemm_fp8_plain
    w, sw, w_trans = _weight_fields(qw)
    data, scale = fn(qx.data, qx.scale, w, sw, w_trans=w_trans,
                     quant_out=True)
    return QTensor(data, scale, row_tile(3))


def grouped_gemm_nt_fp8(qa: QTensor, qb: QTensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    """qa (E, M, C), qb (E, N, C), both row-tiled over C -> (E, M, N)."""
    fn = grouped_gemm_nt_fp8_cuda if _on_card(qa.data) else \
        grouped_gemm_nt_fp8_plain
    return fn(qa.data, qa.scale, qb.data, qb.scale, out_dtype)


def fp8_transpose(q: QTensor) -> QTensor:
    """Scaling-aware direct transpose of a row-tiled (E, M, K) QTensor ->
    row-tiled (E, K, M), scales block-aligned."""
    fn = fp8_transpose_cuda if _on_card(q.data) else fp8_transpose_plain
    data, scale = fn(q.data, q.scale)
    return QTensor(data, scale, row_tile(3))


# ---------------------------------------------------------------------------
# Masked layout: 128-row groups at or beyond masked_m[e] are not computed.
# ---------------------------------------------------------------------------
def grouped_gemm_fp8_masked(qx: QTensor, qw: QTensor,
                            masked_m: torch.Tensor) -> torch.Tensor:
    """grouped_gemm_fp8 with dead capacity groups skipped (written 0)."""
    fn = masked_grouped_gemm_fp8_cuda if _on_card(qx.data) else \
        masked_grouped_gemm_fp8_plain
    w, sw, w_trans = _weight_fields(qw)
    return fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32),
              w_trans=w_trans)


def grouped_gemm_fp8_masked_quant_out(qx: QTensor, qw: QTensor,
                                      masked_m: torch.Tensor) -> QTensor:
    """grouped_gemm_fp8_quant_out with dead capacity groups skipped
    (payload 0, scale 1.0)."""
    fn = masked_grouped_gemm_fp8_cuda if _on_card(qx.data) else \
        masked_grouped_gemm_fp8_plain
    w, sw, w_trans = _weight_fields(qw)
    data, scale = fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32),
                     w_trans=w_trans, quant_out=True)
    return QTensor(data, scale, row_tile(3))


def grouped_gemm_nt_fp8_masked(qa: QTensor, qb: QTensor,
                               masked_m: torch.Tensor,
                               out_dtype=torch.float32) -> torch.Tensor:
    """grouped_gemm_nt_fp8 over the live token steps only: the contraction
    steps k with k*128 >= masked_m[e] are skipped."""
    fn = masked_grouped_gemm_nt_fp8_cuda if _on_card(qa.data) else \
        masked_grouped_gemm_nt_fp8_plain
    return fn(qa.data, qa.scale, qb.data, qb.scale,
              masked_m.to(torch.int32), out_dtype)


def grouped_gemm_swiglu_quant_masked(qx: QTensor, qw13: QTensor,
                                     masked_m: torch.Tensor) -> QTensor:
    """Masked GEMM-1 with the fused SwiGLU + quantize epilogue: qx (E, C,
    K) x qw13 (E, K, 2F) [gate | up] -> row-tiled QTensor (E, C, F)."""
    fn = masked_grouped_gemm_swiglu_quant_cuda if _on_card(qx.data) else \
        masked_grouped_gemm_swiglu_quant_plain
    w, sw, w_trans = _weight_fields(qw13)
    if w_trans:
        raise ValueError("grouped_gemm_swiglu_quant_masked: w13 must be "
                         "stored (E, K, 2F)")
    data, scale = fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32))
    return QTensor(data, scale, row_tile(3))
