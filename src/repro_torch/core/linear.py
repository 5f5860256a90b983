"""The fp8_flow grouped expert FFN, forward only.

Counterpart of the serving subset of ``repro.core.linear``:

    h = x[e] @ w13[e]          (E, C, 2F)   grouped GEMM-1  -> bf16 island
    a = swiglu(h) -> e4m3      (E, C, F)    fused SwiGLU + quantize
    y = a  @ w2[e]             (E, C, D)    grouped GEMM-2  -> bf16

Both GEMMs and the fused SwiGLU+quantize go through ``kernels.ops`` (the
hand-written kernels on a CUDA tensor, their twins on the CPU).  The
backward pass, the other recipes and the masked layout come with the
training slice (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor, quantize_blockwise, row_tile
from repro_torch.core.recipes import Recipe
from repro_torch.kernels import ops


def _ggemm(recipe: Recipe, qx: QTensor, qw: QTensor, out_dtype=torch.bfloat16):
    return ops.grouped_gemm_fp8(qx, qw).to(out_dtype)


def _fused_swiglu_quant(recipe: Recipe, h: torch.Tensor) -> QTensor:
    casts.record("fused_quantize", "swiglu_quant", h.numel())
    E, C, Fh = h.shape
    F = Fh // 2
    q = ops.fused_swiglu_quant(h.reshape(E * C, Fh))
    return QTensor(q.data.reshape(E, C, F), q.scale.reshape(E, C, F // TILE),
                   (1, 1, TILE))


def _quant_weights(recipe: Recipe, w13, w2):
    """W8-resident serving passes QTensors through; bf16 weights are
    quantized blockwise here (the reference's per-call path)."""
    qw13 = w13 if isinstance(w13, QTensor) else quantize_blockwise(
        w13, tag="q_w13")
    qw2 = w2 if isinstance(w2, QTensor) else quantize_blockwise(w2, tag="q_w2")
    return qw13, qw2


def ffn_fwd_fp8_core(recipe: Recipe, act: str, qx: QTensor, qw13: QTensor,
                     qw2: QTensor):
    """fp8_flow grouped FFN forward on an already-quantized input.
    Returns (y bf16, (qx, qa, None)) like the reference."""
    if act != "swiglu":
        raise NotImplementedError(
            f"activation {act!r}: only the SwiGLU expert FFN is ported")
    h = _ggemm(recipe, qx, qw13)                 # BF16 island
    qa = _fused_swiglu_quant(recipe, h)
    y = _ggemm(recipe, qa, qw2)
    return y, (qx, qa, None)


def expert_ffn(recipe: Recipe, act: str, x_in: QTensor, w13, w2):
    """fp8_flow forward of the reference's ``expert_ffn`` (EP=1: the psum
    axes are empty and there is no masked layout)."""
    qw13, qw2 = _quant_weights(recipe, w13, w2)
    y, _ = ffn_fwd_fp8_core(recipe, act, x_in, qw13, qw2)
    return y


def quantize_entry(recipe: Recipe, x: torch.Tensor) -> QTensor:
    """The paper's entry cast (explicit, counted): row-wise po2 quantize of
    (..., K) through the quantize kernel."""
    casts.record("quantize", "q_entry", x.numel())
    K = x.shape[-1]
    q = ops.quantize_rowwise(x.reshape(-1, K))
    return QTensor(q.data.reshape(x.shape),
                   q.scale.reshape(*x.shape[:-1], K // TILE), row_tile(x.ndim))
