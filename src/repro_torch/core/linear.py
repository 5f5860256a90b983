"""The fp8_flow grouped expert FFN with its hand-written backward (Fig. 2).

Counterpart of the fp8_flow branch of ``repro.core.linear``:

    h = x[e] @ w13[e]          (E, C, 2F)   grouped GEMM-1  -> bf16 island
    a = swiglu(h) -> e4m3      (E, C, F)    fused SwiGLU + quantize
    y = a  @ w2[e]             (E, C, D)    grouped GEMM-2  -> bf16

and its backward, ``ffn_bwd_fp8_core``, in the reference's order: the one
explicit island quantize of the output gradient; Dgrad-2 against the
transposed w2; Wgrad-2 from two scaling-aware direct transposes; the h
recompute; dSwiGLU in f32 and its fused quantize; Dgrad-1 with the
quantizing epilogue (the input gradient leaves in FP8); Wgrad-1 from two
direct transposes.  Every GEMM, quantize and transpose goes through
``kernels.ops`` (the hand-written kernels on a CUDA tensor, their twins on
the CPU).

``expert_ffn`` and ``quantize_entry`` are ``torch.autograd.Function``s, as
they are ``custom_vjp``s in the reference.  A QTensor crosses autograd as
its (payload, scale) pair, and so does its cotangent: the FP8 input
gradient of the FFN is an e4m3 payload "gradient" plus an f32 scale
"gradient".  Autograd cannot add two e4m3 gradients, so every FP8
intermediate has exactly one consumer, as in the reference.  The other
recipes, ``save_h`` and the masked layout raise (ROADMAP.md, Queue 1,
items 4-6).
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import (QTensor, _dequantize_nocount,
                                    quantize_blockwise, row_tile)
from repro_torch.core.recipes import Recipe
from repro_torch.core.transpose import transpose_direct
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm_nt_fp8 import OUT_DTYPES


def _ggemm(recipe: Recipe, qx: QTensor, qw: QTensor, out_dtype=torch.bfloat16):
    return ops.grouped_gemm_fp8(qx, qw).to(out_dtype)


def _ggemm_nt(recipe: Recipe, qa: QTensor, qb: QTensor,
              out_dtype=torch.float32):
    """(E,M,C) x (E,N,C) -> (E,M,N), contraction over the last axis of
    both.  A bf16 (or f32) result is rounded once from the f32 sum."""
    kdt = out_dtype if out_dtype in OUT_DTYPES else torch.float32
    return ops.grouped_gemm_nt_fp8(qa, qb, kdt).to(out_dtype)


def _ggemm_quant_out(recipe: Recipe, qx: QTensor, qw: QTensor) -> QTensor:
    """Grouped GEMM with the fused FP8-quantizing epilogue (Dgrad-1)."""
    casts.record("fused_quantize", "dgrad_epilogue", qx.data.shape[0])
    return ops.grouped_gemm_fp8_quant_out(qx, qw)


def _q_row(recipe: Recipe, x: torch.Tensor, tag: str,
           kind: str = "quantize") -> QTensor:
    """Row-wise quantize of (E, C, K) through the quantize kernel."""
    casts.record(kind, tag, x.numel())
    E, C, K = x.shape
    q = ops.quantize_rowwise(x.reshape(E * C, K))
    return QTensor(q.data.reshape(E, C, K), q.scale.reshape(E, C, K // TILE),
                   row_tile(3))


def _block_t(qw: QTensor) -> QTensor:
    """Transpose a (TILE, TILE)-block-quantized weight: an exact relabel
    (views, no copy).  The grouped GEMM kernel reads such a view's stored
    layout transposed on its way into shared memory."""
    return QTensor(qw.data.transpose(-1, -2), qw.scale.transpose(-1, -2),
                   qw.tile)


def _fused_swiglu_quant(recipe: Recipe, h: torch.Tensor) -> QTensor:
    casts.record("fused_quantize", "swiglu_quant", h.numel())
    E, C, Fh = h.shape
    F = Fh // 2
    q = ops.fused_swiglu_quant(h.reshape(E * C, Fh))
    return QTensor(q.data.reshape(E, C, F), q.scale.reshape(E, C, F // TILE),
                   row_tile(3))


def _dswiglu(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    """d[silu(g) * u] in f32 (the BF16 island's backward), -> bf16."""
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    ga = ga.to(torch.float32)
    s = torch.sigmoid(g)
    silu = g * s
    dgate = ga * u * (s + silu * (1.0 - s))
    dup = ga * silu
    return torch.cat([dgate, dup], dim=-1).to(torch.bfloat16)


def _quant_weights(recipe: Recipe, w13, w2):
    """W8-resident serving passes QTensors through; bf16 weights are
    quantized blockwise here (the reference's per-call path)."""
    qw13 = w13 if isinstance(w13, QTensor) else quantize_blockwise(
        w13, tag="q_w13")
    qw2 = w2 if isinstance(w2, QTensor) else quantize_blockwise(w2, tag="q_w2")
    return qw13, qw2


def _check_act(act: str):
    if act != "swiglu":
        raise NotImplementedError(
            f"activation {act!r}: only the SwiGLU expert FFN is ported")


def ffn_fwd_fp8_core(recipe: Recipe, act: str, qx: QTensor, qw13: QTensor,
                     qw2: QTensor):
    """fp8_flow grouped FFN forward on an already-quantized input.
    Returns (y bf16, (qx, qa, None)) like the reference (h is recomputed
    in the backward: FP8 activation checkpointing)."""
    _check_act(act)
    h = _ggemm(recipe, qx, qw13)                 # BF16 island
    qa = _fused_swiglu_quant(recipe, h)
    del h
    y = _ggemm(recipe, qa, qw2)
    return y, (qx, qa, None)


def ffn_bwd_fp8_core(recipe: Recipe, act: str, qx: QTensor, qa: QTensor,
                     qw13: QTensor, qw2: QTensor, qg: QTensor,
                     wg13_dtype=torch.float32, wg2_dtype=torch.float32):
    """fp8_flow grouped FFN backward given the ALREADY-QUANTIZED output
    cotangent ``qg``.  Returns (gx QTensor, wg13, wg2): the input gradient
    in FP8 (fused Dgrad-1 epilogue), the weight gradients in the requested
    dtypes, each rounded once from the f32 accumulator."""
    _check_act(act)
    # Dgrad-2: FP8 x FP8 against the transposed w2
    ga = _ggemm(recipe, qg, _block_t(qw2))
    # Wgrad-2 via scaling-aware DIRECT transposes -- zero casts
    wg2 = _ggemm_nt(recipe, transpose_direct(qa), transpose_direct(qg),
                    wg2_dtype)
    # BF16 island: recompute h (FP8 activation checkpointing)
    h = _ggemm(recipe, qx, qw13)
    gh = _dswiglu(h, ga)
    del h, ga
    casts.record("fused_quantize", "dact_quant", gh.numel())
    qgh = _q_row(recipe, gh, "dact_quant", kind="fused_quantize_inner")
    del gh
    # Dgrad-1 with the fused quantizing epilogue -> FP8 input gradient
    gx = _ggemm_quant_out(recipe, qgh, _block_t(qw13))
    # Wgrad-1, again via direct transposes
    wg13 = _ggemm_nt(recipe, transpose_direct(qx), transpose_direct(qgh),
                     wg13_dtype)
    return gx, wg13, wg2


class _ExpertFFN(torch.autograd.Function):
    """expert_ffn's custom VJP.  The ledger active in the forward is kept on
    ctx and re-entered in the backward, which autograd may run on another
    thread (casts.py)."""

    @staticmethod
    def forward(ctx, recipe, act, xd, xs, w13, w2):
        ctx.ledger = casts.current()
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        y, (_, qa, _) = ffn_fwd_fp8_core(recipe, act,
                                         QTensor(xd, xs, row_tile(3)), qw13,
                                         qw2)
        ctx.save_for_backward(xd, xs)
        ctx.qa, ctx.qw13, ctx.qw2 = qa, qw13, qw2
        ctx.recipe, ctx.act = recipe, act
        ctx.w_dtypes = (w13.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        xd, xs = ctx.saved_tensors
        with casts.use(ctx.ledger):
            # ---- the single explicit backward cast: BF16 island -> FP8 ----
            qg = _q_row(ctx.recipe, gy.to(torch.bfloat16).contiguous(),
                        "q_bwd_island")
            gx, wg13, wg2 = ffn_bwd_fp8_core(
                ctx.recipe, ctx.act, QTensor(xd, xs, row_tile(3)), ctx.qa,
                ctx.qw13, ctx.qw2, qg, *ctx.w_dtypes)
        ctx.qa = ctx.qw13 = ctx.qw2 = None
        return None, None, gx.data, gx.scale, wg13, wg2


def expert_ffn(recipe: Recipe, act: str, x_in: QTensor, w13, w2,
               masked_m=None):
    """fp8_flow ``expert_ffn`` at EP = 1 (the reference's psum axes are
    empty).  x_in is the row-tiled (E, C, D) QTensor; w13 (E, D, 2F) and
    w2 (E, F, D) are bf16 (differentiable) or W8-resident QTensors
    (serving)."""
    if masked_m is not None:
        raise NotImplementedError(
            "the masked expert layout is not ported yet (ROADMAP.md, "
            "Queue 1, item 5)")
    if isinstance(w13, QTensor) or isinstance(w2, QTensor):
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        y, _ = ffn_fwd_fp8_core(recipe, act, x_in, qw13, qw2)
        return y
    return _ExpertFFN.apply(recipe, act, x_in.data, x_in.scale, w13, w2)


class _QuantizeEntry(torch.autograd.Function):
    """The entry cast's VJP: the FP8 input gradient is dequantized inside
    the consuming add (fused), closing the FP8 loop."""

    @staticmethod
    def forward(ctx, x):
        ctx.ledger = casts.current()
        ctx.x_dtype = x.dtype
        casts.record("quantize", "q_entry", x.numel())
        K = x.shape[-1]
        q = ops.quantize_rowwise(x.reshape(-1, K))
        return (q.data.reshape(x.shape),
                q.scale.reshape(*x.shape[:-1], K // TILE))

    @staticmethod
    def backward(ctx, gd, gs):
        with casts.use(ctx.ledger):
            casts.record("fused_dequantize", "entry_bwd", gd.numel())
        return _dequantize_nocount(QTensor(gd, gs, row_tile(gd.ndim)),
                                   ctx.x_dtype)


def quantize_entry(recipe: Recipe, x: torch.Tensor) -> QTensor:
    """The paper's entry cast (explicit, counted): row-wise po2 quantize of
    (..., K) through the quantize kernel."""
    data, scale = _QuantizeEntry.apply(x)
    return QTensor(data, scale, row_tile(x.ndim))
