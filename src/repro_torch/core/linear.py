"""The recipe-dispatched grouped expert FFN with its hand-written
backwards (Fig. 2).

Counterpart of ``repro.core.linear``.  The fp8_flow branch:

    h = x[e] @ w13[e]          (E, C, 2F)   grouped GEMM-1  -> bf16 island
    a = swiglu(h) -> e4m3      (E, C, F)    fused SwiGLU + quantize
        (GeGLU, GELU, ReLU: the activation to bf16, then the row-wise
        quantize, ``act_quant``, as the reference computes them)
    y = a  @ w2[e]             (E, C, D)    grouped GEMM-2  -> bf16

and its backward, ``ffn_bwd_fp8_core``, in the reference's order: the one
explicit island quantize of the output gradient; Dgrad-2 against the
transposed w2; Wgrad-2 from two scaling-aware direct transposes; the h
recompute; the activation's backward in f32 and its fused quantize;
Dgrad-1 with the quantizing epilogue (the input gradient leaves in FP8);
Wgrad-1 from two direct transposes.  Every GEMM, quantize and transpose
goes through ``kernels.ops`` (the hand-written kernels on a CUDA tensor,
their twins on the CPU).

The baselines, each with the reference's hand-written backward and its
cast-ledger records in the reference's order:

  bf16       bf16 ``matmul``s and f32 ``einsum`` Wgrads (0 casts); the
             reference computes these products outside any Pallas kernel.
  blockwise  FP8 only inside the GEMMs: the bf16 input, activation output
             and gradients quantized row-wise with linear scales right before
             each GEMM, the Wgrad operands freshly quantized from
             transposed bf16 copies (8 casts).
  naive_fp8  FP8-saved input and activation whose Wgrad layouts are
             rebuilt by ``transpose_naive`` (dequantize -> transpose ->
             requantize: the double quantization error), the gradients
             quantized fresh (10 casts here + 2 at the dispatch).

Their quantizes are the quantize kernel in its linear mode, their GEMMs
the NN (bf16 out, Dgrad-1 included) and NT kernels on linear scales,
promoted in f32 as the reference's Pallas kernels do; the reference's
XLA route rounds those scales to bf16 first (ROADMAP.md, Queue 3).

``expert_ffn``, ``quantize_entry`` and ``dequantize_exit`` are
``torch.autograd.Function``s, as they are ``custom_vjp``s in the
reference.  A QTensor crosses autograd as its (payload, scale) pair, and
so does its cotangent: the FP8 input gradient of the FFN is an e4m3
payload "gradient" plus an f32 scale "gradient".  Autograd cannot add two
e4m3 gradients, so every FP8 intermediate has exactly one consumer, as in
the reference.  ``save_h`` raises (ROADMAP.md, Queue 1, item 6).

``masked_m`` (E,) int32, each expert's live rows (``core.moe``'s expert
plan, on the device), routes all five grouped GEMMs of the forward and
backward to the masked-layout kernels, and with
``Recipe(swiglu_epilogue=True)`` GEMM-1 and the SwiGLU quantize to the
fused kernel; on the dispatch layout the result is bitwise the padded
path's, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import (QTensor, _dequantize_nocount,
                                    quantize_blockwise, row_tile)
from repro_torch.core.recipes import Recipe
from repro_torch.core.transpose import transpose_direct, transpose_naive
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm_nt_fp8 import OUT_DTYPES


def _ggemm(recipe: Recipe, qx: QTensor, qw: QTensor, out_dtype=torch.bfloat16,
           masked_m=None):
    """masked_m (int32 (E,), per-expert live rows) routes to the masked
    kernel -- bitwise the padded one on the zero-padded dispatch buffers."""
    if masked_m is not None:
        return ops.grouped_gemm_fp8_masked(qx, qw, masked_m).to(out_dtype)
    return ops.grouped_gemm_fp8(qx, qw).to(out_dtype)


def _ggemm_nt(recipe: Recipe, qa: QTensor, qb: QTensor,
              out_dtype=torch.float32, masked_m=None):
    """(E,M,C) x (E,N,C) -> (E,M,N), contraction over the last axis of
    both.  A bf16 (or f32) result is rounded once from the f32 sum."""
    kdt = out_dtype if out_dtype in OUT_DTYPES else torch.float32
    if masked_m is not None:
        return ops.grouped_gemm_nt_fp8_masked(qa, qb, masked_m,
                                              kdt).to(out_dtype)
    return ops.grouped_gemm_nt_fp8(qa, qb, kdt).to(out_dtype)


def _ggemm_quant_out(recipe: Recipe, qx: QTensor, qw: QTensor,
                     masked_m=None) -> QTensor:
    """Grouped GEMM with the fused FP8-quantizing epilogue (Dgrad-1)."""
    casts.record("fused_quantize", "dgrad_epilogue", qx.data.shape[0])
    if masked_m is not None:
        return ops.grouped_gemm_fp8_masked_quant_out(qx, qw, masked_m)
    return ops.grouped_gemm_fp8_quant_out(qx, qw)


def _q_row(recipe: Recipe, x: torch.Tensor, tag: str,
           kind: str = "quantize") -> QTensor:
    """Row-wise quantize of (E, C, K) through the quantize kernel, with the
    recipe's scales."""
    casts.record(kind, tag, x.numel())
    E, C, K = x.shape
    q = ops.quantize_rowwise(x.reshape(E * C, K), recipe.scale_mode)
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


# ---------------------------------------------------------------------------
# Activations, in f32 (the BF16 island), the reference's table
# (repro/core/linear.py:164-207).  GELU is the tanh approximation, written
# in f32 ops in the reference's order; its derivative is written out in
# the order of the reference's ``jax.vjp`` of that expression.  The two
# packages' tanh may differ in the last bit, as their sigmoid does.
# ---------------------------------------------------------------------------
# sqrt(2 / pi) and 0.044715 as f32 values (the reference's constants are
# f32), so an f32 product with them rounds the same in any precision
_SQRT_2_OVER_PI = 0.7978845834732056
_GELU_A = 0.044714998453855515


def _gelu_f32(t: torch.Tensor) -> torch.Tensor:
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI
                                  * (t + _GELU_A * (t * t * t))))
    return t * cdf


def _dgelu_f32(t: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """ct * gelu'(t), the terms and sums in the order of the reference's
    vjp: d(t * cdf) + d(tanh) + d(t ** 3)."""
    th = torch.tanh(_SQRT_2_OVER_PI * (t + _GELU_A * (t * t * t)))
    cdf = 0.5 * (1.0 + th)
    dt = (0.5 * (t * ct)) * (1.0 - th)
    dinner = _SQRT_2_OVER_PI * (dt + dt * th)
    return (ct * cdf + dinner) + (_GELU_A * dinner) * (3.0 * (t * t))


def _swiglu(h: torch.Tensor) -> torch.Tensor:
    """silu(g) * u in f32 -> bf16: the baselines' separate activation
    pass (the BF16 island's forward)."""
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    return (g * torch.sigmoid(g) * u).to(torch.bfloat16)


def _dswiglu(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    """d[silu(g) * u] in f32 (the BF16 island's backward), -> bf16."""
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    ga = ga.to(torch.float32)
    s = torch.sigmoid(g)
    silu = g * s
    dgate = ga * u * (s + silu * (1.0 - s))
    dup = ga * silu
    return torch.cat([dgate, dup], dim=-1).to(torch.bfloat16)


def _geglu(h: torch.Tensor) -> torch.Tensor:
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    return (_gelu_f32(g) * u).to(torch.bfloat16)


def _dgeglu(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    g, u = h.to(torch.float32).chunk(2, dim=-1)
    ga = ga.to(torch.float32)
    dgate = _dgelu_f32(g, ga * u)
    dup = ga * _gelu_f32(g)
    return torch.cat([dgate, dup], dim=-1).to(torch.bfloat16)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return _gelu_f32(h.to(torch.float32)).to(torch.bfloat16)


def _dgelu(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    return _dgelu_f32(h.to(torch.float32),
                      ga.to(torch.float32)).to(torch.bfloat16)


def _relu(h: torch.Tensor) -> torch.Tensor:
    return torch.relu(h.to(torch.float32)).to(torch.bfloat16)


def _drelu(h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    return torch.where(h.to(torch.float32) > 0, ga.to(torch.float32),
                       0.0).to(torch.bfloat16)


_ACT_FWD = {"swiglu": _swiglu, "geglu": _geglu, "gelu": _gelu, "relu": _relu}
_ACT_BWD = {"swiglu": _dswiglu, "geglu": _dgeglu, "gelu": _dgelu,
            "relu": _drelu}


def _act_fwd(act: str, h: torch.Tensor) -> torch.Tensor:
    return _ACT_FWD[act](h)


def _act_bwd(act: str, h: torch.Tensor, ga: torch.Tensor) -> torch.Tensor:
    return _ACT_BWD[act](h, ga)


def _quant_weights(recipe: Recipe, w13, w2):
    """W8-resident serving passes QTensors through; bf16 weights are
    quantized blockwise here (the reference's per-call path)."""
    qw13 = w13 if isinstance(w13, QTensor) else quantize_blockwise(
        w13, recipe.scale_mode, tag="q_w13")
    qw2 = w2 if isinstance(w2, QTensor) else quantize_blockwise(
        w2, recipe.scale_mode, tag="q_w2")
    return qw13, qw2


def _use_swiglu_epilogue(recipe: Recipe, act: str, masked_m) -> bool:
    """The fused SwiGLU+quant GEMM-1 epilogue applies on the masked path
    only, and only when h need not be kept for the backward (it is
    recomputed there)."""
    return (recipe.swiglu_epilogue and act == "swiglu"
            and masked_m is not None and not recipe.save_h)


def ffn_fwd_fp8_core(recipe: Recipe, act: str, qx: QTensor, qw13: QTensor,
                     qw2: QTensor, masked_m=None):
    """fp8_flow grouped FFN forward on an already-quantized input.
    Returns (y bf16, (qx, qa, None)) like the reference (h is recomputed
    in the backward: FP8 activation checkpointing).  SwiGLU runs the
    fused SwiGLU + quantize; another activation is computed to bf16 and
    quantized row-wise by #1 (``act_quant``), as the reference does."""
    if _use_swiglu_epilogue(recipe, act, masked_m):
        # GEMM-1 with the SwiGLU + quantize in its epilogue: the BF16
        # island lives only in registers (bitwise the unfused pair), and
        # the ledger gets the unfused kernel's entry (h.numel() = E*C*2F)
        E, C = qx.data.shape[:2]
        casts.record("fused_quantize", "swiglu_quant",
                     E * C * qw13.data.shape[-1])
        qa = ops.grouped_gemm_swiglu_quant_masked(qx, qw13, masked_m)
    else:
        h = _ggemm(recipe, qx, qw13, masked_m=masked_m)     # BF16 island
        if act == "swiglu":
            qa = _fused_swiglu_quant(recipe, h)
        else:
            casts.record("fused_quantize", "act_quant", h.numel())
            qa = _q_row(recipe, _act_fwd(act, h), "act_quant",
                        kind="fused_quantize_inner")
        del h
    y = _ggemm(recipe, qa, qw2, masked_m=masked_m)
    return y, (qx, qa, None)


def ffn_bwd_fp8_core(recipe: Recipe, act: str, qx: QTensor, qa: QTensor,
                     qw13: QTensor, qw2: QTensor, qg: QTensor,
                     wg13_dtype=torch.float32, wg2_dtype=torch.float32,
                     masked_m=None):
    """fp8_flow grouped FFN backward given the ALREADY-QUANTIZED output
    cotangent ``qg``.  Returns (gx QTensor, wg13, wg2): the input gradient
    in FP8 (fused Dgrad-1 epilogue), the weight gradients in the requested
    dtypes, each rounded once from the f32 accumulator.  masked_m skips
    dead capacity groups in all five grouped GEMMs (the Dgrad rows beyond
    the count are zero because the combine's probability weighting zeros
    dead slots upstream; the NT forms skip zero token columns)."""
    # Dgrad-2: FP8 x FP8 against the transposed w2
    ga = _ggemm(recipe, qg, _block_t(qw2), masked_m=masked_m)
    # Wgrad-2 via scaling-aware DIRECT transposes -- zero casts
    wg2 = _ggemm_nt(recipe, transpose_direct(qa), transpose_direct(qg),
                    wg2_dtype, masked_m=masked_m)
    # BF16 island: recompute h (FP8 activation checkpointing); the
    # activation's backward needs the bf16 h, so the masked path recomputes
    # it unfused
    h = _ggemm(recipe, qx, qw13, masked_m=masked_m)
    gh = _act_bwd(act, h, ga)
    del h, ga
    casts.record("fused_quantize", "dact_quant", gh.numel())
    qgh = _q_row(recipe, gh, "dact_quant", kind="fused_quantize_inner")
    del gh
    # Dgrad-1 with the fused quantizing epilogue -> FP8 input gradient
    gx = _ggemm_quant_out(recipe, qgh, _block_t(qw13), masked_m=masked_m)
    # Wgrad-1, again via direct transposes
    wg13 = _ggemm_nt(recipe, transpose_direct(qx), transpose_direct(qgh),
                     wg13_dtype, masked_m=masked_m)
    return gx, wg13, wg2


class _ExpertFFN(torch.autograd.Function):
    """expert_ffn's custom VJP.  The ledger active in the forward is kept on
    ctx and re-entered in the backward, which autograd may run on another
    thread (casts.py)."""

    @staticmethod
    def forward(ctx, recipe, act, xd, xs, w13, w2, masked_m):
        ctx.ledger = casts.current()
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        y, (_, qa, _) = ffn_fwd_fp8_core(recipe, act,
                                         QTensor(xd, xs, row_tile(3)), qw13,
                                         qw2, masked_m)
        ctx.save_for_backward(xd, xs)
        ctx.qa, ctx.qw13, ctx.qw2 = qa, qw13, qw2
        ctx.recipe, ctx.act, ctx.masked_m = recipe, act, masked_m
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
                ctx.qw13, ctx.qw2, qg, *ctx.w_dtypes,
                masked_m=ctx.masked_m)
        ctx.qa = ctx.qw13 = ctx.qw2 = ctx.masked_m = None
        return None, None, gx.data, gx.scale, wg13, wg2, None


def _t(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x with its last two axes swapped (the
    reference's swapaxes ahead of a Wgrad-layout quantize)."""
    return x.transpose(-1, -2).contiguous()


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> bf16 from f32 sums rounded once, as cuBLAS on the
    card and the reference's XLA dot do.  PyTorch's bf16 GEMM on the CPU
    rounds otherwise (0.017% of lanes off the once-rounded product at
    (2, 128, 256) x (256, 256)), so the CPU multiplies in f32."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.to(torch.float32),
                        b.to(torch.float32)).to(torch.bfloat16)


class _BF16FFN(torch.autograd.Function):
    """The bf16 recipe: no quantization; bf16 products, f32 Wgrads."""

    @staticmethod
    def forward(ctx, recipe, act, x, w13, w2):
        h = _bf16_matmul(x.to(torch.bfloat16), w13.to(torch.bfloat16))
        y = _bf16_matmul(_act_fwd(act, h), w2.to(torch.bfloat16))
        ctx.save_for_backward(x, h, w13, w2)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, gy):
        x, h, w13, w2 = ctx.saved_tensors
        gy = gy.to(torch.bfloat16)
        a = _act_fwd(ctx.act, h)
        ga = _bf16_matmul(gy, w2.to(torch.bfloat16).transpose(-1, -2))
        wg2 = torch.einsum("ecf,ecd->efd", a.to(torch.float32),
                           gy.to(torch.float32)).to(w2.dtype)
        del a
        gh = _act_bwd(ctx.act, h, ga)
        del ga
        gx = _bf16_matmul(gh, w13.to(torch.bfloat16).transpose(-1, -2))
        wg13 = torch.einsum("eck,ecf->ekf", x.to(torch.float32),
                            gh.to(torch.float32)).to(w13.dtype)
        return None, None, gx.to(x.dtype), wg13, wg2


class _BlockwiseFFN(torch.autograd.Function):
    """TransformerEngine-style blockwise FP8 (Fig. 2b): the bf16 input and
    h are saved; every GEMM operand is quantized fresh (8 casts)."""

    @staticmethod
    def forward(ctx, recipe, act, x, w13, w2):
        ctx.ledger = casts.current()
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        qx = _q_row(recipe, x, "q_gemm1_in")
        h = _ggemm(recipe, qx, qw13)
        del qx
        qa = _q_row(recipe, _act_fwd(act, h), "q_gemm2_in")
        y = _ggemm(recipe, qa, qw2)
        ctx.save_for_backward(x, h)
        ctx.recipe, ctx.act, ctx.qw13, ctx.qw2 = recipe, act, qw13, qw2
        ctx.w_dtypes = (w13.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, h = ctx.saved_tensors
        r, qw13, qw2 = ctx.recipe, ctx.qw13, ctx.qw2
        wg13_dtype, wg2_dtype = ctx.w_dtypes
        with casts.use(ctx.ledger):
            gy = gy.to(torch.bfloat16).contiguous()
            qg = _q_row(r, gy, "q_bwd_dgrad2")
            ga = _ggemm(r, qg, _block_t(qw2))
            del qg
            # fresh Wgrad-layout quantizes of the bf16-saved tensors
            qaT = _q_row(r, _t(_act_fwd(ctx.act, h)), "q_bwd_wgrad2_a")
            qgT = _q_row(r, _t(gy), "q_bwd_wgrad2_g")
            wg2 = _ggemm_nt(r, qaT, qgT, wg2_dtype)
            del qaT, qgT
            gh = _act_bwd(ctx.act, h, ga)
            del ga
            qgh = _q_row(r, gh, "q_bwd_dgrad1")
            gx = _ggemm(r, qgh, _block_t(qw13))
            del qgh
            qghT = _q_row(r, _t(gh), "q_bwd_wgrad1_g")
            del gh
            qxT = _q_row(r, _t(x), "q_bwd_wgrad1_x")
            wg13 = _ggemm_nt(r, qxT, qghT, wg13_dtype)
        ctx.qw13 = ctx.qw2 = None
        return None, None, gx.to(x.dtype), wg13, wg2


class _NaiveFFN(torch.autograd.Function):
    """DeepSeek-style drop-in FP8 (Fig. 2c): the FP8 input and activation
    are saved, and their Wgrad layouts rebuilt by dequantize -> transpose
    -> requantize (the double quantization error; 10 casts)."""

    @staticmethod
    def forward(ctx, recipe, act, x, w13, w2):
        ctx.ledger = casts.current()
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        qx = _q_row(recipe, x, "q_gemm1_in")
        h = _ggemm(recipe, qx, qw13)
        qa = _q_row(recipe, _act_fwd(act, h), "q_gemm2_in")
        del h
        y = _ggemm(recipe, qa, qw2)
        ctx.recipe, ctx.act, ctx.qx, ctx.qa = recipe, act, qx, qa
        ctx.qw13, ctx.qw2 = qw13, qw2
        ctx.x_dtype, ctx.w_dtypes = x.dtype, (w13.dtype, w2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        r, qx, qa, qw13, qw2 = ctx.recipe, ctx.qx, ctx.qa, ctx.qw13, ctx.qw2
        wg13_dtype, wg2_dtype = ctx.w_dtypes
        with casts.use(ctx.ledger):
            gy = gy.to(torch.bfloat16).contiguous()
            qg = _q_row(r, gy, "q_bwd_dgrad2")
            ga = _ggemm(r, qg, _block_t(qw2))
            del qg
            qaT = transpose_naive(qa, r.scale_mode)
            qgT = _q_row(r, _t(gy), "q_bwd_wgrad2_g")
            wg2 = _ggemm_nt(r, qaT, qgT, wg2_dtype)
            del qaT, qgT
            h = _ggemm(r, qx, qw13)                 # recompute from FP8 x
            gh = _act_bwd(ctx.act, h, ga)
            del h, ga
            qgh = _q_row(r, gh, "q_bwd_dgrad1")
            gx = _ggemm(r, qgh, _block_t(qw13))     # bf16 to the combine
            del qgh
            qxT = transpose_naive(qx, r.scale_mode)
            qghT = _q_row(r, _t(gh), "q_bwd_wgrad1_g")
            del gh
            wg13 = _ggemm_nt(r, qxT, qghT, wg13_dtype)
        ctx.qx = ctx.qa = ctx.qw13 = ctx.qw2 = None
        return None, None, gx.to(ctx.x_dtype), wg13, wg2


_BASELINE_FFN = {"bf16": _BF16FFN, "blockwise": _BlockwiseFFN,
                 "naive_fp8": _NaiveFFN}


def expert_ffn(recipe: Recipe, act: str, x_in, w13, w2, masked_m=None):
    """``expert_ffn`` at EP = 1 (the reference's psum axes are empty).
    fp8_flow: x_in is the row-tiled (E, C, D) QTensor; w13 (E, D, 2F) and
    w2 (E, F, D) are bf16 (differentiable) or W8-resident QTensors
    (serving); masked_m (E,) int32 on x_in's device selects the masked
    layout (None: padded).  The other recipes take the bf16 (E, C, D)
    input and bf16 weights and ignore masked_m, as the reference does."""
    if recipe.name != "fp8_flow":
        if isinstance(w13, QTensor) or isinstance(w2, QTensor):
            raise ValueError(f"{recipe.name}: W8-resident weights are "
                             "fp8_flow only")
        return _BASELINE_FFN[recipe.name].apply(recipe, act, x_in, w13, w2)
    if isinstance(w13, QTensor) or isinstance(w2, QTensor):
        qw13, qw2 = _quant_weights(recipe, w13, w2)
        y, _ = ffn_fwd_fp8_core(recipe, act, x_in, qw13, qw2, masked_m)
        return y
    return _ExpertFFN.apply(recipe, act, x_in.data, x_in.scale, w13, w2,
                            masked_m)


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
    (..., K) through the quantize kernel (fp8_flow's)."""
    data, scale = _QuantizeEntry.apply(x)
    return QTensor(data, scale, row_tile(x.ndim))


class _DequantizeExit(torch.autograd.Function):
    """naive_fp8's post-dispatch dequantize (explicit) and its backward's
    explicit quantize: the Q/DQ-around-comm pair of Table 1."""

    @staticmethod
    def forward(ctx, recipe, data, scale):
        ctx.ledger, ctx.recipe = casts.current(), recipe
        casts.record("dequantize", "dq_post_dispatch", data.numel())
        return _dequantize_nocount(QTensor(data, scale, row_tile(data.ndim)),
                                   torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        with casts.use(ctx.ledger):
            casts.record("quantize", "q_bwd_dispatch", g.numel())
        K = g.shape[-1]
        q = ops.quantize_rowwise(g.contiguous().reshape(-1, K),
                                 ctx.recipe.scale_mode)
        return (None, q.data.reshape(g.shape),
                q.scale.reshape(*g.shape[:-1], K // TILE))


def dequantize_exit(recipe: Recipe, q: QTensor) -> torch.Tensor:
    """A row-tiled QTensor -> bf16, counted as ``dq_post_dispatch`` (the
    reference's bf16 product of payload and scale: a linear scale is
    rounded to bf16 first, as there).  Backward: the bf16 gradient
    quantized row-wise with the recipe's scales (``q_bwd_dispatch``)."""
    return _DequantizeExit.apply(recipe, q.data, q.scale)


def dense_mlp(recipe: Recipe, act: str, x: torch.Tensor, w13, w2):
    """The dense-architecture MLP (a dense layer's, or the shared
    experts'): the recipe's expert FFN as one group, with no dispatch.

    x (T, D); w13 (D, g*F); w2 (F, D).  T and D are zero-padded to the
    128-tile alignment the FP8 pathway needs (zero rows and columns add
    nothing to outputs or gradients) and the result is sliced back.
    fp8_flow quantizes once at the entry and stays FP8 end to end; the
    baselines run their FFN on the bf16 input.  No ``masked_m``: every
    recipe takes the padded kernels here.  The reference's guard-stats
    hook on the entry (``record_entry_stats("q_entry_mlp")``) is not
    ported (core/quant.py)."""
    T, D = x.shape
    Tp, Dp = -(-T // TILE) * TILE, -(-D // TILE) * TILE
    if Tp != T or Dp != D:
        x = torch.nn.functional.pad(x, (0, Dp - D, 0, Tp - T))
        w13 = torch.nn.functional.pad(w13, (0, 0, 0, Dp - D))
        w2 = torch.nn.functional.pad(w2, (0, Dp - D))
    x3 = x.reshape(1, Tp, Dp)
    x_in = quantize_entry(recipe, x3) if recipe.name == "fp8_flow" \
        else x3.to(torch.bfloat16)
    return expert_ffn(recipe, act, x_in, w13[None], w2[None])[0, :T, :D]
