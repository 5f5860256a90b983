"""Public wrappers of the kernel suite, on QTensors.

Counterpart of ``repro.kernels.ops``.  The device decides: a tensor on the
CPU takes the kernel's plain PyTorch twin, a CUDA tensor launches the
hand-written kernel, and a failure to build or launch raises -- there is
no fallback.  Row and capacity axes are taken as they come (no padding to
128 as the TPU wrappers do).  The masked-layout wrappers take
``masked_m`` (E,), each expert's live rows, as a tensor on the operands'
device; it is never read on the host.  Three of them take the reference's
static ``expected_m`` hint: at ``expected_m >= C`` (every capacity row
expected live) they call the padded wrapper instead, whose result is the
masked one bit for bit.  The fused SwiGLU GEMM-1 takes the hint and never
falls back, as the reference's does: the fusion pays at any load.

While a ``roofline.analysis.tally()`` is open, each wrapper reports its
kernel's FLOPs and bytes by formula (a masked kernel its live 128-row
tiles, counted on the device) and the aten ops of its body -- the twin's
on the CPU, the allocations around the launch on the card -- are not
counted, so a CPU and a GPU tally of one step agree on the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, row_tile
from repro_torch.kernels.adamw_update import (adamw_update_cuda,
                                              adamw_update_plain)
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
from repro_torch.roofline import analysis as roofline

_Q = 1 + 4 / 128          # bytes a row-tiled e4m3 element moves with its scale


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel route for device {t.device}")


def quantize_rowwise(x: torch.Tensor, scale_mode: str = "po2") -> QTensor:
    """(M, K) bf16/f32 -> row-tiled QTensor, po2 or linear scales."""
    with roofline.kernel(
            "quantize_rowwise_linear" if scale_mode == "linear"
            else "quantize_rowwise",
            lambda: _quantize_counts(x)):
        return _quantize_rowwise(x, scale_mode)


def _quantize_counts(x):
    M, K = x.shape
    return 4 * M * K, M * K * (x.element_size() + _Q)


def _quantize_rowwise(x, scale_mode):
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
    M, F2 = h.shape
    with roofline.kernel("fused_swiglu_quant",
                         lambda: (4 * M * F2, M * F2 * 2 + M * F2 // 2 * _Q)):
        fn = fused_swiglu_quant_cuda if _on_card(h) \
            else fused_swiglu_quant_plain
        data, scale = fn(h)
        return QTensor(data, scale, row_tile(2))


def fused_permute_pad(q: QTensor, row_map: torch.Tensor) -> QTensor:
    """Gather a 2-D row-tiled QTensor's rows by int32 row_map (-1 = pad)."""
    D = q.data.shape[1]

    def counts():
        # the live rows read, every row written, the map read
        live = (row_map >= 0).sum(dtype=torch.float64)
        n = row_map.numel()
        return 0, live * (D * _Q) + n * (D * _Q + 4)
    with roofline.kernel("fused_permute_pad", counts):
        fn = fused_permute_pad_cuda if _on_card(q.data) \
            else fused_permute_pad_plain
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


def _gemm_dims(qx: QTensor, qw: QTensor):
    E, C, K = qx.data.shape
    return E, C, K, qw.data.shape[-1]


def _gemm_counts(qx, qw, out_bytes_elem, rows=None, live_experts=None):
    """FLOPs and bytes of an NN grouped GEMM: 2 E C K N, the e4m3 x rows
    with scales, the e4m3 weight with its 128x128 block scales, the
    output.  A masked GEMM passes its live tile rows and live experts
    (device tensors)."""
    E, C, K, N = _gemm_dims(qx, qw)
    rows = E * C if rows is None else rows
    live_experts = E if live_experts is None else live_experts
    w_bytes = K * N + (K // 128) * (N // 128) * 4
    return (2 * rows * K * N,
            rows * K * _Q + live_experts * w_bytes
            + E * C * N * out_bytes_elem)


def _live_tiles(masked_m: torch.Tensor, C: int):
    """(rows in live 128-row tiles, live experts) of a masked_m on its
    device: what a masked kernel computes."""
    m = masked_m.to(torch.float64).clamp(0, C)
    rows = torch.clamp(torch.ceil(m / 128) * 128, max=C)
    return rows.sum(), (m > 0).sum(dtype=torch.float64)


def grouped_gemm_fp8(qx: QTensor, qw: QTensor) -> torch.Tensor:
    """qx (E, C, K) row-tiled x qw (E, K, N) block-tiled -> (E, C, N) bf16."""
    with roofline.kernel("grouped_gemm_fp8",
                         lambda: _gemm_counts(qx, qw, 2)):
        fn = grouped_gemm_fp8_cuda if _on_card(qx.data) \
            else grouped_gemm_fp8_plain
        w, sw, w_trans = _weight_fields(qw)
        return fn(qx.data, qx.scale, w, sw, w_trans=w_trans)


def grouped_gemm_fp8_quant_out(qx: QTensor, qw: QTensor) -> QTensor:
    """As grouped_gemm_fp8, with the f32 accumulator quantized row-wise to
    e4m3 in the epilogue -> row-tiled QTensor (E, C, N)."""
    with roofline.kernel("grouped_gemm_fp8_quant_out",
                         lambda: _gemm_counts(qx, qw, _Q)):
        fn = grouped_gemm_fp8_cuda if _on_card(qx.data) \
            else grouped_gemm_fp8_plain
        w, sw, w_trans = _weight_fields(qw)
        data, scale = fn(qx.data, qx.scale, w, sw, w_trans=w_trans,
                         quant_out=True)
        return QTensor(data, scale, row_tile(3))


def grouped_gemm_nt_fp8(qa: QTensor, qb: QTensor,
                        out_dtype=torch.float32) -> torch.Tensor:
    """qa (E, M, C), qb (E, N, C), both row-tiled over C -> (E, M, N)."""
    with roofline.kernel("grouped_gemm_nt_fp8",
                         lambda: _nt_counts(qa, qb, out_dtype)):
        fn = grouped_gemm_nt_fp8_cuda if _on_card(qa.data) else \
            grouped_gemm_nt_fp8_plain
        return fn(qa.data, qa.scale, qb.data, qb.scale, out_dtype)


def _nt_counts(qa, qb, out_dtype, tokens=None, steps=None):
    """FLOPs and bytes of an NT Wgrad GEMM over C tokens: 2 E M N C, both
    operands with their scales, the output.  A masked one passes its live
    tokens and token steps (device tensors)."""
    E, M, C = qa.data.shape
    N = qb.data.shape[1]
    out = E * M * N * torch.empty((), dtype=out_dtype).element_size()
    if tokens is None:
        return 2 * E * M * N * C, E * (M + N) * C * _Q + out
    return 2 * M * N * tokens, (M + N) * (tokens + steps * 4) + out


def fp8_transpose(q: QTensor) -> QTensor:
    """Scaling-aware direct transpose of a row-tiled (E, M, K) QTensor ->
    row-tiled (E, K, M), scales block-aligned."""
    with roofline.kernel("fp8_transpose",
                         lambda: (0, 2 * q.data.numel() * _Q)):
        fn = fp8_transpose_cuda if _on_card(q.data) else fp8_transpose_plain
        data, scale = fn(q.data, q.scale)
        return QTensor(data, scale, row_tile(3))


# ---------------------------------------------------------------------------
# Masked layout: 128-row groups at or beyond masked_m[e] are not computed.
# ---------------------------------------------------------------------------
def _use_padded(expected_m, C: int) -> bool:
    return expected_m is not None and expected_m >= C


def _masked_gemm_counts(qx, qw, masked_m, out_bytes_elem):
    rows, live = _live_tiles(masked_m, qx.data.shape[1])
    return _gemm_counts(qx, qw, out_bytes_elem, rows, live)


def grouped_gemm_fp8_masked(qx: QTensor, qw: QTensor, masked_m: torch.Tensor,
                            expected_m: int | None = None) -> torch.Tensor:
    """grouped_gemm_fp8 with dead capacity groups skipped (written 0);
    ``expected_m >= C`` takes the padded kernel."""
    if _use_padded(expected_m, qx.data.shape[1]):
        return grouped_gemm_fp8(qx, qw)
    with roofline.kernel("masked_grouped_gemm_fp8",
                         lambda: _masked_gemm_counts(qx, qw, masked_m, 2)):
        fn = masked_grouped_gemm_fp8_cuda if _on_card(qx.data) else \
            masked_grouped_gemm_fp8_plain
        w, sw, w_trans = _weight_fields(qw)
        return fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32),
                  w_trans=w_trans)


def grouped_gemm_fp8_masked_quant_out(qx: QTensor, qw: QTensor,
                                      masked_m: torch.Tensor,
                                      expected_m: int | None = None
                                      ) -> QTensor:
    """grouped_gemm_fp8_quant_out with dead capacity groups skipped
    (payload 0, scale 1.0); ``expected_m >= C`` takes the padded kernel."""
    if _use_padded(expected_m, qx.data.shape[1]):
        return grouped_gemm_fp8_quant_out(qx, qw)
    with roofline.kernel("masked_grouped_gemm_fp8_quant_out",
                         lambda: _masked_gemm_counts(qx, qw, masked_m, _Q)):
        fn = masked_grouped_gemm_fp8_cuda if _on_card(qx.data) else \
            masked_grouped_gemm_fp8_plain
        w, sw, w_trans = _weight_fields(qw)
        data, scale = fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32),
                         w_trans=w_trans, quant_out=True)
        return QTensor(data, scale, row_tile(3))


def grouped_gemm_nt_fp8_masked(qa: QTensor, qb: QTensor,
                               masked_m: torch.Tensor,
                               out_dtype=torch.float32,
                               expected_m: int | None = None) -> torch.Tensor:
    """grouped_gemm_nt_fp8 over the live token steps only: the contraction
    steps k with k*128 >= masked_m[e] are skipped; ``expected_m >= C``
    takes the padded kernel."""
    C = qa.data.shape[2]
    if _use_padded(expected_m, C):
        return grouped_gemm_nt_fp8(qa, qb, out_dtype)

    def counts():
        tokens, _ = _live_tiles(masked_m, C)
        steps = torch.ceil(masked_m.to(torch.float64).clamp(0, C)
                           / 128).sum()
        return _nt_counts(qa, qb, out_dtype, tokens, steps)
    with roofline.kernel("masked_grouped_gemm_nt_fp8", counts):
        fn = masked_grouped_gemm_nt_fp8_cuda if _on_card(qa.data) else \
            masked_grouped_gemm_nt_fp8_plain
        return fn(qa.data, qa.scale, qb.data, qb.scale,
                  masked_m.to(torch.int32), out_dtype)


def grouped_gemm_swiglu_quant_masked(qx: QTensor, qw13: QTensor,
                                     masked_m: torch.Tensor,
                                     expected_m: int | None = None
                                     ) -> QTensor:
    """Masked GEMM-1 with the fused SwiGLU + quantize epilogue: qx (E, C,
    K) x qw13 (E, K, 2F) [gate | up] -> row-tiled QTensor (E, C, F).
    ``expected_m`` is taken and ignored: the fusion never falls back (a
    masked_m of C gives the padded bits anyway)."""
    E, C, K = qx.data.shape
    F = qw13.data.shape[-1] // 2

    def counts():
        rows, live = _live_tiles(masked_m, C)
        w_bytes = K * 2 * F + (K // 128) * (2 * F // 128) * 4
        return (2 * rows * K * 2 * F,
                rows * K * _Q + live * w_bytes + E * C * F * _Q)
    with roofline.kernel("masked_grouped_gemm_swiglu_quant", counts):
        fn = masked_grouped_gemm_swiglu_quant_cuda if _on_card(qx.data) \
            else masked_grouped_gemm_swiglu_quant_plain
        w, sw, w_trans = _weight_fields(qw13)
        if w_trans:
            raise ValueError("grouped_gemm_swiglu_quant_masked: w13 must be "
                             "stored (E, K, 2F)")
        data, scale = fn(qx.data, qx.scale, w, sw, masked_m.to(torch.int32))
        return QTensor(data, scale, row_tile(3))


def adamw_update(cfg, lr: float, b1c: float, b2c: float, g: torch.Tensor,
                 clip: torch.Tensor, m, v, master, p: torch.Tensor,
                 flags=None, skip_mask: int = 0) -> None:
    """The AdamW update of one chunk of one leaf, in place (state chunks in
    the encodings of ``dist/opt_state.py``; ``master`` None without master
    weights).  Nothing is written where ``flags & skip_mask`` != 0."""
    def counts():
        # every state tensor read and written once, g read: 16 operations
        # an element (the f32 update)
        state = [t for s in (m, v, master, p) if s is not None
                 for t in ((s.data, s.scale) if isinstance(s, QTensor)
                           else (s,))]
        nbytes = sum(t.numel() * t.element_size() for t in state)
        return 16 * p.numel(), 2 * nbytes + g.numel() * g.element_size()
    with roofline.kernel("adamw_update", counts):
        fn = adamw_update_cuda if _on_card(p) else adamw_update_plain
        fn(cfg, lr, b1c, b2c, g, clip, m, v, master, p, flags, skip_mask)
