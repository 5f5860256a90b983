"""FP8 gradient compression for a data-parallel sum.

Counterpart of ``repro.runtime.compression``: ``compressed_psum`` sums a
tensor over a group with an e4m3 payload + po2 scales on the wire --
reduce-scatter in FP8 (an all-to-all of the row blocks), a local f32
sum, a re-quantize, and an all-gather in FP8 -- halving the bytes of a
bf16 sum (plus 1/128 for the scales) at a quantization error bounded by
the po2 tile quantizer.  ``compress_decompress`` is the round trip, for
error-feedback accounting.  Both quantize with kernel #1
(``ops.quantize_rowwise``) on the card and its twin on the CPU, recorded
as fused casts (``grad_compress``, ``grad_compress2``).

The train path's gradient reduction is ``dist/grad_comm.py`` (bucketed,
scale-agreed, ZeRO-1); this is the standalone psum-shaped primitive of
the reference's cross-pod hop.
"""
from __future__ import annotations

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import TILE
from repro_torch.core.quant import QTensor, _dequantize_nocount
from repro_torch.dist import comm
from repro_torch.kernels import ops


def _q_rows(rows: torch.Tensor, tag: str) -> QTensor:
    casts.record("fused_quantize", tag, rows.numel())
    return ops.quantize_rowwise(rows)


def _q_flat(x: torch.Tensor):
    """Any tensor as flat (rows, TILE) e4m3 + scales; (q, n, pad)."""
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % TILE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return _q_rows(flat.reshape(-1, TILE), "grad_compress"), n, pad


def _dq_flat(q: QTensor, n: int, shape, dtype) -> torch.Tensor:
    flat = _dequantize_nocount(q, torch.float32).reshape(-1)[:n]
    return flat.reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` with an FP8 wire: reduce-scatter(e4m3)
    -> local dequantize + f32 sum -> re-quantize -> all-gather(e4m3).
    Bytes: 2 x (N/P x 1 B + scales) a hop instead of 2 x N x 4 B."""
    q, n, _ = _q_flat(x)
    P = comm.size(group)
    rows = q.data.shape[0]
    rpad = (-rows) % P
    data, scale = q.data, q.scale
    if rpad:
        data = torch.cat([data, data.new_zeros((rpad, TILE))])
        scale = torch.cat([scale, scale.new_ones((rpad, 1))])
    dsh = comm.all_to_all(data, group).reshape(P, -1, TILE)
    ssh = comm.all_to_all(scale, group).reshape(P, -1, 1)
    local = dsh[0].to(torch.float32) * ssh[0]
    for i in range(1, P):
        local.add_(dsh[i].to(torch.float32) * ssh[i])
    q2 = _q_rows(local, "grad_compress2")
    gd = comm.all_gather(q2.data, group)
    gs = comm.all_gather(q2.scale, group)
    out = (gd.to(torch.float32) * gs).reshape(-1)[:n]
    return out.reshape(x.shape).to(x.dtype)


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """The FP8 round trip of x (error-feedback accounting and tests)."""
    q, n, _ = _q_flat(x)
    return _dq_flat(q, n, x.shape, x.dtype)
