"""Scaling-aware FP8 direct transpose (paper Algorithm 1): a row-wise
quantized (..., M, K) e4m3 tensor with po2 scales (..., M, K/128) ->
(..., K, M) e4m3 with scales (..., K, M/128), with no dequantize and no
requantize.

Per 128 x 128 tile, every row is rebased onto the tile's largest row scale
s_max by subtracting k_i = log2(s_max / s_i) from its e4m3 exponents, with
round-to-nearest-even shifts into the subnormal range; the transposed tile
carries s_max.  Integer operations on the encodings only, so the twin
below, the CUDA kernel and the Pallas kernel agree bit for bit.

Replaces ``repro/kernels/fp8_transpose.py::fp8_transpose_pallas``
(``pallas_call`` at fp8_transpose.py:102; the reference applies it with a
``vmap`` over experts, the CUDA kernel takes the (E, M, K) batch in one
launch).  CUDA source: ``csrc/fp8_transpose.cu`` (bound: bytes), which
rebases a 32-bit word of one row at a time and looks up the reference's
rebase in a table only where a byte leaves the normal range.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3, TILE
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/fp8_transpose.py:102"
SOURCE = "src/repro_torch/csrc/fp8_transpose.cu"


def _rshift_rne(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even right shift of a non-negative int32 tensor."""
    n = n.clamp(0, 15)
    floor = v >> n
    rem = v - (floor << n)
    half = 1 << (n - 1).clamp(min=0)
    up = (n > 0) & ((rem > half) | ((rem == half) & ((floor & 1) == 1)))
    return floor + up.to(torch.int32)


def _rebase_exponent(enc: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Divide e4m3 encodings (int32 0..255) by 2**k (k >= 0), exactly."""
    sign = enc & 0x80
    e = (enc >> 3) & 0xF
    m = enc & 0x7
    e_new = e - k
    normal_out = sign | ((e_new & 0xF) << 3) | m
    m_sub = _rshift_rne(8 + m, 1 - e_new)
    sub_from_normal = torch.where(m_sub >= 8, sign | 8, sign | m_sub)
    sub_from_sub = sign | _rshift_rne(m, k)
    return torch.where(e == 0, sub_from_sub,
                       torch.where(e_new >= 1, normal_out, sub_from_normal))


def _check(data, scale):
    *lead, M, K = data.shape
    if M % TILE or K % TILE:
        raise ValueError(f"fp8_transpose: dims ({M},{K}) must be multiples "
                         f"of {TILE}")
    if tuple(scale.shape) != (*lead, M, K // TILE):
        raise ValueError(f"fp8_transpose: scales {tuple(scale.shape)} do not "
                         f"match payload {tuple(data.shape)}")
    return lead, M, K


def fp8_transpose_plain(data: torch.Tensor, scale: torch.Tensor):
    lead, M, K = _check(data, scale)
    nb_m, nb_k = M // TILE, K // TILE
    s = scale.reshape(*lead, nb_m, TILE, nb_k)
    s_max = s.amax(dim=-2)                                 # (..., nb_m, nb_k)
    # both are normal powers of two: k is the difference of their exponents
    k = ((s_max.view(torch.int32) >> 23)[..., None, :]
         - (s.view(torch.int32) >> 23))                    # (..., nb_m, T, nb_k)
    enc = data.view(torch.uint8).reshape(*lead, nb_m, TILE, nb_k, TILE)
    out = _rebase_exponent(enc.to(torch.int32), k[..., None]).to(torch.uint8)
    nd = out.ndim
    perm = tuple(range(nd - 4)) + (nd - 2, nd - 1, nd - 4, nd - 3)
    out = out.permute(perm).reshape(*lead, K, M)
    s_out = s_max.transpose(-1, -2).repeat_interleave(TILE, dim=-2)
    return out.view(E4M3), s_out.contiguous()


def fp8_transpose_cuda(data: torch.Tensor, scale: torch.Tensor):
    kernels.check_cuda_input(data, "fp8_transpose", E4M3, 3)
    kernels.check_cuda_input(scale, "fp8_transpose", torch.float32, 3)
    _, M, K = _check(data, scale)
    E = data.shape[0]
    out = torch.empty((E, K, M), dtype=E4M3, device=data.device)
    s_out = torch.empty((E, K, M // TILE), dtype=torch.float32,
                        device=data.device)
    if E and M and K:
        build.launch("fp8_transpose", data.data_ptr(), scale.data_ptr(),
                     out.data_ptr(), s_out.data_ptr(), E, M, K)
        kernels.LAUNCHES["fp8_transpose"] += 1
    return out, s_out
