"""int8 po2-exponent codecs for scales on a wire.

Counterpart of ``repro.dist.scale_sync``'s codecs (the port keeps its own
copy).  A po2 scale s = 2^e travels as its int8 exponent e, one byte a
scale.  Two spellings, value-identical for every exponent ``po2_scale``
can give (|e| <= 126):

  scale_to_exp_i8 / exp_i8_to_scale            frexp / ldexp
  scale_to_exp_i8_bits / exp_i8_to_scale_bits  shift and bias on the f32
                                               bit pattern: no float op

The KV-page migration wire (``serve/transfer.py``) uses the bit forms, so
its codec runs no floating-point arithmetic at all.

The FP8 DP gradient wire agrees its scales across the replicas before
any of them quantizes (the reference's ``:24-86``): ``agree_amax`` takes
the per-row amax's MAX over the data group, so every replica quantizes a
bucket row with the SAME po2 scale, and the e4m3 payloads sum exactly
after an exact dequantize.  ``wire_anomaly`` is the wire guard's check of
a received message, made the same on every replica by a MAX.
"""
from __future__ import annotations

import torch

from repro_torch.core.fp8 import E4M3_MAX, po2_scale
from repro_torch.dist import comm


def agree_amax(amax: torch.Tensor, group) -> torch.Tensor:
    """MAX over the data group: every replica sees the global per-row
    amax.  No group (one replica) is the identity."""
    if group is None:
        return amax
    return comm.all_reduce_(amax.contiguous(), group, "max")


def agreed_po2_scale(x_rows: torch.Tensor, group,
                     fmt_max: float = E4M3_MAX) -> torch.Tensor:
    """The per-row agreed po2 scale (rows, 1) of a (rows, TILE) bucket,
    the same on every replica of the group by construction."""
    amax = x_rows.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    return po2_scale(agree_amax(amax, group), fmt_max)


def wire_anomaly(exp: torch.Tensor, payload: torch.Tensor, group,
                 exp_limit: int) -> torch.Tensor:
    """The wire guard's predicate on a RECEIVED message, before the
    dequantize-sum: True (a bool device scalar) when an exponent is absurd
    (|e| > exp_limit) or a payload byte decodes to NaN (e4m3fn's only
    non-finite codes, 0x7f / 0xff); MAX over the group makes it the same
    on every replica."""
    bad_exp = (exp.to(torch.int32).abs() > exp_limit).any()
    codes = payload.view(torch.uint8) & 0x7F
    bad = bad_exp | (codes == 0x7F).any()
    return comm.agree_max_int(bad.to(torch.int32), group) > 0


def scale_to_exp_i8(scale: torch.Tensor) -> torch.Tensor:
    """po2 scale -> int8 exponent (s = 2^e).  frexp is exact: s = 0.5 *
    2^(e+1), so e fits int8 for any scale po2_scale gives."""
    _, e = torch.frexp(scale.to(torch.float32))
    return (e - 1).to(torch.int8)


def exp_i8_to_scale(exp: torch.Tensor) -> torch.Tensor:
    """int8 exponent -> f32 po2 scale.  ldexp, not exp2: an f32 exp2 need
    not be correctly rounded for |e| >= 13, which would break the exact-po2
    contract the wire rests on."""
    one = torch.ones(exp.shape, dtype=torch.float32, device=exp.device)
    return torch.ldexp(one, exp.to(torch.int32))


def scale_to_exp_i8_bits(scale: torch.Tensor) -> torch.Tensor:
    """Bit spelling of ``scale_to_exp_i8``: a po2 scale 2^e has f32 bits
    (e + 127) << 23 (sign 0, mantissa 0), so the exponent is a shift and a
    bias subtract on the int32 view."""
    bits = scale.view(torch.int32)
    return ((bits >> 23) - 127).to(torch.int8)


def exp_i8_to_scale_bits(exp: torch.Tensor) -> torch.Tensor:
    """Inverse of ``scale_to_exp_i8_bits`` by bit construction, value-
    identical to ``exp_i8_to_scale``."""
    bits = (exp.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)
