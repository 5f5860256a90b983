"""int8 po2-exponent codecs for scales on a wire.

Counterpart of ``repro.dist.scale_sync``'s codecs (the port keeps its own
copy).  A po2 scale s = 2^e travels as its int8 exponent e, one byte a
scale.  Two spellings, value-identical for every exponent ``po2_scale``
can give (|e| <= 126):

  scale_to_exp_i8 / exp_i8_to_scale            frexp / ldexp
  scale_to_exp_i8_bits / exp_i8_to_scale_bits  shift and bias on the f32
                                               bit pattern: no float op

The KV-page migration wire (``serve/transfer.py``) uses the bit forms, so
its codec runs no floating-point arithmetic at all.  ``agree_amax``,
``agreed_po2_scale`` and ``wire_anomaly`` belong to the FP8 DP gradient
wire and come with multi-GPU training (ROADMAP.md, Queue 1, item 7).
"""
from __future__ import annotations

import torch


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
