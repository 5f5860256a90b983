"""FP8 format constants and the tile-scale arithmetic.

Counterpart of ``repro.core.fp8``, with the linear scale of
``repro.core.quant.compute_scale`` beside the po2 one.  The po2 scale
exponent is read from the bits of ``r = amax / 448`` (the frexp recipe
below) instead of ``ceil(log2(r))``: f32 ``log2`` differs between
libraries near powers of two, while the bit recipe gives the exact
smallest power of two on every input, and the CUDA kernels use the same
recipe, so kernel == plain on the card bit for bit.
"""
from __future__ import annotations

import torch

E4M3 = torch.float8_e4m3fn

E4M3_MAX = 448.0          # largest finite e4m3fn magnitude
F32_MIN_NORMAL = 2.0 ** -126
TILE = 128                # per-tile quantization granularity (paper Eq. 2)


def po2_exponent(amax: torch.Tensor, fmt_max: float = E4M3_MAX) -> torch.Tensor:
    """Exponent e of the smallest power of two with amax / 2**e <= fmt_max,
    clamped to [-126, 126] (int32).

    With r = amax / fmt_max in f32 and frexp(r) = (m, k): e = k - 1 when
    m == 0.5 (r is a power of two), else k.  From the f32 bits of a normal
    r, k = E - 126 and m == 0.5 exactly when the mantissa field is 0.  A
    subnormal r (E == 0) lies below 2**-126 and clamps to -126."""
    r = amax.to(torch.float32) / fmt_max
    bits = r.view(torch.int32)
    biased = (bits >> 23) & 0xFF
    e = torch.where((bits & 0x7FFFFF) == 0, biased - 127, biased - 126)
    return e.clamp(-126, 126)


def po2_scale(amax: torch.Tensor, fmt_max: float = E4M3_MAX) -> torch.Tensor:
    """Smallest power-of-two f32 scale s with amax / s <= fmt_max; built
    from the bits ((e + 127) << 23).  amax == 0 gives s = 1, and so does a
    subnormal amax: XLA and the TPU flush f32 subnormals to zero, so the
    reference's ``amax > 0`` is false for them (the payload is 0 either
    way)."""
    e = po2_exponent(amax, fmt_max)
    s = ((e + 127) << 23).to(torch.int32).view(torch.float32)
    return torch.where(amax >= F32_MIN_NORMAL, s, torch.ones_like(s))


def linear_scale(amax: torch.Tensor,
                 fmt_max: float = E4M3_MAX) -> torch.Tensor:
    """The conventional recipe's scale (``scale_mode="linear"``): amax /
    448 in f32, correctly rounded; 1.0 where amax is 0, subnormal or NaN,
    as the reference's ``where(amax > 0, amax / 448, 1)`` gives under
    XLA's flush of subnormals.  A normal amax below 448 * 2**-126 gives a
    subnormal scale here, where XLA flushes it to 0 (ROADMAP.md, Queue
    3)."""
    amax = amax.to(torch.float32)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal (a different value on ~half of
    # all inputs); tensor / tensor is IEEE division on the CPU and the card
    r = amax / torch.full_like(amax, fmt_max)
    return torch.where(amax >= F32_MIN_NORMAL, r, torch.ones_like(amax))


def is_po2(s: torch.Tensor) -> torch.Tensor:
    """True where s is an exact positive power of two."""
    m, _ = torch.frexp(s.to(torch.float32))
    return (s > 0) & (m == 0.5)


def cast_to(x: torch.Tensor) -> torch.Tensor:
    """Saturating e4m3 cast: clip to +-448, then round to nearest even.
    A bf16 input is clipped in bf16 (+-448 is exact there, and bf16 -> e4m3
    rounds exactly as f32 -> e4m3)."""
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    return x.clamp(-E4M3_MAX, E4M3_MAX).to(E4M3)
