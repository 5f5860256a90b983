"""FP8-split AdamW optimizer state behind QTensor.

Counterpart of ``repro.dist.opt_state`` (its single-device part).  The
policy keeps, for every leaf it applies to:

  m       e4m3 payload + per-row po2 scale (QTensor, 1.03 B a parameter)
  v       bf16, leaf-shaped (2 B a parameter)
  master  f16 payload + per-row po2 scale (QTensor, ~2.03 B a parameter):
          the row scale restores the exponent range f16 lacks, so the
          payload's 10 mantissa bits sit near the row amax

=> ~5.1 B a parameter of state instead of 12.  An encoded leaf is flat
``(rows, 128)``, zero-padded at the tail, with one scale a row.  Small or
1-D leaves (norms, biases, the router below ``min_size``) keep f32.

The scales are the port's exact po2 (``core/fp8.po2_scale``: the exponent
from the bits of amax / fmax), where the reference takes
``ceil(log2(.))``; the two differ only where f32 ``log2`` lands on the
wrong side of a power of two (ROADMAP.md, Queue 3).  The ZeRO-1 flat
buckets wait for multi-GPU training (ROADMAP.md, Queue 1, item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import casts
from repro_torch.core.fp8 import E4M3, E4M3_MAX, TILE, cast_to, po2_scale
from repro_torch.core.quant import QTensor, _dequantize_nocount
from repro_torch.device import CHUNK_ELEMS

# the encodings: plain leaf-shaped tensors, or (rows, TILE) QTensors
PLAIN_KINDS = {"f32": torch.float32, "bf16": torch.bfloat16}
SCALED_KINDS = {"e4m3": E4M3, "f16": torch.float16}


@dataclasses.dataclass(frozen=True)
class StatePolicy:
    """Optimizer-state dtype policy (``AdamWConfig.state_policy``).

    Kinds: 'f32' | 'bf16' (plain tensors, leaf-shaped) and 'e4m3' | 'f16'
    (QTensor: flat (rows, TILE) payload + per-row po2 scale)."""
    m: str = "e4m3"
    v: str = "bf16"
    master: str = "f16"
    min_size: int = 2048

    def applies(self, leaf) -> bool:
        return leaf.ndim >= 2 and leaf.numel() >= self.min_size


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Flatten any tensor to zero-padded (rows, TILE)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % TILE
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, TILE)


def _row_scale(rows: torch.Tensor, fmt_max: float) -> torch.Tensor:
    amax = rows.abs().amax(dim=-1, keepdim=True).to(torch.float32)
    return po2_scale(amax, fmt_max)


def encode(kind: str, x: torch.Tensor):
    """A tensor (any shape, f32 or bf16) -> its encoded state leaf.  Rows
    are independent, so a large leaf is encoded CHUNK_ELEMS at a time (the
    same bits, the temporaries of a chunk)."""
    if kind in PLAIN_KINDS:
        return x.to(PLAIN_KINDS[kind])
    if kind not in SCALED_KINDS:
        raise ValueError(f"unknown state encoding {kind}")
    rows = _rows(x)
    if kind == "e4m3":
        casts.record("fused_quantize", "opt_state", rows.numel())
    step = CHUNK_ELEMS // TILE
    if rows.shape[0] <= step:
        data, scale = _encode_rows(kind, rows)
        return QTensor(data=data, scale=scale, tile=(1, TILE))
    data = torch.empty(rows.shape, dtype=SCALED_KINDS[kind],
                       device=rows.device)
    scale = torch.empty((rows.shape[0], 1), dtype=torch.float32,
                        device=rows.device)
    for r in range(0, rows.shape[0], step):
        data[r:r + step], scale[r:r + step] = _encode_rows(
            kind, rows[r:r + step])
    return QTensor(data=data, scale=scale, tile=(1, TILE))


def _encode_rows(kind: str, rows: torch.Tensor):
    if kind == "e4m3":
        scale = _row_scale(rows, E4M3_MAX)
        return cast_to(rows.to(torch.float32) / scale), scale
    # payload in (-1, 1]: f16's mantissa sits at the row amax; a po2
    # division is exact, so a bf16 row loses nothing representable
    scale = _row_scale(rows, 1.0)
    if rows.dtype == torch.bfloat16:
        return (rows / scale.to(torch.bfloat16)).to(torch.float16), scale
    return (rows.to(torch.float32) / scale).to(torch.float16), scale


def decode(enc, like_shape, size: int) -> torch.Tensor:
    """An encoded state leaf -> f32 tensor of like_shape."""
    if isinstance(enc, QTensor):
        flat = _dequantize_nocount(enc, torch.float32).reshape(-1)
        return flat[:size].reshape(like_shape)
    return enc.to(torch.float32)


def kind_of(enc) -> str:
    """The encoding of a state leaf."""
    if isinstance(enc, QTensor):
        return "e4m3" if enc.data.dtype == E4M3 else "f16"
    return "f32" if enc.dtype == torch.float32 else "bf16"


def encode_like(x32: torch.Tensor, template):
    """Re-encode an updated f32 value into the template's representation."""
    if isinstance(template, QTensor):
        return encode(kind_of(template), x32)
    return x32.to(template.dtype)


def zeros_encoded(kind: str, like: torch.Tensor):
    """Zero state in the target encoding without an f32 temporary."""
    if kind in PLAIN_KINDS:
        return torch.zeros(like.shape, dtype=PLAIN_KINDS[kind],
                           device=like.device)
    n_rows = -(-like.numel() // TILE)
    return QTensor(data=torch.zeros((n_rows, TILE), dtype=SCALED_KINDS[kind],
                                    device=like.device),
                   scale=torch.ones((n_rows, 1), dtype=torch.float32,
                                    device=like.device),
                   tile=(1, TILE))


def state_bytes_model(n_params: int, pol: StatePolicy,
                      master_weights: bool = True) -> float:
    """Bytes of optimizer state under the policy (memory accounting)."""
    per = {"f32": 4.0, "bf16": 2.0,
           "e4m3": 1.0 + 4.0 / TILE, "f16": 2.0 + 4.0 / TILE}
    total = per[pol.m] + per[pol.v]
    if master_weights:
        total += per[pol.master]
    return total * n_params
