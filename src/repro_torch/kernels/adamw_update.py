"""The fused AdamW update of one chunk of one leaf, in place.

Not a TPU kernel: the reference's optimizer is XLA
(``repro/optim/adamw.py:38-49``, ``:110-162``), so this kernel replaces
no ``pallas_call``.  CUDA source: ``csrc/adamw_update.cu``, whose header
gives the design and what bounds it (bytes).

One call updates the chunk of a parameter `p` (bf16, or f32: the norms
and the router of some configs) from its gradient
`g` (bf16, or the f32 sums of gradient accumulation) times the clip
factor `clip` (a device scalar), and the state chunks `m`, `v` and
`master` (``None`` when ``master_weights=False``), each in one of the
encodings of ``dist/opt_state.py``: an f32 or bf16 tensor, or an e4m3 /
f16 ``QTensor`` of (rows, 128) and a scale a row.  A chunk starts on a
row boundary.  With `flags` (an int32 device scalar, the guard's anomaly
bits) and ``flags & skip_mask`` nonzero, nothing is written.

The plain twin is the optimizer's chunk loop: decode, ``adamw_math``,
then ``encode_like``; on a skipped step every output keeps its old bytes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import casts
from repro_torch.core.quant import QTensor
from repro_torch.kernels import build

REPLACES = ("none: the reference's AdamW is XLA "
            "(src/repro/optim/adamw.py:110-162)")
SOURCE = "src/repro_torch/csrc/adamw_update.cu"

# the kind codes of csrc/adamw_update.cu
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
         torch.float16: 3}
_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _put(dst: torch.Tensor, src: torch.Tensor, keep) -> None:
    """dst <- src, or dst unchanged (every byte) where `keep` is true."""
    if keep is None:
        dst.copy_(src)
        return
    iv = _INT_VIEW[dst.element_size()]
    dst.view(iv).copy_(torch.where(keep, dst.view(iv),
                                   src.to(dst.dtype).view(iv)))


def _put_state(enc, x32: torch.Tensor, keep) -> None:
    from repro_torch.dist import opt_state as ost
    new = ost.encode_like(x32, enc)
    if isinstance(enc, QTensor):
        _put(enc.data, new.data, keep)
        _put(enc.scale, new.scale, keep)
    else:
        _put(enc, new, keep)


def adamw_update_plain(cfg, lr: float, b1c: float, b2c: float,
                       g: torch.Tensor, clip: torch.Tensor, m, v,
                       master, p: torch.Tensor,
                       flags: Optional[torch.Tensor] = None,
                       skip_mask: int = 0) -> None:
    from repro_torch.dist.opt_state import decode
    from repro_torch.optim.adamw import adamw_math
    n = p.numel()
    keep = None if flags is None else (flags & skip_mask) != 0
    m32, v32 = decode(m, (n,), n), decode(v, (n,), n)
    base = decode(master, (n,), n) if master is not None \
        else p.to(torch.float32)
    new_w, m_new, v_new = adamw_math(cfg, g.to(torch.float32) * clip, m32,
                                     v32, base, lr, b1c, b2c)
    del m32, v32, base
    _put_state(m, m_new, keep)
    _put_state(v, v_new, keep)
    if master is not None:
        _put_state(master, new_w, keep)
    _put(p, new_w.to(p.dtype), keep)


def _state_args(enc, n: int, name: str):
    """(payload pointer, scale pointer, kind code) of one state chunk."""
    if enc is None:
        return None, None, -1
    if isinstance(enc, QTensor):
        rows = -(-n // 128)
        if enc.data.shape != (rows, 128) or enc.scale.shape != (rows, 1):
            raise ValueError(f"adamw_update: {name} holds "
                             f"{tuple(enc.data.shape)} rows for {n} elements")
        kernels.check_cuda_input(enc.data, f"adamw_update {name}",
                                 enc.data.dtype, 2)
        kernels.check_cuda_input(enc.scale, f"adamw_update {name} scale",
                                 torch.float32, 2)
        if enc.data.dtype not in (torch.float8_e4m3fn, torch.float16):
            raise TypeError(f"adamw_update: {name} payload {enc.data.dtype}")
        return enc.data.data_ptr(), enc.scale.data_ptr(), \
            _KIND[enc.data.dtype]
    if enc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adamw_update: {name} {enc.dtype}")
    if enc.numel() != n or not enc.is_cuda or not enc.is_contiguous():
        raise ValueError(f"adamw_update: {name} must be a contiguous CUDA "
                         f"tensor of {n} elements")
    return enc.data_ptr(), None, _KIND[enc.dtype]


def adamw_update_cuda(cfg, lr: float, b1c: float, b2c: float,
                      g: torch.Tensor, clip: torch.Tensor, m, v,
                      master, p: torch.Tensor,
                      flags: Optional[torch.Tensor] = None,
                      skip_mask: int = 0) -> None:
    n = p.numel()
    if p.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"adamw_update: parameter {p.dtype}")
    kernels.check_cuda_input(p, "adamw_update p", p.dtype, 1)
    if g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"adamw_update: gradient {g.dtype}")
    kernels.check_cuda_input(g, "adamw_update g", g.dtype, 1)
    if g.numel() != n:
        raise ValueError(f"adamw_update: gradient of {g.numel()} elements "
                         f"for a chunk of {n}")
    kernels.check_cuda_input(clip.reshape(1), "adamw_update clip",
                             torch.float32, 1)
    if flags is not None:
        kernels.check_cuda_input(flags.reshape(1), "adamw_update flags",
                                 torch.int32, 1)
    args = [_state_args(s, n, k) for s, k in ((m, "m"), (v, "v"),
                                              (master, "master"))]
    if isinstance(m, QTensor) and m.data.dtype == torch.float8_e4m3fn:
        casts.record("fused_quantize", "opt_state", m.data.numel())
    f = np.float32
    # ATen's CUDA division by a Python scalar multiplies by the f32
    # reciprocal (div_true_kernel_cuda): the twin's m_new / b1c, v_new / b2c
    scal = (f(cfg.b1), f(1 - cfg.b1), f(cfg.b2), f(1 - cfg.b2),
            f(1.0) / f(b1c), f(1.0) / f(b2c), f(cfg.eps),
            f(cfg.weight_decay), f(lr))
    if n:
        build.launch(
            "adamw_update", g.data_ptr(), int(g.dtype == torch.float32),
            clip.data_ptr(), None if flags is None else flags.data_ptr(),
            int(skip_mask), *args[0], *args[1], *args[2], p.data_ptr(),
            int(p.dtype == torch.float32), n,
            *(float(s) for s in scal))
        kernels.LAUNCHES["adamw_update"] += 1
