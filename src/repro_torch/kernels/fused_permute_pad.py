"""Fused permute + pad of an FP8 payload and its scale rows.

out[i] = x[row_map[i]], sout[i] = s[row_map[i]]; a row_map entry outside
[0, T) (-1 by convention) writes payload 0 and scale 1.0.  Used for the
prefill send layout, the expert grouping, and the decode gather (the
reference's ``_take_rows`` pair at core/moe.py:454-455 is this function).

Replaces ``repro/kernels/fused_permute_pad.py::fused_permute_pad_pallas``
(``pallas_call`` at fused_permute_pad.py:52).  CUDA source:
``csrc/permute_pad.cu`` (bound: bytes; one gathered read and one write per
row).  Payloads move as uint8, so NaN encodings are data.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.fp8 import E4M3
from repro_torch.kernels import build

REPLACES = "src/repro/kernels/fused_permute_pad.py:52"
SOURCE = "src/repro_torch/csrc/permute_pad.cu"


def fused_permute_pad_plain(x: torch.Tensor, s: torch.Tensor,
                            row_map: torch.Tensor):
    valid = (row_map >= 0) & (row_map < x.shape[0])
    idx = torch.where(valid, row_map, 0).long()
    xo = torch.where(valid[:, None], x.view(torch.uint8)[idx], 0)
    so = torch.where(valid[:, None], s[idx], 1.0)
    return xo.view(x.dtype), so


def fused_permute_pad_cuda(x: torch.Tensor, s: torch.Tensor,
                           row_map: torch.Tensor):
    kernels.check_cuda_input(x, "fused_permute_pad", E4M3, 2)
    kernels.check_cuda_input(s, "fused_permute_pad", torch.float32, 2)
    kernels.check_cuda_input(row_map, "fused_permute_pad", torch.int32, 1)
    T, D = x.shape
    if s.shape[0] != T or D % 16:
        raise ValueError(f"fused_permute_pad: payload {tuple(x.shape)} and "
                         f"scales {tuple(s.shape)} disagree")
    n_out, Ds = row_map.shape[0], s.shape[1]
    xo = torch.empty((n_out, D), dtype=E4M3, device=x.device)
    so = torch.empty((n_out, Ds), dtype=torch.float32, device=x.device)
    if n_out:
        build.launch("permute_pad", x.data_ptr(), s.data_ptr(),
                     row_map.data_ptr(), xo.data_ptr(), so.data_ptr(), T, D,
                     Ds, n_out)
        kernels.LAUNCHES["fused_permute_pad"] += 1
    return xo, so
