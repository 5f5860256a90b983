"""Carry parameter trees into the port, bits unchanged.

``params_from_numpy`` takes a tree of numpy arrays -- the reference's
``init_params`` or ``quantize_params_for_serving`` tree after
``np.asarray`` on every leaf -- and returns the port's params on `device`.
Dicts map to dicts; an object with ``data``, ``scale`` and ``tile``
attributes (the reference's QTensor) maps to the port's QTensor.  bf16
arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) travel
as uint16 views and e4m3 arrays as uint8 views, so every bit is kept.
``pools_from_numpy`` does the same for the reference's paged KV pools.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device

_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # torch.from_numpy wants a writable buffer
        a = a.copy()
    view = _VIEWS.get(a.dtype.name)
    if view is not None:
        t = torch.from_numpy(a.view(view[0])).view(view[1])
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if not isinstance(tree, np.ndarray) and all(
            hasattr(tree, f) for f in ("data", "scale", "tile")):
        return QTensor(tensor_from_numpy(tree.data, device),
                       tensor_from_numpy(tree.scale, device),
                       tuple(tree.tile))
    return tensor_from_numpy(tree, device)


def pools_from_numpy(pools, device="cuda"):
    """The reference's paged KV pools ({stack: {"k"|"v": {"data"[,
    "scale"]}}}, numpy leaves) as the port's pools on `device`, bit for bit:
    e4m3 payloads through uint8 views, bf16 through uint16, f32 scales as
    they are.  Raises on a tree that is not that layout."""
    out = {}
    for stack, kvs in pools.items():
        if sorted(kvs) != ["k", "v"]:
            raise ValueError(f"pool stack {stack!r} has {sorted(kvs)}, "
                             "want k and v")
        out[stack] = {}
        for kv, p in kvs.items():
            data = np.asarray(p["data"])
            if data.ndim != 5 or set(p) - {"data", "scale"}:
                raise ValueError(f"{stack}/{kv}: not a paged pool "
                                 "(L, n_pages, page_size, KV, hd)")
            t = {"data": tensor_from_numpy(data, device)}
            if "scale" in p:
                scale = np.asarray(p["scale"], np.float32)
                if scale.shape != data.shape[:-1] + (1,):
                    raise ValueError(f"{stack}/{kv}: scale {scale.shape} "
                                     f"for data {data.shape}")
                t["scale"] = tensor_from_numpy(scale, device)
            out[stack][kv] = t
    return out


def params_to(tree, device):
    """The same tree on `device` (leaves already there are not copied)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)
