"""Device selection for the port's entry points.

Entry points default to ``"cuda"``.  Asking for CUDA where no card is
visible raises: nothing in the port falls back to the CPU on its own.
"""
from __future__ import annotations

import torch

# elements of a large tensor that an f32-widening pass (the weight
# quantizer, the global norm, the AdamW update, the cross-entropy) handles
# at once: 128 MiB of f32, where a whole full-width expert leaf widened to
# f32 would be 6.4 GB
CHUNK_ELEMS = 1 << 25


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
