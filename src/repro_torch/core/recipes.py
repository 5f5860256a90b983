"""Precision-recipe configuration (paper Fig. 2).

Counterpart of ``repro.core.recipes``.  ``Recipe.use_pallas`` has no
counterpart: the device decides (a CUDA tensor launches the hand-written
kernel, a CPU tensor takes its plain PyTorch twin).  Only ``fp8_flow`` is
ported so far; the other three recipes raise until they are ported
(ROADMAP.md, Queue 1, item 4).
"""
from __future__ import annotations

import dataclasses

RECIPES = ("bf16", "blockwise", "naive_fp8", "fp8_flow")
PORTED = ("fp8_flow",)


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str = "fp8_flow"
    scale_mode: str = "po2"
    # the reference's options that the port does not run yet; True raises
    save_h: bool = False
    masked_experts: bool = False

    def __post_init__(self):
        if self.name not in RECIPES:
            raise ValueError(f"unknown recipe {self.name}; pick from {RECIPES}")
        if self.name not in PORTED:
            raise NotImplementedError(
                f"recipe {self.name!r} is not ported yet; repro_torch runs "
                "fp8_flow only (ROADMAP.md, Queue 1, item 4)")
        if self.scale_mode != "po2":
            raise NotImplementedError("fp8_flow uses po2 scales only")
        if self.save_h:
            raise NotImplementedError(
                "save_h=True (keep the bf16 h for the backward) is not ported "
                "yet; the port recomputes h (ROADMAP.md, Queue 1, item 6)")
        if self.masked_experts:
            raise NotImplementedError(
                "masked experts (and their SwiGLU GEMM-1 epilogue) are not "
                "ported yet (ROADMAP.md, Queue 1, item 5)")


def get_recipe(name: str) -> Recipe:
    return Recipe(name=name)
