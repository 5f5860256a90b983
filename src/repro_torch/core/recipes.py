"""Precision-recipe configuration: the four dataflows of paper Fig. 2.

Counterpart of ``repro.core.recipes``:

  bf16      (2a)  no quantization anywhere (0 activation casts per MoE
                  forward + backward).
  blockwise (2b)  FP8 only inside the grouped GEMMs, linear scales, BF16
                  dispatch and BF16-saved activations (8 casts).
  naive_fp8 (2c)  FP8 dispatch with Q/DQ around it, FP8-saved activations
                  whose Wgrad layouts are rebuilt by dequantize ->
                  transpose -> requantize, linear scales (12 casts).
  fp8_flow  (2d)  po2 scales, the scaling-aware transpose, the fused
                  quantizes, FP8 dispatch both ways (2 casts).

``Recipe.use_pallas`` has no counterpart: the device decides (a CUDA tensor
launches the hand-written kernel, a CPU tensor takes its plain PyTorch
twin).  ``get_recipe`` starts from the reference's presets, so
``blockwise`` and ``naive_fp8`` carry ``scale_mode="linear"``.
"""
from __future__ import annotations

import dataclasses

RECIPES = ("bf16", "blockwise", "naive_fp8", "fp8_flow")


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str = "fp8_flow"
    # 'po2' enables the scaling-aware transpose; 'linear' is the
    # conventional amax scale of the baselines (double quantization error)
    scale_mode: str = "po2"
    # the reference's option that the port does not run yet; True raises
    save_h: bool = False
    # Route the expert grouped GEMMs through the MASKED layout: per-expert
    # live row counts from the expert plan skip dead 128-row capacity
    # groups.  Bitwise the padded layout on the zero-padded dispatch
    # buffers, so the padded path stays the default and the A/B baseline.
    # fp8_flow only, as in the reference: the other recipes ignore it.
    masked_experts: bool = False
    # Fuse the inter-GEMM SwiGLU + row-wise e4m3 quantize into GEMM-1's
    # epilogue (masked layout only: it needs masked_experts; h never
    # reaches device memory).  Bitwise the unfused pair.
    swiglu_epilogue: bool = False

    def __post_init__(self):
        if self.name not in RECIPES:
            raise ValueError(f"unknown recipe {self.name}; pick from {RECIPES}")
        if self.scale_mode not in ("po2", "linear"):
            raise ValueError(f"scale_mode {self.scale_mode!r}: 'po2' or "
                             "'linear'")
        if self.name == "fp8_flow" and self.scale_mode != "po2":
            raise NotImplementedError(
                "fp8_flow with linear scales: the scaling-aware transpose "
                "needs po2 scales")
        if self.save_h:
            raise NotImplementedError(
                "save_h=True (keep the bf16 h for the backward) is not ported "
                "yet; the port recomputes h (ROADMAP.md, Queue 1, item 6)")

    @property
    def is_fp8(self) -> bool:
        return self.name != "bf16"

    @property
    def fp8_dispatch(self) -> bool:
        return self.name in ("naive_fp8", "fp8_flow")

    @property
    def fp8_dispatch_bwd(self) -> bool:
        return self.name == "fp8_flow"


BF16 = Recipe(name="bf16")
BLOCKWISE = Recipe(name="blockwise", scale_mode="linear")
NAIVE_FP8 = Recipe(name="naive_fp8", scale_mode="linear")
FP8_FLOW = Recipe(name="fp8_flow", scale_mode="po2")
_PRESETS = {"bf16": BF16, "blockwise": BLOCKWISE, "naive_fp8": NAIVE_FP8,
            "fp8_flow": FP8_FLOW}


def get_recipe(name: str, **kw) -> Recipe:
    """The named preset with the given fields overridden, e.g.
    ``get_recipe("fp8_flow", masked_experts=True, swiglu_epilogue=True)``."""
    if name not in _PRESETS:
        raise ValueError(f"unknown recipe {name}; pick from {RECIPES}")
    base = _PRESETS[name]
    return dataclasses.replace(base, **kw) if kw else base
