"""Architecture registry (a copy of ``repro.configs``' registry).

Only the architectures the port can serve and train are registered: the
attention-only decoders the reference's paged engine serves -- the dense
qwen15_05b, starcoder2_15b (GELU, LayerNorm), gemma3_4b and gemma2_9b
(GeGLU, local:global attention), the all-MoE qwen3_moe_235b and
grok1_314b, and the two DeepSeek models with a dense prologue and shared
experts.  llava_next_34b, seamless_m4t_v2, mamba2_27b and hymba_15b need
the frontend, encoder-decoder and SSM stacks (ROADMAP.md, Queue 1,
item 2).
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeSpec,
                                      applicable_shapes)

ARCH_IDS = ["qwen15_05b", "qwen3_moe_235b", "deepseek_v2_lite",
            "deepseek_v3_671b", "starcoder2_15b", "gemma3_4b", "gemma2_9b",
            "grok1_314b"]

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeSpec",
           "applicable_shapes", "get_arch"]


def get_arch(name: str) -> ArchConfig:
    import importlib
    name = name.replace("-", "_")
    if name not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ported: {ARCH_IDS}); "
            "see ROADMAP.md, Queue 1, item 2")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
