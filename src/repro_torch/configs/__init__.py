"""Architecture registry (a copy of ``repro.configs``' registry): all
twelve of the reference's architectures.

The attention-only decoders also serve through the paged engine
(``serve.engine``); llava_next_34b (vision prefix), seamless_m4t_v2
(encoder-decoder), mamba2_27b (SSM) and hymba_15b (hybrid) serve through
``serve.serve_step`` (``make_prefill``, ``make_serve_step``), as in the
reference, whose paged engine refuses them too.
"""
from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeSpec,
                                      applicable_shapes)

ARCH_IDS = [
    "starcoder2_15b", "qwen15_05b", "gemma3_4b", "gemma2_9b",
    "seamless_m4t_v2", "mamba2_27b", "hymba_15b", "qwen3_moe_235b",
    "grok1_314b", "llava_next_34b", "deepseek_v2_lite", "deepseek_v3_671b",
]

__all__ = ["ARCH_IDS", "ArchConfig", "SHAPES", "ShapeSpec",
           "applicable_shapes", "get_arch"]


def get_arch(name: str) -> ArchConfig:
    import importlib
    name = name.replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
