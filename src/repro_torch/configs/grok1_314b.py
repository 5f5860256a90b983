"""Grok-1 314B [hf:xai-org/grok-1, unverified]: 8 experts top-2 with huge
per-expert FFN (32768) -> experts are TP-sharded (E < model-axis width);
the FP8 dataflow applies without the dispatch all-to-all (DESIGN.md §6)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok1_314b", n_layers=64, d_model=6144, n_heads=48, n_kv=8,
    head_dim=128, d_ff=0, vocab=131072, act="geglu",
    rope_theta=1e4, moe=True, n_experts=8, top_k=2, d_ff_expert=32768,
    fsdp=True, grad_accum=1,
)
