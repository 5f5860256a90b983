"""Qwen3-235B-A22B [hf:Qwen/Qwen3-30B-A3B scaled]: 128 experts top-8,
per-expert d_ff 1536, qk-norm, GQA 64H/4KV.  The paper's primary target
shape: full FP8-Flow-MoE recipe with EP dispatch."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_235b", n_layers=94, d_model=4096, n_heads=64, n_kv=4,
    head_dim=128, d_ff=0, vocab=151936, act="swiglu", qk_norm=True,
    rope_theta=1e6, moe=True, n_experts=128, top_k=8, d_ff_expert=1536,
    fsdp=True, grad_accum=1,
)
